"""The port's flow variants (fields/flow.py): the pwlinear and realnvp
(affine) transforms, the three priors, realnvp's Gaussian prior and
sigmoid output cell, and the packed conditioning field, against the JAX
package.

numpy inputs from a seed go through the JAX function and its port;
draws are made with jax.random and handed to the port as numbers.
float32 values agree to rtol 1e-5 / atol 1e-5 and gradients (of a random
projection of the outputs) to 1e-4 of their largest magnitude unless a
test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.fields import flow as jflow
from tensoflow_tpu_torch.convert import params_from_jax
from tensoflow_tpu_torch.fields import flow as pflow

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
FLOW_TYPES = ('pwquad', 'pwlinear', 'realnvp')


def _t(x, grad=False):
    t = torch.tensor(np.asarray(x))
    return t.requires_grad_(True) if grad else t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=RTOL, atol=ATOL, msg=''):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _grad_close(pg, jg, tol=1e-4, msg=''):
    jg = np.asarray(jg)
    scale = float(np.abs(jg).max()) + 1e-12
    np.testing.assert_allclose(pg.numpy() / scale, jg / scale, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# element-wise transforms
# ---------------------------------------------------------------------------

TRANSFORMS = [('pwlinear_flow', 10), ('pwlinear_flow_inv', 10),
              ('affine_flow', 2), ('affine_flow_inv', 2)]


@pytest.mark.parametrize('name,plen', TRANSFORMS)
def test_transform_values_logj_and_grads(name, plen):
    rng = np.random.RandomState(0)
    n = 301
    x = rng.uniform(0.01, 0.99, (n, 1)).astype(np.float32)
    # include bin edges of the uniform-width pwlinear bins
    x[:11, 0] = np.arange(11, dtype=np.float32) / 10
    x = np.clip(x, 1e-6, 1 - 1e-6)
    p = (rng.randn(n, 1, plen) * (1.5 if plen > 2 else 0.5)).astype(
        np.float32)
    py = rng.randn(n, 1).astype(np.float32)
    pl = rng.randn(n, 1).astype(np.float32)
    jf, pf = getattr(jflow, name), getattr(pflow, name)

    def jloss(x_, p_):
        y, lj = jf(x_, p_)
        return jnp.sum(y * py) + jnp.sum(lj * pl)

    jy, jlj = jf(jnp.asarray(x), jnp.asarray(p))
    jgx, jgp = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(p))
    tx, tp = _t(x, True), _t(p, True)
    ty, tlj = pf(tx, tp)
    (torch.sum(ty * _t(py)) + torch.sum(tlj * _t(pl))).backward()
    _close(ty, jy, msg='y')
    _close(tlj, jlj, msg='logj')
    _grad_close(tx.grad, jgx, msg='dx')
    _grad_close(tp.grad, jgp, msg='dparams')


@pytest.mark.parametrize('kind', ['pwlinear', 'affine'])
def test_transform_roundtrip_in_the_port(kind):
    rng = np.random.RandomState(1)
    x = _t(rng.uniform(0.02, 0.98, (64, 1)).astype(np.float32))
    p = _t((rng.randn(64, 1, 10 if kind == 'pwlinear' else 2)
            * 0.5).astype(np.float32))
    fwd = getattr(pflow, kind + '_flow')
    inv = getattr(pflow, kind + '_flow_inv')
    y, lj = inv(x, p)
    x2, lj2 = fwd(y, p)
    # inverse pair: round trip to 1e-5, log-Jacobians cancel to 1e-5
    _close(x2, x.numpy(), rtol=0, atol=1e-5)
    _close(lj + lj2, np.zeros((64, 1), np.float32), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('prior', ['ggx', 'uniform', 'sphere'])
def test_priors_with_jax_draws(prior):
    key = jax.random.PRNGKey(4)
    pn, sn = 7, 33
    if prior == 'ggx':
        jx, jlj = jflow.ggx_prior_sample(key, pn, sn)
        u = np.asarray(jax.random.uniform(key, (pn, sn, 2)))
        x, lj = pflow.ggx_prior_sample(pn, sn, noise=_t(u))
        _close(pflow.ggx_prior_log_prob(x), jflow.ggx_prior_log_prob(jx))
    elif prior == 'uniform':
        jx, jlj = jflow.uniform_prior_sample(key, pn, sn)
        u = np.asarray(jax.random.uniform(key, (pn, sn, 2)))
        x, lj = pflow.uniform_prior_sample(pn, sn, noise=_t(u))
    else:
        jx, jlj = jflow.sphere_prior_sample(key, pn, sn, True)
        u = np.asarray(jax.random.uniform(key, (pn, sn, 1)))
        x, lj = pflow.sphere_prior_sample(pn, sn, _t(u))
    _close(x, jx, msg='x')
    _close(lj, jlj, msg='-log prob')
    # drawn from a generator: reproducible, inside the unit square
    if prior != 'sphere':
        fn = getattr(pflow, prior + '_prior_sample')
        a, _ = fn(pn, sn, gen=torch.Generator().manual_seed(1))
        b, _ = fn(pn, sn, gen=torch.Generator().manual_seed(1))
        assert torch.equal(a, b)
        assert float(a.min()) >= 0 and float(a.max()) <= 1


# ---------------------------------------------------------------------------
# the conditional flow of every type
# ---------------------------------------------------------------------------

def _cfgs(flow_type):
    kw = dict(grid_size=(16, 16, 16), flow_type=flow_type)
    return jflow.FlowConfig(**kw), pflow.FlowConfig(**kw)


@pytest.fixture(scope='module', params=FLOW_TYPES)
def case(request):
    jcfg, pcfg = _cfgs(request.param)
    rng = np.random.RandomState(2)
    jp = jflow.init_tenso_flow(jax.random.PRNGKey(3), jcfg)
    # the field's init is 1e-4 small: scale it up so the tensorial
    # feature matters in the comparison
    jp['field']['planes'] = [p * 3e3 for p in jp['field']['planes']]
    pn, sn = 19, 6
    return dict(
        jcfg=jcfg, pcfg=pcfg, jp=jp, pn=pn, sn=sn,
        pts=rng.uniform(-0.9, 0.9, (pn, 3)).astype(np.float32),
        refl=rng.uniform(0.05, 0.95, (pn, 2)).astype(np.float32),
        rough=rng.uniform(0.1, 0.9, (pn, 1)).astype(np.float32),
        x=rng.uniform(0.05, 0.95, (pn, sn, 2)).astype(np.float32))


def _pparams(jp):
    pp = params_from_jax(_np(jp))
    for t in jax.tree.leaves(pp):
        t.requires_grad_(True)
    return pp


def _conds(c):
    return _t(c['pts']), _t(AABB), _t(c['refl']), _t(c['rough'])


def _jconds(c):
    return (jnp.asarray(c['pts']), jnp.asarray(AABB), jnp.asarray(c['refl']),
            jnp.asarray(c['rough']))


def test_flow_tree_shapes_match_jax(case):
    """init_tenso_flow of each type gives the JAX tree's shapes (realnvp's
    blocks end in 2 parameters, pwlinear's in n_bins)."""
    pinit = pflow.init_tenso_flow(torch.Generator().manual_seed(0),
                                  case['pcfg'])
    jl = jax.tree_util.tree_leaves_with_path(case['jp'])
    pl = jax.tree_util.tree_leaves_with_path(pinit)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == \
        [jax.tree_util.keystr(k) for k, _ in pl]
    assert [v.shape for _, v in jl] == [tuple(v.shape) for _, v in pl]
    assert case['pcfg'].param_len == case['jcfg'].param_len


def test_flow_log_density_and_param_grads(case):
    c = case
    proj = np.random.RandomState(4).randn(c['pn'], c['sn'], 1).astype(
        np.float32)

    def jloss(p):
        z, lq = jflow.flow_log_density(p, c['jcfg'], *_jconds(c),
                                       jnp.asarray(c['x']))
        return jnp.sum(lq * proj), (z, lq)

    (_, (jz, jlq)), jg = jax.value_and_grad(jloss, has_aux=True)(c['jp'])
    pp = _pparams(c['jp'])
    z, lq = pflow.flow_log_density(pp, c['pcfg'], *_conds(c), _t(c['x']))
    torch.sum(lq * _t(proj)).backward()
    _close(z, jz, msg='z')
    _close(lq, jlq, msg='log q')
    for jl, pl in zip(jax.tree.leaves(jg), jax.tree.leaves(pp)):
        _grad_close(pl.grad, jl)


@pytest.mark.parametrize('train', [True, False])
def test_flow_sample_with_handed_in_prior_noise(case, train):
    """The prior's draw (the lattice's azimuth roll, realnvp's normals,
    which it draws also when not training) from the JAX function's key,
    handed to the port as numbers."""
    c = case
    key = jax.random.PRNGKey(11)
    jx, jlj = jflow.flow_sample(c['jp'], c['jcfg'], key, *_jconds(c),
                                c['sn'], train=train)
    if c['pcfg'].flow_type == 'realnvp':
        noise = _t(np.asarray(jax.random.normal(key, (c['pn'], c['sn'], 2))))
    else:
        noise = _t(np.asarray(jax.random.uniform(
            key, (c['pn'], c['sn'], 1)))) if train else None
    x, lj = pflow.flow_sample(params_from_jax(_np(c['jp'])), c['pcfg'], None,
                              *_conds(c), c['sn'], train=train, noise=noise)
    _close(x, jx, msg='x')
    _close(lj, jlj, msg='-log q')


def test_packed_field_route_matches_jax(case):
    """flow_pack + packed= through flow_feature, flow_log_density and
    flow_sample: the packed atlas's level 0, the raw planes' numbers."""
    c = case
    jpk = jflow.flow_pack(c['jp'], c['jcfg'])
    pp = params_from_jax(_np(c['jp']))
    ppk = pflow.flow_pack(pp, c['pcfg'])
    jf = jflow.flow_feature(c['jp'], c['jcfg'], *_jconds(c), packed=jpk)
    f = pflow.flow_feature(pp, c['pcfg'], *_conds(c), packed=ppk)
    _close(f, jf, msg='feature')
    _close(f, pflow.flow_feature(pp, c['pcfg'], *_conds(c)), msg='raw')
    _, jlq = jflow.flow_log_density(c['jp'], c['jcfg'], *_jconds(c),
                                    jnp.asarray(c['x']), packed=jpk)
    _, lq = pflow.flow_log_density(pp, c['pcfg'], *_conds(c), _t(c['x']),
                                   packed=ppk)
    _close(lq, jlq, msg='log q')
    gen = torch.Generator().manual_seed(3)
    a, _ = pflow.flow_sample(pp, c['pcfg'], gen, *_conds(c), c['sn'],
                             packed=ppk)
    gen = torch.Generator().manual_seed(3)
    b, _ = pflow.flow_sample(pp, c['pcfg'], gen, *_conds(c), c['sn'])
    _close(a, b.numpy(), msg='sample')
