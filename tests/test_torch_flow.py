"""The port's conditional flow (fields/flow.py) and the samplers and BRDF
terms it is used with, against the JAX package.

numpy inputs from a seed go through the JAX function and its port.
float32; the two sides do the same arithmetic in the same order, so
values agree to rtol 1e-5 / atol 1e-6 and gradients (of a random
projection of the outputs) to 1e-4 of their largest magnitude unless a
test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.fields import flow as jflow
from tensoflow_tpu.ops import brdf as jbrdf
from tensoflow_tpu.ops import samplers as jsamp
from tensoflow_tpu.ops import tensor_field as jtf
from tensoflow_tpu_torch.convert import params_from_jax
from tensoflow_tpu_torch.fields import flow as pflow
from tensoflow_tpu_torch.ops import brdf as pbrdf
from tensoflow_tpu_torch.ops import samplers as psamp
from tensoflow_tpu_torch.ops import tensor_field as ptf

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
JCFG = jflow.FlowConfig(grid_size=(16, 16, 16))
PCFG = pflow.FlowConfig(grid_size=(16, 16, 16))


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


def _unit(rng, n):
    d = rng.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# the spline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('direction', ['flow', 'flow_inv'])
def test_pwquad_values_logj_and_grads(direction):
    rng = np.random.RandomState(0)
    n, k, b = 257, 1, 10
    x = rng.uniform(0.01, 0.99, (n, k)).astype(np.float32)
    wv = (rng.randn(n, k, 2 * b + 1) * 1.5).astype(np.float32)
    py = rng.randn(n, k).astype(np.float32)
    pl = rng.randn(n, 1).astype(np.float32)
    jf = jflow.pwquad_flow if direction == 'flow' else jflow.pwquad_flow_inv
    pf = pflow.pwquad_flow if direction == 'flow' else pflow.pwquad_flow_inv

    def jloss(x_, wv_):
        y, lj = jf(x_, wv_)
        return jnp.sum(y * py) + jnp.sum(lj * pl)

    jy, jlj = jf(jnp.asarray(x), jnp.asarray(wv))
    jgx, jgw = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(wv))
    tx, tw = _t(x, True), _t(wv, True)
    ty, tlj = pf(tx, tw)
    (torch.sum(ty * _t(py)) + torch.sum(tlj * _t(pl))).backward()
    # the quadratic solve subtracts nearly equal numbers, and the two
    # cumsums add in different orders: 1e-5 absolute
    _close(ty, jy, rtol=1e-5, atol=1e-5, msg='y')
    _close(tlj, jlj, rtol=1e-5, atol=1e-5, msg='logj')
    _grad_close(tx.grad, jgx, msg='dx')
    _grad_close(tw.grad, jgw, msg='dwv')


def test_pwquad_roundtrip_in_the_port():
    rng = np.random.RandomState(1)
    x = _t(rng.uniform(0.02, 0.98, (64, 1)).astype(np.float32))
    wv = _t(rng.randn(64, 1, 21).astype(np.float32))
    y, lj = pflow.pwquad_flow_inv(x, wv)
    x2, lj2 = pflow.pwquad_flow(y, wv)
    # inverse pair: round trip to 1e-4, log-Jacobians cancel to 1e-3
    _close(x2, x.numpy(), rtol=0, atol=1e-4)
    _close(lj + lj2, np.zeros((64, 1), np.float32), rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# the conditional flow
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def flow_case():
    rng = np.random.RandomState(2)
    jp = jflow.init_tenso_flow(jax.random.PRNGKey(3), JCFG)
    # the field's init is 1e-4 small: scale it up so the tensorial
    # feature matters in the comparison
    jp['field']['planes'] = [p * 3e3 for p in jp['field']['planes']]
    pn, sn = 19, 6
    return dict(
        jp=jp, pn=pn, sn=sn,
        pts=rng.uniform(-0.9, 0.9, (pn, 3)).astype(np.float32),
        refl=rng.uniform(0.05, 0.95, (pn, 2)).astype(np.float32),
        rough=rng.uniform(0.1, 0.9, (pn, 1)).astype(np.float32),
        x=rng.uniform(0.05, 0.95, (pn, sn, 2)).astype(np.float32))


def _pparams(jp):
    pp = params_from_jax(_np(jp))
    for t in jax.tree.leaves(pp):
        t.requires_grad_(True)
    return pp


def test_flow_log_density_and_param_grads(flow_case):
    c = flow_case
    proj = np.random.RandomState(4).randn(c['pn'], c['sn'], 1).astype(
        np.float32)

    def jloss(p):
        z, lq = jflow.flow_log_density(
            p, JCFG, jnp.asarray(c['pts']), jnp.asarray(AABB),
            jnp.asarray(c['refl']), jnp.asarray(c['rough']),
            jnp.asarray(c['x']))
        return jnp.sum(lq * proj), (z, lq)

    (_, (jz, jlq)), jg = jax.value_and_grad(jloss, has_aux=True)(c['jp'])
    pp = _pparams(c['jp'])
    z, lq = pflow.flow_log_density(pp, PCFG, _t(c['pts']), _t(AABB),
                                   _t(c['refl']), _t(c['rough']), _t(c['x']))
    torch.sum(lq * _t(proj)).backward()
    _close(z, jz, msg='z')
    _close(lq, jlq, rtol=1e-5, atol=1e-5, msg='log q')
    for jl, pl in zip(jax.tree.leaves(jg), jax.tree.leaves(pp)):
        _grad_close(pl.grad, jl)


def test_flow_log_density_with_rays_id(flow_case):
    c = flow_case
    rid = np.random.RandomState(5).randint(0, c['pn'], (31,)).astype(np.int32)
    x = c['x'].reshape(-1, 2)[:31]
    _, jlq = jflow.flow_log_density(
        c['jp'], JCFG, jnp.asarray(c['pts']), jnp.asarray(AABB),
        jnp.asarray(c['refl']), jnp.asarray(c['rough']), jnp.asarray(x),
        rays_id=jnp.asarray(rid))
    _, lq = pflow.flow_log_density(
        params_from_jax(_np(c['jp'])), PCFG, _t(c['pts']), _t(AABB),
        _t(c['refl']), _t(c['rough']), _t(x), rays_id=_t(rid).long())
    _close(lq, jlq, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('train', [True, False])
def test_flow_sample_with_handed_in_prior_noise(flow_case, train):
    """flow_sample returns -log q; the prior's azimuth roll is evaluated
    with jax.random from the key the JAX function is given and handed to
    the port as numbers."""
    c = flow_case
    key = jax.random.PRNGKey(11)
    jx, jlj = jflow.flow_sample(
        c['jp'], JCFG, key, jnp.asarray(c['pts']), jnp.asarray(AABB),
        jnp.asarray(c['refl']), jnp.asarray(c['rough']), c['sn'], train=train)
    roll = np.asarray(jax.random.uniform(key, (c['pn'], c['sn'], 1)))
    x, lj = pflow.flow_sample(
        params_from_jax(_np(c['jp'])), PCFG, None, _t(c['pts']), _t(AABB),
        _t(c['refl']), _t(c['rough']), c['sn'], train=train,
        noise=_t(roll) if train else None)
    _close(x, jx, rtol=1e-5, atol=2e-6, msg='x')
    _close(lj, jlj, rtol=1e-5, atol=1e-5, msg='-log q')
    # sign convention: the density of the samples is -(-log q)
    _, lq = pflow.flow_log_density(
        params_from_jax(_np(c['jp'])), PCFG, _t(c['pts']), _t(AABB),
        _t(c['refl']), _t(c['rough']), x)
    _close(lq, -np.asarray(jlj), rtol=0, atol=2e-3, msg='log q = -(-log q)')


def test_flow_sample_draws_from_its_generator(flow_case):
    c = flow_case
    pp = params_from_jax(_np(c['jp']))
    args = (_t(c['pts']), _t(AABB), _t(c['refl']), _t(c['rough']), c['sn'])
    a, _ = pflow.flow_sample(pp, PCFG, torch.Generator().manual_seed(1),
                             *args)
    b, _ = pflow.flow_sample(pp, PCFG, torch.Generator().manual_seed(1),
                             *args)
    d, _ = pflow.flow_sample(pp, PCFG, torch.Generator().manual_seed(2),
                             *args)
    assert torch.equal(a, b) and not torch.equal(a, d)
    assert float(a.min()) > 0 and float(a.max()) < 1


def test_unported_flow_types_raise():
    """The flow types that once raised (pwlinear, realnvp) initialise with
    the JAX trees' shapes; an unknown type raises."""
    for flow_type in ('pwlinear', 'realnvp'):
        kw = dict(grid_size=(8, 8, 8), flow_type=flow_type)
        jp = jflow.init_tenso_flow(jax.random.PRNGKey(0),
                                   jflow.FlowConfig(**kw))
        pp = pflow.init_tenso_flow(torch.Generator().manual_seed(0),
                                   pflow.FlowConfig(**kw))
        assert [np.shape(v) for v in jax.tree.leaves(jp)] == \
            [tuple(v.shape) for v in jax.tree.leaves(pp)], flow_type
    with pytest.raises(ValueError, match='flow_type'):
        pflow.FlowConfig(flow_type='spline').param_len


# ---------------------------------------------------------------------------
# raw-plane field sampling, samplers, BRDF
# ---------------------------------------------------------------------------

def test_vm_features_value_and_field_grads():
    rng = np.random.RandomState(6)
    jf = jtf.init_vm_random(jax.random.PRNGKey(0), (12, 10, 14), 5, scale=1.0)
    xyz = rng.uniform(-0.05, 1.05, (53, 3)).astype(np.float32)
    proj = rng.randn(53, 15).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda f: jnp.sum(jtf.vm_features(f, jnp.asarray(xyz), None, 1)
                          * proj))(jf)
    pf = params_from_jax(_np(jf))
    for t in jax.tree.leaves(pf):
        t.requires_grad_(True)
    out = ptf.vm_features(pf, _t(xyz))
    torch.sum(out * _t(proj)).backward()
    _close(out, jtf.vm_features(jf, jnp.asarray(xyz), None, 1))
    for jl, pl in zip(jax.tree.leaves(jg), jax.tree.leaves(pf)):
        _grad_close(pl.grad, jl)
    pinit = ptf.init_vm_random(torch.Generator().manual_seed(0),
                               (12, 10, 14), 5)
    assert [tuple(p.shape) for p in pinit['planes']] == [
        tuple(p.shape) for p in jf['planes']]
    assert float(pinit['planes'][0].abs().max()) <= 1e-4


def test_sampler_tables_are_the_jax_tables():
    for n in (16, 96, 512):
        np.testing.assert_array_equal(psamp.direction_samples_01(n),
                                      jsamp.direction_samples_01(n))
        np.testing.assert_array_equal(psamp.sphere_prior_angles_01(n),
                                      jsamp.sphere_prior_angles_01(n))


@pytest.mark.parametrize('kind', ['diffuse', 'specular'])
def test_direction_samplers_with_handed_in_roll(kind):
    rng = np.random.RandomState(7)
    pn, sn = 23, 16
    normals, view = _unit(rng, pn), _unit(rng, pn)
    view = view + 1.5 * normals
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    rough = rng.uniform(0.05, 0.9, (pn, 1)).astype(np.float32)
    table = jsamp.direction_samples_01(sn)
    key = jax.random.PRNGKey(5)
    roll = np.asarray(jax.random.uniform(key, (pn, 1, 1)))
    if kind == 'diffuse':
        jout = jsamp.sample_diffuse_directions(
            jnp.asarray(table), jnp.asarray(normals), jnp.asarray(view), key)
        pout = psamp.sample_diffuse_directions(
            _t(table), _t(normals), _t(view), _t(roll))
    else:
        jout = jsamp.sample_specular_directions(
            jnp.asarray(table), jnp.asarray(normals), jnp.asarray(view),
            jnp.asarray(rough), key)
        pout = psamp.sample_specular_directions(
            _t(table), _t(normals), _t(view), _t(rough), _t(roll))
    # angles pass through atan2/acos of float32 dot products: 2e-5
    for name, p, j in zip(('dirs', 'angles', 'pdf', 'half'), pout, jout):
        _close(p, j, rtol=2e-5, atol=2e-5, msg=f'{kind} {name}')


def test_half_angles_and_direction_to_angle():
    rng = np.random.RandomState(8)
    pn, sn = 17, 5
    normals, view = _unit(rng, pn), _unit(rng, pn)
    view = view + 1.5 * normals
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    ang = np.stack([rng.uniform(0, 2 * np.pi, (pn, sn)),
                    rng.uniform(0.05, 1.4, (pn, sn))], -1).astype(np.float32)
    jout = jsamp.half_angles_to_directions(
        jnp.asarray(ang), jnp.asarray(normals), jnp.asarray(view))
    pout = psamp.half_angles_to_directions(_t(ang), _t(normals), _t(view))
    for p, j in zip(pout, jout):
        _close(p, j, rtol=2e-5, atol=2e-5)
    _close(psamp.angles_to_directions(_t(ang), _t(normals)),
           jsamp.angles_to_directions(jnp.asarray(ang), jnp.asarray(normals)),
           rtol=2e-5, atol=2e-5)
    dirs = np.asarray(jout[0])
    _close(psamp.direction_to_angle(_t(normals), _t(dirs)),
           jsamp.direction_to_angle(jnp.asarray(normals), jnp.asarray(dirs)),
           rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('gtype', ['schlick', 'ggx_smith'])
def test_brdf_specular_weight(gtype):
    rng = np.random.RandomState(9)
    n = 41
    normals, view, light = _unit(rng, n), _unit(rng, n), _unit(rng, n)
    f0 = rng.uniform(0.02, 0.9, (n, 3)).astype(np.float32)
    alpha = rng.uniform(0.01, 0.9, (n, 1)).astype(np.float32)
    jw, jnol = jbrdf.specular_weight(
        jnp.asarray(normals), jnp.asarray(view), jnp.asarray(light),
        jnp.asarray(f0), jnp.asarray(alpha), gtype)
    pw, pnol = pbrdf.specular_weight(_t(normals), _t(view), _t(light),
                                     _t(f0), _t(alpha), gtype)
    _close(pw, jw, rtol=1e-4, atol=1e-6)
    _close(pnol, jnol)
    for p, j in zip(pbrdf.tangent_frame(_t(normals)),
                    jbrdf.tangent_frame(jnp.asarray(normals))):
        _close(p, j)
