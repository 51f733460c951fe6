"""The port's field variants against the JAX package: vm_features at mip
levels, vm_features_packed, the deduplicated stencil lookups
(vm_stencil_variants / vm_stencil_features(_split)), shrink_vm, and
sdf_with_grad_hessian on the split ('xla') route, against the JAX
package's 'xla' route and against the port's kernel route (its plain
version here).

Both sides do the same float32 arithmetic on the same numpy inputs:
values agree to rtol 1e-5 / atol 2e-6 and gradients (of a random
projection) to 1e-4 of their largest magnitude unless a test says
otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.fields import tenso_sdf as jsdf
from tensoflow_tpu.ops import tensor_field as jtf
from tensoflow_tpu_torch.convert import params_from_jax
from tensoflow_tpu_torch.fields import tenso_sdf as psdf
from tensoflow_tpu_torch.ops import tensor_field as ptf

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
LEVEL_CASES = [(1, False), (3, False), (3, True)]


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, rtol=1e-5, atol=2e-6, msg=''):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _grad_close(pg, jg, tol=1e-4, msg=''):
    jg = np.asarray(jg)
    scale = float(np.abs(jg).max()) + 1e-12
    np.testing.assert_allclose(pg.numpy() / scale, jg / scale, atol=tol,
                               err_msg=msg)


def _field(seed=0, gs=(16, 8, 12), c=4):
    """A field whose lines vary too (random init keeps them constant,
    which would hide a mip-blend fault)."""
    field = jtf.init_vm_random(jax.random.PRNGKey(seed), list(gs), c,
                               scale=1.0)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), 3)
    field['lines'] = [jax.random.normal(k, l.shape)
                      for k, l in zip(keys, field['lines'])]
    return field


def _port_field(jf):
    pf = params_from_jax(jax.tree.map(np.asarray, jf))
    for t in jax.tree.leaves(pf):
        t.requires_grad_(True)
    return pf


def _level(rng, n, n_levels, with_level):
    return (rng.rand(n).astype(np.float32) * (n_levels - 1)
            if with_level else None)


@pytest.mark.parametrize('n_levels,with_level', LEVEL_CASES)
@pytest.mark.parametrize('route', ['raw', 'packed'])
def test_vm_features_at_levels_and_their_grads(route, n_levels, with_level):
    jf = _field()
    rng = np.random.RandomState(3)
    n = 64
    xyz = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    level = _level(rng, n, n_levels, with_level)
    proj = rng.randn(n, 12).astype(np.float32)
    jlv = None if level is None else jnp.asarray(level)

    def jfeat(f):
        if route == 'raw':
            return jtf.vm_features(f, jnp.asarray(xyz), jlv, n_levels)
        return jtf.vm_features_packed(jtf.pack_vm_field(f, n_levels),
                                      jnp.asarray(xyz), jlv)

    jv, jg = jax.jit(jax.value_and_grad(
        lambda f: jnp.sum(jfeat(f) * proj)))(jf)
    pf = _port_field(jf)
    plv = None if level is None else _t(level)
    if route == 'raw':
        out = ptf.vm_features(pf, _t(xyz), plv, n_levels)
    else:
        out = ptf.vm_features_packed(ptf.pack_vm_field(pf, n_levels),
                                     _t(xyz), plv)
    torch.sum(out * _t(proj)).backward()
    _close(out, jax.jit(jfeat)(jf))
    for jl, pl in zip(jax.tree.leaves(jg), jax.tree.leaves(pf)):
        _grad_close(pl.grad, jl)


@pytest.mark.parametrize('n_levels,with_level', [(1, False), (3, True)])
def test_vm_stencil_features_and_their_grads(n_levels, with_level):
    """vm_stencil_features(_split) and vm_stencil_variants against JAX,
    and the stencil rows against vm_features at the 7 offset points."""
    gs = (16, 8, 12)
    jf = _field(2, gs)
    rng = np.random.RandomState(5)
    n = 48
    xyz = (rng.rand(n, 3) * 0.8 + 0.1).astype(np.float32)
    level = _level(rng, n, n_levels, with_level)
    d01 = [1.0 / (g - 1.0) for g in gs]
    proj = rng.randn(7, n, 12).astype(np.float32)
    jlv = None if level is None else jnp.asarray(level)

    def jstencil(f):
        return jtf.vm_stencil_features(jtf.pack_vm_field(f, n_levels),
                                       jnp.asarray(xyz), d01, jlv)

    jv, jg = jax.jit(jax.value_and_grad(
        lambda f: jnp.sum(jstencil(f) * proj)))(jf)
    pf = _port_field(jf)
    plv = None if level is None else _t(level)
    packed = ptf.pack_vm_field(pf, n_levels)
    out = ptf.vm_stencil_features(packed, _t(xyz), d01, plv)
    torch.sum(out * _t(proj)).backward()
    _close(out, jax.jit(jstencil)(jf))
    for jl, pl in zip(jax.tree.leaves(jg), jax.tree.leaves(pf)):
        _grad_close(pl.grad, jl)
    split = ptf.vm_stencil_features_split(packed, _t(xyz), d01, plv)
    _close(torch.cat(split, -1), out.detach().numpy(), rtol=0, atol=0)
    P, L = ptf.vm_stencil_variants(packed, _t(xyz), d01, plv)
    jP, jL = jtf.vm_stencil_variants(jtf.pack_vm_field(jf, n_levels),
                                     jnp.asarray(xyz), d01, jlv)
    for i in range(3):
        for a, b in zip(P[i] + L[i], jP[i] + jL[i]):
            _close(a, b)
    offs = np.zeros((7, 3), np.float32)
    for a in range(3):
        offs[1 + 2 * a, a] = d01[a]
        offs[2 + 2 * a, a] = -d01[a]
    for k in range(7):
        want = ptf.vm_features(pf, _t(xyz + offs[k]), plv, n_levels)
        _close(out[k], want.detach().numpy(), rtol=1e-5, atol=1e-5,
               msg=f'stencil point {k}')


def test_shrink_vm_matches_jax():
    jf = _field(4, (20, 16, 12))
    aabb = np.array([[-1.0, -1.2, -0.8], [1.0, 1.2, 0.8]])
    new = np.array([[-0.5, -0.3, -0.8], [0.7, 1.0, 0.1]])
    jout, jsize = jtf.shrink_vm(jf, (20, 16, 12), aabb, new)
    pout, psize = ptf.shrink_vm(params_from_jax(jax.tree.map(np.asarray, jf)),
                                (20, 16, 12), aabb, new)
    assert psize == jsize
    for a, b in zip(jax.tree.leaves(pout), jax.tree.leaves(jout)):
        _close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# sdf_with_grad_hessian on the split ('xla') route
# ---------------------------------------------------------------------------

def _sdf_setup(n_levels, seed=0):
    kw = dict(grid_size=(24, 20, 16), n_comp=8, sdf_dim=32, app_dim=16,
              sdf_multires=3, n_levels=n_levels)
    cfgj = jsdf.SDFConfig(stencil_impl='xla', **kw)
    params = jsdf.init_tenso_sdf(jax.random.PRNGKey(seed), cfgj)
    k = jax.random.PRNGKey(seed + 1)
    f = params['field']
    f['planes'] = [p + 0.1 * jax.random.normal(k, p.shape)
                   for p in f['planes']]
    f['lines'] = [l + 0.1 * jax.random.normal(k, l.shape)
                  for l in f['lines']]
    w0 = params['mlp'][0]['w']
    params['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(k, w0.shape)
    rng = np.random.RandomState(seed)
    n = 60
    xyz = ((rng.rand(n, 3) - 0.5) * 2.2).astype(np.float32)
    level = rng.rand(n).astype(np.float32) if n_levels > 1 else None
    return kw, cfgj, params, xyz, level


def _port_sdf(params, kw, impl, xyz, level):
    pp = _port_field(params)
    out = psdf.sdf_with_grad_hessian(
        pp, psdf.SDFConfig(stencil_impl=impl, **kw), _t(xyz), _t(AABB),
        level=None if level is None else _t(level))
    (torch.sum(out[0] ** 2) + torch.sum(out[1] ** 2)
     + torch.sum(out[2] ** 2)).backward()
    return out, pp


def _leaves(p):
    """Leaves in jax.tree_util order (dict keys sorted)."""
    if isinstance(p, dict):
        return [x for k in sorted(p) for x in _leaves(p[k])]
    if isinstance(p, list):
        return [x for v in p for x in _leaves(v)]
    return [p]


@pytest.mark.parametrize('n_levels', [1, 2])
def test_sdf_split_route_matches_jax_xla(n_levels):
    """The port's 'xla' route is the JAX package's 'xla' route: sdf / app /
    grad to 1e-5 relative, the hessian (1/eps^2 amplified) to rtol 1e-4 /
    atol 1e-3, the parameter gradients to 1e-4 of their largest
    magnitude."""
    kw, cfgj, params, xyz, level = _sdf_setup(n_levels)
    lv_j = None if level is None else jnp.asarray(level)

    def loss(p):
        sdf, app, grad, nh = jsdf.sdf_with_grad_hessian(
            p, cfgj, jnp.asarray(xyz), jnp.asarray(AABB), level=lv_j)
        return (jnp.sum(sdf ** 2) + jnp.sum(app ** 2)
                + jnp.sum(grad ** 2)), (sdf, app, grad, nh)

    (_, jo), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    po, pp = _port_sdf(params, kw, 'xla', xyz, level)
    for a, b, name in zip(po[:3], jo[:3], ('sdf', 'app', 'grad')):
        _close(a, b, rtol=1e-5, atol=1e-5, msg=name)
    _close(po[3], jo[3], rtol=1e-4, atol=1e-3, msg='hessian')
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg),
                            _leaves(pp)):
        _grad_close(b.grad, a, msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('n_levels', [1, 2])
def test_sdf_split_route_matches_kernel_route(n_levels):
    """Two algorithms for one function in the port: the split route and
    the stencil head's plain version, at the tolerances that hold the
    kernel route to the JAX 'xla' route (tests/test_torch_tenso_sdf.py)."""
    kw, _, params, xyz, level = _sdf_setup(n_levels, seed=2)
    po, pp = _port_sdf(params, kw, 'xla', xyz, level)
    ko, kp = _port_sdf(params, kw, 'auto', xyz, level)
    _close(po[0], ko[0].detach(), rtol=0, atol=2e-6, msg='sdf')
    _close(po[1], ko[1].detach(), rtol=0, atol=2e-6, msg='app')
    _close(po[2], ko[2].detach(), rtol=0, atol=1e-4, msg='grad')
    _close(po[3], ko[3].detach(), rtol=1e-3, atol=5e-3, msg='hessian')
    for a, b in zip(_leaves(pp), _leaves(kp)):
        _grad_close(a.grad, b.grad.numpy(), tol=1e-2)


def test_stencil_impl_routes():
    """'auto' and 'pallas' take the stencil kernels' route
    (ops/stencil.py), 'xla' and any other value the split route, as the
    JAX package routes every value but 'pallas' to 'xla'."""
    assert psdf.stencil_route(psdf.SDFConfig()) == 'kernel'
    assert psdf.stencil_route(psdf.SDFConfig(stencil_impl='pallas')) == \
        'kernel'
    assert psdf.stencil_route(psdf.SDFConfig(stencil_impl='xla')) == 'split'
    assert psdf.stencil_route(psdf.SDFConfig(stencil_impl='triton')) == \
        'split'
