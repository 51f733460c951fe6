"""The port's TensoSDF field vs the JAX package.

sdf_with_grad_hessian goes, in the port, through the patch atlas and the
stencil head (its plain version on the CPU); it is held to the JAX
package's 'xla' route with the tolerances of the JAX package's own
test_stencil_head_matches_xla: sdf/app 2e-6, FD grad 1e-4, hessian
rtol 1e-3 / atol 5e-3, and parameter gradients (of sdf, app and grad,
not the 1/eps^4-amplified hessian) within 1e-2 of their largest
magnitude.  The single-point evaluations (sdf_only, apply_tenso_sdf) do
the same arithmetic on both sides: rtol 1e-5 / atol 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.fields import tenso_sdf as jsdf
from tensoflow_tpu_torch.convert import params_from_jax
from tensoflow_tpu_torch.fields import tenso_sdf as psdf

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)


def _setup(n_levels, seed=0):
    cfgj = jsdf.SDFConfig(grid_size=(24, 20, 16), n_comp=8, sdf_dim=32,
                          app_dim=16, sdf_multires=3, n_levels=n_levels,
                          stencil_impl='xla')
    cfgp = psdf.SDFConfig(grid_size=(24, 20, 16), n_comp=8, sdf_dim=32,
                          app_dim=16, sdf_multires=3, n_levels=n_levels)
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
    level = (rng.rand(n).astype(np.float32) if n_levels > 1 else None)
    return cfgj, cfgp, params, xyz, level


def _port_params(params):
    p = params_from_jax(jax.tree.map(np.asarray, params))
    for t in jax.tree_util.tree_leaves(
            p, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        t.requires_grad_(True)
    return p


def _port_leaves(p):
    """Leaves in jax.tree_util order (dict keys sorted)."""
    if isinstance(p, dict):
        return [x for k in sorted(p) for x in _port_leaves(p[k])]
    if isinstance(p, list):
        return [x for v in p for x in _port_leaves(v)]
    return [p]


@pytest.mark.parametrize('n_levels', [1, 2])
def test_sdf_with_grad_hessian_matches_jax_xla(n_levels):
    cfgj, cfgp, params, xyz, level = _setup(n_levels)
    lv_j = None if level is None else jnp.asarray(level)

    def run(p):
        return jsdf.sdf_with_grad_hessian(p, cfgj, jnp.asarray(xyz),
                                          jnp.asarray(AABB), level=lv_j)

    def loss(p):
        sdf, app, grad, nh = run(p)
        return (jnp.sum(sdf ** 2) + jnp.sum(app ** 2)
                + jnp.sum(grad ** 2)), (sdf, app, grad, nh)

    (_, jo), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pp = _port_params(params)
    po = psdf.sdf_with_grad_hessian(
        pp, cfgp, torch.tensor(xyz), torch.tensor(AABB),
        level=None if level is None else torch.tensor(level))
    np.testing.assert_allclose(po[0].detach(), jo[0], atol=2e-6)
    np.testing.assert_allclose(po[1].detach(), jo[1], atol=2e-6)
    np.testing.assert_allclose(po[2].detach(), jo[2], atol=1e-4)
    np.testing.assert_allclose(po[3].detach(), jo[3], rtol=1e-3, atol=5e-3)

    (torch.sum(po[0] ** 2) + torch.sum(po[1] ** 2)
     + torch.sum(po[2] ** 2)).backward()
    jl = jax.tree_util.tree_leaves_with_path(jg)
    pl = _port_leaves(pp)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        a = np.asarray(a)
        scale = float(np.abs(a).max()) + 1e-8
        np.testing.assert_allclose(b.grad.numpy() / scale, a / scale,
                                   atol=1e-2,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('n_levels', [1, 2])
def test_single_point_field_matches_jax(n_levels):
    cfgj, cfgp, params, xyz, level = _setup(n_levels, seed=3)
    lv_j = None if level is None else jnp.asarray(level)[:, None]
    lv_p = None if level is None else torch.tensor(level)[:, None]
    pp = _port_params(params)
    a, x = jnp.asarray(AABB), jnp.asarray(xyz)
    jfull = jsdf.apply_tenso_sdf(params, cfgj, x, a, lv_j)
    jonly = jsdf.sdf_only(params, cfgj, x, a, lv_j)
    pfull = psdf.apply_tenso_sdf(pp, cfgp, torch.tensor(xyz),
                                 torch.tensor(AABB), lv_p)
    ponly = psdf.sdf_only(pp, cfgp, torch.tensor(xyz), torch.tensor(AABB),
                          lv_p)
    np.testing.assert_allclose(pfull.detach(), jfull, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(ponly.detach(), jonly, rtol=1e-5, atol=2e-6)


def test_init_and_rot_table_match_jax():
    """Layouts of the initial parameters and the PE rotation table."""
    cfgj, cfgp, _, _, _ = _setup(1)
    jp = jsdf.init_tenso_sdf(jax.random.PRNGKey(0), cfgj)
    pp = psdf.init_tenso_sdf(torch.Generator().manual_seed(0), cfgp)
    jl = jax.tree_util.tree_leaves(jp)
    pl = _port_leaves(pp)
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in pl]
    # deterministic parts of the init are equal; random parts differ
    for k in ('planes', 'lines'):
        for a, b in zip(pp['field'][k], jp['field'][k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pp['mlp'][1]['b'].numpy(),
                                  np.asarray(jp['mlp'][1]['b']))
    np.testing.assert_array_equal(
        pp['mlp'][0]['w'][:3 * cfgp.n_comp].numpy(), 0.0)
    offs = np.zeros((7, 3), np.float32)
    for a_ in range(3):
        offs[1 + 2 * a_, a_] = 1.0 / 24
        offs[2 + 2 * a_, a_] = -1.0 / 24
    np.testing.assert_allclose(
        psdf._pe_rot_table(torch.tensor(offs), 3).numpy(),
        np.asarray(jsdf._pe_rot_table(jnp.asarray(offs), 3)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(psdf.units(cfgp, torch.tensor(AABB)).numpy(),
                               np.asarray(jsdf.units(cfgj, AABB)))
