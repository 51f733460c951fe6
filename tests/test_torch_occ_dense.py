"""The occupancy-grid sampler without compaction (compact_samples_per_ray
0): the port's dense route against the JAX package's and against its own
compacted route.

  * render_rays on the dense occupancy-grid route, training mode (the
    sampler's jitter, the radiance head and the occ loss on the baked
    SDF), from JAX-exported parameters, the same occupancy state, rays
    and jax.random draws: ray_rgb to 2e-5 absolute, the other outputs to
    1e-4, and the gradients of the photometric loss to every parameter
    within 2e-4 of each leaf's largest magnitude (2e-3 for the line
    texels and the occlusion predictor's first layer, see the test);
  * the same route against the port's compacted route at full budget
    (compact_samples_per_ray = occ_max_samples: nothing is dropped), as
    tests/test_compaction.py holds the JAX package's two routes;
  * draw_noise's occ-loss scores follow the route, and a ShapeTrainer on
    the dense route trains and renders.

Widths are tests/test_compaction.py's (C=8, H=64, app_dim 32, a 32^3 grid
and occupancy grid, 32 samples a ray).  The JAX side runs its stencil
through the Pallas head in interpret mode, jitted.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.fields import light as jlight
from tensoflow_tpu.models import shape_renderer as jsr
from tensoflow_tpu.ops import grid as jgrid
from tensoflow_tpu.train import trainer as jtrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.convert import occ_state_from_jax, params_from_jax
from tensoflow_tpu_torch.fields import light as plight
from tensoflow_tpu_torch.models import shape_renderer as psr
from tensoflow_tpu_torch.train import trainer as ptrainer
from tensoflow_tpu_torch.train.trainer import ShapeTrainer, named_leaves

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml')
SMALL = ['database_name=toy/sphere_32_4', 'sdf_n_comp=8', 'sdf_dim=64',
         'app_dim=32', 'N_voxel_init=32768', 'N_voxel_final=32768',
         'occ_grid_reso=32', 'occ_max_samples=32', 'occ_loss_max_pn=32',
         'train_ray_num=24', 'upsample_list=null', 'init_radius=0.5',
         'compact_samples_per_ray=0', 'occ_sdf_thresh=0.2',
         'name=occ_dense']
PALLAS = ['stencil_impl=pallas', 'stencil_tile=64']
OUT_KEYS = ('ray_rgb', 'acc', 'normal', 'radiance', 'gradient_error',
            'loss_hessian', 'loss_tv_sdf', 'loss_occ', 'std', 'sample_num',
            'sdf_vals')


def _close(a, b, rtol=1e-5, atol=1e-5, msg=''):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _jax_leaves(tree):
    """{path tuple: numpy leaf}, paths as the port's named_leaves."""
    return {tuple(getattr(e, 'key', getattr(e, 'idx', None)) for e in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _setup():
    """(JAX rcfg, port rcfg, JAX params, JAX occupancy state): the init's
    sphere with a noised field and W0, its occupancy baked at step 0."""
    jcfg = jconfig.load_config(CFG_PATH, overrides=SMALL + PALLAS)
    pcfg = pconfig.load_config(CFG_PATH, overrides=SMALL)
    grid = jconfig.n_to_reso(jcfg['N_voxel_init'], jcfg['aabb'])
    jr = jtrainer.build_shape_config(jcfg, grid, jcfg['max_levels'])
    pr = ptrainer.build_shape_config(pcfg, grid, pcfg['max_levels'])
    assert jr.use_occ_grid and jr.compact_samples_per_ray == 0
    assert pr.use_occ_grid and pr.compact_samples_per_ray == 0
    params = jsr.init_shape_renderer(jax.random.PRNGKey(3), jr)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    params['sdf']['field'] = jax.tree.map(
        lambda x: x + 0.01 * jax.random.normal(k1, x.shape),
        params['sdf']['field'])
    w0 = params['sdf']['mlp'][0]['w']
    params['sdf']['mlp'][0]['w'] = w0 + 0.01 * jax.random.normal(k2, w0.shape)
    occ_cfg = jgrid.OccGridConfig(resolution=jr.occ_grid_reso)
    centers = jgrid.occ_grid_cell_centers(occ_cfg)
    state = jgrid.update_occ_grid(
        jgrid.init_occ_grid(occ_cfg), occ_cfg,
        jsr.compute_occ_alpha(params, jr, centers), 0,
        sdf=jsr.compute_sdf_chunked(params, jr, centers), prune=True)
    return jr, pr, params, state


def _rays(rn, seed):
    """Rays from a sphere of radius ~2.6 towards the origin."""
    rng = np.random.RandomState(seed)
    o = rng.randn(rn, 3)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * rng.uniform(
        2.3, 2.9, (rn, 1))
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.randn(
        rn, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return {'rays_o': o.astype(np.float32), 'dirs': d.astype(np.float32),
            'rays_d': d.astype(np.float32),
            'radiis': rng.uniform(1e-3, 3e-3, (rn, 1)).astype(np.float32),
            'rays_cos': rng.uniform(0.9, 1.0, (rn, 1)).astype(np.float32),
            'rgbs': rng.uniform(0, 1, (rn, 3)).astype(np.float32)}


def _loss(out, w_rgb, w_rad):
    """The photometric part of the step's loss (colour, radiance, acc).
    The eikonal and hessian terms are compared as values (OUT_KEYS): their
    gradients reach the field through the 7-point stencil's 1/eps and
    1/eps^2 differences, which amplify float32 rounding (the sdf column's
    bias takes exactly cancelling contributions, see
    tests/test_torch_hierarchical.py)."""
    return (jnp if isinstance(out['acc'], jnp.ndarray) else torch).sum(
        out['ray_rgb'] * w_rgb) + (out['radiance'] * w_rad).sum() \
        + out['acc'].sum() * 0.1


def _port_render(pp, pr, state, batch, noise, step, occ_loss_on=True):
    mips = plight.build_mips(pp['shading']['envlight'], pr.shading.env)
    return psr.render_rays(
        pp, pr, mips, state, {k: torch.from_numpy(v) for k, v in
                              batch.items()},
        step, 0.6, noise, True, radiance_on=True, occ_loss_on=occ_loss_on)


def _grads(loss, leaves):
    for _, t in leaves:
        t.grad = None
    loss.backward()
    return {path: (t.grad if t.grad is not None
                   else torch.zeros_like(t)).numpy().copy()
            for path, t in leaves}


def test_dense_occ_route_matches_jax():
    jr, pr, params, jstate = _setup()
    rn, step = 24, 30000
    batch = _rays(rn, seed=2)
    rng = np.random.RandomState(4)
    w_rgb = rng.randn(rn, 3).astype(np.float32)
    w_rad = rng.randn(rn, 3).astype(np.float32)
    key = jax.random.PRNGKey(6)

    def jrun(p):
        mips = jlight.build_mips(p['shading']['envlight'], jr.shading.env)
        out = jsr.render_rays(p, jr, mips, jstate, jax.tree.map(
            jnp.asarray, batch), step, 0.6, key, True, radiance_on=True,
            occ_loss_on=True)
        return _loss(out, w_rgb, w_rad), {k: out[k] for k in OUT_KEYS}

    (jl, jout), jg = jax.jit(jax.value_and_grad(jrun, has_aux=True))(params)
    pp = params_from_jax(jax.tree.map(np.asarray, params))
    leaves = named_leaves(pp)
    for _, t in leaves:
        t.requires_grad_(True)
    sn = pr.occ_max_samples
    assert psr.n_route_samples(pr) == sn
    k_sample, k_occ = jax.random.split(key)
    noise = {'sample_jitter': torch.from_numpy(np.array(
                 jax.random.uniform(k_sample, (rn, 1)))),
             'occ_score': torch.from_numpy(np.array(
                 jax.random.uniform(k_occ, (rn * sn,))))}
    pstate = occ_state_from_jax(jax.tree.map(np.asarray, jstate))
    out = _port_render(pp, pr, pstate, batch, noise, step)
    assert 0 < float(out['sample_num']) < sn
    assert float(out['loss_occ'].detach()) > 0.0
    assert all(bool(torch.isfinite(out[k]).all()) for k in OUT_KEYS)
    _close(out['ray_rgb'], jout['ray_rgb'], rtol=0, atol=2e-5,
           msg='ray_rgb')
    for k in OUT_KEYS:
        _close(out[k], jout[k], rtol=1e-4, atol=1e-4, msg=k)
    loss = _loss(out, torch.from_numpy(w_rgb), torch.from_numpy(w_rad))
    _close(loss, jl, rtol=1e-5, atol=1e-5, msg='loss')
    pg = _grads(loss, leaves)
    jleaves = _jax_leaves(jg)
    assert sorted(jleaves) == sorted(pg)
    moved = 0
    for path, jgl in jleaves.items():
        scale = float(np.abs(jgl).max()) + 1e-12
        moved += scale > 1e-12
        # two leaves sum float32 terms that cancel, in another order on
        # each side: a line texel takes thousands of patch cotangents of
        # both signs (the JAX package's own two routes agree to 5e-5 of
        # the largest, this port to ~1e-3, as the split and kernel
        # stencil routes do); the occlusion predictor's first layer reads
        # the reflected direction, made from the stencil's finite-
        # difference normal (1/eps times float32 rounding of the field)
        tol = 2e-3 if (path[:3] == ('sdf', 'field', 'lines') or path[:4] == (
            'shading', 'inner_weight', 'layers', 0)) else 2e-4
        _close(pg[path] / scale, jgl / scale, rtol=0, atol=tol,
               msg=f'grad {path}')
    assert moved >= len(jleaves) // 2


def test_dense_occ_route_matches_compacted_at_full_budget():
    """Nothing is dropped at compact_samples_per_ray = occ_max_samples, so
    both routes evaluate the same samples: colours, acc and the masked
    means agree, and so do the gradients (occ loss off: its scores are
    drawn per slot, whose numbering differs between the routes)."""
    _, pr, params, jstate = _setup()
    pc = pr._replace(compact_samples_per_ray=pr.occ_max_samples)
    rn = 24
    batch = _rays(rn, seed=5)
    rng = np.random.RandomState(6)
    w_rgb = torch.from_numpy(rng.randn(rn, 3).astype(np.float32))
    w_rad = torch.from_numpy(rng.randn(rn, 3).astype(np.float32))
    pstate = occ_state_from_jax(jax.tree.map(np.asarray, jstate))
    pp = params_from_jax(jax.tree.map(np.asarray, params))
    leaves = named_leaves(pp)
    for _, t in leaves:
        t.requires_grad_(True)
    jitter = torch.from_numpy(rng.rand(rn, 1).astype(np.float32))
    outs, grads = {}, {}
    for name, cfg in (('dense', pr), ('compact', pc)):
        noise = psr.draw_noise(torch.Generator().manual_seed(0), cfg, rn,
                               'cpu')
        noise['sample_jitter'] = jitter
        outs[name] = _port_render(pp, cfg, pstate, batch, noise, 30000,
                                  occ_loss_on=False)
        grads[name] = _grads(_loss(outs[name], w_rgb, w_rad), leaves)
    d, c = outs['dense'], outs['compact']
    assert 0 < float(d['sample_num']) < pr.occ_max_samples
    _close(d['ray_rgb'].detach(), c['ray_rgb'].detach(), rtol=0, atol=2e-5, msg='ray_rgb')
    _close(d['acc'].detach(), c['acc'].detach(), rtol=0, atol=2e-5, msg='acc')
    for k in ('gradient_error', 'loss_hessian', 'sample_num'):
        _close(d[k].detach(), c[k].detach(), rtol=2e-4, atol=0, msg=k)
    for path, gd in grads['dense'].items():
        scale = float(np.abs(gd).max()) + 1e-12
        _close(grads['compact'][path] / scale, gd / scale, rtol=0,
               atol=2e-4, msg=f'grad {path}')


@pytest.mark.parametrize('over,sn', [
    ([], 32),                                      # dense occupancy route
    (['occ_max_samples=400'], 108),                # ... all its march steps
    (['compact_samples_per_ray=12'], 12),          # compacted
    (['use_occ_grid=false', 'n_samples=8', 'n_importance=8',
      'up_sample_steps=2'], 16),                   # hierarchical
    (['use_occ_grid=false', 'n_samples=8', 'n_importance=0',
      'predict_BG=true', 'n_bg_samples=5'], 8)])
def test_draw_noise_follows_the_route(over, sn):
    cfg = pconfig.load_config(CFG_PATH, overrides=SMALL + over)
    rcfg = ptrainer.build_shape_config(cfg, (32, 32, 32), 1)
    assert psr.n_route_samples(rcfg) == sn
    noise = psr.draw_noise(torch.Generator().manual_seed(0), rcfg, 10, 'cpu')
    assert noise['sample_jitter'].shape == (10, 1)
    assert noise['occ_score'].shape == (10 * sn,)
    assert ('bg_jitter' in noise) == rcfg.predict_BG
    if rcfg.predict_BG:
        assert noise['bg_jitter'].shape == (10, rcfg.n_bg_samples)


def test_dense_occ_route_trains_and_renders():
    """ShapeTrainer on the dense occupancy-grid route: two steps with the
    occ loss on (one occupancy update first), finite terms, then a render
    of a 16x16 view."""
    cfg = pconfig.load_config(CFG_PATH, overrides=[
        'database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
        'app_dim=8', 'N_voxel_init=4096', 'N_voxel_final=4096',
        'occ_grid_reso=8', 'train_ray_num=16', 'occ_max_samples=16',
        'occ_loss_max_pn=16', 'upsample_list=null', 'init_radius=0.5',
        'compact_samples_per_ray=0', 'test_ray_num=64'])
    trainer = ShapeTrainer(cfg, device='cpu')
    trainer.init_dataset()
    assert trainer.rcfg.compact_samples_per_ray == 0
    logs = trainer.train(n_steps=2, log_every=1)
    assert len(logs) == 2
    for r in logs:
        assert all(np.isfinite(v) for v in r.values()), r
    assert trainer.rcfg.compact_samples_per_ray == 0
    db = trainer.database
    K = np.diag([0.25, 0.25, 1.0]).astype(np.float32) @ db.get_K(0)
    out = trainer.render_image(db.get_pose(0), K, 16, 16)
    assert all(np.isfinite(v).all() for v in out.values())
    assert out['ray_rgb'].shape == (16, 16, 3)
