"""Stage 1 on the hierarchical sampler: the port against the JAX package.

The same numpy inputs (made from a seed) and the same jax.random draws go
through the JAX function and its port:

  * sample_ray_hierarchical with and without the per-ray perturbation,
    with clip_sample_variance on and off: t_starts, t_ends (1e-5) and
    the mask (equal); and against the torch-oracle fixture
    tests/fixtures/ref_shape.npz at the JAX test's own tolerance;
  * render_rays on the dense path (alpha mask, radiance head, live-field
    occ loss): outputs to 1e-4, and the gradients of a loss to every
    parameter, deviation included, to 1e-4 of each leaf's largest
    magnitude, with clip_sample_variance on (the sampler carries
    deviation's gradient) and off;
  * the alpha mask: build_alpha_mask's volume (equal), sample_alpha,
    max_pool_3d_3x3, the checkpoint payload both ways; segment_weights;
  * the live-field _occ_loss;
  * three ShapeTrainer steps across the alpha-mask build (after step 1)
    and an upsample (after step 2) from JAX-exported parameters and the
    same draws: loss trace to 2e-4; then render_image on a 16x16 view to
    1e-4.

The JAX step runs its stencil through the Pallas head in interpret mode,
the algorithm the port's stencil head reproduces; it is jitted, as the
JAX trainer jits it.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.fields import light as jlight
from tensoflow_tpu.models import shape_renderer as jsr
from tensoflow_tpu.ops import composite as jcomp
from tensoflow_tpu.ops import grid as jgrid
from tensoflow_tpu.train import checkpoints as jckpt
from tensoflow_tpu.train import losses as jlosses
from tensoflow_tpu.train import trainer as jtrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.convert import alpha_mask_from_jax, params_from_jax
from tensoflow_tpu_torch.fields import light as plight
from tensoflow_tpu_torch.models import shape_renderer as psr
from tensoflow_tpu_torch.ops import composite as pcomp
from tensoflow_tpu_torch.ops import grid as pgrid
from tensoflow_tpu_torch.train import checkpoints as pckpt
from tensoflow_tpu_torch.train import trainer as ptrainer
from tensoflow_tpu_torch.train.trainer import EVAL_KEYS, named_leaves

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(ROOT, 'configs/shape/syn/compressor.yaml')
SMALL = ['database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
         'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=32768',
         'train_ray_num=48', 'n_samples=16', 'n_importance=16',
         'up_sample_steps=4', 'occ_loss_max_pn=32', 'test_ray_num=96',
         'name=parity_hier']
PALLAS = ['stencil_impl=pallas', 'stencil_tile=64']


def _close(a, b, rtol=1e-5, atol=1e-5, msg=''):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _jax_leaves(tree):
    """{path tuple: numpy leaf}, paths as the port's named_leaves."""
    return {tuple(getattr(e, 'key', getattr(e, 'idx', None)) for e in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _configs(extra=()):
    """(JAX rcfg, port rcfg, JAX params) at the SMALL widths of the
    published non-occ config, with a noised field and W0 so that the
    gradients exercise every path."""
    over = SMALL + list(extra)
    jcfg = jconfig.load_config(CFG_PATH, overrides=over + PALLAS)
    pcfg = pconfig.load_config(CFG_PATH, overrides=over)
    grid = jconfig.n_to_reso(jcfg['N_voxel_init'], jcfg['aabb'])
    jr = jtrainer.build_shape_config(jcfg, grid, jcfg['max_levels'])
    pr = ptrainer.build_shape_config(pcfg, grid, pcfg['max_levels'])
    params = jsr.init_shape_renderer(jax.random.PRNGKey(3), jr)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    params['sdf']['field'] = jax.tree.map(
        lambda x: x + 0.05 * jax.random.normal(k1, x.shape),
        params['sdf']['field'])
    w0 = params['sdf']['mlp'][0]['w']
    params['sdf']['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(k2, w0.shape)
    return jr, pr, params


def _rays(rn, seed):
    """Rays from a sphere of radius ~2.6 towards the origin, with the
    pixel footprint inputs of the toy scenes."""
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


def _near_far(batch):
    o, d = batch['rays_o'], batch['dirs']
    a = np.sum(d * d, -1, keepdims=True)
    mid = 0.5 * -(2.0 * np.sum(o * d, -1, keepdims=True)) / a
    return (np.maximum(mid - 1.0, 1e-3).astype(np.float32),
            (mid + 1.0).astype(np.float32))


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('perturb,clip', [(False, True), (True, True),
                                          (True, False)])
def test_sample_ray_hierarchical_matches_jax(perturb, clip):
    """Samples and mask; and with clip_sample_variance the gradient of a
    projection of the samples to deviation, the path through which
    inv_s = min(inv_s0, 64 * 2^i) moves them.  That gradient is
    ill-conditioned in float32: a sample that inverse-CDF sampling places
    in a bin of almost no mass moves by d(cdf) / (bin mass), so float32
    rounding of the section weights reaches it amplified (the same port
    in float64 differs from both float32 runs by ~3 %; on a field with a
    sharp surface the two float32 runs differ by ~6 %).  On this field
    (the init's small sphere, noised) the two float32 runs agree to
    ~1e-5, which holds the two implementations to the same arithmetic."""
    jr, pr, params = _configs([f'clip_sample_variance={clip}'])
    rn = 40
    batch = _rays(rn, seed=1)
    near, far = _near_far(batch)
    key = jax.random.PRNGKey(5)
    args = [batch[k] for k in ('rays_o', 'dirs')] + [near, far] + [
        batch[k] for k in ('radiis', 'rays_cos')]
    w = np.random.RandomState(2).randn(rn, psr.n_dense_samples(pr)).astype(
        np.float32)

    def jrun(p):
        ts, te, m = jsr.sample_ray_hierarchical(
            p, jr, *[jnp.asarray(a) for a in args], key, perturb)
        return jnp.sum(ts * w), (ts, te, m)
    (_, (js, je, jm)), jg = jax.jit(jax.value_and_grad(jrun, has_aux=True))(
        params)
    jitter = (torch.from_numpy(np.array(jax.random.uniform(key, (rn, 1))))
              if perturb else None)
    pp = params_from_jax(jax.tree.map(np.asarray, params))
    dev = pp['deviation']['variance'].requires_grad_(True)
    ps, pe, pm = psr.sample_ray_hierarchical(
        pp, pr, *[torch.from_numpy(a) for a in args], jitter)
    assert ps.shape == (rn, psr.n_dense_samples(pr)) == js.shape
    assert bool(torch.isfinite(ps).all() and torch.isfinite(pe).all())
    _close(ps, js, rtol=1e-5, atol=1e-5, msg='t_starts')
    _close(pe, je, rtol=1e-5, atol=1e-5, msg='t_ends')
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert 0 < int(pm.sum()) < pm.numel()
    assert bool((ps[:, 1:] >= ps[:, :-1]).all())
    jgd = float(jg['deviation']['variance'])
    if clip:
        (g,) = torch.autograd.grad(torch.sum(ps * torch.from_numpy(w)), dev)
        assert jgd != 0.0
        np.testing.assert_allclose(float(g), jgd, rtol=1e-4)
    else:
        assert jgd == 0.0 and not ps.requires_grad


def test_hierarchical_sampler_matches_reference():
    """The port's sampler against the torch reference's z-value sets, as
    tests/test_ref_shape_parity.py holds the JAX package's to them."""
    from tensoflow_tpu_torch.fields import tenso_sdf as psdf
    fx = dict(np.load(os.path.join(ROOT, 'tests/fixtures/ref_shape.npz')))
    sdf_cfg = psdf.SDFConfig(grid_size=(32, 32, 32), n_comp=8, sdf_dim=64,
                             app_dim=16, n_levels=3, sdf_multires=3)
    rcfg = psr.ShapeRendererConfig(
        sdf=sdf_cfg, aabb=((-1.0,) * 3, (1.0,) * 3), n_samples=24,
        n_importance=16, up_sample_steps=4, perturb=0.0,
        clip_sample_variance=True, use_occ_grid=False, std_act='exp',
        inv_s_init=0.3)
    t = torch.from_numpy
    params = {
        'sdf': {'field': {
            'planes': [t(np.ascontiguousarray(np.transpose(
                fx[f'w_sdf_plane{i}'][0], (2, 1, 0)))) for i in range(3)],
            'lines': [t(np.ascontiguousarray(fx[f'w_sdf_line{i}'][0, :, :, 0]
                                             .T)) for i in range(3)]},
            'mlp': [{'w': t(fx['w_mlp0_w'].T.copy()), 'b': t(fx['w_mlp0_b'])},
                    {'w': t(fx['w_mlp1_w'].T.copy()),
                     'b': t(fx['w_mlp1_b'])}]},
        'deviation': {'variance': t(np.asarray(fx['w_variance']))}}
    ts, _, mask = psr.sample_ray_hierarchical(
        params, rcfg, t(fx['o']), t(fx['d']), t(fx['near']), t(fx['far']),
        t(fx['radiis']), t(fx['rays_cos']), None)
    for r in range(fx['o'].shape[0]):
        ours = np.sort(ts[r][mask[r]].numpy())
        ref = np.sort(fx['t_starts'][fx['ray_indices'] == r])
        assert len(ours) == len(ref), (r, len(ours), len(ref))
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=2e-3,
                                   err_msg=f'ray {r}')


# ---------------------------------------------------------------------------
# render_rays, dense
# ---------------------------------------------------------------------------

def _mask_volume(seed, shape=(12, 10, 8)):
    vol = (np.random.RandomState(seed).rand(*shape) > 0.15).astype(np.float32)
    return np.asarray([[-1.0] * 3, [1.0] * 3], np.float32), vol


OUT_KEYS = ('ray_rgb', 'acc', 'normal', 'radiance', 'roughness_weights',
            'gradient_error', 'loss_sparse', 'loss_hessian', 'loss_tv_sdf',
            'loss_gaussian', 'loss_occ', 'std', 'sample_num', 'sdf_vals')


def _loss(out, w_rgb, w_rad):
    return (jnp if isinstance(out['acc'], jnp.ndarray) else torch).sum(
        out['ray_rgb'] * w_rgb) + (out['radiance'] * w_rad).sum() \
        + out['acc'].sum() * 0.1 + out['gradient_error'] \
        + out['loss_sparse'] + 1e-2 * out['loss_hessian'] \
        + out['loss_tv_sdf'] + out['normal'].sum() * 0.01


@pytest.mark.parametrize('clip', [True, False])
def test_render_rays_dense_matches_jax(clip):
    """render_rays on the dense path with the alpha mask, the radiance
    head and the live-field occ loss: outputs and parameter gradients.
    The gradients of the first case include deviation's path through the
    sampler (clip_sample_variance: inv_s = min(inv_s0, 64 * 2^i))."""
    jr, pr, params = _configs([f'clip_sample_variance={clip}',
                               'gaussianLoss_step=0'])
    rn, step = 32, 30000
    batch = _rays(rn, seed=2)
    aabb, vol = _mask_volume(3)
    jmask = jgrid.AlphaGridMask(aabb=jnp.asarray(aabb),
                                volume=jnp.asarray(vol))
    rng = np.random.RandomState(4)
    w_rgb = rng.randn(rn, 3).astype(np.float32)
    w_rad = rng.randn(rn, 3).astype(np.float32)
    key = jax.random.PRNGKey(6)

    def jrun(p):
        mips = jlight.build_mips(p['shading']['envlight'], jr.shading.env)
        out = jsr.render_rays(p, jr, mips, None, jax.tree.map(
            jnp.asarray, batch), step, 0.6, key, True, radiance_on=True,
            occ_loss_on=True, alpha_mask=jmask)
        return _loss(out, w_rgb, w_rad), {k: out[k] for k in OUT_KEYS}

    (jl, jout), jg = jax.jit(jax.value_and_grad(jrun, has_aux=True))(params)
    pp = params_from_jax(jax.tree.map(np.asarray, params))
    leaves = named_leaves(pp)
    for _, t in leaves:
        t.requires_grad_(True)
    k_sample, k_occ = jax.random.split(key)
    sn = psr.n_dense_samples(pr)
    noise = {'sample_jitter': torch.from_numpy(np.array(
                 jax.random.uniform(k_sample, (rn, 1)))),
             'occ_score': torch.from_numpy(np.array(
                 jax.random.uniform(k_occ, (rn * sn,))))}
    mips = plight.build_mips(pp['shading']['envlight'], pr.shading.env)
    out = psr.render_rays(
        pp, pr, mips, None, {k: torch.from_numpy(v) for k, v in batch.items()},
        step, 0.6, noise, True, radiance_on=True, occ_loss_on=True,
        alpha_mask=alpha_mask_from_jax(jckpt.pack_alpha_mask(jmask)))
    assert 0 < float(out['sample_num']) < sn
    assert all(bool(torch.isfinite(out[k]).all()) for k in OUT_KEYS)
    for k in OUT_KEYS:
        _close(out[k], jout[k], rtol=1e-4, atol=1e-4, msg=k)
    loss = _loss(out, torch.from_numpy(w_rgb), torch.from_numpy(w_rad))
    _close(loss, jl, rtol=1e-5, atol=1e-5, msg='loss')
    loss.backward()
    jleaves = _jax_leaves(jg)
    assert sorted(jleaves) == sorted(p for p, _ in leaves)
    for path, t in leaves:
        jgl = jleaves[path]
        pg = (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()
        scale = float(np.abs(jgl).max()) + 1e-12
        if path == ('sdf', 'mlp', 1, 'b'):
            # the sdf column's bias takes the sum of the centre's and the
            # six offsets' cotangents, in which the FD gradient and
            # hessian terms (~1/eps and 1/eps^2, largest where |grad| is
            # small) cancel exactly in exact arithmetic: what is left is
            # float32 noise of either side, ~1e-3 of the total
            _close(pg[0] / scale, jgl[0] / scale, rtol=0, atol=5e-3,
                   msg='grad b1[0]')
            pg, jgl = pg[1:], jgl[1:]
        _close(pg / scale, jgl / scale, rtol=0, atol=1e-4,
               msg=f'grad {path}')
    dev = float(pp['deviation']['variance'].grad)
    assert dev != 0.0
    if clip:
        # the sampler's share of deviation's gradient is what clip adds:
        # without it the positions would carry none
        assert abs(float(jleaves[('deviation', 'variance')]) - dev) \
            <= 1e-4 * abs(dev)


# ---------------------------------------------------------------------------
# the alpha mask, segment_weights, the live occ loss
# ---------------------------------------------------------------------------

def test_build_alpha_mask_matches_jax():
    jr, pr, params = _configs(['init_radius=0.5'])
    jm = jsr.build_alpha_mask(params, jr, grid_size=32, mul_length=3.0,
                              alpha_thresh=1e-3)
    pm = psr.build_alpha_mask(params_from_jax(jax.tree.map(np.asarray,
                                                           params)),
                              pr, grid_size=32, mul_length=3.0,
                              alpha_thresh=1e-3)
    vol = np.asarray(jm.volume)
    assert 0.05 < vol.mean() < 0.95
    np.testing.assert_array_equal(pm.volume.numpy(), vol)
    np.testing.assert_array_equal(pm.aabb.numpy(), np.asarray(jm.aabb))


def test_sample_alpha_and_max_pool_match_jax():
    rng = np.random.RandomState(7)
    vol = rng.rand(9, 7, 5).astype(np.float32)
    _close(pgrid.max_pool_3d_3x3(torch.from_numpy(vol)),
           jgrid.max_pool_3d_3x3(jnp.asarray(vol)), rtol=0, atol=0)
    aabb = np.asarray([[-1.0, -0.5, -1.0], [1.0, 1.0, 0.5]], np.float32)
    pts = rng.uniform(-1.3, 1.3, (200, 3)).astype(np.float32)
    jm = jgrid.AlphaGridMask(aabb=jnp.asarray(aabb), volume=jnp.asarray(vol))
    pm = pgrid.AlphaGridMask(aabb=torch.from_numpy(aabb),
                             volume=torch.from_numpy(vol))
    _close(pm.sample_alpha(torch.from_numpy(pts)),
           jm.sample_alpha(jnp.asarray(pts)), rtol=1e-6, atol=1e-6)


def test_alpha_mask_checkpoint_roundtrip():
    """The port's payload round trip (the counterpart of the JAX
    package's test), and each side reads the other's payload."""
    rng = np.random.RandomState(0)
    aabb = np.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    vol = (rng.rand(9, 7, 5) > 0.5).astype(np.float32)
    mask = pgrid.AlphaGridMask(aabb=torch.from_numpy(aabb),
                               volume=torch.from_numpy(vol))
    payload = pckpt.pack_alpha_mask(mask)
    assert payload['bits'].nbytes < vol.size        # actually packed
    back = pckpt.unpack_alpha_mask(payload)
    np.testing.assert_array_equal(back.volume.numpy(), vol)
    np.testing.assert_array_equal(back.aabb.numpy(), aabb)
    assert pckpt.pack_alpha_mask(None) is None
    assert pckpt.unpack_alpha_mask(None) is None
    jmask = jckpt.unpack_alpha_mask(payload)
    np.testing.assert_array_equal(np.asarray(jmask.volume), vol)
    jpayload = jckpt.pack_alpha_mask(jmask)
    assert sorted(jpayload) == sorted(payload)
    np.testing.assert_array_equal(alpha_mask_from_jax(jpayload).volume, vol)


def test_segment_weights_matches_jax():
    rng = np.random.RandomState(8)
    args = [rng.randn(6, 11).astype(np.float32) * s for s in (0.1, 1.0)] + [
        rng.uniform(0.01, 0.1, (6, 11)).astype(np.float32),
        np.float32(30.0) * np.ones((6, 11), np.float32)]
    surf = rng.rand(6, 11) > 0.3
    _close(pcomp.segment_weights(*[torch.from_numpy(a) for a in args],
                                 torch.from_numpy(surf)),
           jcomp.segment_weights(*[jnp.asarray(a) for a in args],
                                 jnp.asarray(surf)), rtol=1e-6, atol=1e-7)


def test_occ_loss_live_field_matches_jax():
    """The occ loss off the occupancy grid marches the live field: the
    same qualifying samples (top scores) and the same marched
    occlusion."""
    jr, pr, params = _configs(['init_radius=0.5'])
    rng = np.random.RandomState(9)
    n = 400
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    sdf = (rng.randn(n) * 0.01).astype(np.float32)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    refl = rng.randn(n, 3).astype(np.float32)
    refl /= np.linalg.norm(refl, axis=-1, keepdims=True)
    occ = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    inner = rng.rand(n) > 0.2
    key = jax.random.PRNGKey(10)
    inv_s = np.float32(25.0)
    jl = jax.jit(lambda p: jsr._occ_loss(
        p, jr, jnp.asarray(jr.aabb), jnp.asarray(pts), jnp.asarray(sdf),
        jnp.asarray(normals), jnp.asarray(dirs),
        {'reflective': jnp.asarray(refl), 'occ_prob': jnp.asarray(occ)},
        jnp.asarray(inner), key, jnp.asarray(inv_s),
        packed=None, occ_state=None))(params)
    pp = params_from_jax(jax.tree.map(np.asarray, params))
    aabb = psr.aabb_tensor(pr, 'cpu')
    from tensoflow_tpu_torch.fields import tenso_sdf as psdf

    def sdf_fun(x):
        return psdf.sdf_only(pp['sdf'], pr.sdf, x, aabb)
    t = torch.from_numpy
    pl = psr._occ_loss(
        pr, t(pts), t(sdf), t(normals), t(dirs),
        {'reflective': t(refl), 'occ_prob': t(occ)}, t(inner),
        t(np.array(jax.random.uniform(key, (n,)))), torch.tensor(inv_s),
        sdf_fun)
    assert float(jl) > 0.0
    _close(pl, jl, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer: three steps across the alpha mask and an upsample
# ---------------------------------------------------------------------------

TRAIN = ['update_AlphaMask_lst=[1]', 'upsample_list=[2]', 'occ_loss_step=0',
         'radiance_field_step=-1', 'gaussianLoss_step=0', 'init_radius=0.5',
         'sdf_multires=0', 'split_manul=false']


class JaxDraws(ptrainer.ShapeTrainer):
    """The port's trainer drawing its step noise from a JAX key chain that
    mirrors JaxShapeTrainer.train's splits (no occupancy update off the
    occupancy grid), with the background's fold_in(k, 7) draw."""

    def __init__(self, cfg, key):
        super().__init__(cfg, device='cpu')
        self.key = key

    def step_noise(self, step):
        self.key, k = jax.random.split(self.key)
        k_sample, k_occ = jax.random.split(k)
        rn = self.cfg['train_ray_num']
        m = rn * psr.n_dense_samples(self.rcfg)
        noise = {'sample_jitter': jax.random.uniform(k_sample, (rn, 1)),
                 'occ_score': jax.random.uniform(k_occ, (m,))}
        if self.rcfg.predict_BG:
            noise['bg_jitter'] = jax.random.uniform(
                jax.random.fold_in(k, 7), (rn, self.rcfg.n_bg_samples))
        return {k_: torch.from_numpy(np.asarray(v).copy())
                for k_, v in noise.items()}


def jax_train(jt, n_steps):
    """JaxShapeTrainer.train's loop with its step jitted per phase key (as
    _get_step_fn does); returns the loss terms of each step.  Before the
    first alpha mask the step gets a mask that keeps every sample, which
    computes what no mask computes and shares the later steps' compile."""
    fns, logs = {}, []
    for step in range(n_steps):
        rcfg, tx = jt.rcfg, jt.tx
        radiance_on, occ_on = jt.phase_flags(step)
        mask = jt.alpha_mask or jgrid.AlphaGridMask(
            aabb=jnp.asarray(rcfg.aabb, jnp.float32),
            volume=jnp.ones((128,) * 3, jnp.float32))
        fkey = (rcfg, radiance_on, occ_on)
        if fkey not in fns:
            @jax.jit
            def step_fn(params, opt_state, batch, step, weights, k, mask,
                        rcfg=rcfg, tx=tx, radiance_on=radiance_on,
                        occ_on=occ_on):
                def loss_fn(p):
                    mips = jlight.build_mips(p['shading']['envlight'],
                                             rcfg.shading.env)
                    out = jsr.train_step_outputs(
                        p, rcfg, mips, None, batch, step, k, radiance_on,
                        occ_on, alpha_mask=mask)
                    total, terms = jlosses.total_loss_shape(out, weights)
                    return total, {**terms, 'sample_num': out['sample_num'],
                                   'psnr': out['psnr'], 'std': out['std']}

                (total, terms), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                updates, opt_state = tx.update(grads, opt_state, params)
                return (optax.apply_updates(params, updates), opt_state,
                        {**terms, 'loss': total})
            fns[fkey] = step_fn
        batch = jt.batcher.next_batch()
        weights = jlosses.schedule_weights(jt.cfg, step)
        jt.rng, k = jax.random.split(jt.rng)
        jt.params, jt.opt_state, terms = fns[fkey](
            jt.params, jt.opt_state, batch, step, weights, k, mask)
        logs.append({k_: float(v) for k_, v in terms.items()})
        jt.maybe_update_alpha_mask(step)
        jt.maybe_upsample(step)
    return logs


def trainer_pair(extra=(), path=CFG_PATH):
    """The JAX trainer and the port's (JaxDraws) at the SMALL widths of the
    config at ``path`` with the TRAIN schedule (``extra`` overrides
    both), from the same parameters."""
    over = SMALL + TRAIN + list(extra)
    jt = jtrainer.ShapeTrainer(jconfig.load_config(path,
                                                   overrides=over + PALLAS))
    k = jax.random.PRNGKey(7)
    w0 = jt.params['sdf']['mlp'][0]['w']
    jt.params['sdf']['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(
        k, w0.shape)
    # strongly typed leaves, as after the first update: the step then
    # compiles once and not again at its second call
    jt.params = jax.tree.map(lambda x: jnp.array(x, dtype=x.dtype),
                             jt.params)
    jt.opt_state = jt.tx.init(jt.params)
    jt.init_dataset()
    pt = JaxDraws(pconfig.load_config(path, overrides=over), jt.rng)
    pt.set_params(params_from_jax(jax.tree.map(np.asarray, jt.params)))
    pt.init_dataset()
    return jt, pt


def compare_logs(jlogs, plogs, tol=2e-4):
    assert [l['step'] for l in plogs] == list(range(1, len(jlogs) + 1))
    for step, (jl, pl) in enumerate(zip(jlogs, plogs)):
        for k_, v in jl.items():
            np.testing.assert_allclose(pl[k_], v, rtol=tol, atol=1e-7,
                                       err_msg=f'step {step} {k_}')


@pytest.fixture(scope='module')
def trained():
    """The trainer pair's renders of a 16x16 view from their common
    initial parameters (two mip levels), then three training steps of
    each."""
    jt, pt = trainer_pair(['N_voxel_init=4500', 'max_levels=2'])
    assert pt.rcfg.sdf.n_levels == 2
    db = jt.database
    K = np.diag([0.5, 0.5, 1.0]).astype(np.float32) @ db.get_K(0)
    rng = jt.rng              # render_image splits it once per chunk
    renders = (jt.render_image(db.get_pose(0), K, 16, 16),
               pt.render_image(db.get_pose(0), K, 16, 16))
    jt.rng = rng
    jlogs = jax_train(jt, 3)
    plogs = pt.train(n_steps=3, log_every=1)
    return jt, pt, jlogs, plogs, renders


def test_three_step_trace_matches_jax(trained):
    jt, pt, jlogs, plogs, _ = trained
    jmask = np.asarray(jt.alpha_mask.volume)
    assert not pt.rcfg.use_occ_grid and pt.alpha_mask is not None
    # built from the parameters after one step on each side, which may
    # differ by 2 lr in a texel whose gradient is float32 noise (Adam's
    # first update is sign(g) * lr): voxels near the threshold follow
    pmask = pt.alpha_mask.volume.numpy()
    assert 0.01 < pmask.mean() < 0.99
    assert np.mean(pmask != jmask) < 0.01
    assert pt.rcfg.sdf.grid_size == jt.rcfg.sdf.grid_size
    assert pt.rcfg.sdf.n_levels == jt.rcfg.sdf.n_levels == 3
    assert pt.opt.reset_step == jt.opt_reset_step == 2
    # the mask culls samples at the third step
    assert plogs[2]['sample_num'] < plogs[0]['sample_num']
    compare_logs(jlogs, plogs)


def test_render_image_hierarchical_matches_jax(trained):
    """render_image on the hierarchical sampler, in chunks of 96 rays
    (the last one padded): every one of its 15 images.  (The NeuS
    upsampling is ill-conditioned in float32 where a ray's pdf is thin:
    after a few training steps, sdf values equal to 1e-7 move a sample by
    up to 2e-4 on some rays, on either side alike; the untrained field
    does not.)"""
    jout, pout = trained[4]
    assert sorted(jout) == sorted(pout) == sorted(EVAL_KEYS)
    assert float(np.mean(pout['acc'])) > 0.05
    for key in EVAL_KEYS:
        np.testing.assert_allclose(pout[key], jout[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_checkpoint_carries_the_alpha_mask(trained, tmp_path):
    pt = trained[1]
    path = str(tmp_path / 'model.pkl')
    pt.save(path)
    t2 = ptrainer.ShapeTrainer(pt.cfg, device='cpu')
    assert t2.alpha_mask is None
    t2.load(path)
    np.testing.assert_array_equal(t2.alpha_mask.volume.numpy(),
                                  pt.alpha_mask.volume.numpy())
    assert t2.rcfg == pt.rcfg


SPHERE_CLI = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
              'app_dim=8', 'N_voxel_init=512', 'N_voxel_final=4096',
              'train_ray_num=16', 'n_samples=8', 'n_importance=8',
              'upsample_list=[1]', 'update_AlphaMask_lst=[2]',
              'test_ray_num=64', 'init_radius=0.5', 'sdf_multires=0',
              'split_manul=false', 'save_interval=2', 'val_interval=4',
              'train_log_step=1', 'name=cli_sphere']


def test_cli_on_the_hierarchical_sampler(tmp_path, monkeypatch, capsys):
    """The hermetic flow of configs/shape/toy/sphere.yaml (hierarchical
    sampler, sample-variance clip) through run_training: 4 steps across an
    upsample and the alpha-mask build, a validation, checkpoints that
    carry the mask; then extract_mesh on that non-occ checkpoint."""
    from tensoflow_tpu_torch import extract_mesh, run_training
    from tensoflow_tpu_torch.ops import mesh as pmesh
    cfg_path = os.path.join(ROOT, 'configs/shape/toy/sphere.yaml')
    monkeypatch.chdir(tmp_path)
    run_training.main(['--cfg', cfg_path, '--steps', '4', '--device', 'cpu',
                       *SPHERE_CLI])
    printed = capsys.readouterr().out
    assert 'training done at step 4' in printed
    assert printed.count('[val] step=') == 1, printed
    ckpt = pckpt.load_checkpoint(
        str(tmp_path / 'data' / 'model' / 'cli_sphere' / 'model.pkl'))
    assert ckpt['alpha_mask'] is not None
    assert ckpt['kwargs']['n_levels'] == 2
    out, verts, tris = extract_mesh.main(
        ['--cfg', cfg_path, '--resolution', '24', '--device', 'cpu',
         *SPHERE_CLI])
    assert out.endswith('cli_sphere-4.ply') and len(tris) > 0
    rv, _ = pmesh.read_ply(out)
    np.testing.assert_array_equal(rv, verts)
