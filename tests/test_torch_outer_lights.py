"""The port's outer lights against the JAX package: the 'direction' and
'sphere_direction' light MLPs, the photographer ``human_light`` and its
blend in get_lights, env_light_image, the math they stand on
(get_camera_plane_intersection, integrated_positional_encoding), the
init tree of each light setup, and mc_forward outputs and parameter
gradients with each setup on the two-lobe analytic grid.

Same numpy inputs on both sides, JAX params carried over by
convert.params_from_jax, float32 (estimator_dtype='f32').

The integrated directional encoding (IDE) that feeds the direction
lights is float32 noise in its degree-16 columns on both sides: Legendre
coefficients up to ~1e5 cancel to O(1), and the JAX package's own eager
and jitted encodings differ there by ~1e-2 (the same holds for the
inner light, ported earlier).  So:
  * test_ide_noise_is_the_references holds the port's encoding to the
    JAX one: the well-conditioned columns (degree <= 8) to 1e-5, the
    degree-16 columns within twice the JAX eager-vs-jit spread;
  * the light functions are compared with the encoding pinned (the
    port's IDE returns the JAX values, its own gradient kept), light
    values rtol 1e-5 (atol 1e-6, 1e-5 after the exp), and the gradients
    of the outer and human light MLPs within 2e-3 of each leaf's
    largest magnitude; the envlight cubemap (ported earlier) rtol 1e-4,
    as tests/test_torch_mc_shading.py holds it;
  * mc_forward against the jitted JAX one (where nothing can be pinned):
    outputs rtol 2e-4 / atol 2e-5 and gradients within 2e-3 of each
    leaf's largest magnitude, as tests/test_torch_mc_shading.py holds
    the envlight setup, except the leaves of the IDE-fed outer-light
    MLP: 5e-2, because the reference's own eager and jitted gradients of
    these leaves differ by up to 4.2e-2 of their largest magnitude
    (predict_outer_lights('direction') on 2,000 random directions, a
    random projection of the lights).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.data import rays as jrays
from tensoflow_tpu.fields import mc_shading as jmc
from tensoflow_tpu.ops import math as jmath
from tensoflow_tpu.ops import sdf_trace as jst
from tensoflow_tpu_torch.convert import (packed_sdf_grid_from_jax,
                                         params_from_jax)
from tensoflow_tpu_torch.fields import mc_shading as pmc
from tensoflow_tpu_torch.ops import math as pmath

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

SMALL = dict(diffuse_sample_num=16, specular_sample_num=8,
             nis_diffuse_sample_num=4, nis_specular_sample_num=4,
             grid_size=(16, 16, 16), light_reso=8, mat_n_comp=4,
             estimator_dtype='f32')
SETUPS = {
    'envlight': dict(),
    'direction': dict(outer_light_version='direction'),
    'sphere_direction_human': dict(outer_light_version='sphere_direction',
                                   human_lights=True),
}
LOBE_CENTERS = np.asarray([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]], np.float32)
LOBE_RADIUS = 0.45
AABB = np.asarray([[-1.0] * 3, [1.0] * 3], np.float32)
UNIT = 2.0 / 31.0
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.tensor(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol, atol, msg=''):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _jax_ide(xyz, kappa_inv, deg_view=5):
    return np.array(jmath.integrated_dir_encoding(
        jnp.asarray(xyz.detach().numpy()), kappa_inv, deg_view))


@pytest.fixture
def pinned_ide(monkeypatch):
    """The port's IDE with the JAX package's (eager) values."""
    def ide(xyz, kappa_inv, deg_view=5):
        port = pmath.integrated_dir_encoding(xyz, kappa_inv, deg_view)
        ref = torch.from_numpy(_jax_ide(xyz, kappa_inv, deg_view))
        return port + (ref - port).detach()
    monkeypatch.setattr(pmc, 'integrated_dir_encoding', ide)


def _cfgs(name):
    return (jmc.MCShadingConfig(**SMALL, **SETUPS[name]),
            pmc.MCShadingConfig(**SMALL, **SETUPS[name]))


@pytest.fixture(scope='module')
def rays():
    """Points near the object, human poses of four toy cameras (one a
    point) and directions of which about half head for their camera's
    plane close to the camera."""
    rng = np.random.RandomState(0)
    n = 96
    az = 2 * np.pi * np.arange(4) / 4
    eye = 2.2 * np.stack([np.cos(az) * 0.9, np.sin(az) * 0.9,
                          np.full(4, 0.45)], -1)
    poses = []
    for e in eye:              # c2w of a camera looking at the origin
        f = -e / np.linalg.norm(e)
        r = np.cross(f, [0.0, 0.0, 1.0])
        r /= np.linalg.norm(r)
        u = np.cross(r, f)
        poses.append(np.concatenate(
            [np.stack([r, u, -f], 1), e[:, None]], 1))
    human = np.asarray(jrays.get_human_coordinate_poses(
        np.asarray(poses, np.float32)))
    cam = rng.randint(0, 4, n)
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    toward = eye[cam] + rng.randn(n, 3) * 0.8 - pts
    d = np.where(rng.rand(n, 1) < 0.5, toward, rng.randn(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return dict(pts=pts, d=d, human=human[cam].astype(np.float32),
                human_pp=human.astype(np.float32), cam=cam)


@pytest.fixture(scope='module')
def light_params():
    out = {}
    for name in SETUPS:
        jcfg, _ = _cfgs(name)
        jp = jmc.init_mc_shading(jax.random.PRNGKey(3), jcfg)
        if name == 'envlight':      # the cubemap starts constant
            base = jp['outer_light']['base']
            jp['outer_light']['base'] = base + 0.5 * jax.random.normal(
                jax.random.PRNGKey(4), base.shape)
        out[name] = (jp, params_from_jax(_np(jp)))
    return out


def test_camera_plane_intersection_matches_jax(rays):
    ji, jd, jh = jmath.get_camera_plane_intersection(
        jnp.asarray(rays['pts']), jnp.asarray(rays['d']),
        jnp.asarray(rays['human']))
    pi, pd, ph = pmath.get_camera_plane_intersection(
        _t(rays['pts']), _t(rays['d']), _t(rays['human']))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    _close(pi, ji, rtol=1e-5, atol=1e-5)
    _close(pd, jd, rtol=1e-5, atol=1e-5)
    # one pose per point for its S rays: the batched product, no copy
    pts3 = _t(rays['pts']).view(4, 24, 3)
    d3 = _t(rays['d']).view(4, 24, 3)
    hp = _t(rays['human_pp'])
    bi, bd, bh = pmath.get_camera_plane_intersection(pts3, d3, hp)
    ei, ed, eh = pmath.get_camera_plane_intersection(
        pts3, d3, hp[:, None].expand(4, 24, 3, 4))
    assert torch.equal(bh, eh)
    _close(bi, ei, rtol=1e-6, atol=1e-6)
    _close(bd, ed, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('degs', [(0, 6), (2, 5)])
def test_integrated_positional_encoding_matches_jax(degs):
    rng = np.random.RandomState(1)
    mean = rng.randn(50, 2).astype(np.float32)
    var = rng.rand(50, 2).astype(np.float32) * 0.3
    j = jmath.integrated_positional_encoding(jnp.asarray(mean),
                                             jnp.asarray(var), *degs)
    p = pmath.integrated_positional_encoding(_t(mean), _t(var), *degs)
    assert p.shape == j.shape == (50, 2 * 2 * (degs[1] - degs[0]))
    _close(p, j, **TOL)
    _close(pmath.expected_sin(_t(mean), _t(var)),
           jmath.expected_sin(jnp.asarray(mean), jnp.asarray(var)), **TOL)


def test_ide_noise_is_the_references(rays):
    d = np.concatenate([rays['d'], [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]],
                       0).astype(np.float32)
    eager = _jax_ide(_t(d), 0.0)
    jit = np.asarray(jax.jit(lambda x: jmath.integrated_dir_encoding(
        x, 0.0, 5))(jnp.asarray(d)))
    port = pmath.integrated_dir_encoding(_t(d), 0.0, 5).numpy()
    deg16 = np.zeros(port.shape[1], bool)
    deg16[19:36] = deg16[36 + 19:] = True        # (m, l=16), re and im
    for ref in (eager, jit):
        np.testing.assert_allclose(port[:, ~deg16], ref[:, ~deg16],
                                   rtol=1e-5, atol=1e-5)
    spread = float(np.abs(eager - jit)[:, deg16].max())
    for ref in (eager, jit):
        assert float(np.abs(port - ref)[:, deg16].max()) <= 2 * spread


@pytest.mark.parametrize('name', sorted(SETUPS))
def test_init_tree_matches_jax(name):
    jcfg, pcfg = _cfgs(name)
    jp = jmc.init_mc_shading(jax.random.PRNGKey(0), jcfg)
    pp = pmc.init_mc_shading(torch.Generator().manual_seed(0), pcfg)
    jshapes = {jax.tree_util.keystr(p): v.shape for p, v in
               jax.tree_util.tree_leaves_with_path(jp)}
    pshapes = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_leaves_with_path(pp)}
    assert pshapes == jshapes
    if name != 'envlight':
        np.testing.assert_allclose(
            pp['outer_light']['layers'][-1]['b'].numpy(), np.log(0.5),
            rtol=1e-6)
    if 'human' in name:
        np.testing.assert_allclose(
            pp['human_light']['layers'][-1]['b'].numpy(), np.log(0.02),
            rtol=1e-6)


@pytest.mark.parametrize('name', sorted(SETUPS))
def test_predict_outer_lights_matches_jax(rays, light_params, name,
                                          pinned_ide):
    jcfg, pcfg = _cfgs(name)
    jp, pp = light_params[name]
    # points outside the unit sphere too: sphere_direction pulls them in
    pts = rays['pts'] * 2.5
    j = jmc.predict_outer_lights(jp, jcfg, jnp.asarray(pts),
                                 jnp.asarray(rays['d']))
    p = pmc.predict_outer_lights(pp, pcfg, _t(pts), _t(rays['d']))
    assert float(np.std(np.asarray(j))) > 1e-4
    _close(p, j, **(dict(rtol=1e-4, atol=1e-6) if name == 'envlight'
                    else TOL))


def test_get_human_light_matches_jax(rays, light_params):
    jp, pp = light_params['sphere_direction_human']
    jl, jw = jmc.get_human_light(jp, jnp.asarray(rays['pts']),
                                 jnp.asarray(rays['d']),
                                 jnp.asarray(rays['human']))
    pl, pw = pmc.get_human_light(pp, _t(rays['pts']), _t(rays['d']),
                                 _t(rays['human']))
    lit = np.asarray(jw)[:, 0] > 0
    assert 0.2 < lit.mean() < 0.9
    _close(pl, jl, **TOL)
    _close(pw, jw, **TOL)


def _sphere_tracer(xp):
    """ray / lobe-0 sphere intersection, written once for jnp and torch"""
    def trace(o, dd):
        oc = o - LOBE_CENTERS[0]
        b = xp.sum(oc * dd, -1)
        c = xp.sum(oc * oc, -1) - LOBE_RADIUS ** 2
        disc = b * b - c
        t = -b - xp.sqrt(xp.clip(disc, 0.0, None))
        hit = (disc > 0) & (t > 1e-3)
        inters = o + dd * t[:, None]
        nrm = (inters - LOBE_CENTERS[0]) / LOBE_RADIUS
        return inters, nrm, xp.where(hit, t, 10.0)[:, None], hit
    return trace


class _TorchNP:
    sum = staticmethod(lambda a, dim: torch.sum(a, dim))
    sqrt = staticmethod(torch.sqrt)
    clip = staticmethod(lambda a, lo, hi: torch.clamp(a, min=lo, max=hi))
    where = staticmethod(lambda c, a, b: torch.where(
        c, a, torch.full_like(a, b)))


def test_get_lights_human_blend_matches_jax(rays, light_params,
                                            pinned_ide):
    """get_lights with human poses [pn, 3, 4] for [pn, sn] rays: lights
    and the gradients of a projection of them w.r.t. the outer and human
    light MLPs (2e-3 of each leaf's largest magnitude)."""
    jcfg, pcfg = _cfgs('sphere_direction_human')
    jp, _ = light_params['sphere_direction_human']
    pn, sn = 4, 24
    pts = (rays['pts'].reshape(pn, sn, 3) * 0.3
           + np.asarray([0.0, 0.0, 0.6], np.float32))
    d = rays['d'].reshape(pn, sn, 3)
    hp = rays['human_pp']
    proj = np.random.RandomState(2).randn(pn, sn, 3).astype(np.float32)

    def jloss(p):
        lights, hit = jmc.get_lights(p, jcfg, _sphere_tracer(jnp), UNIT,
                                     jnp.asarray(pts), jnp.asarray(d),
                                     jnp.asarray(hp))
        return jnp.sum(lights * proj), (lights, hit)

    (_, (jl, jh)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    pp = params_from_jax(_np(jp))
    for t in jax.tree.leaves(pp):
        t.requires_grad_(True)
    pl, ph = pmc.get_lights(pp, pcfg, _sphere_tracer(_TorchNP), UNIT,
                            _t(pts), _t(d), _t(hp))
    torch.sum(pl * _t(proj)).backward()
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert 0.05 < np.asarray(jh).mean() < 0.95
    _close(pl, jl, rtol=1e-5, atol=1e-5, msg='lights')
    # the blend moved the lights of the rays that reach a camera plane
    plain = jmc.get_lights(jp, jcfg, _sphere_tracer(jnp), UNIT,
                           jnp.asarray(pts), jnp.asarray(d))[0]
    assert float(np.abs(np.asarray(plain) - np.asarray(jl)).max()) > 1e-3
    for name in ('outer_light', 'human_light'):
        for jleaf, pleaf in zip(jax.tree.leaves(jg[name]),
                                jax.tree.leaves(pp[name])):
            jleaf = np.asarray(jleaf)
            scale = float(np.abs(jleaf).max()) + 1e-12
            np.testing.assert_allclose(pleaf.grad.numpy() / scale,
                                       jleaf / scale, atol=2e-3,
                                       err_msg=f'grad {name}')


@pytest.mark.parametrize('name', sorted(SETUPS))
def test_env_light_image_matches_jax(light_params, name, pinned_ide):
    jcfg, pcfg = _cfgs(name)
    jp, pp = light_params[name]
    for gamma in (True, False):
        j = jmc.env_light_image(jp, jcfg, 8, 16, gamma)
        p = pmc.env_light_image(pp, pcfg, 8, 16, gamma)
        assert p.shape == (8, 16, 3)
        _close(p, j, rtol=1e-5, atol=1e-5, msg=f'gamma={gamma}')


# ---------------------------------------------------------------------------
# mc_forward on the two-lobe packed grid, NIS loss phase, with each setup
# ---------------------------------------------------------------------------

def two_lobe_sdf(pts):
    d = np.linalg.norm(pts[..., None, :] - LOBE_CENTERS, axis=-1)
    return (d - LOBE_RADIUS).min(-1)


@pytest.fixture(scope='module')
def lobes(rays):
    xs = np.linspace(-1, 1, 32, dtype=np.float32)
    vals = two_lobe_sdf(np.stack(np.meshgrid(xs, xs, xs, indexing='ij'),
                                 -1)).astype(np.float32)
    jpg = jst.bake_vis_cache(jst.pack_sdf_grid(jst.SDFGrid(
        values=jnp.asarray(vals), aabb=jnp.asarray(AABB))),
        apex_pad=2.0 * UNIT)
    ppg = packed_sdf_grid_from_jax(
        np.asarray(jpg.mid_rows), np.asarray(jpg.blocks),
        np.asarray(jpg.coarse_rows), np.asarray(jpg.aabb), jpg.reso,
        np.asarray(jpg.vis_rows), jpg.vis_pad)
    rng = np.random.RandomState(4)
    pn = 24
    which = rng.randint(0, 2, 4 * pn)
    n = rng.randn(4 * pn, 3).astype(np.float32)
    n[:, 0] += 1.5 * (1 - 2 * which)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pts = LOBE_CENTERS[which] + n * LOBE_RADIUS
    keep = np.where(two_lobe_sdf(pts) > -1e-3)[0][:pn]
    pts, n = pts[keep].astype(np.float32), n[keep]
    v = rng.randn(pn, 3).astype(np.float32)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True) + 1.2 * n
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    return dict(jpg=jpg, ppg=ppg, pts=pts, n=n, v=v, pn=pn,
                human=rays['human_pp'][rng.randint(0, 4, pn)])


@pytest.mark.parametrize('name', ['direction', 'sphere_direction_human'])
def test_mc_forward_with_outer_lights_matches_jax(lobes, name):
    jcfg, pcfg = _cfgs(name)
    jp = jmc.init_mc_shading(jax.random.PRNGKey(5), jcfg)
    jp['mat_field']['planes'] = [x * 3e3 for x in jp['mat_field']['planes']]
    phase = dict(nis_loss_diffuse=True, nis_loss_specular=True)
    key = jax.random.PRNGKey(21)
    proj = np.random.RandomState(8).randn(lobes['pn'], 3).astype(np.float32)
    hp = lobes['human'] if jcfg.human_lights else None

    def jloss(p):
        out = jmc.mc_forward(
            p, jcfg, lobes['jpg'], UNIT, jnp.asarray(AABB),
            jnp.asarray(lobes['pts']), jnp.asarray(lobes['v']),
            jnp.asarray(lobes['n']), jmc.ShadePhase(**phase), key, True,
            human_poses=None if hp is None else jnp.asarray(hp))
        return (jnp.sum(out['rgb_pr'] * proj) + 10.0 * out['loss_nis']
                + jnp.sum(out['diffuse_light'])), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    k_d, k_s, k_da, k_sa = jax.random.split(key, 4)
    noise = {'az_diffuse': _t(jax.random.uniform(k_da, (lobes['pn'], 1, 1))),
             'az_specular': _t(jax.random.uniform(k_sa, (lobes['pn'], 1, 1)))}
    pp = params_from_jax(_np(jp))
    for t in jax.tree.leaves(pp):
        t.requires_grad_(True)
    pout = pmc.mc_forward(
        pp, pcfg, lobes['ppg'], UNIT, _t(AABB), _t(lobes['pts']),
        _t(lobes['v']), _t(lobes['n']), pmc.ShadePhase(**phase), noise, True,
        human_poses=None if hp is None else _t(hp))
    (torch.sum(pout['rgb_pr'] * _t(proj)) + 10.0 * pout['loss_nis']
     + torch.sum(pout['diffuse_light'])).backward()
    assert sorted(pout) == sorted(jout)
    n_rays = lobes['pn'] * (jcfg.diffuse_sample_num
                            + jcfg.specular_sample_num)
    for k, v in jout.items():
        if k.startswith('secondary_'):
            # a ray at a certification threshold may go either way
            assert abs(float(pout[k]) - float(v)) <= 2.5 / n_rays, k
        else:
            _close(pout[k], v, rtol=2e-4, atol=2e-5, msg=f'{name} {k}')
    for (path, jleaf), pleaf in zip(jax.tree_util.tree_leaves_with_path(jg),
                                    jax.tree.leaves(pp)):
        jleaf = np.asarray(jleaf)
        scale = float(np.abs(jleaf).max())
        got = np.zeros_like(jleaf) if pleaf.grad is None \
            else pleaf.grad.numpy()
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            got / (scale + 1e-9), jleaf / (scale + 1e-9),
            atol=5e-2 if key.startswith("['outer_light']") else 2e-3,
            err_msg=f'{name} grad {key}')
    for light in ('outer_light',) + (('human_light',) if hp is not None
                                     else ()):
        assert any(float(np.abs(np.asarray(g)).max()) > 0
                   for g in jax.tree.leaves(jg[light])), light


# ---------------------------------------------------------------------------
# the trainer: human poses reach the step only where the shader uses them
# ---------------------------------------------------------------------------

def test_step_batch_takes_human_poses_only_for_human_lights(tmp_path):
    """A sphere_direction + human-light MaterialTrainer takes the hits'
    human poses [n, 3, 4] to the device with its batch and trains; an
    envlight shader's step is the same with or without them."""
    import os
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.models import material_renderer as pmr
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    geo = str(tmp_path / 'geo.pt')
    ShapeTrainer(pconfig.load_config(
        os.path.join(root, 'configs/shape/toy/sphere.yaml'),
        overrides=['database_name=toy/sphere_16_2', 'sdf_n_comp=2',
                   'sdf_dim=16', 'app_dim=8', 'N_voxel_init=512',
                   'N_voxel_final=512', 'upsample_list=null',
                   'init_radius=0.5', 'sdf_multires=0']),
        device='cpu').save(geo)
    base = {'isMaterial': True, 'database_name': 'toy/sphere_16_2',
            'nerfDataType': True, 'train_ray_num': 16, 'bake_resolution': 16,
            'shader_cfg': {**SMALL, 'nis_start_iter': 2, 'nis_loss_iter': 1}}
    human = MaterialTrainer(pconfig.load_config(extra={
        **base, 'shader_cfg': {**base['shader_cfg'],
                               **SETUPS['sphere_direction_human']}}),
        geo, device='cpu')
    human.init_dataset()
    assert human.step_keys()[-1] == 'human_poses'
    assert human.batcher.batch['human_poses'].shape[1:] == (3, 4)
    logs = human.train(n_steps=3, log_every=1)
    assert all(np.isfinite(r['loss']) for r in logs)

    env = MaterialTrainer(pconfig.load_config(extra=base), geo, device='cpu')
    env.init_dataset()
    assert 'human_poses' not in env.step_keys()
    hb = {k: torch.as_tensor(v[:16]) for k, v in env.batcher.batch.items()}
    phase = env.phase(0)
    noise = env.step_noise(0, phase)
    with torch.no_grad():
        a = pmr.train_step_outputs(env.params, env.rcfg, env.grid, hb, phase,
                                   noise, 0)
        b = pmr.train_step_outputs(
            env.params, env.rcfg, env.grid,
            {k: v for k, v in hb.items() if k != 'human_poses'}, phase,
            noise, 0)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
