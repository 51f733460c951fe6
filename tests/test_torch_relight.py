"""Relighting of the port against the JAX package: the unpacked cubemap
lookups and the latlong <-> cubemap converters (1e-6 abs), relight_direct
on the analytic-sphere packed grid of tests/test_relight.py with JAX's
azimuth roll fed to the port (colours 1e-4 abs, at most one secondary ray
classified differently), the relight_orb view loop (trace_surface +
relight_view) against the same loop written with the JAX functions and
JAX's per-chunk rolls, and the Blender bundle (equal JSON, the Blender
script byte for byte).
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.eval import relight as jrelight
from tensoflow_tpu.fields import mc_shading as jmc
from tensoflow_tpu.models import material_renderer as jmr
from tensoflow_tpu.ops import cubemap as jcm
from tensoflow_tpu.ops import sdf_trace as jst
from tensoflow_tpu.train.trainer import ShapeTrainer as JaxShapeTrainer
from tensoflow_tpu.train.trainer_mat import MaterialTrainer as JaxMatTrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch import relight_orb
from tensoflow_tpu_torch.convert import (geo_checkpoint_from_jax,
                                         packed_sdf_grid_from_jax,
                                         params_from_jax)
from tensoflow_tpu_torch.eval import relight as prelight
from tensoflow_tpu_torch.fields import mc_shading as pmc
from tensoflow_tpu_torch.ops import cubemap as pcm
from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

CUBE_TOL = 1e-6
COLOUR_TOL = 1e-4
VIS_FLIPS = 1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# jitted once for the whole file: eager JAX dispatches every op of the
# sphere trace's loops on its own (~20 s a call)
_jax_relight = jax.jit(jrelight.relight_direct, static_argnums=(1, 3),
                       static_argnames=('n_samples',))


def _dirs(n, seed):
    d = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# cubemap
# ---------------------------------------------------------------------------

def test_sample_cubemap_matches_jax():
    rng = np.random.RandomState(0)
    cube = rng.rand(6, 16, 16, 3).astype(np.float32)
    d = _dirs(2000, 1)
    want = np.asarray(jcm.sample_cubemap(jnp.asarray(cube), jnp.asarray(d)))
    got = pcm.sample_cubemap(torch.tensor(cube), torch.tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CUBE_TOL)


def test_sample_cubemap_mip_matches_jax():
    """Levels below 0 and above the last included (clamped); one level
    takes the plain lookup."""
    rng = np.random.RandomState(2)
    base = rng.rand(6, 32, 32, 3).astype(np.float32)
    pyr = [np.asarray(x) for x in jcm.build_cubemap_pyramid(
        jnp.asarray(base), 4)]
    assert len(pyr) == 4
    d = _dirs(2000, 3)
    lv = rng.uniform(-0.5, 3.5, 2000).astype(np.float32)
    for levels in (pyr, pyr[:1]):
        want = np.asarray(jcm.sample_cubemap_mip(
            [jnp.asarray(x) for x in levels], jnp.asarray(d),
            jnp.asarray(lv)))
        got = pcm.sample_cubemap_mip([torch.tensor(x) for x in levels],
                                     torch.tensor(d), torch.tensor(lv))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CUBE_TOL)


@pytest.mark.parametrize('res', [8, 64])
def test_latlong_to_cubemap_matches_jax(res):
    ll = np.random.RandomState(res).rand(32, 64, 3).astype(np.float32) * 4
    want = np.asarray(jcm.latlong_to_cubemap(jnp.asarray(ll), res))
    got = pcm.latlong_to_cubemap(torch.tensor(ll), res).numpy()
    assert got.shape == (6, res, res, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=CUBE_TOL)


@pytest.mark.parametrize('hw', [(17, 30), (64, 128)])
def test_cubemap_to_latlong_matches_jax(hw):
    cube = np.random.RandomState(5).rand(6, 16, 16, 3).astype(np.float32)
    want = np.asarray(jcm.cubemap_to_latlong(jnp.asarray(cube), hw))
    got = pcm.cubemap_to_latlong(torch.tensor(cube), hw).numpy()
    assert got.shape == hw + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=CUBE_TOL)


# ---------------------------------------------------------------------------
# relight_direct on the analytic sphere
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def sphere():
    cfg = jmc.MCShadingConfig(grid_size=(8, 8, 8), light_reso=8)
    params = jmc.init_mc_shading(jax.random.PRNGKey(0), cfg)
    # the material field starts 1e-4 small: scale it so materials vary
    params['mat_field']['planes'] = [
        x * 3e3 for x in params['mat_field']['planes']]
    xs = np.linspace(-1, 1, 16, dtype=np.float32)
    xx, yy, zz = np.meshgrid(xs, xs, xs, indexing='ij')
    vals = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) - 0.5
    aabb = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    grid = jst.pack_sdf_grid(jst.SDFGrid(values=jnp.asarray(vals),
                                         aabb=jnp.asarray(aabb)))
    pgrid = packed_sdf_grid_from_jax(
        np.asarray(grid.mid_rows), np.asarray(grid.blocks),
        np.asarray(grid.coarse_rows), aabb, grid.reso)
    return dict(cfg=cfg, params=params, grid=grid, aabb=aabb,
                pcfg=pmc.MCShadingConfig(**cfg._asdict()),
                pparams=params_from_jax(_np(params)), pgrid=pgrid)


def _relight_pair(s, n, env, key, n_samples):
    rng = np.random.RandomState(0)
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    view = nrm + 0.5 * rng.randn(n, 3).astype(np.float32)
    verts = nrm * 0.5
    jout = _jax_relight(
        s['params'], s['cfg'], s['grid'], 2.0 / 16, jnp.asarray(s['aabb']),
        verts, nrm, jnp.asarray(env), view, key, n_samples=n_samples)
    roll = np.asarray(jax.random.uniform(key, (n, 1, 1)))
    pout, phit = prelight.relight_direct(
        s['pparams'], s['pcfg'], s['pgrid'], 2.0 / 16,
        torch.tensor(s['aabb']), torch.tensor(verts), torch.tensor(nrm),
        torch.tensor(env), torch.tensor(view), roll=torch.tensor(roll),
        n_samples=n_samples, return_hits=True)
    return np.asarray(jout), pout.numpy(), phit, (verts, nrm, view, roll)


def _jax_secondary_hits(s, verts, nrm, view, key, n_samples):
    """The JAX package's secondary hits for the directions relight_direct
    draws with ``key``."""
    from tensoflow_tpu.ops import samplers as jsam
    table = jnp.asarray(jsam.direction_samples_01(n_samples))
    dirs = jsam.sample_diffuse_directions(table, jnp.asarray(nrm),
                                          jnp.asarray(view), key)[0]
    o = jnp.broadcast_to(jnp.asarray(verts)[:, None], dirs.shape)
    d = dirs.reshape(-1, 3)
    hit = jax.jit(lambda g, oo, dd: jst.sphere_trace(g, oo, dd)[3])(
        s['grid'], o.reshape(-1, 3) + 2 * (2.0 / 16) * d, d)
    return np.asarray(hit).reshape(dirs.shape[:2])


def test_relight_direct_matches_jax(sphere):
    """64 surface points of the sphere, 32 samples each, under a varied
    environment, JAX's roll given to the port."""
    env = np.random.RandomState(1).rand(6, 8, 8, 3).astype(np.float32) * 2
    key = jax.random.PRNGKey(1)
    jc, pc, phit, (verts, nrm, view, _) = _relight_pair(sphere, 64, env,
                                                        key, 32)
    assert pc.shape == (64, 3) and np.isfinite(pc).all()
    assert (pc >= 0).all() and (pc <= 1).all() and pc.std() > 1e-2
    jhit = _jax_secondary_hits(sphere, verts, nrm, view, key, 32)
    assert 0 < jhit.sum() < jhit.size      # the sphere shadows itself
    assert int((jhit != phit.numpy()).sum()) <= VIS_FLIPS
    np.testing.assert_allclose(pc, jc, rtol=0, atol=COLOUR_TOL)


def test_relight_direct_without_roll_is_deterministic(sphere):
    env = np.full((6, 8, 8, 3), 0.5, np.float32)
    n = _dirs(8, 4)
    args = (sphere['pparams'], sphere['pcfg'], sphere['pgrid'], 2.0 / 16,
            torch.tensor(sphere['aabb']), torch.tensor(n * 0.5),
            torch.tensor(n), torch.tensor(env), torch.tensor(-n))
    a = prelight.relight_direct(*args, n_samples=16)
    b = prelight.relight_direct(*args, n_samples=16)
    assert torch.equal(a, b) and a.shape == (8, 3)
    want = _jax_relight(
        sphere['params'], sphere['cfg'], sphere['grid'], 2.0 / 16,
        jnp.asarray(sphere['aabb']), n * 0.5, n, jnp.asarray(env), -n, None,
        n_samples=16)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=0,
                               atol=COLOUR_TOL)


# ---------------------------------------------------------------------------
# the relight_orb view loop: trace_surface + relight_direct over chunks
# ---------------------------------------------------------------------------

GEO = {'name': 'rl_geo', 'database_name': 'toy/sphere_32_4',
       'dataset_dir': 'unused', 'nerfDataType': True, 'train_ray_num': 64,
       'sdf_n_comp': 4, 'sdf_dim': 32, 'app_dim': 16,
       'N_voxel_init': 4096, 'N_voxel_final': 4096,
       'apply_occ_loss': False, 'init_radius': 0.5}
SHADER = {'diffuse_sample_num': 16, 'specular_sample_num': 8,
          'nis_diffuse_sample_num': 4, 'nis_specular_sample_num': 4,
          'grid_size': (16, 16, 16), 'light_reso': 8, 'mat_n_comp': 4,
          'estimator_dtype': 'f32'}
MAT = {'name': 'rl_mat', 'isMaterial': True,
       'database_name': 'toy/sphere_32_4', 'dataset_dir': 'unused',
       'nerfDataType': True, 'train_ray_num': 32, 'bake_resolution': 32,
       'split_manul': False, 'shader_cfg': SHADER}
VIEW = 16          # the 32x32 toy view rendered at 16x16
CHUNK = 128        # 256 rays: two chunks
N_SAMPLES = 16


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp('rl')
    jgeo = JaxShapeTrainer(jconfig.load_config(extra=GEO))
    jgeo.save(str(d / 'model.pkl'))
    with open(d / 'model.pkl', 'rb') as f:
        geo_checkpoint_from_jax(pickle.load(f), str(d / 'model.pt'))
    jmt = JaxMatTrainer(jconfig.load_config(extra=MAT), str(d / 'model.pkl'))
    jmt.params['mat_field']['planes'] = [
        x * 3e3 for x in jmt.params['mat_field']['planes']]
    pmt = MaterialTrainer(pconfig.load_config(extra=MAT),
                          str(d / 'model.pt'), device='cpu')
    jg = jmt.grid
    pmt.grid = packed_sdf_grid_from_jax(
        np.asarray(jg.mid_rows), np.asarray(jg.blocks),
        np.asarray(jg.coarse_rows), np.asarray(jg.aabb), jg.reso,
        None if jg.vis_rows is None else np.asarray(jg.vis_rows), jg.vis_pad)
    pmt.set_params(params_from_jax(_np(jmt.params)))
    from tensoflow_tpu.data import database as jdb
    db = jdb.parse_database_name(MAT['database_name'], 'unused',
                                 isWhiteBG=True)
    vid = db.get_img_ids()[1]
    K = np.diag([VIEW / 32, VIEW / 32, 1.0]).astype(np.float32) @ db.get_K(vid)
    return dict(jmt=jmt, pmt=pmt, pose=db.get_pose(vid), K=K)


def _jax_view(jmt, env, pose, K, keys):
    """relight_orb.py's loop, written with the JAX functions."""
    from tensoflow_tpu.data import rays as jrays
    info = {'imgs': np.zeros((1, VIEW, VIEW, 3), np.float32),
            'Ks': K[None], 'poses': np.asarray(pose, np.float32)[None]}
    batch, rn, _, _ = jrays.construct_ray_batch_nerf(info)
    img = np.ones((rn, 3), np.float32)
    hits, sec = [], []
    aabb = jnp.asarray(jmt.rcfg.aabb)
    us = jmr.unit_size(jmt.rcfg)
    trace = jax.jit(lambda g, grid, o, d: jmr.trace_surface(
        g, jmt.rcfg, grid, o, d))
    for ci, ri in enumerate(range(0, rn, CHUNK)):
        o = jnp.asarray(batch['rays_o'][ri:ri + CHUNK])
        d = jnp.asarray(batch['dirs'][ri:ri + CHUNK])
        inters, normals, _, hit = trace(jmt.geo_params, jmt.grid, o, d)
        colors = _jax_relight(
            jmt.params, jmt.rcfg.shader, jmt.grid, us, aabb, inters,
            normals, env, -d, keys[ci], n_samples=N_SAMPLES)
        sel = np.asarray(hit)
        img[ri:ri + CHUNK][sel] = np.asarray(colors)[sel]
        hits.append(sel)
    return img.reshape(VIEW, VIEW, 3), np.concatenate(hits)


def test_relight_view_matches_the_jax_loop(pair):
    env_ll = np.random.RandomState(6).rand(16, 32, 3).astype(np.float32) * 3
    env = jcm.latlong_to_cubemap(jnp.asarray(env_ll), 8)
    penv = pcm.latlong_to_cubemap(torch.tensor(env_ll), 8)
    np.testing.assert_allclose(penv.numpy(), np.asarray(env), rtol=0,
                               atol=CUBE_TOL)
    n_chunks = -(-VIEW * VIEW // CHUNK)
    keys = jax.random.split(jax.random.PRNGKey(3), n_chunks)
    rolls = [torch.tensor(np.asarray(jax.random.uniform(
        keys[i], (min(CHUNK, VIEW * VIEW - i * CHUNK), 1, 1))))
        for i in range(n_chunks)]
    jimg, jhit = _jax_view(pair['jmt'], env, pair['pose'], pair['K'], keys)
    out = relight_orb.relight_view(pair['pmt'], penv, pair['pose'],
                                   pair['K'], VIEW, VIEW, rolls=rolls,
                                   chunk=CHUNK, n_samples=N_SAMPLES)
    phit = out['hit'].reshape(-1)
    assert 16 <= int(jhit.sum()) <= VIEW * VIEW - 16
    assert int((phit != jhit).sum()) <= VIS_FLIPS
    both = (phit & jhit).reshape(VIEW, VIEW)
    img = out['rgb']
    assert img.shape == (VIEW, VIEW, 3) and np.isfinite(img).all()
    assert np.all(img[~out['hit']] == 1.0)
    np.testing.assert_allclose(img[both], jimg[both], rtol=0,
                               atol=COLOUR_TOL)
    # every secondary ray of the hit pixels: at most one flip against the
    # JAX loop's colours is what the colour tolerance above absorbs
    assert img[both].std() > 1e-3


def test_relight_view_draws_from_the_trainers_generator(pair):
    """Without rolls the view draws each chunk's roll from the trainer's
    generator: the same seed gives the same image, a roll changes it."""
    pmt = pair['pmt']
    penv = torch.full((6, 8, 8, 3), 0.7)
    pmt.gen.manual_seed(11)
    a = relight_orb.relight_view(pmt, penv, pair['pose'], pair['K'], VIEW,
                                 VIEW, chunk=CHUNK, n_samples=N_SAMPLES)
    pmt.gen.manual_seed(11)
    b = relight_orb.relight_view(pmt, penv, pair['pose'], pair['K'], VIEW,
                                 VIEW, chunk=CHUNK, n_samples=N_SAMPLES)
    c = relight_orb.relight_view(pmt, penv, pair['pose'], pair['K'], VIEW,
                                 VIEW, chunk=CHUNK, n_samples=N_SAMPLES)
    np.testing.assert_array_equal(a['rgb'], b['rgb'])
    assert not np.array_equal(a['rgb'], c['rgb'])


def test_relight_view_renders_a_band_of_rows(pair):
    penv = torch.full((6, 8, 8, 3), 0.7)
    rolls = [torch.full((CHUNK, 1, 1), 0.25)] * 2
    band_rolls = [torch.full((6 * VIEW, 1, 1), 0.25)]
    full = relight_orb.relight_view(pair['pmt'], penv, pair['pose'],
                                    pair['K'], VIEW, VIEW, rolls=rolls,
                                    chunk=CHUNK, n_samples=N_SAMPLES)
    band = relight_orb.relight_view(pair['pmt'], penv, pair['pose'],
                                    pair['K'], VIEW, VIEW, rolls=band_rolls,
                                    chunk=CHUNK, n_samples=N_SAMPLES,
                                    rows=(6, 12))
    assert band['rgb'].shape == (6, VIEW, 3)
    np.testing.assert_array_equal(band['hit'], full['hit'][6:12])


# ---------------------------------------------------------------------------
# the Blender bundle
# ---------------------------------------------------------------------------

def _bundle(mod, tmp, cfg, **kw):
    cwd = os.getcwd()
    os.makedirs(tmp, exist_ok=True)
    os.chdir(tmp)
    try:
        out = mod.run_blender_relight(cfg, **kw)
    finally:
        os.chdir(cwd)
    d = os.path.join(tmp, 'data', 'relight', cfg['name'])
    return (out, open(os.path.join(d, 'relight_driver.py'), 'rb').read(),
            json.load(open(os.path.join(d, 'relight_cfg.json'))))


def test_blender_bundle_equals_jax(tmp_path, capsys):
    """No blender on PATH: both write the same script and JSON and return
    None."""
    cfg = {'name': 'scene', 'mesh': 'data/meshes/scene.ply', 'trans': True}
    poses = [np.eye(4, dtype=np.float32) + 0.01 * i for i in range(2)]
    kw = dict(hdr_path='env.hdr', poses=poses, hw=(48, 64))
    jout, jdrv, jcfg = _bundle(jrelight, str(tmp_path / 'j'), cfg, **kw)
    pout, pdrv, pcfg = _bundle(prelight, str(tmp_path / 'p'), cfg, **kw)
    assert jout is None and pout is None
    assert pdrv == jdrv
    assert pcfg == jcfg
    assert 'blender not found; relight bundle written to data/relight/scene' \
        in capsys.readouterr().out
    _, _, p0 = _bundle(prelight, str(tmp_path / 'p0'), {'name': 's',
                                                        'mesh': 'm.ply'})
    _, _, j0 = _bundle(jrelight, str(tmp_path / 'j0'), {'name': 's',
                                                        'mesh': 'm.ply'})
    assert p0 == j0 and p0['poses'] == [] and p0['hdr'] == ''


def test_blender_invoked_when_a_binary_is_on_path(tmp_path, monkeypatch):
    """A fake blender on PATH: the port runs it as the JAX package does
    (tests/test_relight.py), with the bundle's script and JSON."""
    fake = tmp_path / 'bin' / 'blender'
    fake.parent.mkdir()
    log = tmp_path / 'argv.txt'
    fake.write_text(f'#!/bin/sh\necho "$@" > {log}\n')
    fake.chmod(0o755)
    monkeypatch.setenv('PATH', f'{fake.parent}{os.pathsep}'
                       + os.environ.get('PATH', ''))
    monkeypatch.chdir(tmp_path)
    out = prelight.run_blender_relight({'name': 'toy_exec', 'mesh': 'm.ply',
                                        'trans': True})
    assert out == os.path.join('data/relight', 'toy_exec')
    argv = log.read_text().split()
    assert argv[:4] == ['--background', '--python',
                        os.path.join(out, 'relight_driver.py'), '--']
    assert argv[-1] == os.path.join(out, 'relight_cfg.json')
    assert json.load(open(argv[-1]))['trans'] is True
