"""Stage-2 evaluation of the port against the JAX package: eval_outputs,
MaterialTrainer.render_image and validate (the analytic and the '_nis'
variant), predict_vertex_materials, and the run_training / eval_mat CLIs
on the CPU.

A JAX stage-1 trainer writes its checkpoint; both MaterialTrainers start
from the same parameters (the JAX ones, converted), the same baked trace
grid and the same frozen flow copies.  Evaluation draws nothing on either
side (is_train=False: no azimuth roll, no flow-prior roll), so no noise is
injected; test_jax_render_draws_nothing holds the JAX render to that.

float32 with estimator_dtype='f32'.  Tolerances:
  * eval_outputs on the same traced hits: rtol 2e-4 / atol 2e-5, as
    mc_forward is held (tests/test_torch_mc_shading.py); the bf16
    estimator at the tolerance of test_mc_forward_bf16_estimator_is_close
    _to_jax (8e-2 absolute, 2e-2 on average);
  * render_image: the primary trace may classify a ray differently on the
    two sides (a depth at a threshold of the sphere trace): at most 2 of
    the 64 pixels may differ in their hit mask; on the pixels both sides
    hit, every image within 2e-3 absolute (the neural refinement puts the
    hits 2e-4 apart, test_torch_train_material.py, and the shade carries
    that into its colours), and exactly 0 / 1 where neither hits;
  * validate: PSNR within 0.05 dB;
  * predict_vertex_materials: rtol 1e-5 / atol 1e-6.
"""
import json
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.data import database as jdb
from tensoflow_tpu.models import material_renderer as jmr
from tensoflow_tpu.train.trainer import ShapeTrainer as JaxShapeTrainer
from tensoflow_tpu.train.trainer_mat import MaterialTrainer as JaxMatTrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch import eval_mat, run_training
from tensoflow_tpu_torch.convert import (geo_checkpoint_from_jax,
                                         packed_sdf_grid_from_jax,
                                         params_from_jax)
from tensoflow_tpu_torch.data import database as pdb
from tensoflow_tpu_torch.models import material_renderer as pmr
from tensoflow_tpu_torch.ops import mesh as pmesh
from tensoflow_tpu_torch.ops.math import linear_to_srgb
from tensoflow_tpu_torch.train import checkpoints as pckpt
from tensoflow_tpu_torch.train.trainer import ShapeTrainer
from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEO = {'name': 'val_geo', 'database_name': 'toy/sphere_32_4',
       'dataset_dir': 'unused', 'nerfDataType': True, 'train_ray_num': 64,
       'sdf_n_comp': 4, 'sdf_dim': 32, 'app_dim': 16,
       'N_voxel_init': 4096, 'N_voxel_final': 4096,
       'apply_occ_loss': False, 'init_radius': 0.5}
SHADER = {'diffuse_sample_num': 16, 'specular_sample_num': 8,
          'nis_diffuse_sample_num': 4, 'nis_specular_sample_num': 4,
          'nis_start_iter': 3, 'nis_loss_iter': 1, 'nis_update_interval': 5,
          'grid_size': (16, 16, 16), 'light_reso': 8, 'mat_n_comp': 4,
          'estimator_dtype': 'f32'}
MAT = {'name': 'val_mat', 'isMaterial': True,
       'database_name': 'toy/sphere_32_4', 'dataset_dir': 'unused',
       'nerfDataType': True, 'train_ray_num': 32, 'bake_resolution': 32,
       'split_manul': False, 'shader_cfg': SHADER}
DOWN = 0.25                  # the 32x32 toy view rendered at 8x8
HIT_ALLOWANCE = 2


def _t(x):
    return torch.tensor(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """(JAX trainer, port trainer) with the same geometry, parameters,
    grid and frozen flow copies, and the held-out view."""
    d = tmp_path_factory.mktemp('geo')
    jgeo = JaxShapeTrainer(jconfig.load_config(extra=GEO))
    w0 = jgeo.params['sdf']['mlp'][0]['w']
    jgeo.params['sdf']['mlp'][0]['w'] = w0 + 0.005 * jax.random.normal(
        jax.random.PRNGKey(7), w0.shape)
    jgeo.save(str(d / 'model.pkl'))
    with open(d / 'model.pkl', 'rb') as f:
        geo_checkpoint_from_jax(pickle.load(f), str(d / 'model.pt'))

    jmt = JaxMatTrainer(jconfig.load_config(extra=MAT), str(d / 'model.pkl'))
    # the fields start 1e-4 small: scale them so materials vary by point
    for name in ('mat_field', 'flow_diffuse', 'flow_specular'):
        f = jmt.params[name]['field'] if name.startswith('flow') \
            else jmt.params[name]
        f['planes'] = [x * 3e3 for x in f['planes']]
    jmt.update_flow_copies(2)              # step 3 = nis_start_iter
    assert set(jmt.flow_copies) == {'diffuse', 'specular'}
    jmt.database = jdb.parse_database_name(MAT['database_name'], 'unused',
                                           isWhiteBG=True)
    jmt.test_ids = list(jdb.get_database_split(jmt.database,
                                               split_manul=False)[1])

    pmt = MaterialTrainer(pconfig.load_config(extra=MAT),
                          str(d / 'model.pt'), device='cpu')
    jg = jmt.grid
    pmt.grid = packed_sdf_grid_from_jax(
        np.asarray(jg.mid_rows), np.asarray(jg.blocks),
        np.asarray(jg.coarse_rows), np.asarray(jg.aabb), jg.reso,
        np.asarray(jg.vis_rows), jg.vis_pad)
    pmt.set_params(params_from_jax(_np(jmt.params)))
    pmt.flow_copies = params_from_jax(_np(jmt.flow_copies))
    pmt.database = pdb.parse_database_name(MAT['database_name'], 'unused',
                                           isWhiteBG=True)
    pmt.test_ids = list(pdb.get_database_split(pmt.database,
                                               split_manul=False)[1])
    assert pmt.test_ids == jmt.test_ids
    vid = jmt.test_ids[0]
    K = (np.diag([DOWN, DOWN, 1.0]).astype(np.float32)
         @ jmt.database.get_K(vid))
    return dict(jmt=jmt, pmt=pmt, pose=jmt.database.get_pose(vid), K=K,
                geo=str(d / 'model.pt'))


@pytest.fixture(scope='module')
def renders(pair):
    jmt, pmt = pair['jmt'], pair['pmt']
    jimg = jmt.render_image(pair['pose'], pair['K'], 8, 8)
    pimg = pmt.render_image(pair['pose'], pair['K'], 8, 8)
    return jimg, pimg


def test_render_image_matches_jax(renders):
    """Both variants, every image: zero where nothing is hit, the white
    background on rgb_pr only."""
    jimg, pimg = renders
    assert sorted(pimg) == sorted(jimg)
    assert 'rgb_pr_nis' in pimg
    jh, ph = jimg['hit_mask'][..., 0] > 0.5, pimg['hit_mask'][..., 0] > 0.5
    assert int((jh != ph).sum()) <= HIT_ALLOWANCE
    both, neither = jh & ph, ~jh & ~ph
    assert 8 <= both.sum() <= 56
    for k, v in jimg.items():
        if k == 'hit_mask':
            continue
        p = pimg[k]
        assert p.shape == v.shape, k
        np.testing.assert_allclose(p[both], v[both], rtol=0, atol=2e-3,
                                   err_msg=k)
        want = 1.0 if k == 'rgb_pr' else 0.0
        assert np.all(p[neither] == want) and np.all(v[neither] == want), k
    assert np.all(np.isfinite(pimg['rgb_pr_nis']))
    assert float(np.abs(pimg['rgb_pr_nis'] - pimg['rgb_pr'])[both].max()) \
        > 1e-4


def test_render_image_pads_its_last_chunk(pair, renders):
    """Chunks of 48 (64 = 48 + 16, the last padded with copies of its last
    ray) give the primary-hit images of one chunk of 512.  The shaded
    images depend on the chunk, on both sides: the secondary trace and
    the inner-light MLP have slot budgets proportional to the chunk's rays,
    and the padding rays take their share."""
    _, pimg = renders
    small = pair['pmt'].render_image(pair['pose'], pair['K'], 8, 8,
                                     chunk=48)
    for k in ('hit_mask', 'normal', 'albedo', 'metallic', 'roughness',
              'normal_nis', 'albedo_nis'):
        np.testing.assert_array_equal(small[k], pimg[k], err_msg=k)
    assert np.all(np.isfinite(small['rgb_pr_nis']))


def test_jax_render_draws_nothing(pair, renders):
    """The JAX render splits one key per chunk but shades with
    is_train=False, which draws nothing: another key gives the same
    images, so the port's render needs no noise hook."""
    jmt = pair['jmt']
    jimg, _ = renders
    rng = jmt.rng
    jmt.rng = jax.random.PRNGKey(12345)
    again = jmt.render_image(pair['pose'], pair['K'], 8, 8)
    jmt.rng = rng
    for k, v in jimg.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_validate_matches_jax(pair):
    """validate renders the held-out view at 8x8 (the ground truth resized
    like cv2.resize(INTER_LINEAR)) and scores rgb_pr_nis with the white
    background added."""
    jpsnr = pair['jmt'].validate(max_views=1, downsample=DOWN)
    ppsnr = pair['pmt'].validate(max_views=1, downsample=DOWN)
    assert np.isfinite(ppsnr)
    assert abs(ppsnr - jpsnr) < 0.05, (ppsnr, jpsnr)


@pytest.fixture(scope='module')
def hits(pair):
    """Primary hits of the 8x8 view traced by the JAX package: the same
    input for both eval_outputs."""
    jmt = pair['jmt']
    info = {'imgs': np.zeros((1, 8, 8, 3), np.float32),
            'Ks': pair['K'][None], 'poses': pair['pose'][None]}
    from tensoflow_tpu.data import rays as jrays
    batch = jrays.construct_ray_batch_nerf(info)[0]
    o, d = jnp.asarray(batch['rays_o']), jnp.asarray(batch['dirs'])
    inters, normals, _, hit = jax.jit(
        lambda geo, grid, oo, dd: jmr.trace_surface(geo, jmt.rcfg, grid, oo,
                                                    dd))(
        jmt.geo_params, jmt.grid, o, d)
    hit = np.asarray(hit)
    return {'inters': np.asarray(inters)[hit],
            'normals': np.asarray(normals)[hit],
            'rays_d': np.asarray(d)[hit]}


@pytest.mark.parametrize('estimator', ['f32', 'bf16'])
def test_eval_outputs_match_jax(pair, hits, estimator):
    jmt, pmt = pair['jmt'], pair['pmt']
    jrcfg = jmt.rcfg._replace(shader=jmt.rcfg.shader._replace(
        estimator_dtype=estimator))
    prcfg = pmt.rcfg._replace(shader=pmt.rcfg.shader._replace(
        estimator_dtype=estimator))
    jout = jax.jit(lambda p, g, b, fd, fs: jmr.eval_outputs(
        p, jrcfg, g, b, jax.random.PRNGKey(0), fd, fs))(
        jmt.params, jmt.grid, {k: jnp.asarray(v) for k, v in hits.items()},
        jmt.flow_copies['diffuse'], jmt.flow_copies['specular'])
    with torch.no_grad():
        pout = pmr.eval_outputs(pmt.params, prcfg, pmt.grid,
                                {k: _t(v) for k, v in hits.items()},
                                pmt.flow_copies['diffuse'],
                                pmt.flow_copies['specular'])
    assert sorted(pout) == sorted(jout)
    n_rays = len(hits['inters']) * (SHADER['diffuse_sample_num']
                                    + SHADER['specular_sample_num'])
    for k, v in jout.items():
        v, p = np.asarray(v, np.float32), pout[k].float().numpy()
        if 'secondary_' in k:
            assert abs(float(p) - float(v)) <= 2.5 / n_rays, k
        elif estimator == 'f32':
            np.testing.assert_allclose(p, v, rtol=2e-4, atol=2e-5,
                                       err_msg=k)
        elif k.split('_nis')[0] in ('rgb_pr', 'diffuse_color',
                                    'specular_color', 'visibility',
                                    'diffuse_light'):
            np.testing.assert_allclose(p, v, rtol=0, atol=8e-2, err_msg=k)
            assert float(np.abs(p - v).mean()) < 2e-2, k


def test_predict_vertex_materials_matches_jax(pair):
    """Chunks of 256 over 1,000 vertices (the last zero-padded)."""
    verts = np.random.RandomState(3).uniform(-0.8, 0.8, (1000, 3)).astype(
        np.float32)
    j = jmr.predict_vertex_materials(pair['jmt'].params, pair['jmt'].rcfg,
                                     verts, batch_size=256)
    p = pmr.predict_vertex_materials(pair['pmt'].params, pair['pmt'].rcfg,
                                     verts, batch_size=256)
    for k in ('metallic', 'roughness', 'albedo'):
        assert p[k].shape == np.asarray(j[k]).shape == (
            1000, 3 if k == 'albedo' else 1)
        np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(p['albedo'].std()) > 1e-3


# ---------------------------------------------------------------------------
# the CLIs on the CPU: a 'direction' config trains through a validation,
# keeps model_best.pkl, then eval_mat renders and bakes
# ---------------------------------------------------------------------------

CLI_CFG = os.path.join(ROOT, 'configs/mat/syn/lego.yaml')
CLI_GEO = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
           'app_dim=8', 'N_voxel_init=512', 'N_voxel_final=512',
           'upsample_list=null', 'init_radius=0.5', 'sdf_multires=0']


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp('cli')
    geo = str(d / 'geo.pt')
    ShapeTrainer(pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/toy/sphere.yaml'),
        overrides=CLI_GEO), device='cpu').save(geo)

    def sphere(p):
        return np.linalg.norm(p, axis=-1) - 0.5
    verts, tris = pmesh.extract_geometry(np.array([-1.0] * 3),
                                         np.array([1.0] * 3), 16, 0.0,
                                         sphere)
    assert len(verts) > 100
    ply = str(d / 'mesh.ply')
    pmesh.write_ply(ply, verts, tris)
    overrides = [
        'name=cli_mat', 'database_name=toy/sphere_16_4', 'split_manul=false',
        f'geo_model_path={geo}', f'mesh={ply}', 'train_ray_num=16',
        'bake_resolution=16', 'save_interval=2', 'val_interval=2',
        'train_log_step=1', 'total_step=100'] + [
        f'shader_cfg.{k}={list(v) if isinstance(v, tuple) else v}'
        for k, v in SHADER.items()]
    cwd = os.getcwd()
    os.chdir(d)
    try:
        run_training.main(['--cfg', CLI_CFG, '--steps', '2', '--device',
                           'cpu', *overrides])
        result = eval_mat.main(['--cfg', CLI_CFG, '--run_nvs',
                                '--extract_mats', '--device', 'cpu',
                                *overrides])
    finally:
        os.chdir(cwd)
    return dict(dir=d, overrides=overrides, result=result, ply=ply)


def test_run_training_material_validates_and_keeps_best(cli_run, capsys):
    model_dir = cli_run['dir'] / 'data' / 'model' / 'cli_mat'
    assert (model_dir / 'model.pkl').exists()
    best = pckpt.load_checkpoint(str(model_dir / 'model_best.pkl'))
    assert best['step'] == 2 and np.isfinite(best['best_para'])
    assert best['best_para'] > 0
    # the direction light's predictor was saved and trained
    assert 'layers' in best['params']['outer_light']


def test_eval_mat_writes_views_and_materials(cli_run, monkeypatch):
    """The PNG, read back by cv2, is the render of the loaded checkpoint
    pixel for pixel (analytic pass: load restarts the flows); the
    metallic / roughness bakes are the vertex materials, gamma-corrected;
    --relight leaves the Blender bundle."""
    d, over = cli_run['dir'], cli_run['overrides']
    cfg = pconfig.load_config(CLI_CFG, overrides=over)
    tr = MaterialTrainer(cfg, cfg['geo_model_path'], device='cpu')
    tr.load(str(d / 'data' / 'model' / 'cli_mat' / 'model.pkl'))
    assert tr.flow_copies == {}
    db = pdb.parse_database_name(cfg['database_name'], 'unused',
                                 isTest=True, isWhiteBG=True)
    for vid in db.get_img_ids():
        h, w = db.get_image(vid).shape[:2]
        out = tr.render_image(db.get_pose(vid), db.get_K(vid), h, w)
        assert 'rgb_pr_nis' not in out
        want = (np.clip(out['rgb_pr'], 0, 1) * 255).astype(np.uint8)
        png = cv2.imread(str(d / 'data' / 'nvs' / 'cli_mat'
                             / f'{vid}_mat.png'), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(png[..., ::-1], want)
    assert len(cli_run['result']['psnr']) == len(db.get_img_ids())
    verts, _ = pmesh.read_ply(cli_run['ply'])
    mats = pmr.predict_vertex_materials(tr.params, tr.rcfg, verts)
    out_dir = d / 'data' / 'materials' / 'cli_mat'
    for k in ('metallic', 'roughness'):
        np.testing.assert_allclose(
            np.load(out_dir / f'{k}.npy'),
            linear_to_srgb(torch.from_numpy(mats[k])).numpy(), rtol=1e-6)
    albedo = np.load(out_dir / 'albedo.npy')
    assert albedo.shape == (len(verts), 3) and np.all(np.isfinite(albedo))
    assert (d / 'data' / 'nvs' / 'cli_mat' / 'albedoRescale_record.txt'
            ).exists()
    # --relight bakes the same materials and leaves the Blender bundle
    # (no blender binary here)
    monkeypatch.chdir(d)
    res = eval_mat.main(['--cfg', CLI_CFG, '--relight', '--hdr', 'env.hdr',
                         '--device', 'cpu', *over])
    assert res['relight'] is None
    bundle = json.load(open(d / 'data' / 'relight' / 'cli_mat' /
                            'relight_cfg.json'))
    assert bundle['hdr'] == 'env.hdr' and bundle['mesh'] == cli_run['ply']
