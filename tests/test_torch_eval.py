"""Rendering, validation metrics, mesh extraction and the CLIs of the port
against the JAX package.

  * ShapeTrainer.render_image on a 16x16 view in chunks of 96 rays (the
    last one padded), two mip levels: every one of its 15 images against
    the JAX trainer's render_image (its stencil through the Pallas head in
    interpret mode) from the same parameters and occupancy state, to 1e-4;
  * psnr / ssim and eval_and_dump against the JAX package's, to 1e-6; the
    validation resize against cv2.resize;
  * extract_geometry on an analytic sphere: the same vertices and
    triangles as the JAX package's ops/mesh.py; PLY write/read;
  * the two CLIs end to end on the CPU at a tiny size.
"""
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.eval import metrics as jmetrics
from tensoflow_tpu.ops import mesh as jmesh
from tensoflow_tpu.train import metrics_vis as jvis
from tensoflow_tpu.train.trainer import ShapeTrainer as JaxShapeTrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch import extract_mesh, run_training
from tensoflow_tpu_torch.convert import occ_state_from_jax, params_from_jax
from tensoflow_tpu_torch.eval import metrics as pmetrics
from tensoflow_tpu_torch.ops import mesh as pmesh
from tensoflow_tpu_torch.train import metrics_vis as pvis
from tensoflow_tpu_torch.train.trainer import EVAL_KEYS, ShapeTrainer

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml')
RENDER = [
    'database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
    'app_dim=16', 'N_voxel_init=4500', 'N_voxel_final=4500',
    'max_levels=2', 'occ_grid_reso=16', 'occ_max_samples=48',
    'upsample_list=null', 'compact_samples_per_ray=16',
    'test_ray_num=96', 'init_radius=0.5', 'sdf_multires=0',
    'name=parity_eval']


def test_render_image_matches_jax():
    jt = JaxShapeTrainer(jconfig.load_config(
        CFG_PATH, overrides=RENDER + ['stencil_impl=pallas',
                                      'stencil_tile=32']))
    k = jax.random.PRNGKey(11)
    w0 = jt.params['sdf']['mlp'][0]['w']
    jt.params['sdf']['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(
        k, w0.shape)
    jt.init_dataset()
    pt = ShapeTrainer(pconfig.load_config(CFG_PATH, overrides=RENDER),
                      device='cpu')
    pt.set_params(params_from_jax(jax.tree.map(np.asarray, jt.params)))
    pt.occ_state = occ_state_from_jax(jax.tree.map(np.asarray, jt.occ_state))
    assert pt.rcfg.sdf.n_levels == 2
    db = jt.database
    K = np.diag([0.5, 0.5, 1.0]).astype(np.float32) @ db.get_K(0)
    jout = jt.render_image(db.get_pose(0), K, 16, 16)
    pout = pt.render_image(db.get_pose(0), K, 16, 16)
    assert sorted(jout) == sorted(pout) == sorted(EVAL_KEYS)
    assert float(np.mean(pout['acc'])) > 0.05      # the view sees surface
    for key in EVAL_KEYS:
        assert pout[key].shape == jout[key].shape, key
        np.testing.assert_allclose(pout[key], jout[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_psnr_ssim_and_dump_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    gt = rng.rand(40, 36, 3).astype(np.float32)
    pred = np.clip(gt + 0.05 * rng.randn(40, 36, 3), 0, 1).astype(np.float32)
    np.testing.assert_allclose(pmetrics.psnr(gt, pred),
                               jmetrics.psnr(gt, pred), rtol=1e-6)
    np.testing.assert_allclose(pmetrics.ssim(gt, pred),
                               jmetrics.ssim(gt, pred), rtol=1e-6)
    np.testing.assert_allclose(pmetrics.ssim(gt[..., 0], pred[..., 0]),
                               jmetrics.ssim(gt[..., 0], pred[..., 0]),
                               rtol=1e-6)
    outs = {'ray_rgb': pred, 'normal_vis': gt, 'roughness': gt[..., :1]}
    pres = pvis.eval_and_dump(gt, outs, 'm', 3, 1,
                              vis_dir=str(tmp_path / 'p'))
    jres = jvis.eval_and_dump(gt, outs, 'm', 3, 1,
                              vis_dir=str(tmp_path / 'j'))
    assert pres == pytest.approx(jres, rel=1e-6)
    p_img = cv2.imread(str(tmp_path / 'p' / 'm-val' / 'step3-1.jpg'))
    j_img = cv2.imread(str(tmp_path / 'j' / 'm-val' / 'step3-1.jpg'))
    np.testing.assert_array_equal(p_img, j_img)


@pytest.mark.parametrize('src,dst', [((128, 128), (64, 64)),
                                     ((128, 96), (32, 24)),
                                     ((37, 53), (18, 26)),
                                     ((20, 30), (40, 45))])
def test_resize_linear_matches_cv2(src, dst):
    """The validation downsample computes cv2.resize's INTER_LINEAR
    values: to 1e-7 at the configs' ratios (1/2, 1/4); at other ratios
    cv2's optimised path sums the same two taps in another order (1e-5)."""
    img = np.random.RandomState(sum(src)).rand(*src, 3).astype(np.float32)
    got = pvis.resize_linear(img, *dst)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    exact = src[0] % dst[0] == 0 and src[0] // dst[0] in (2, 4)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-7 if exact else 1e-5)


def test_extract_geometry_matches_jax(tmp_path):
    def sphere(p):
        return np.linalg.norm(p - np.array([0.1, -0.05, 0.0]), axis=-1) - 0.6
    args = (np.array([-1.0, -1, -1]), np.array([1.0, 1, 1]), 40, 0.0, sphere)
    pv, pt_ = pmesh.extract_geometry(*args)
    jv, jt_ = jmesh.extract_geometry(*args)
    assert len(pv) > 1000
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt_, jt_)
    path = str(tmp_path / 'sphere.ply')
    pmesh.write_ply(path, pv, pt_)
    rv, rt = jmesh.read_ply(path)
    np.testing.assert_array_equal(rv, pv)
    np.testing.assert_array_equal(rt, pt_)
    rv, rt = pmesh.read_ply(path)
    np.testing.assert_array_equal(rv, pv)
    np.testing.assert_array_equal(rt, pt_)


CLI = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
       'app_dim=8', 'N_voxel_init=512', 'N_voxel_final=4096',
       'occ_grid_reso=8', 'train_ray_num=16', 'occ_max_samples=16',
       'occ_loss_max_pn=16', 'upsample_list=[1]',
       'compact_samples_per_ray=8', 'test_ray_num=64', 'init_radius=0.5',
       'sdf_multires=0', 'split_manul=false', 'save_interval=2', 'val_interval=2',
       'train_log_step=1', 'name=cli_toy']


def test_cli_train_validate_and_extract_on_cpu(tmp_path, monkeypatch,
                                               capsys):
    """run_training: 4 steps across an upsample in rounds of
    save_interval, a validation at each val_interval, the best checkpoint
    kept; extract_mesh on its checkpoint; both with --device cpu."""
    monkeypatch.chdir(tmp_path)
    run_training.main(['--cfg', CFG_PATH, '--steps', '4', '--device', 'cpu',
                       *CLI])
    printed = capsys.readouterr().out
    assert printed.count('[val] step=') == 2, printed
    assert 'training done at step 4' in printed
    model_dir = tmp_path / 'data' / 'model' / 'cli_toy'
    assert (model_dir / 'model.pkl').exists()
    assert (model_dir / 'model_best.pkl').exists()
    assert list((tmp_path / 'data' / 'train_vis' / 'cli_toy-val').iterdir())
    out, verts, tris = extract_mesh.main(
        ['--cfg', CFG_PATH, '--resolution', '24', '--device', 'cpu', *CLI])
    assert out.endswith('cli_toy-4.ply') and len(tris) > 0
    rv, rt = pmesh.read_ply(out)
    np.testing.assert_array_equal(rv, verts)
    np.testing.assert_array_equal(rt, tris)


def test_validate_scores_the_held_out_view(tmp_path, monkeypatch):
    """validate(): the held-out view rendered at downsample_ratio, its PSNR
    the one eval_and_dump computes from render_image and the resized gt."""
    monkeypatch.chdir(tmp_path)
    cfg = pconfig.load_config(CFG_PATH, overrides=CLI + [
        'downsample_ratio=0.5'])
    trainer = ShapeTrainer(cfg, device='cpu')
    trainer.init_dataset()
    trainer.train(n_steps=1, log_every=1)
    (vid,) = trainer.test_ids
    gt = pvis.resize_linear(
        trainer.database.get_image(vid).astype(np.float32) / 255.0, 8, 8)
    K = np.diag([0.5, 0.5, 1.0]).astype(np.float32) @ \
        trainer.database.get_K(vid)
    out = trainer.render_image(trainer.database.get_pose(vid), K, 8, 8)
    assert trainer.validate(downsample=None) == pytest.approx(
        pmetrics.psnr(gt, out['ray_rgb']), rel=1e-6)
    assert all(np.isfinite(out[k]).all() for k in EVAL_KEYS)
