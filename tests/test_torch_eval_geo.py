"""The geometry-evaluation metrics and CLIs of the port against the JAX
package: ``normal_mae``, ``chamfer_distance`` and
``scale_invariant_psnr_hdr`` (eval/metrics.py) at 1e-12 in float64;
``python -m tensoflow_tpu_torch.eval_geo`` on the CPU on the test split
of a tensoSDF layout written from a toy scene (finite metrics, the
reference's metrics_record.txt line); ``eval_orb_shape`` giving the
Chamfer distance the JAX package's CLI computes from the same draws."""
import importlib.util
import os
import re

import numpy as np
import pytest

from tensoflow_tpu.eval import metrics as j_metrics
from tensoflow_tpu_torch.eval import metrics as p_metrics

from test_torch_databases import SMALL_HIER, chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r'^\S+ geo: PSNR -?\d+\.\d{4} SSIM -?\d+\.\d{4}'
                  r' NormalMAE \d+\.\d{4}$')


@pytest.mark.parametrize('masked', [False, True])
def test_metrics_match_jax(masked):
    rng = np.random.RandomState(3)
    gt_n, pr_n = rng.randn(2, 9, 11, 3)
    mask = (rng.rand(9, 11) > 0.4).astype(np.float64) if masked else None
    assert abs(p_metrics.normal_mae(gt_n, pr_n, mask)
               - j_metrics.normal_mae(gt_n, pr_n, mask)) <= 1e-12
    gt, pr = rng.rand(2, 9, 11, 3) * 4
    assert abs(p_metrics.scale_invariant_psnr_hdr(gt, pr, mask)
               - j_metrics.scale_invariant_psnr_hdr(gt, pr, mask)) <= 1e-12
    a, b = rng.randn(300, 3), rng.randn(200, 3) * 1.1
    for both in (True, False):
        assert abs(p_metrics.chamfer_distance(a, b, both)
                   - j_metrics.chamfer_distance(a, b, both)) <= 1e-12


def _tiny_checkpoint(cfg_path, overrides, path):
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    cfg = pconfig.load_config(cfg_path, overrides=overrides)
    ShapeTrainer(cfg, device='cpu').save(path)


def test_eval_geo_cli_on_the_cpu(tmp_path, monkeypatch):
    from tensoflow_tpu_torch import eval_geo
    from tensoflow_tpu_torch.data import image_io
    from tensoflow_tpu_torch.data.toy import ToyDatabase
    toy = ToyDatabase('toy/blobs_12_3')
    chip_smoke.write_blender_layout(toy, str(tmp_path / 'blobs'),
                                    test_ids=[0, 2])
    monkeypatch.chdir(tmp_path)
    cfg = os.path.join(ROOT, 'configs/shape/syn/compressor.yaml')
    over = SMALL_HIER + ['database_name=tensoSDF/blobs',
                         f'dataset_dir={tmp_path}', 'test_ray_num=64']
    _tiny_checkpoint(cfg, over, str(tmp_path / 'geo.pkl'))
    res = eval_geo.main(['--cfg', cfg, '--ckpt', str(tmp_path / 'geo.pkl'),
                         '--device', 'cpu', '--save_dir',
                         str(tmp_path / 'nvs'), *over])
    assert len(res['psnr']) == len(res['ssim']) == len(res['normal_mae']) == 2
    assert np.isfinite(res['psnr'] + res['ssim'] + res['normal_mae']).all()
    with open(tmp_path / 'data' / 'metrics_record.txt') as f:
        (line,) = f.read().splitlines()
    assert line == res['line'] and LINE.match(line), line
    pred = image_io.imread(str(tmp_path / 'nvs' / '1_pred.png'))
    assert pred.shape == (12, 12, 3) and pred.dtype == np.uint8


def test_eval_orb_shape_cli_matches_jax(tmp_path, monkeypatch):
    from tensoflow_tpu_torch import eval_orb_shape
    from tensoflow_tpu_torch.data.toy import blob_sdf
    from tensoflow_tpu_torch.ops import mesh
    monkeypatch.chdir(tmp_path)
    lin = np.linspace(-1, 1, 20)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing='ij'), -1)
    verts, tris = mesh.marching_tets(blob_sdf(grid))
    mesh.write_ply(str(tmp_path / 'pred.ply'), verts / 19 * 2 - 1, tris)
    sph = verts / 19 * 2 - 1
    sph = 0.5 * sph / np.linalg.norm(sph, axis=-1, keepdims=True)
    mesh.write_ply(str(tmp_path / 'gt.ply'), sph, np.zeros((0, 3), np.int32))
    cd = eval_orb_shape.main(['--mesh', str(tmp_path / 'pred.ply'),
                              '--gt_mesh', str(tmp_path / 'gt.ply'),
                              '--n_samples', '2000'])
    spec = importlib.util.spec_from_file_location(
        'jax_eval_orb_shape', os.path.join(ROOT, 'eval_orb_shape.py'))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    v1, t1 = mesh.read_ply(str(tmp_path / 'pred.ply'))
    v2, _ = mesh.read_ply(str(tmp_path / 'gt.ply'))
    want = j_metrics.chamfer_distance(ref.sample_surface(v1, t1, 2000), v2)
    assert np.isfinite(cd) and cd == want
    with open(tmp_path / 'data' / 'metrics_record.txt') as f:
        assert f.read() == (f'{tmp_path / "pred.ply"} vs '
                            f'{tmp_path / "gt.ply"}: chamfer {cd:.6f}\n')
