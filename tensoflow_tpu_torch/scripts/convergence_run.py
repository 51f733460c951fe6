"""Schedule-scale hermetic convergence run of stage 1 (counterpart of the
JAX repo's scripts/convergence_run.py).

Trains stage 1 on the procedural blobs scene through the published phase
machinery: the occupancy-grid sampler, two log-spaced grid upsamples
(128^3 -> 256^3 -> 512^3 N_voxel) with optimizer resets, the radiance
field and the occ loss turned on, the alpha-mask marks; every 600 steps a
validation of two held-out views and a Chamfer distance to the analytic
surface, with the JSON rewritten after each mark.

    python -m tensoflow_tpu_torch.scripts.convergence_run \\
        [--out tensoflow_tpu_torch/assets/convergence/blobs_convergence_h100.json] \\
        [--device cpu] [--git-commit SHA]

It runs on the card; ``--device cpu`` runs the plain PyTorch path.
tests/test_torch_convergence_artifact.py holds the committed artifact to
the JAX artifact's bounds.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from tensoflow_tpu_torch.scripts import record as rec

OUT = os.path.join(rec.ROOT, 'tensoflow_tpu_torch', 'assets', 'convergence',
                   'blobs_convergence_h100.json')
SCENE = 'toy/blobs_96_12'


def shape_config(total: int = 3600, upsample_list: Sequence[int] = (1200, 2400),
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JAX script's config (scripts/convergence_run.py:88-112); ``extra``
    overrides keys (tests shrink the widths)."""
    from tensoflow_tpu_torch.config import load_config
    up = list(upsample_list)
    return load_config(extra={
        'name': 'convergence_blobs',
        'database_name': SCENE,
        'dataset_dir': 'unused',
        'nerfDataType': True,
        'train_ray_num': 512,
        'sdf_n_comp': 16, 'sdf_dim': 128, 'app_dim': 64,
        'use_occ_grid': True, 'occ_grid_reso': 128,
        'occ_max_samples': 96,
        # the reference's warmup ratio (10k of 100k) on the compressed
        # schedule
        'occ_warmup_steps': 400,
        # the compressor_occ schedule compressed 100k -> 3.6k steps
        # (N_voxel 128^3 -> 512^3 log-spaced at the same 20 % / 40 % marks,
        # configs/shape/syn/compressor_occ.yaml:61-64)
        'N_voxel_init': 128 ** 3, 'N_voxel_final': 512 ** 3,
        'upsample_list': up,
        'update_AlphaMask_lst': up,
        'has_radiance_field': True, 'radiance_field_step': 1800,
        'apply_occ_loss': True, 'occ_loss_step': 1500,
        'occ_loss_max_pn': 512,
        'apply_mask_loss': True,
        'anneal_end': 800,
        'lr_decay_iters': total,
        'total_step': total,
        **(extra or {}),
    })


def chamfer_vs_gt(trainer, res: int = 128, n_surface: int = 20000):
    """Bidirectional Chamfer between the trained SDF's marching-tets mesh
    (the SDF queried on the trainer's device) and the analytic blobs
    surface; (nan, n_verts) below 100 vertices."""
    from scipy.spatial import cKDTree

    from tensoflow_tpu_torch.data.toy import blob_sdf
    from tensoflow_tpu_torch.extract_mesh import sdf_query
    from tensoflow_tpu_torch.ops import mesh as mesh_mod

    query = sdf_query(trainer.params, trainer.rcfg, trainer.device, None)
    verts, _ = mesh_mod.extract_geometry(
        np.array([-1.0] * 3), np.array([1.0] * 3), res, 0.0, query)
    if len(verts) < 100:
        return float('nan'), len(verts)
    rng = np.random.RandomState(0)
    idx = rng.choice(len(verts), min(n_surface, len(verts)), replace=False)
    pred = verts[idx]
    # pred -> GT: |blob_sdf| is the exact distance (a Lipschitz <= 1 smooth
    # union, slightly conservative)
    d_pred_gt = np.abs(blob_sdf(pred))
    # GT -> pred: GT surface points by projecting sphere points, then the
    # nearest vertex
    gs = rng.randn(n_surface, 3)
    gs /= np.linalg.norm(gs, axis=-1, keepdims=True)
    gt_pts = gs * 0.45
    for _ in range(12):
        gt_pts -= blob_sdf(gt_pts)[..., None] * _grad(gt_pts)
    d_gt_pred, _ = cKDTree(pred).query(gt_pts, k=1)
    return float(d_pred_gt.mean() + d_gt_pred.mean()), len(verts)


def _grad(p, eps=1e-4):
    from tensoflow_tpu_torch.data.toy import blob_sdf
    offs = np.eye(3) * eps
    g = np.stack([blob_sdf(p + offs[i]) - blob_sdf(p - offs[i])
                  for i in range(3)], -1) / (2 * eps)
    return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)


def run(out: str = OUT, total: int = 3600,
        marks: Optional[Sequence[int]] = None,
        upsample_list: Sequence[int] = (1200, 2400), chamfer_res: int = 128,
        device=None, extra: Optional[Dict[str, Any]] = None,
        commit: Optional[str] = None) -> Dict[str, Any]:
    """Train ``total`` steps, validating and measuring the Chamfer at each
    of ``marks`` (every 600 steps by default); returns the record written
    to ``out`` after each mark."""
    from tensoflow_tpu_torch import resolve_device
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer

    device = resolve_device(device)
    card = rec.card_name(device)
    cfg = shape_config(total, upsample_list, extra)
    marks = list(marks) if marks is not None else \
        list(range(600, total + 1, 600))
    clock = rec.PhaseClock(device)
    with clock.phase('setup'):
        trainer = ShapeTrainer(cfg, device=device)
        trainer.init_dataset()
    t0 = time.time()
    traj = {'meta': {'scene': cfg['database_name'], 'total': total,
                     'upsample_list': list(upsample_list),
                     'phases': {'occ_loss_on': cfg['occ_loss_step'],
                                'radiance_on': cfg['radiance_field_step']},
                     'timestamp': time.strftime('%Y-%m-%d %H:%M:%S')},
            'steps': [], 'chamfer': []}
    done = 0
    for mark in marks:
        with clock.phase('train'):
            logs = trainer.train(n_steps=mark - done, log_every=100)
        seconds = {'train_s': clock.last_s}
        with clock.phase('validate'):
            val = trainer.validate(max_views=2)
        seconds['validate_s'] = clock.last_s
        with clock.phase('chamfer'):
            cham, nverts = chamfer_vs_gt(trainer, res=chamfer_res)
        seconds['chamfer_s'] = clock.last_s
        done = mark
        traj['steps'] += logs
        traj['chamfer'].append({
            'step': done, 'val_psnr': val, 'chamfer': cham,
            'n_verts': nverts, 'grid': list(trainer.rcfg.sdf.grid_size),
            'wall_s': round(time.time() - t0, 1),
            **{k: round(v, 3) for k, v in seconds.items()}})
        print(f'[{done}] val_psnr={val:.2f} chamfer={cham:.4f} '
              f'grid={trainer.rcfg.sdf.grid_size} '
              f'({time.time() - t0:.0f}s)', flush=True)
        traj.update(rec.run_info(device, clock, card, commit))
        rec.write_json(out, traj)
    print('wrote', out, flush=True)
    return traj


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', type=str, default=OUT)
    ap.add_argument('--device', type=str, default=None,
                    help="'cpu' for the plain path (default: the card)")
    ap.add_argument('--git-commit', type=str, default=None,
                    help='the commit recorded in the artifact (default: '
                         "the checkout's HEAD)")
    args = ap.parse_args(argv)
    return run(args.out, device=args.device, commit=args.git_commit)


if __name__ == '__main__':
    main()
