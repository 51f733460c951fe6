"""Schedule-scale convergence run of stage 2 (counterpart of the JAX repo's
scripts/convergence_mat.py).

Hermetic: trains stage-1 geometry on the procedural toy sphere, saves it
in the port's checkpoint format to a temporary directory, bakes it, then
runs the whole material stage (MC estimator, env light, the NIS flows with
the reference's phase schedule: warmup -> flow sampling on -> flow-copy
refreshes) for ``--steps`` steps, recording the PSNR / MC-variance /
NIS-loss trajectory.

    python -m tensoflow_tpu_torch.scripts.convergence_mat [--steps N] \\
        [--shape-steps N] [--out PATH] [--device cpu] [--git-commit SHA]

It runs on the card; ``--device cpu`` runs the plain PyTorch path.
tests/test_torch_convergence_artifact.py holds the committed artifact
(tensoflow_tpu_torch/assets/convergence/toy_material_convergence_h100.json)
to the JAX artifact's bounds.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Optional

from tensoflow_tpu_torch.scripts import record as rec

OUT = os.path.join(rec.ROOT, 'tensoflow_tpu_torch', 'assets', 'convergence',
                   'toy_material_convergence_h100.json')
DATABASE = 'toy/sphere_64_8'


def shape_config(name: str = 'conv_mat_shape',
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JAX scripts' stage-1 config (scripts/convergence_mat.py:42-52,
    scripts/ab_material.py:88-98, which differ in the name only)."""
    from tensoflow_tpu_torch.config import load_config
    return load_config(extra={
        'name': name,
        'database_name': DATABASE,
        'dataset_dir': 'unused', 'nerfDataType': True,
        'train_ray_num': 512,
        'n_samples': 24, 'n_importance': 24, 'up_sample_steps': 4,
        'sdf_n_comp': 12, 'sdf_dim': 128, 'app_dim': 64,
        'N_voxel_init': 64 ** 3, 'N_voxel_final': 64 ** 3,
        'apply_occ_loss': False, 'apply_mask_loss': True,
        'anneal_end': 200,
        **(extra or {}),
    })


def nis_schedule(steps: int) -> Dict[str, int]:
    """The reference's NIS schedule ratios compressed onto ``steps``: the
    flows start sampling after ~1/5 of training and the frozen sampling
    copies refresh on the cadence the loss uses."""
    nis_start = max(steps // 5, 10)
    return {'nis_start_iter': nis_start,
            'nis_loss_iter': max(nis_start // 2, 5),
            'nis_update_interval': max(steps // 15, 5)}


def shader(steps: int) -> Dict[str, Any]:
    return {
        'diffuse_sample_num': 64,
        'specular_sample_num': 32,
        'nis_diffuse_sample_num': 16,
        'nis_specular_sample_num': 16,
        **nis_schedule(steps),
        'grid_size': (64, 64, 64),
        'light_reso': 64,
    }


def mat_config(name: str, shader_cfg: Dict[str, Any],
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JAX scripts' stage-2 config around ``shader_cfg``
    (scripts/convergence_mat.py:70-94, scripts/ab_material.py:49-61);
    ``extra`` overrides keys, its ``shader_cfg`` keys those of the shader."""
    from tensoflow_tpu_torch.config import load_config
    extra = dict(extra or {})
    shader_cfg = {**shader_cfg, **extra.pop('shader_cfg', {})}
    return load_config(extra={
        'name': name,
        'isMaterial': True,
        'database_name': DATABASE,
        'dataset_dir': 'unused', 'nerfDataType': True,
        'train_ray_num': 128,
        'bake_resolution': 128,
        'refine_with_neural_sdf': True,
        'shader_cfg': shader_cfg,
        **extra,
    })


def train_geometry(shape_cfg, shape_steps: int, path: str, device, clock):
    """Stage 1 for ``shape_steps`` steps, saved to ``path``; its logs."""
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    with clock.phase('stage1'):
        st = ShapeTrainer(shape_cfg, device=device)
        st.init_dataset()
        logs = st.train(n_steps=shape_steps, log_every=100)
        st.save(path)
    return logs


def run(out: str = OUT, steps: int = 1500, shape_steps: int = 500,
        device=None, shape_extra: Optional[Dict[str, Any]] = None,
        mat_extra: Optional[Dict[str, Any]] = None,
        commit: Optional[str] = None) -> Dict[str, Any]:
    from tensoflow_tpu_torch import resolve_device
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

    device = resolve_device(device)
    card = rec.card_name(device)
    clock = rec.PhaseClock(device)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        geo_path = os.path.join(tmp, 'conv_mat_geo.pkl')
        logs1 = train_geometry(shape_config(extra=shape_extra), shape_steps,
                               geo_path, device, clock)
        print(f'[stage1] {shape_steps} steps, psnr '
              f'{logs1[0]["psnr"]:.2f} -> {logs1[-1]["psnr"]:.2f} '
              f'({time.time() - t0:.0f}s)', flush=True)
        mcfg = mat_config('conv_mat', shader(steps), mat_extra)
        with clock.phase('stage2_setup'):
            mt = MaterialTrainer(mcfg, geo_path, device=device)
            mt.init_dataset()

    traj = []

    def cb(host):
        traj.append(host)
        print(f'[stage2] step={host["step"]} psnr={host.get("psnr", 0):.2f}'
              f' var={host.get("variance", 0):.5f}', flush=True)

    with clock.phase('stage2'):
        mt.train(n_steps=steps, log_every=max(steps // 30, 10), callback=cb)

    record = {
        'generated': 'python -m tensoflow_tpu_torch.scripts.convergence_mat',
        'database': f'{DATABASE} (procedural, hermetic)',
        'shape_steps': shape_steps,
        'mat_steps': steps,
        'nis_start_iter': mcfg['shader_cfg']['nis_start_iter'],
        'stage1_psnr': [logs1[0]['psnr'], logs1[-1]['psnr']],
        'trajectory': traj,
        'wall_s': round(time.time() - t0, 1),
        **rec.run_info(device, clock, card, commit),
    }
    rec.write_json(out, record)
    print(f'wrote {out} ({time.time() - t0:.0f}s total)', flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=1500)
    ap.add_argument('--shape-steps', type=int, default=500)
    ap.add_argument('--out', type=str, default=OUT)
    ap.add_argument('--device', type=str, default=None,
                    help="'cpu' for the plain path (default: the card)")
    ap.add_argument('--git-commit', type=str, default=None,
                    help='the commit recorded in the artifact (default: '
                         "the checkout's HEAD)")
    args = ap.parse_args(argv)
    return run(args.out, args.steps, args.shape_steps, device=args.device,
               commit=args.git_commit)


if __name__ == '__main__':
    main()
