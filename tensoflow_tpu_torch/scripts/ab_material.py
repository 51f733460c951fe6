"""Stage-2 A/B runs (counterpart of the JAX repo's scripts/ab_material.py).

One shared stage-1 geometry, then three material-stage arms from the same
config, seed and data, differing in exactly one switch:

  * ``budgeted_nis``      — production: budgeted secondary trace, flows on
  * ``budgeted_nis_off``  — the flows never sample and get no NIS loss:
        the NIS A/B behind the paper's core claim (estimator variance and
        PSNR trajectories at matched steps)
  * ``dense_nis``         — the dense full-fidelity secondary trace
        (secondary_budget and inner_light_budget 0): the budgeted-trace
        quality A/B (final PSNR and material-map deltas between arms)

The whole run (stage 1 and the three arms) is made at the config's
``random_seed`` (6033), then again at each of ``--seeds`` (6034 and 6035 by
default), recorded under ``seeds`` as evidence of the spread. With
``--no-config-seed`` only ``--seeds`` run: each seed's entry then carries
its own ``card`` and ``git_commit``, and an existing ``--out`` keeps the
seeds it holds (the ten-seed NIS record,
toy_material_ab_seeds_h100.json, is gathered so, one seed a call).

    python -m tensoflow_tpu_torch.scripts.ab_material [--steps N] \\
        [--shape-steps N] [--seeds S ...] [--no-config-seed] [--out PATH] \\
        [--device cpu] [--git-commit SHA]

It runs on the card; ``--device cpu`` runs the plain PyTorch path.
tests/test_torch_convergence_artifact.py holds the committed artifact
(tensoflow_tpu_torch/assets/convergence/toy_material_ab_h100.json; its
6033 arms) to the JAX artifact's bounds.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from tensoflow_tpu_torch.scripts import convergence_mat as cm
from tensoflow_tpu_torch.scripts import record as rec

OUT = os.path.join(rec.ROOT, 'tensoflow_tpu_torch', 'assets', 'convergence',
                   'toy_material_ab_h100.json')
SEEDS_OUT = os.path.join(os.path.dirname(OUT), 'toy_material_ab_seeds_h100.json')
ARMS = (('budgeted_nis', True, True),
        ('budgeted_nis_off', False, True),
        ('dense_nis', True, False))
SEEDS = (6034, 6035)
TRAJ_KEYS = ('step', 'psnr', 'variance', 'loss_nis', 'loss_rgb')


def mat_config(name: str, steps: int, nis_on: bool, budgeted: bool,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JAX script's arm config (scripts/ab_material.py:30-61)."""
    shader = {**cm.shader(steps),
              'use_nis_diffuse': nis_on,
              'use_nis_specular': nis_on}
    if not budgeted:
        shader['secondary_budget'] = 0.0     # dense full-fidelity trace
        shader['inner_light_budget'] = 0.0
    return cm.mat_config(name, shader, extra)


@torch.no_grad()
def surface_material_maps(mt) -> Dict[str, np.ndarray]:
    """Predicted material maps on a fixed surface-point probe set: 2,048
    points on the sphere of radius 0.5 (RandomState(0))."""
    from tensoflow_tpu_torch.fields import mc_shading
    from tensoflow_tpu_torch.models.shape_renderer import aabb_tensor
    rng = np.random.RandomState(0)
    n = rng.randn(2048, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pts = torch.as_tensor(0.5 * n, device=mt.device)
    met, rough, alb = mc_shading.predict_materials(
        mt.params, mt.rcfg.shader, pts, aabb_tensor(mt.rcfg, mt.device))
    return {'metallic': met.cpu().numpy(), 'roughness': rough.cpu().numpy(),
            'albedo': alb.cpu().numpy()}


def map_delta(maps, a: str, b: str) -> Dict[str, float]:
    return {k: float(np.mean(np.abs(maps[a][k] - maps[b][k])))
            for k in maps[a]}


def run_seed(seed: Optional[int], steps: int, shape_steps: int, device,
             shape_extra: Optional[Dict[str, Any]] = None,
             mat_extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Stage 1 and the three arms at ``seed`` (None: the config's own);
    returns the JAX record's arms, map deltas and wall clock with the
    phases' wall clock and launches."""
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    over = {} if seed is None else {'random_seed': seed}
    clock = rec.PhaseClock(device)
    t0 = time.time()
    arms, maps = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        geo_path = os.path.join(tmp, 'ab_mat_geo.pkl')
        logs1 = cm.train_geometry(
            cm.shape_config('ab_mat_shape', {**over, **(shape_extra or {})}),
            shape_steps, geo_path, device, clock)
        print(f'[stage1] psnr {logs1[-1]["psnr"]:.2f} '
              f'({time.time() - t0:.0f}s)', flush=True)
        for name, nis_on, budgeted in ARMS:
            ta = time.time()
            cfg = mat_config(f'ab_{name}', steps, nis_on, budgeted,
                             {**over, **(mat_extra or {})})
            with clock.phase(f'{name}/setup'):
                mt = MaterialTrainer(cfg, geo_path, device=device)
                mt.init_dataset()
            traj = []
            with clock.phase(f'{name}/train'):
                mt.train(n_steps=steps, log_every=max(steps // 30, 10),
                         callback=traj.append)
            with clock.phase(f'{name}/validate'):
                val = float(np.mean(mt.validate(max_views=2,
                                                downsample=0.5)))
            arms[name] = {
                'val_psnr': val,
                'trajectory': [{k: t[k] for k in TRAJ_KEYS if k in t}
                               for t in traj],
            }
            maps[name] = surface_material_maps(mt)
            print(f'[{name}] val_psnr={val:.2f} '
                  f'({time.time() - ta:.0f}s)', flush=True)
    return {
        'arms': arms,
        'material_map_mean_abs_delta': {
            'budgeted_vs_dense': map_delta(maps, 'budgeted_nis', 'dense_nis'),
            'nis_vs_off': map_delta(maps, 'budgeted_nis', 'budgeted_nis_off'),
        },
        'wall_s': round(time.time() - t0, 1),
        'phase_wall_s': {k: round(v, 3) for k, v in clock.wall_s.items()},
        'launches': clock.launches,
    }


def run(out: str = OUT, steps: int = 1500, shape_steps: int = 500,
        seeds: Sequence[int] = SEEDS, device=None,
        shape_extra: Optional[Dict[str, Any]] = None,
        mat_extra: Optional[Dict[str, Any]] = None,
        commit: Optional[str] = None,
        config_seed: bool = True) -> Dict[str, Any]:
    """The three arms at the config's seed (unless ``config_seed`` is
    False), then at each of ``seeds``; the JSON is written after each
    seed."""
    from tensoflow_tpu_torch import resolve_device
    device = resolve_device(device)
    info = {'card': rec.card_name(device), 'device': str(device),
            'git_commit': commit if commit else rec.git_commit()}
    head = {
        'generated': 'python -m tensoflow_tpu_torch.scripts.ab_material',
        'database': f'{cm.DATABASE} (procedural, hermetic)',
        'mat_steps': steps,
    }
    if config_seed:
        record = {**head,
                  'random_seed': cm.shape_config(
                      extra=shape_extra)['random_seed'],
                  **run_seed(None, steps, shape_steps, device, shape_extra,
                             mat_extra),
                  **info, 'seeds': {}}
        rec.write_json(out, record)
    elif os.path.exists(out):
        with open(out) as f:
            record = json.load(f)
        assert record['mat_steps'] == steps, (out, record['mat_steps'])
    else:
        record = {**head, 'seeds': {}}
    for seed in seeds:
        res = run_seed(seed, steps, shape_steps, device, shape_extra,
                       mat_extra)
        # a record without the config's run says per seed where each ran
        record['seeds'][str(seed)] = res if config_seed else {**res, **info}
        rec.write_json(out, record)
    print(f'wrote {out}', flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=1500)
    ap.add_argument('--shape-steps', type=int, default=500)
    ap.add_argument('--seeds', type=int, nargs='*', default=list(SEEDS),
                    help='the seeds run after the config\'s own, recorded '
                         'under "seeds"')
    ap.add_argument('--no-config-seed', dest='config_seed',
                    action='store_false',
                    help="run --seeds only, not the config's own seed")
    ap.add_argument('--out', type=str, default=None,
                    help='default: toy_material_ab_h100.json, or '
                         'toy_material_ab_seeds_h100.json with '
                         '--no-config-seed')
    ap.add_argument('--device', type=str, default=None,
                    help="'cpu' for the plain path (default: the card)")
    ap.add_argument('--git-commit', type=str, default=None,
                    help='the commit recorded in the artifact (default: '
                         "the checkout's HEAD)")
    args = ap.parse_args(argv)
    out = args.out or (OUT if args.config_seed else SEEDS_OUT)
    return run(out, args.steps, args.shape_steps, args.seeds,
               device=args.device, commit=args.git_commit,
               config_seed=args.config_seed)


if __name__ == '__main__':
    main()
