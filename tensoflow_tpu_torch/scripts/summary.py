"""Figures of the evidence artifacts, for comparing runs: the blobs run's
marks and its rays/s by grid phase, the material run's PSNR and ms/step,
and each A/B seed's arms (val PSNR, the tail variance of the MC estimator
from step 600 as the JAX test takes it, and the same mean without the
arm's largest logged value), with the JAX CPU artifacts beside them and
the JAX A/B script's runs at the port's other two seeds
(toy_material_ab_jax_cpu_seed<S>.json, written by tests/jax_ab_seed.py).

    python -m tensoflow_tpu_torch.scripts.summary [--dir DIR] [--jax-dir DIR]

Reads JSON only; the port's artifacts default to
tensoflow_tpu_torch/assets/convergence/, the JAX ones to data/convergence/.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List

import numpy as np

from tensoflow_tpu_torch.scripts import record as rec

PORT_DIR = os.path.join(rec.ROOT, 'tensoflow_tpu_torch', 'assets',
                        'convergence')
JAX_DIR = os.path.join(rec.ROOT, 'data', 'convergence')
RUN_RAYS, MAT_RAYS = 512, 128        # train_ray_num of the scripts' configs
SEEDS_ON_JAX = (6034, 6035)


def tail_variance(traj: List[Dict[str, Any]], start: int = 600):
    """(mean, mean without the largest value) of the logged variance from
    ``start`` on."""
    v = np.array([m['variance'] for m in traj if m['step'] >= start])
    return float(v.mean()), float(np.delete(v, v.argmax()).mean())


def blobs_lines(t) -> List[str]:
    out = [f'  mark {m["step"]}: grid {m["grid"][0]}, val PSNR '
           f'{m["val_psnr"]:.3f}, Chamfer {m["chamfer"]:.5f}'
           + (f', {m["train_s"]:.1f} s training '
              f'({RUN_RAYS * 600 / m["train_s"]:.0f} rays/s)'
              if 'train_s' in m else f', wall {m["wall_s"]} s')
           for m in t['chamfer']]
    marks = t['chamfer']
    if all('train_s' in m for m in marks):
        for lo, hi in ((0, 1200), (1200, 2400), (2400, 3600)):
            secs = sum(m['train_s'] for m in marks if lo < m['step'] <= hi)
            steps = hi - lo
            out.append(f'  steps {lo + 1}-{hi}: {secs:.1f} s, '
                       f'{secs / steps * 1e3:.1f} ms/step, '
                       f'{RUN_RAYS * steps / secs:.0f} rays/s')
        train = t['phase_wall_s']['train']
        out.append(f'  3,600 steps: {train:.1f} s of training, '
                   f'{RUN_RAYS * 3600 / train:.0f} rays/s')
    return out


def material_lines(t) -> List[str]:
    ps = [m['psnr'] for m in t['trajectory']]
    out = [f'  stage-1 PSNR {t["stage1_psnr"][0]:.3f} -> '
           f'{t["stage1_psnr"][1]:.3f}; stage-2 first-3 mean '
           f'{np.mean(ps[:3]):.3f}, last-5 mean {np.mean(ps[-5:]):.3f}, '
           f'max {max(ps):.3f}; wall {t["wall_s"]} s']
    if 'phase_wall_s' in t:
        w = t['phase_wall_s']
        out.append(f'  stage 1 {w["stage1"]:.1f} s, stage 2 '
                   f'{w["stage2"]:.1f} s = '
                   f'{w["stage2"] / t["mat_steps"] * 1e3:.1f} ms/step '
                   f'({MAT_RAYS * t["mat_steps"] / w["stage2"]:.0f} rays/s)')
    return out


def ab_lines(t) -> List[str]:
    runs = {str(t.get('random_seed', 6033)): t, **t.get('seeds', {})}
    out = []
    for seed, r in runs.items():
        arms = r['arms']
        var = {n: tail_variance(a['trajectory']) for n, a in arms.items()}
        on, off = var['budgeted_nis'], var['budgeted_nis_off']
        out.append(f'  seed {seed}: val PSNR '
                   + ', '.join(f'{n} {a["val_psnr"]:.3f}'
                               for n, a in arms.items()))
        out.append('    tail variance '
                   + ', '.join(f'{n} {v[0]:.5f}' for n, v in var.items())
                   + f'; NIS / off {on[0] / off[0]:.3f} (bound < 0.92); '
                   f'without each arm\'s largest value {on[1]:.5f} / '
                   f'{off[1]:.5f} = {on[1] / off[1]:.3f}')
        d = r['material_map_mean_abs_delta']
        out.append('    map deltas budgeted vs dense '
                   + ', '.join(f'{k} {v:.4f}'
                               for k, v in d['budgeted_vs_dense'].items())
                   + '; NIS vs off '
                   + ', '.join(f'{k} {v:.4f}'
                               for k, v in d['nis_vs_off'].items()))
        if 'phase_wall_s' in r:
            w = r['phase_wall_s']
            out.append(f'    wall {r["wall_s"]} s: stage 1 '
                       f'{w["stage1"]:.1f} s; '
                       + ', '.join(
                           f'{n} {w[n + "/train"]:.1f} s = '
                           f'{w[n + "/train"] / t["mat_steps"] * 1e3:.1f} '
                           'ms/step' for n in arms))
        else:
            out.append(f'    wall {r["wall_s"]} s')
    return out


ARTIFACTS = (('blobs_convergence', blobs_lines),
             ('toy_material_convergence', material_lines),
             ('toy_material_ab', ab_lines))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--dir', default=PORT_DIR)
    ap.add_argument('--jax-dir', default=JAX_DIR)
    args = ap.parse_args(argv)
    for name, lines in ARTIFACTS:
        runs = [('port', os.path.join(args.dir, name + '_h100.json'), None),
                ('JAX CPU artifact',
                 os.path.join(args.jax_dir, name + '.json'), None)]
        # the JAX script at the A/B's other seeds (tests/jax_ab_seed.py)
        runs += [(f'JAX CPU run, seed {seed}', os.path.join(
            args.dir, f'{name}_jax_cpu_seed{seed}.json'), seed)
            for seed in SEEDS_ON_JAX if name == 'toy_material_ab']
        for label, path, seed in runs:
            with open(path) as f:
                t = json.load(f)
            if seed is not None:
                t['random_seed'] = seed
            card = t.get('card') or 'no card recorded'
            print(f'{name} ({label}; {card}):')
            print('\n'.join(lines(t)))


if __name__ == '__main__':
    main()
