"""Figures of the evidence artifacts, for comparing runs: the blobs run's
marks and its rays/s by grid phase, the material run's PSNR and ms/step,
and each A/B seed's arms (val PSNR, the tail variance of the MC estimator
from step 600 as the JAX test takes it, and the same mean without the
arm's largest logged value), with the JAX CPU artifacts beside them and
the JAX A/B script's runs at the other nine seeds
(toy_material_ab_jax_cpu_seed<S>.json, written by tests/jax_ab_seed.py);
then the NIS decision over ten seeds a side (``nis_decision``): each
seed's ratio r of the two arms' tail variances, the two-sided
Mann-Whitney U test of log r between the port and JAX, and the
difference of the mean log r with its bootstrap interval.

    python -m tensoflow_tpu_torch.scripts.summary [--dir DIR] [--jax-dir DIR]

Reads JSON only; the port's artifacts default to
tensoflow_tpu_torch/assets/convergence/, the JAX ones to data/convergence/.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Sequence

import numpy as np

from tensoflow_tpu_torch.scripts import record as rec

PORT_DIR = os.path.join(rec.ROOT, 'tensoflow_tpu_torch', 'assets',
                        'convergence')
JAX_DIR = os.path.join(rec.ROOT, 'data', 'convergence')
RUN_RAYS, MAT_RAYS = 512, 128        # train_ray_num of the scripts' configs
CONFIG_SEED = 6033                   # random_seed of the A/B's configs
TEN_SEEDS = tuple(range(CONFIG_SEED, CONFIG_SEED + 10))
SEEDS_ON_JAX = TEN_SEEDS[1:]
ALPHA = 0.05
BOOTSTRAP = 10_000


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
    runs = {str(t.get('random_seed', CONFIG_SEED)): t} if 'arms' in t else {}
    runs.update(t.get('seeds', {}))
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


def nis_ratio(run) -> float:
    """r: the tail mean variance of the NIS arm over the arm without NIS
    (logged steps >= 600, as tests/test_convergence_artifact.py takes it)."""
    arms = run['arms']
    return (tail_variance(arms['budgeted_nis']['trajectory'])[0]
            / tail_variance(arms['budgeted_nis_off']['trajectory'])[0])


def ten_seed_runs(port_dir: str = PORT_DIR, jax_dir: str = JAX_DIR):
    """{'port': {seed: run}, 'jax': {seed: run}} at TEN_SEEDS: the port's
    6033 arms and 6034-6035 from toy_material_ab_h100.json, the rest from
    toy_material_ab_seeds_h100.json; JAX's 6033 from its CPU artifact, the
    rest from toy_material_ab_jax_cpu_seed<S>.json."""
    def load(path):
        with open(path) as f:
            return json.load(f)
    ab = load(os.path.join(port_dir, 'toy_material_ab_h100.json'))
    port = {int(ab['random_seed']): ab,
            **{int(s): r for s, r in ab['seeds'].items()},
            **{int(s): r for s, r in load(os.path.join(
                port_dir, 'toy_material_ab_seeds_h100.json'))['seeds'].items()}}
    jax = {CONFIG_SEED: load(os.path.join(jax_dir, 'toy_material_ab.json')),
           **{s: load(os.path.join(
               port_dir, f'toy_material_ab_jax_cpu_seed{s}.json'))
              for s in SEEDS_ON_JAX}}
    return {'port': port, 'jax': jax}


def nis_decision(port_r: Sequence[float], jax_r: Sequence[float]):
    """The two-sided Mann-Whitney U test of log r, port against JAX, and the
    difference of the mean log r (port - JAX) with its 95 % bootstrap
    interval (BOOTSTRAP resamples of each side, numpy default_rng(0))."""
    from scipy.stats import mannwhitneyu
    lp, lj = np.log(np.asarray(port_r)), np.log(np.asarray(jax_r))
    p = float(mannwhitneyu(lp, lj, alternative='two-sided').pvalue)
    rng = np.random.default_rng(0)
    diffs = (lp[rng.integers(0, lp.size, (BOOTSTRAP, lp.size))].mean(1)
             - lj[rng.integers(0, lj.size, (BOOTSTRAP, lj.size))].mean(1))
    lo, hi = np.percentile(diffs, [2.5, 97.5])
    return {'p': p, 'diff': float(lp.mean() - lj.mean()),
            'interval': (float(lo), float(hi))}


def nis_lines(port_dir: str = PORT_DIR, jax_dir: str = JAX_DIR) -> List[str]:
    runs = ten_seed_runs(port_dir, jax_dir)
    r = {side: {s: nis_ratio(run) for s, run in sorted(by_seed.items())}
         for side, by_seed in runs.items()}
    out = ['NIS / off tail variance ratio r over ten seeds a side '
           '(bound < 0.92):']
    for side in ('port', 'jax'):
        fails = sum(v >= 0.92 for v in r[side].values())
        out.append(f'  {side}: ' + ', '.join(
            f'{s} {v:.3f}' for s, v in r[side].items())
            + f'; {fails} of {len(r[side])} fail the bound')
    d = nis_decision(list(r['port'].values()), list(r['jax'].values()))
    lo, hi = d['interval']
    out.append(f'  Mann-Whitney U of log r, two-sided: p = {d["p"]:.4f} '
               f'({"told apart" if d["p"] < ALPHA else "not told apart"} '
               f'at alpha {ALPHA}); mean log r port - JAX {d["diff"]:.4f}, '
               f'95 % bootstrap interval [{lo:.4f}, {hi:.4f}]')
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
        if name == 'toy_material_ab':
            # the port's other seeds, one chip call each
            runs.insert(1, ('port, seeds', os.path.join(
                args.dir, name + '_seeds_h100.json'), None))
            # the JAX script at the A/B's other seeds (tests/jax_ab_seed.py)
            runs += [(f'JAX CPU run, seed {seed}', os.path.join(
                args.dir, f'{name}_jax_cpu_seed{seed}.json'), seed)
                for seed in SEEDS_ON_JAX]
        for label, path, seed in runs:
            with open(path) as f:
                t = json.load(f)
            if seed is not None:
                t['random_seed'] = seed
            card = t.get('card') or next(
                (r['card'] for r in t.get('seeds', {}).values()
                 if r.get('card')), 'no card recorded')
            print(f'{name} ({label}; {card}):')
            print('\n'.join(lines(t)))
    print('\n'.join(nis_lines(args.dir, args.jax_dir)))


if __name__ == '__main__':
    main()
