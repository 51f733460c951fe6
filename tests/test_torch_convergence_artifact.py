"""Holds the port's committed evidence artifacts (tensoflow_tpu_torch/
assets/convergence/*_h100.json, written on an NVIDIA H100 by
tensoflow_tpu_torch/scripts/{convergence_run,convergence_mat,ab_material}.py
at the JAX scripts' defaults) to

  * every bound of tests/test_convergence_artifact.py, unchanged (its
    three tests, verbatim but for the file they read; the A/B test's
    bounds one case each, so that each is read whatever the others do);
  * bands around the JAX artifacts in data/convergence/: the final val
    PSNR of the blobs run within 2 dB and its final Chamfer at most 1.5x;
    the material run's final stage-1 PSNR within 2 dB and the mean stage-2
    PSNR of its last 5 logs within 3 dB; each A/B arm's val PSNR within
    2 dB;
  * the run's record: every key of the JAX artifact, the card (an NVIDIA
    card), the JAX scripts' step counts and seeds;
  * the NIS A/B over ten seeds a side (6033-6042): the port's ratio of the
    two arms' tail variances against the JAX script's, by a two-sided
    Mann-Whitney U test of log r at alpha 0.05.

Reads only JSON: no training runs here.
"""
import json
import os

import numpy as np
import pytest

from tensoflow_tpu_torch.scripts import record

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART_DIR = os.path.join(ROOT, 'tensoflow_tpu_torch', 'assets', 'convergence')
JAX_DIR = os.path.join(ROOT, 'data', 'convergence')
ART = os.path.join(ART_DIR, 'blobs_convergence_h100.json')
MAT_ART = os.path.join(ART_DIR, 'toy_material_convergence_h100.json')
AB_ART = os.path.join(ART_DIR, 'toy_material_ab_h100.json')
AB_SEEDS_ART = os.path.join(ART_DIR, 'toy_material_ab_seeds_h100.json')
TEN_SEEDS = list(range(6033, 6043))
# port artifact -> the JAX artifact it answers
JAX_OF = {ART: 'blobs_convergence.json',
          MAT_ART: 'toy_material_convergence.json',
          AB_ART: 'toy_material_ab.json'}


def _load(path):
    with open(path) as f:
        return json.load(f)


def _jax(path):
    return _load(os.path.join(JAX_DIR, JAX_OF[path]))


def test_convergence_trajectory_bounds():
    with open(ART) as f:
        t = json.load(f)
    meta = t['meta']
    assert meta['upsample_list'] == [1200, 2400]
    assert meta['phases']['occ_loss_on'] == 1500
    marks = t['chamfer']
    assert [m['step'] for m in marks] == [600, 1200, 1800, 2400, 3000,
                                          3600]
    # both upsample boundaries were actually crossed
    grids = [m['grid'][0] for m in marks]
    assert grids[0] < 200 and 200 < grids[3] < 400 and grids[-1] > 400, \
        grids
    # geometry improves through the schedule: final Chamfer beats the
    # first checkpoint by >=20% and is the best of the run's tail
    chams = [m['chamfer'] for m in marks]
    assert np.isfinite(chams).all(), chams
    assert chams[-1] < 0.8 * chams[0], chams
    assert chams[-1] == min(chams), chams
    # rendering stays converged after warmup (val on held-out views)
    vals = [m['val_psnr'] for m in marks]
    assert min(vals) > 18.0, vals
    assert max(vals) > 23.0, vals
    # per-step logs cover the whole run and the losses stayed finite
    steps = t['steps']
    assert steps[-1]['step'] == 3600
    assert all(np.isfinite(r['loss']) for r in steps)
    # occ loss became active on schedule
    occ_rows = [r for r in steps if r['step'] > 1600 and 'loss_occ' in r]
    assert occ_rows, 'occ-loss phase never appeared in logs'


def test_material_convergence_trajectory_bounds():
    with open(MAT_ART) as f:
        t = json.load(f)
    assert t['mat_steps'] == 1500 and t['nis_start_iter'] == 300
    traj = t['trajectory']
    steps = [m['step'] for m in traj]
    assert steps[-1] == 1500 and len(traj) >= 20
    ps = [m['psnr'] for m in traj]
    vs = [m['variance'] for m in traj]
    assert np.isfinite(ps).all() and np.isfinite(vs).all()
    # stage-1 geometry converged before baking
    assert t['stage1_psnr'][1] > t['stage1_psnr'][0] + 5.0
    # material stage converges and stays converged THROUGH the NIS
    # phase flips (sampling on, copy refreshes each update interval)
    first = np.mean(ps[:3])
    tail = np.mean(ps[-5:])
    assert tail > first + 4.0, (first, tail)
    assert max(ps) > 20.0, max(ps)
    # no post-NIS collapse: the worst post-NIS psnr stays above the
    # pre-NIS start
    post = [p for s, p in zip(steps, ps) if s > 300]
    assert min(post) > first, (first, min(post))


def _tail_mean(t, name, key):
    tr = t['arms'][name]['trajectory']
    vals = [m[key] for m in tr if m['step'] >= 600]
    assert len(vals) >= 5
    return float(np.mean(vals))


def _ab_arms_converge(t):
    # all arms converge
    for name, arm in t['arms'].items():
        assert arm['val_psnr'] > 18.0, (name, arm['val_psnr'])


def _ab_nis_variance(t):
    # (1) NIS variance reduction at matched budgeted config
    v_on = _tail_mean(t, 'budgeted_nis', 'variance')
    v_off = _tail_mean(t, 'budgeted_nis_off', 'variance')
    assert np.isfinite(v_on) and np.isfinite(v_off)
    assert v_on < 0.92 * v_off, (v_on, v_off)


def _ab_nis_psnr(t):
    # and no PSNR cost for the variance win
    arms = t['arms']
    assert arms['budgeted_nis']['val_psnr'] > \
        arms['budgeted_nis_off']['val_psnr'] - 0.5


def _ab_budget_psnr(t):
    # (2) budgeted trace matches dense on converged quality
    arms = t['arms']
    assert arms['budgeted_nis']['val_psnr'] > \
        arms['dense_nis']['val_psnr'] - 0.5


def _ab_budget_deltas(t):
    deltas = t['material_map_mean_abs_delta']['budgeted_vs_dense']
    for k, v in deltas.items():
        assert v < 0.06, (k, v)


def _ab_metallic_scale(t):
    # scale reference: the one-switch NIS arm moves the maps MORE than
    # the trace switch does (the budget is not the dominant error)
    deltas = t['material_map_mean_abs_delta']
    assert deltas['budgeted_vs_dense']['metallic'] < \
        deltas['nis_vs_off']['metallic']


@pytest.mark.parametrize('bound', [
    _ab_arms_converge, _ab_nis_variance, _ab_nis_psnr, _ab_budget_psnr,
    _ab_budget_deltas, _ab_metallic_scale],
    ids=['arms_converge', 'nis_variance', 'nis_psnr', 'budget_psnr',
         'budget_deltas', 'metallic_scale'])
def test_material_ab_nis_and_budget_bounds(bound):
    """The JAX test's A/B bounds, one case each, on the port's 6033 arms.

    (1) NIS A/B — the paper's core claim: with the flows sampling, the
        per-sample estimator variance at matched steps/config drops and
        converged PSNR does not regress.
    (2) budgeted-vs-dense trace A/B — converged PSNR and the recovered
        material maps match between the production budgeted trace and
        the dense full-fidelity trace."""
    with open(AB_ART) as f:
        t = json.load(f)
    bound(t)


def _jax_seed_files():
    """{seed: path} of the JAX A/B script's runs on the CPU
    (tests/jax_ab_seed.py), as committed."""
    pre, suf = 'toy_material_ab_jax_cpu_seed', '.json'
    return {int(n[len(pre):-len(suf)]): os.path.join(ART_DIR, n)
            for n in os.listdir(ART_DIR)
            if n.startswith(pre) and n.endswith(suf)}


def _ten_seed_runs():
    """The A/B runs at TEN_SEEDS, each side: the port's 6033 arms and
    6034-6035 (toy_material_ab_h100.json), the rest on the card
    (toy_material_ab_seeds_h100.json); JAX's 6033 (its CPU artifact) and
    the JAX script's runs at the rest."""
    ab = _load(AB_ART)
    port = {ab['random_seed']: ab,
            **{int(s): r for s, r in ab['seeds'].items()},
            **{int(s): r for s, r in _load(AB_SEEDS_ART)['seeds'].items()}}
    jax = {6033: _jax(AB_ART),
           **{s: _load(p) for s, p in _jax_seed_files().items()}}
    return port, jax


def _nis_ratio(run):
    return (_tail_mean(run, 'budgeted_nis', 'variance')
            / _tail_mean(run, 'budgeted_nis_off', 'variance'))


def _ten_seeds_each_side():
    port, jax = _ten_seed_runs()
    assert sorted(port) == TEN_SEEDS and sorted(jax) == TEN_SEEDS
    assert sorted(_jax_seed_files()) == TEN_SEEDS[1:]
    t = _load(AB_SEEDS_ART)
    assert sorted(t['seeds']) == [str(s) for s in TEN_SEEDS[3:]]
    assert t['mat_steps'] == 1500
    want = {k: _jax(AB_ART)[k] for k in ('arms', 'material_map_mean_abs_delta')}
    for seed, run in t['seeds'].items():
        assert not record.missing_keys(want, run), seed
        assert run['card'].startswith('NVIDIA H100') and \
            run['card'].endswith(' W'), (seed, run['card'])
        assert run['device'].startswith('cuda') and run['git_commit'], seed
        assert all(v > 0 for v in run['phase_wall_s'].values()), seed
    for seed, run in jax.items():
        assert run['mat_steps'] == 1500, seed
        assert run['arms'].keys() == want['arms'].keys(), seed


def _ratio_distributions_agree():
    from scipy.stats import mannwhitneyu
    from tensoflow_tpu_torch.scripts import summary
    port, jax = _ten_seed_runs()
    lp = np.log([_nis_ratio(port[s]) for s in TEN_SEEDS])
    lj = np.log([_nis_ratio(jax[s]) for s in TEN_SEEDS])
    assert np.isfinite(lp).all() and np.isfinite(lj).all()
    p = mannwhitneyu(lp, lj, alternative='two-sided').pvalue
    # the figure scripts/summary.py prints, and PERF.md states
    assert summary.nis_decision(np.exp(lp), np.exp(lj))['p'] == \
        pytest.approx(p, rel=1e-12)
    assert p >= 0.05, (p, np.exp(lp), np.exp(lj))


@pytest.mark.parametrize('check', [_ten_seeds_each_side,
                                   _ratio_distributions_agree],
                         ids=['ten_seeds', 'mann_whitney'])
def test_nis_ratio_distribution_against_jax(check):
    """The NIS A/B's ratio r (the NIS arm's tail variance over the arm
    without NIS, logged steps >= 600) at the ten seeds 6033-6042 on each
    side, recomputed from the committed files: the port's (on the card)
    and the JAX script's (on a CPU) are not told apart by a two-sided
    Mann-Whitney U test of log r at alpha 0.05."""
    check()


def _band_blobs(t, j):
    val, ref = t['chamfer'][-1], j['chamfer'][-1]
    assert abs(val['val_psnr'] - ref['val_psnr']) <= 2.0, (val, ref)
    assert val['chamfer'] <= 1.5 * ref['chamfer'], (val, ref)


def _band_material(t, j):
    assert abs(t['stage1_psnr'][1] - j['stage1_psnr'][1]) <= 2.0, \
        (t['stage1_psnr'], j['stage1_psnr'])
    tail = np.mean([m['psnr'] for m in t['trajectory'][-5:]])
    ref = np.mean([m['psnr'] for m in j['trajectory'][-5:]])
    assert abs(tail - ref) <= 3.0, (tail, ref)


def _band_ab(t, j):
    assert t['arms'].keys() == j['arms'].keys()
    for name, arm in t['arms'].items():
        ref = j['arms'][name]['val_psnr']
        assert abs(arm['val_psnr'] - ref) <= 2.0, (name, arm['val_psnr'],
                                                   ref)


@pytest.mark.parametrize('path,band', [(ART, _band_blobs),
                                       (MAT_ART, _band_material),
                                       (AB_ART, _band_ab)],
                         ids=['blobs', 'material', 'ab'])
def test_port_tracks_the_jax_artifact(path, band):
    band(_load(path), _jax(path))


def _defaults_blobs(t):
    assert t['meta']['total'] == 3600 and t['meta']['scene'] == \
        'toy/blobs_96_12'


def _defaults_material(t):
    assert (t['shape_steps'], t['mat_steps']) == (500, 1500)


def _defaults_ab(t):
    assert t['mat_steps'] == 1500 and t['random_seed'] == 6033
    assert sorted(t['seeds']) == ['6034', '6035']
    for seed, run in t['seeds'].items():
        assert run['arms'].keys() == t['arms'].keys(), seed
        assert not record.missing_keys(
            {k: _jax(AB_ART)[k] for k in ('arms',
                                          'material_map_mean_abs_delta')},
            run), seed


@pytest.mark.parametrize('path,defaults', [(ART, _defaults_blobs),
                                           (MAT_ART, _defaults_material),
                                           (AB_ART, _defaults_ab)],
                         ids=['blobs', 'material', 'ab'])
def test_artifact_records_the_run(path, defaults):
    """Every key of the JAX artifact, an NVIDIA card with its power limit,
    the device, the commit, the phases' wall clock and launches, the JAX
    scripts' step counts and seeds."""
    t = _load(path)
    assert record.missing_keys(_jax(path), t) == []
    assert t['card'].startswith('NVIDIA ') and t['card'].endswith(' W'), \
        t['card']
    assert t['device'].startswith('cuda') and t['git_commit']
    assert t['phase_wall_s'] and all(v > 0 for v in t['phase_wall_s'].values())
    assert sum(n['stencil_head_fwd'] for n in t['launches'].values()) > 0
    defaults(t)


def test_summary_reads_every_artifact(capsys):
    """python -m tensoflow_tpu_torch.scripts.summary, which PERF.md's
    figures of these runs come from, reads the port's and the JAX
    artifacts, the A/B runs at seeds 6034-6042 on both sides, and prints
    the ten ratios a side with the Mann-Whitney p and its interval."""
    from tensoflow_tpu_torch.scripts import summary
    summary.main([])
    out = capsys.readouterr().out
    for name in ('blobs_convergence', 'toy_material_convergence',
                 'toy_material_ab'):
        assert f'{name} (port; NVIDIA ' in out
        assert f'{name} (JAX CPU artifact;' in out
    for seed in ('6033', '6034', '6035'):
        assert f'seed {seed}: val PSNR' in out
    for seed in map(str, TEN_SEEDS[1:]):
        assert f'toy_material_ab (JAX CPU run, seed {seed};' in out
    for seed in map(str, TEN_SEEDS[3:]):
        assert f'seed {seed}: val PSNR' in out
    assert 'toy_material_ab (port, seeds; NVIDIA H100' in out
    port, jax = _ten_seed_runs()
    for side, runs in (('port', port), ('jax', jax)):
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f'  {side}: 6033 '))
        for seed in TEN_SEEDS:
            assert f'{seed} {_nis_ratio(runs[seed]):.3f}' in line, \
                (side, seed)
    assert 'Mann-Whitney U of log r, two-sided: p = ' in out
    assert '95 % bootstrap interval [' in out
    assert '3,600 steps: ' in out and 'rays/s' in out
