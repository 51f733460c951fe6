"""A run of the cell on the CPU at a tiny size, with the card's look
skipped: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault a training
cell on one chip can have (a step that leaves its state unchanged; half
of the batch left out, the mean taken over the rest).  The control, the
reference in TF32 in the program's place, needs the card: its test runs
there at the cell's own size."""
import os

import pytest
import torch

from conftest import BENCH, TINY_SHAPE, TINY_TRAFFIC, load

run = load(os.path.join(BENCH, 'run.py'), 'bench_run_cpu')
CELL = 'shape_hier_512'
# on the CPU the stencil head runs its plain version: no route to hold
TRAFFIC = {**TINY_TRAFFIC, 'route': None}


def _run(seed=4294967311, trace=0):
    return run.run_cell(CELL, seed, 0.1, trace, device='cpu',
                        overrides=TINY_SHAPE, traffic_over=TRAFFIC)


def test_sound_run_is_correct():
    res = _run()
    assert list(res) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'checks']
    assert res['correct'], res['checks']
    assert res['attempted'] == 2 and res['failed'] == 0
    assert set(res['metrics']) == {'train_rays_per_s', 'step_ms_p95',
                                   'setup_s'}
    for v in res['checks'].values():
        assert v['value'] <= v['limit']


def test_traced_run_reports_per_layer_metrics():
    res = _run(seed=7, trace=1)
    assert res['correct'], res['checks']
    assert 'step_mfu' in res['metrics']
    assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}
    assert {'busy_s', 'window_s'} <= set(res['device'])


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from tensoflow_tpu_torch.train import trainer as tr
    monkeypatch.setattr(tr.ScheduledAdam, 'step', lambda self: None)
    res = _run(seed=11)
    assert not res['correct']
    got = res['checks']['change_median']
    assert got['value'] > got['limit']


def test_half_batch_is_not_correct(monkeypatch):
    from tensoflow_tpu_torch.train import trainer as tr
    inner = tr.ShapeTrainer.train_step

    def half(self, step, batch, weights, noise, radiance_on, occ_on):
        rn = batch['rays_o'].shape[0]
        keep = rn // 2
        sn = noise['occ_score'].shape[0] // rn
        batch = {k: v[:keep] for k, v in batch.items()}
        noise = {'sample_jitter': noise['sample_jitter'][:keep],
                 'occ_score': noise['occ_score'][:keep * sn]}
        return inner(self, step, batch, weights, noise, radiance_on, occ_on)
    monkeypatch.setattr(tr.ShapeTrainer, 'train_step', half)
    res = _run(seed=13)
    assert not res['correct']
    assert res['checks']['loss']['value'] > \
        res['checks']['loss']['limit']


def test_jax_loaded_by_the_comparison_leaves_no_result(monkeypatch):
    """A module that may not be loaded, loaded by the reference or the
    comparison after the window, ends the run without a result."""
    import sys
    import types
    inner = run.spec_mod.load_module

    def load_module(path, name):
        mod = inner(path, name)
        if name.startswith('bench_check_'):
            checks = mod.checks

            def loads_jax(inputs, device):
                monkeypatch.setitem(sys.modules, 'jax',
                                    types.ModuleType('jax'))
                return checks(inputs, device)
            mod.checks = loads_jax
        return mod
    monkeypatch.setattr(run.spec_mod, 'load_module', load_module)
    with pytest.raises(SystemExit, match="'jax'"):
        _run(seed=17)


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(cuda_card):
    """At the cell's own size: the program within every limit, the
    reference in TF32 put in its place beyond at least one, and so the
    half-batch fault planted in the reference."""
    readings = load(os.path.join(BENCH, 'tests', 'readings.py'),
                    'bench_readings')
    check = load(os.path.join(BENCH, 'configs', 'shape_compressor',
                              'check.py'), 'bench_check_card')
    run.cache_dirs(run.ROOT)
    out = readings.seed_readings(CELL, 1234567891, True)
    lim = check.limits()
    compared = [k for k in check.COMPARED if k in out['control']]
    assert all(out['program'][k] <= lim[k] for k in check.COMPARED)
    for fault in ('control', 'half_batch'):
        assert any(out[fault][k] > lim[k] for k in compared
                   if k in out[fault]), out[fault]
    assert torch.cuda.is_available()
