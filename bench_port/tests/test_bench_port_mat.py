"""The cell ``mat_nis_sample`` on the CPU at a tiny size, with the card's
look skipped: a sound run comes out correct; a traced run records the
stage-2 spans and reports the per-layer metrics a CPU run can read; and a
run with the timed path broken underneath comes out not correct, once for
each fault: the specular flow copy ignored (the GGX samples kept where it
samples), the Adam step skipped (the state left unchanged), half of the
batch, a visibility cache that certifies every cone clear.  A second run
in a checkout loads the geometry the first trained.  The control, the reference in TF32 in the program's place, needs
the card: its test runs there at the cell's own size, and so does a
traced run that reads the span metrics from the card's kernels."""
import os

import pytest
import torch

from conftest import BENCH, load

run = load(os.path.join(BENCH, 'run.py'), 'bench_run_mat')
CELL = 'mat_nis_sample'
# stage 2 and its geometry cut to a few rays, samples and texels
TINY_MAT = [
    'database_name=toy/sphere_32_4', 'train_ray_num=16', 'bake_resolution=32',
    'shader_cfg.diffuse_sample_num=16', 'shader_cfg.specular_sample_num=8',
    'shader_cfg.nis_diffuse_sample_num=8',
    'shader_cfg.nis_specular_sample_num=4',
    'shader_cfg.grid_size=[32,32,32]', 'shader_cfg.light_reso=8',
    'shader_cfg.mat_n_comp=4',
    'geo.database_name=toy/sphere_32_4', 'geo.sdf_n_comp=4',
    'geo.sdf_dim=32', 'geo.app_dim=16', 'geo.N_voxel_init=4096',
    'geo.N_voxel_final=4096', 'geo.init_radius=0.5', 'geo.sdf_multires=0',
    'geo.steps=0']
TRAFFIC = {'warmup_steps': 1, 'min_window_steps': 2,
           'trace_profiled_steps': 1}
NEW = ('flow_device_ms', 'sec_trace_device_ms', 'lights_device_ms',
       'mat_field_device_ms', 'sec_overflow_share')
SPANS = ('tf.step', 'tf.forward', 'tf.backward', 'tf.mat_field', 'tf.flow',
         'tf.sec_trace', 'tf.lights')


def _run(seed=4294967311, trace=0, device='cpu'):
    return run.run_cell(CELL, seed, 0.1, trace, device=device,
                        overrides=TINY_MAT, traffic_over=TRAFFIC)


def test_sound_run_is_correct():
    res = _run()
    assert res['correct'], res['checks']
    assert res['attempted'] == 2 and res['failed'] == 0
    assert set(res['metrics']) == {'train_rays_per_s', 'step_ms_p95',
                                   'setup_s'}
    assert res['checks']['init']['value'] == 0.0


def test_traced_run_records_the_spans(monkeypatch):
    traces = []

    class Keep(run.profile.Trace):
        def __init__(self, *a):
            super().__init__(*a)
            traces.append(self)
    monkeypatch.setattr(run.profile, 'Trace', Keep)
    res = _run(seed=7, trace=1)
    assert res['correct'], res['checks']
    # the device's readings need a card; these two read the program
    assert set(res['metrics']) == {'step_mfu', 'sec_overflow_share'}
    assert 0.0 <= res['metrics']['sec_overflow_share']['value'] <= 100.0
    (tr,) = traces
    for name in SPANS:
        assert sum(e.name == name for e in tr.events) >= tr.n_steps, name


def test_specular_copy_ignored_is_not_correct(monkeypatch):
    from tensoflow_tpu_torch.fields import mc_shading
    inner = mc_shading.shade_mixed

    def ggx_kept(params, cfg, grid, unit_size, aabb, pts, normals, view,
                 metallic, roughness, albedo, phase, *a, **k):
        return inner(params, cfg, grid, unit_size, aabb, pts, normals, view,
                     metallic, roughness, albedo,
                     phase._replace(nis_sample_specular=False), *a, **k)
    monkeypatch.setattr(mc_shading, 'shade_mixed', ggx_kept)
    res = _run(seed=11)
    assert not res['correct']
    assert res['checks']['loss']['value'] > res['checks']['loss']['limit']


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from tensoflow_tpu_torch.train import trainer as tr
    monkeypatch.setattr(tr.ScheduledAdam, 'step', lambda self: None)
    res = _run(seed=13)
    assert not res['correct']
    got = res['checks']['change_median']
    assert got['value'] > got['limit']


def test_half_batch_is_not_correct(monkeypatch):
    from tensoflow_tpu_torch.train import trainer_mat as tm
    inner = tm.MaterialTrainer.train_step

    def half(self, step, batch, weights, noise, phase):
        keep = batch['inters'].shape[0] // 2
        return inner(self, step, {k: v[:keep] for k, v in batch.items()},
                     weights, {k: v[:keep] for k, v in noise.items()}, phase)
    monkeypatch.setattr(tm.MaterialTrainer, 'train_step', half)
    res = _run(seed=17)
    assert not res['correct']
    assert res['checks']['loss']['value'] > res['checks']['loss']['limit']


def test_vis_cache_certifying_all_is_not_correct(monkeypatch):
    from tensoflow_tpu_torch.ops import sdf_trace
    inner = sdf_trace.bake_vis_cache

    def all_clear(pg, *a, **k):
        out = inner(pg, *a, **k)
        out.vis_rows = torch.full_like(out.vis_rows, (1 << 32) - 1)
        return out
    monkeypatch.setattr(sdf_trace, 'bake_vis_cache', all_clear)
    res = _run(seed=23)
    assert not res['correct']
    assert res['checks']['tables']['value'] > 0


def test_geometry_is_trained_once(monkeypatch):
    system = load(os.path.join(BENCH, 'configs', 'mat_compressor',
                               'system.py'), 'bench_system_mat_geo')
    mat, geo, steps = system.split_overrides(TINY_MAT)
    sut = system.System({}, 3, device='cpu', overrides=TINY_MAT)
    path = system.geometry_path(sut.cfg['geo_model_path'], sut.geo_cfg,
                                sut.geo_steps, sut.device)
    first, _ = sut._geometry()
    assert first == path and os.path.exists(path)
    from tensoflow_tpu_torch.train import trainer

    def no_training(*a, **k):
        raise AssertionError('the geometry was trained again')
    monkeypatch.setattr(trainer, 'ShapeTrainer', no_training)
    assert sut._geometry() == (path, False)


def test_readings_at_a_shrunk_size():
    """The readings script on the CPU: the program within every limit,
    each fault beyond at least one."""
    readings = load(os.path.join(BENCH, 'tests', 'readings_mat.py'),
                    'bench_readings_mat')
    check = load(os.path.join(BENCH, 'configs', 'mat_compressor',
                              'check.py'), 'bench_check_mat_cpu')
    out = readings.seed_readings(5, True, 'cpu', TINY_MAT,
                                 {**TRAFFIC, 'expect': {}})
    lim = check.limits()
    assert all(out['program'][k] <= lim[k] for k in check.COMPARED)
    for fault in readings.FAULTS:
        assert any(out[fault][k] > lim[k] for k in check.COMPARED
                   if k in out[fault]), out[fault]


@pytest.mark.cuda
def test_traced_run_on_the_card_reads_the_spans(cuda_card):
    run.cache_dirs(run.ROOT)
    res = _run(seed=19, trace=1, device='cuda')
    assert res['correct'], res['checks']
    for m in NEW + ('step_mfu', 'launches_per_step', 'device_idle_share'):
        assert m in res['metrics'], m


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(cuda_card):
    """At the cell's own size: the program within every limit, the
    reference in TF32 put in its place beyond at least one, and so each
    fault planted in the reference."""
    readings = load(os.path.join(BENCH, 'tests', 'readings_mat.py'),
                    'bench_readings_mat_card')
    check = load(os.path.join(BENCH, 'configs', 'mat_compressor',
                              'check.py'), 'bench_check_mat_card')
    run.cache_dirs(run.ROOT)
    out = readings.seed_readings(1234567891, True)
    lim = check.limits()
    assert all(out['program'][k] <= lim[k] for k in check.COMPARED)
    for fault in ('control',) + readings.FAULTS:
        assert any(out[fault][k] > lim[k] for k in check.COMPARED
                   if k in out[fault]), out[fault]
    assert torch.cuda.is_available()
