"""The port's stage-2 training step against the plain reference of the
benchmark's ``mat_compressor`` configuration (bench_port/configs/
mat_compressor/reference.py, loaded by path), on the CPU at tiny widths.

A ``MaterialTrainer`` at configs/mat/syn/compressor.yaml, shrunk (32 hit
rays, 16 + 8 analytic and 8 + 4 flow samples, 32^3 material and flow
fields, bf16 estimator as published), traces an analytic two-lobe SDF
baked at 32^3 (so that secondary rays hit the other lobe) with budgets of
128 slots that the step's candidates overflow.  One step in each NIS
phase (none; the NIS loss; the NIS loss and sampling from the frozen
copies) runs through the trainer's own ``train_step``; the reference
follows it from the same state, batch and draws, tracing through the
tables it builds itself from the program's packed blocks.  Those tables
(mid and coarse cell rows, visibility cache) equal the program's exactly,
and a cache baked without the launch offset's apex pad does not.

Tolerances: the loss terms rtol 1e-5 (the same float32 and bf16 operations
in the forward, summed in another order where the reference gathers
instead of compacting); each leaf's gradient within 1e-4 of its largest
magnitude (the backward of the program's packed rows and compactions
sums in another order than the reference's plain indexing); the
parameters after Adam within 1e-6 absolute plus 1e-5 relative wherever
the gradient is at least 1e-3 of its leaf's largest, since Adam's first
update is lr * g / (|g| + eps) and a gradient near zero may round to
either sign.

The spans: one step under torch.profiler opens each stage-2 span, the
four layer spans disjoint inside ``tf.forward``; with no profiler the
path makes no profiler range.
"""
import math
import os

import pytest
import torch

from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.fields import mc_shading
from tensoflow_tpu_torch.models import material_renderer as mr
from tensoflow_tpu_torch.ops import sdf_trace
from tensoflow_tpu_torch.train import losses
from tensoflow_tpu_torch.train.checkpoints import named_leaves
from tensoflow_tpu_torch.train.trainer import ShapeTrainer
from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
from tensoflow_tpu_torch.utils import timing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, 'bench_port', 'configs', 'mat_compressor')
PN = 32
GEO = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
       'app_dim=8', 'N_voxel_init=4096', 'N_voxel_final=4096',
       'init_radius=0.5', 'sdf_multires=0', 'split_manul=false']
MAT = ['database_name=toy/sphere_16_2', f'train_ray_num={PN}',
       'bake_resolution=32', 'shader_cfg.diffuse_sample_num=16',
       'shader_cfg.specular_sample_num=8',
       'shader_cfg.nis_diffuse_sample_num=8',
       'shader_cfg.nis_specular_sample_num=4',
       'shader_cfg.grid_size=[32,32,32]', 'shader_cfg.light_reso=8',
       'shader_cfg.mat_n_comp=4', 'shader_cfg.secondary_budget=0.5',
       'shader_cfg.inner_light_budget=0.0625',
       'shader_cfg.a1_budget=0.375']
LOBES = ((-0.3, 0.0, 0.0), (0.3, 0.0, 0.0))
RADIUS = 0.45
# step index, phase flags (sample diffuse, sample specular, loss d, loss s)
PHASES = {'no_nis': (10, (False, False, False, False)),
          'nis_loss': (600, (False, False, True, True)),
          'nis_sample': (1000, (True, True, True, True))}
SPANS = ('tf.step', 'tf.forward', 'tf.backward', 'tf.mat_field', 'tf.flow',
         'tf.sec_trace', 'tf.lights')


def _ref():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'mat_reference', os.path.join(CONF, 'reference.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lobes_sdf(x):
    c = torch.tensor(LOBES, dtype=x.dtype)
    return (torch.linalg.norm(x[:, None, :] - c[None], dim=-1).min(-1)
            .values - RADIUS)[:, None]


def _surface_batch(seed):
    """PN points on the two lobes' outer surface, their normals, view
    rays from the outer side, colours."""
    g = torch.Generator().manual_seed(seed)
    pts, nrm = [], []
    while len(pts) < PN:
        k = len(pts) % 2
        n = torch.randn(3, generator=g)
        n = n / torch.linalg.norm(n)
        p = torch.tensor(LOBES[k]) + RADIUS * n
        other = torch.tensor(LOBES[1 - k])
        if torch.linalg.norm(p - other) > RADIUS + 0.02:
            pts.append(p)
            nrm.append(n)
    pts, nrm = torch.stack(pts), torch.stack(nrm)
    view = nrm + 0.6 * torch.randn((PN, 3), generator=g)
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True)
    view = torch.where(torch.sum(view * nrm, -1, keepdim=True) < 0.1,
                       nrm, view)
    return {'inters': pts, 'normals': nrm, 'rays_d': -view,
            'rgb': torch.rand((PN, 3), generator=g)}


@pytest.fixture(scope='module')
def geo_path(tmp_path_factory):
    cfg = pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml'),
        overrides=GEO)
    path = str(tmp_path_factory.mktemp('geo') / 'geo.pt')
    ShapeTrainer(cfg, device='cpu').save(path)
    return path


def _trainer(geo_path, seed=7):
    cfg = pconfig.load_config(os.path.join(CONF, 'compressor.yaml'),
                              overrides=MAT)
    cfg['random_seed'] = seed
    t = MaterialTrainer(cfg, geo_path, device='cpu')
    dense = sdf_trace.bake_sdf_grid(_lobes_sdf, t.rcfg.aabb,
                                    t.rcfg.bake_resolution)
    t.grid = sdf_trace.bake_vis_cache(sdf_trace.pack_sdf_grid(dense),
                                      apex_pad=2.0 * mr.unit_size(t.rcfg))
    return t


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _shader(scfg):
    return {k: getattr(scfg, k) for k in (
        'diffuse_sample_num', 'specular_sample_num',
        'nis_diffuse_sample_num', 'nis_specular_sample_num',
        'secondary_budget', 'inner_light_budget', 'a1_budget',
        'estimator_dtype', 'inner_light_exp_max', 'grid_size',
        'mat_n_comp', 'light_reso')}


@pytest.mark.parametrize('name', sorted(PHASES))
def test_step_matches_the_reference(geo_path, name):
    step, flags = PHASES[name]
    t = _trainer(geo_path)
    # the live flows a few Adam steps away from their init, and the
    # frozen copies taken then (as update_flow_copies takes them)
    g = torch.Generator().manual_seed(3)
    for key in ('flow_diffuse', 'flow_specular'):
        for _, leaf in named_leaves(t.params[key]):
            with torch.no_grad():
                leaf.add_(0.05 * torch.randn(leaf.shape, generator=g)
                          * leaf.abs().mean())
    phase = mc_shading.ShadePhase(*flags)
    if flags[0]:
        t.flow_copies = {'diffuse': _clone(t.params['flow_diffuse']),
                         'specular': _clone(t.params['flow_specular'])}
    batch = _surface_batch(11)
    noise = t.step_noise(step, phase)
    weights = losses.schedule_weights(t.cfg, step)
    before = _clone(t.params)
    shader = _shader(t.rcfg.shader)
    aux = t.train_step(step, batch, weights, noise, phase)
    prog_grads = {str(p): (x.grad.clone() if x.grad is not None
                           else torch.zeros_like(x))
                  for p, x in named_leaves(t.params)}
    prog_after = {str(p): x.detach() for p, x in named_leaves(t.params)}

    ref = _ref()
    pg = t.grid
    grid = ref.trace_grid(pg.blocks, pg.reso, pg.aabb,
                          2.0 * mr.unit_size(t.rcfg))
    leaves = [str(p) for p, _ in named_leaves(before)]
    state = {'params': before, 'copies': t.flow_copies, 'grid': grid,
             'aabb': pg.aabb, 'unit_size': mr.unit_size(t.rcfg),
             'opt': {'m': {k: torch.zeros_like(v) for k, v in
                           zip(leaves, [x for _, x in named_leaves(before)])},
                     'v': {k: torch.zeros_like(v) for k, v in
                           zip(leaves, [x for _, x in named_leaves(before)])},
                     't': {k: 0 for k in leaves}, 'count': 0,
                     'reset_step': 0}}
    logs, _, after, grads = ref.train_steps(
        t.cfg, state, [{'step': step, 'batch': batch, 'noise': noise,
                        'phase': phase._asdict(), 'weights': weights,
                        'shader': shader}], keep_grads=True)
    log = logs[0]

    n_rays = PN * (shader['diffuse_sample_num']
                   + (shader['nis_diffuse_sample_num'] if flags[0] else 0)
                   + (shader['nis_specular_sample_num'] if flags[1]
                      else shader['specular_sample_num']))
    slots = ref.budget_slots(n_rays, shader['secondary_budget'])
    assert log['secondary_cand_rate'] * n_rays > slots   # overflows
    assert log['secondary_hit_rate'] > 0.0
    for k in ('secondary_cand_rate', 'secondary_hit_rate',
              'secondary_a1_rate'):
        assert float(aux[k]) == pytest.approx(log[k], abs=0.5 / n_rays), k
    for k in ('loss', 'loss_rgb', 'loss_mat_reg', 'loss_diffuse_light',
              'loss_nis'):
        assert float(aux[k]) == pytest.approx(log[k], rel=1e-5, abs=1e-12), k
    if flags[2]:
        assert abs(log['loss_nis']) > 0.0

    for k in leaves:
        gr = grads[0].get(k, torch.zeros_like(prog_grads[k]))
        scale = float(gr.abs().max())
        gap = float((prog_grads[k] - gr).abs().max())
        assert gap <= 1e-4 * scale + 1e-12, (k, gap, scale)
        sure = gr.abs() >= 1e-3 * scale
        if scale > 0:
            d = (prog_after[k] - after[k]).abs()[sure]
            lim = (1e-6 + 1e-5 * after[k].abs())[sure]
            assert bool((d <= lim).all()), (k, float(d.max()))
    moved = [k for k in leaves if k.startswith("('flow")
             and float(grads[0].get(k, torch.zeros(1)).abs().max()) > 0]
    assert bool(moved) == flags[2]


def test_trace_tables_are_rebuilt_exactly(geo_path):
    t = _trainer(geo_path)
    pg, ref = t.grid, _ref()
    own = ref.trace_grid(pg.blocks, pg.reso, pg.aabb,
                         2.0 * mr.unit_size(t.rcfg))
    for k in ('mid_rows', 'coarse_rows', 'vis_rows'):
        assert torch.equal(getattr(pg, k), own[k]), k
    certified = int(torch.sum(own['vis_rows'] != 0))
    assert 0 < certified < own['vis_rows'].numel()
    # without the pad the cones are narrower and certify more bins
    loose = sdf_trace.bake_vis_cache(pg, apex_pad=0.0).vis_rows
    assert not torch.equal(loose, own['vis_rows'])


def test_spans_open_under_a_profiler(geo_path):
    from torch.profiler import ProfilerActivity, profile
    t = _trainer(geo_path)
    t.flow_copies = {'diffuse': _clone(t.params['flow_diffuse']),
                     'specular': _clone(t.params['flow_specular'])}
    batch = {k: v.numpy() for k, v in _surface_batch(5).items()}

    class OneBatch:
        def next_batch(self):
            return batch
    t.batcher = OneBatch()
    t.start_step = 1000
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.train(n_steps=1, log_every=1)
    ev = [e for e in prof.events() if e.name.startswith('tf.')]
    assert {e.name for e in ev} == set(SPANS)
    assert sum(e.name == 'tf.step' for e in ev) == 1
    layer = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in ev if e.name in SPANS[3:])
    for (_, e0, _), (s1, _, _) in zip(layer[:-1], layer[1:]):
        assert e0 <= s1                       # disjoint
    fwd = [e for e in ev if e.name == 'tf.forward'][0]
    assert all(fwd.time_range.start <= s and e <= fwd.time_range.end
               for s, e, _ in layer)


def test_spans_off_make_no_range(geo_path, monkeypatch):
    def no_record(*a, **k):
        raise AssertionError('a RecordFunction was made with no profiler')
    monkeypatch.setattr(timing, 'record_function', no_record)
    t = _trainer(geo_path)
    t.flow_copies = {'diffuse': _clone(t.params['flow_diffuse']),
                     'specular': _clone(t.params['flow_specular'])}
    phase = mc_shading.ShadePhase(True, True, True, True)
    aux = t.train_step(1000, _surface_batch(5),
                       losses.schedule_weights(t.cfg, 1000),
                       t.step_noise(1000, phase), phase)
    assert math.isfinite(float(aux['loss']))
    assert math.isfinite(float(aux['loss_nis']))
