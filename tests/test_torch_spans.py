"""The port's spans inside the stage-1 training step
(``utils/timing.span``): one tiny step on the CPU under torch.profiler
opens each ``tf.*`` span once, nested as the benchmark's readers expect,
on the hierarchical sampler (both stencil routes) and on the occupancy
grid; with no profiler active a span is one shared null context; and the
operator's ``profile_trace`` writes the spans into its Chrome trace.
"""
import contextlib
import json
import os

import pytest
import torch

from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.train.trainer import ShapeTrainer
from tensoflow_tpu_torch.utils import timing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
        'app_dim=8', 'N_voxel_init=4096', 'N_voxel_final=4096',
        'train_ray_num=16', 'occ_loss_max_pn=16', 'upsample_list=null',
        'init_radius=0.5', 'occ_loss_step=0', 'split_manul=false']
ROUTES = {
    'hierarchical': ('compressor.yaml', ['n_samples=8', 'n_importance=8',
                                         'update_AlphaMask_lst=null']),
    'hierarchical_split': ('compressor.yaml', [
        'n_samples=8', 'n_importance=8', 'update_AlphaMask_lst=null',
        'stencil_impl=xla']),
    'occupancy_grid': ('compressor_occ.yaml', ['occ_grid_reso=8',
                                               'occ_max_samples=16']),
}
# each span and the span it opens under
PARENTS = {'tf.step': None, 'tf.forward': 'tf.step',
           'tf.backward': 'tf.step', 'tf.sampler': 'tf.forward',
           'tf.gather': 'tf.forward', 'tf.shading': 'tf.forward',
           'tf.occ_loss': 'tf.forward'}


def _trainer(route):
    yaml, over = ROUTES[route]
    cfg = pconfig.load_config(os.path.join(ROOT, 'configs/shape/syn', yaml),
                              overrides=TINY + over)
    trainer = ShapeTrainer(cfg, device='cpu')
    trainer.init_dataset()
    return trainer


def _span_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith('tf.'):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_one_step_opens_each_span_once(route):
    from torch.profiler import ProfilerActivity, profile
    trainer = _trainer(route)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train(n_steps=1, log_every=1)
    spans = [e for e in prof.events() if e.name.startswith('tf.')]
    assert sorted(e.name for e in spans) == sorted(PARENTS)
    assert {e.name: _span_parent(e) for e in spans} == PARENTS
    assert len({e.thread for e in spans}) == 1


def test_span_off_is_one_null_context(monkeypatch):
    def no_record(*a, **k):
        raise AssertionError('a RecordFunction was made with no profiler')
    monkeypatch.setattr(timing, 'record_function', no_record)
    first = timing.span('tf.step')
    assert isinstance(first, contextlib.nullcontext)
    assert all(timing.span(n) is first for n in PARENTS)
    with timing.span('tf.forward'):
        pass


def test_span_on_is_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span('tf.step') as s:
            torch.ones(4).sum()
    assert s is not None
    (e,) = [e for e in prof.events() if e.name == 'tf.step']
    assert {c.name for c in e.cpu_children} >= {'aten::sum'}
    assert timing.span('tf.step') is timing.span('tf.forward')


def test_profile_trace_holds_the_step_spans(tmp_path):
    """Two steps: one ``tf.step`` range a step, in order (a step's index
    is its range's place), each holding its own forward."""
    trainer = _trainer('hierarchical')
    with timing.profile_trace(str(tmp_path / 'tr')):
        trainer.train(n_steps=2, log_every=1)
    trace = json.load(open(tmp_path / 'tr' / 'trace.json'))
    names = {e.get('name') for e in trace['traceEvents']}
    assert set(PARENTS) <= names
    ranges = {n: sorted((e['ts'], e['ts'] + e['dur'])
                        for e in trace['traceEvents'] if e.get('name') == n)
              for n in ('tf.step', 'tf.forward')}
    steps, fwds = ranges['tf.step'], ranges['tf.forward']
    assert len(steps) == len(fwds) == 2
    assert steps[0][1] <= steps[1][0]
    assert all(s <= f0 and f1 <= e for (s, e), (f0, f1) in zip(steps, fwds))
