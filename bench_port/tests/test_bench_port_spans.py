"""The readers of the program's spans (harness/spans.py and the seven
metrics that use it): the idle split on synthetic busy and span
intervals, the readers on a synthetic trace with and without the spans,
and a tiny traced run of the cell on the CPU, which records the spans and
still reports the per-layer metrics it reported before them."""
import os
from types import SimpleNamespace

import pytest

from conftest import BENCH, TINY_SHAPE, TINY_TRAFFIC, load

spans = load(os.path.join(BENCH, 'harness', 'spans.py'), 'bench_spans')
profile = load(os.path.join(BENCH, 'harness', 'profile.py'), 'bench_profile')
NEW = ('sampler_device_ms', 'gather_device_ms', 'shading_device_ms',
       'occ_loss_device_ms', 'forward_idle_ms', 'backward_idle_ms',
       'between_idle_ms')
readers = {m: load(os.path.join(BENCH, 'metrics', f'{m}.py'), f'm_{m}')
           for m in NEW}


def test_overlap_of_gaps_and_intervals():
    gl = [(5, 12), (14, 26), (28, 45)]
    assert spans.overlap(gl, [(10, 20)]) == 8
    assert spans.overlap(gl, [(0, 4), (46, 50)]) == 0
    assert spans.overlap(gl, [(0, 100)]) == 7 + 12 + 17


def test_gaps_are_split_by_overlap():
    # busy [0,5] [12,14] [26,28] [45,50]: gaps (5,12) (14,26) (28,45)
    merged = [[0, 5], [12, 14], [26, 28], [45, 50]]
    gl = spans.gaps(merged)
    assert gl == [(5, 12), (14, 26), (28, 45)]
    got = spans.split(gl, step=[(2, 40)], forward=[(10, 20)],
                      backward=[(20, 30)])
    # (5,12): 5 between + 2 forward; (14,26): 6 forward + 6 backward;
    # (28,45): 2 backward + 10 between + 5 outside
    assert got == {'forward': 8, 'backward': 8, 'between': 15,
                   'outside': 5}
    assert sum(got.values()) == sum(b - a for a, b in gl)


def test_gap_across_two_steps():
    got = spans.split([(3, 12), (15, 30)], step=[(0, 8), (10, 18)],
                      forward=[(0, 4), (10, 14)],
                      backward=[(4, 6), (14, 16)])
    assert got == {'forward': 3, 'backward': 3, 'between': 4,
                   'outside': 14}


# -- a synthetic trace: events as torch.profiler gives them ---------------

def _ev(name, start, end, thread=1, device='CPU', children=(),
        kernels=(), seq=-1, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        thread=thread, device_type=f'DeviceType.{device}',
        cpu_children=list(children), kernels=list(kernels),
        sequence_nr=seq, fwd_thread=thread,
        is_user_annotation=annotation)


def _trace(with_spans=True, n_steps=1, extra=()):
    """One step on thread 1: forward [10,50] (a gather op launching a
    kernel of 6 us), backward [50,80] on the engine's thread 2 (the
    gather's backward launching 4 us); device busy [12,18] [30,40]
    [55,59] [85,95]."""
    k_fwd = SimpleNamespace(duration=6.0)
    k_bwd = SimpleNamespace(duration=4.0)
    op = _ev('aten::index_select', 11, 12, kernels=[k_fwd], seq=7)
    bwd_op = _ev('aten::index_add_', 54, 55, thread=2, kernels=[k_bwd])
    bwd = _ev('autograd::engine::evaluate_function: IndexSelectBackward0',
              53, 56, thread=2, children=[bwd_op], seq=7)
    bwd.fwd_thread = 1
    events = [op, bwd, bwd_op]
    if with_spans:
        events += [
            _ev('tf.step', 0, 100, annotation=True),
            _ev('tf.forward', 10, 50, annotation=True),
            _ev('tf.gather', 11, 13, children=[op], annotation=True),
            _ev('tf.backward', 50, 80, annotation=True)]
    events += list(extra)
    for s, e in ((12, 18), (30, 40), (55, 59), (85, 95)):
        events.append(_ev('kernel', s, e, thread=7, device='CUDA'))
    prof = SimpleNamespace(events=lambda: events)
    return profile.Trace(prof, 100e-6, n_steps)


def _read(name, trace):
    return readers[name].read(SimpleNamespace(trace=trace))


def test_readers_on_a_trace_with_the_spans():
    tr = _trace(n_steps=2)
    # gaps (18,30) forward, (40,55) forward 10 + backward 5, (59,85)
    # backward 21 + between 5; per step of 2, in ms
    assert _read('forward_idle_ms', tr) == pytest.approx(22e-3 / 2)
    assert _read('backward_idle_ms', tr) == pytest.approx(26e-3 / 2)
    assert _read('between_idle_ms', tr) == pytest.approx(5e-3 / 2)
    assert spans.idle_split(tr)['outside'] == 0
    # the gather's kernel and its backward's, per step of 2, in ms
    assert _read('gather_device_ms', tr) == pytest.approx(10e-3 / 2)
    for m in ('sampler_device_ms', 'shading_device_ms',
              'occ_loss_device_ms'):
        assert _read(m, tr) is None


def test_spans_of_other_threads_do_not_count():
    """A range of the same name on another thread (the autograd engine's)
    changes no part of the split."""
    other = _ev('tf.forward', 59, 85, thread=2, annotation=True)
    assert (spans.idle_split(_trace(extra=[other]))
            == spans.idle_split(_trace()))


def test_split_without_the_backward_span():
    tr = _trace()
    tr.events = [e for e in tr.events if e.name != 'tf.backward']
    assert _read('backward_idle_ms', tr) is None
    assert _read('forward_idle_ms', tr) == pytest.approx(22e-3)
    # the backward's gaps fall to the rest of the step
    assert _read('between_idle_ms', tr) == pytest.approx(31e-3)


@pytest.mark.parametrize('metric', NEW)
def test_reader_without_its_span_reads_none(metric):
    assert _read(metric, None) is None
    assert _read(metric, _trace(with_spans=False)) is None


def test_idle_readers_without_a_device_read_none():
    tr = _trace()
    tr.merged = []
    for m in ('forward_idle_ms', 'backward_idle_ms', 'between_idle_ms'):
        assert _read(m, tr) is None


def test_cpu_traced_run_records_the_spans(monkeypatch):
    """The harness's traced run on the CPU: the spans are in its trace,
    no reader raises, and the per-layer metrics a CPU run reported before
    the spans are still reported (the device's need a card)."""
    run = load(os.path.join(BENCH, 'run.py'), 'bench_run_spans')
    traces = []

    class Keep(run.profile.Trace):
        def __init__(self, *a):
            super().__init__(*a)
            traces.append(self)
    monkeypatch.setattr(run.profile, 'Trace', Keep)
    res = run.run_cell('shape_hier_512', 2 ** 31 + 5, 0.1, 1, device='cpu',
                       overrides=TINY_SHAPE,
                       traffic_over={**TINY_TRAFFIC, 'route': None})
    assert res['correct'], res['checks']
    assert set(res['metrics']) == {'step_mfu'}
    (tr,) = traces
    for name in ('tf.step', 'tf.forward', 'tf.backward', 'tf.sampler',
                 'tf.gather', 'tf.shading', 'tf.occ_loss'):
        assert sum(e.name == name for e in tr.events) == tr.n_steps, name
    assert all(len(iv) == tr.n_steps
               for iv in spans.phase_intervals(tr).values())
