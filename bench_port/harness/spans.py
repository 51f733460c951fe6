"""The program's own spans in a profiled stretch: the ``tf.*`` ranges the
port opens inside its training step (``tensoflow_tpu_torch/utils/
timing.py`` ``span``), on the same clock as the device's records.

* Device time under a span: ``Trace.range_device_s``, the kernels
  launched inside the span and inside the backward ops that carry its
  forward ops' sequence numbers.
* The device's idle time by phase of the step: the idle gaps are the
  spaces between the busy intervals of ``Trace.merged``, as
  ``Trace.idle_gaps`` takes them.  Each gap is split by its overlap with
  the spans: the part inside ``tf.forward``, the part inside
  ``tf.backward``, the part inside ``tf.step`` and outside both
  (``between``), and the part outside every ``tf.step`` (``outside``).
  ``tf.forward`` and ``tf.backward`` are disjoint and lie inside
  ``tf.step``, so the four add up to the gaps.  Only the spans of the
  thread that opened ``tf.step`` count: the backward's kernels are
  launched from the autograd engine's thread, while the training thread
  waits inside ``tf.backward``.

Every reading is in ms a profiled step, or None where the span it needs
was not recorded or no device operation was.
"""
from __future__ import annotations

STEP, FORWARD, BACKWARD = 'tf.step', 'tf.forward', 'tf.backward'
# the span each part of the idle split needs
NEEDS = {'forward': FORWARD, 'backward': BACKWARD, 'between': STEP}


def phase_intervals(trace):
    """{span: [(start, end)]} of ``tf.step``, ``tf.forward`` and
    ``tf.backward`` on the threads that opened ``tf.step``, in one pass
    over the trace."""
    host = [e for e in trace.events
            if e.name in (STEP, FORWARD, BACKWARD)
            and str(e.device_type).endswith('CPU')]
    threads = {e.thread for e in host if e.name == STEP}
    return {name: sorted((e.time_range.start, e.time_range.end)
                         for e in host
                         if e.name == name and e.thread in threads)
            for name in (STEP, FORWARD, BACKWARD)}


def gaps(merged):
    """The spaces between consecutive busy intervals."""
    return [(a, b) for (_, a), (b, _) in zip(merged[:-1], merged[1:])]


def overlap(gap_list, intervals):
    """The length of the gaps inside the disjoint ``intervals``."""
    return sum(max(0.0, min(b, e) - max(a, s))
               for s, e in intervals for a, b in gap_list)


def split(gap_list, step, forward, backward):
    """The length of the gaps in each part of the steps: inside
    ``forward``, inside ``backward``, inside ``step`` and outside both,
    and outside every ``step``; the parts sum to the gaps' length."""
    fwd, bwd = overlap(gap_list, forward), overlap(gap_list, backward)
    in_step = overlap(gap_list, step)
    return {'forward': fwd, 'backward': bwd,
            'between': in_step - fwd - bwd,
            'outside': sum(b - a for a, b in gap_list) - in_step}


def idle_split(trace):
    """{'forward', 'backward', 'between', 'outside'}: the device's idle
    ms a profiled step in each part of the step, None for a part whose
    span was not recorded; None without a ``tf.step`` or without a
    device operation."""
    if trace is None or not trace.merged:
        return None
    iv = phase_intervals(trace)
    if not iv[STEP]:
        return None
    us = split(gaps(trace.merged), iv[STEP], iv[FORWARD], iv[BACKWARD])
    return {k: v / 1e3 / trace.n_steps
            if k not in NEEDS or iv[NEEDS[k]] else None
            for k, v in us.items()}


def idle_ms(trace, part):
    """The idle ms a profiled step of one part of ``idle_split``."""
    parts = idle_split(trace)
    return None if parts is None else parts[part]


def device_ms(trace, name):
    """Device ms a profiled step under span ``name``, forward and
    backward (``Trace.range_device_s``); None without it."""
    if trace is None:
        return None
    s = trace.range_device_s(name)
    return None if s is None else s * 1e3
