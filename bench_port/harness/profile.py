"""The profiled-step reader: a few training steps under torch.profiler,
taken after every unprofiled measurement (a profiler session taxes each
later launch by some microseconds).

From the trace it reads the device's busy time as the union of the
intervals of every device operation (kernels, copies, fills), the kernel
launches, the device time by kernel name, the idle gaps of the device
named by the host operator open when each began, and the device time of
the kernels launched inside a named ``record_function`` range together
with those of the backward ops that carry the sequence numbers of the
range's forward ops (so a layer's time is read whatever implements it,
never by kernel name).
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict


def _is_device(e) -> bool:
    return (str(e.device_type).endswith('CUDA')
            and not getattr(e, 'is_user_annotation', False))


def _is_copy(name: str) -> bool:
    return name.startswith(('Memcpy', 'Memset', 'memcpy', 'memset'))


def profile_run(run, sync):
    """``run()`` under torch.profiler (CPU and CUDA activities), then
    ``sync()``; returns (profiler, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    return prof, wall


def _union(intervals):
    """Merged (start, end) intervals and their total length."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged)


def _descendants(roots):
    out, stack = [], list(roots)
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(e.cpu_children)
    return out


def _kernel_us(events) -> float:
    return sum(k.duration for e in events for k in getattr(e, 'kernels', ()))


class Trace:
    """Readings of one profiled stretch of ``n_steps`` steps."""

    def __init__(self, prof, wall_s: float, n_steps: int):
        self.events = list(prof.events())
        self.n_steps = n_steps
        self.wall_s = wall_s
        dev = [e for e in self.events if _is_device(e)]
        self.device = dev
        self.kernels = [e for e in dev if not _is_copy(e.name)]
        self.merged, busy_us = _union(
            (e.time_range.start, e.time_range.end) for e in dev)
        self.busy_s = busy_us / 1e6
        self.cpu = [e for e in self.events
                    if not _is_device(e)
                    and not getattr(e, 'is_user_annotation', False)]

    def launches_per_step(self) -> float:
        return len(self.kernels) / self.n_steps

    def busy_s_per_step(self) -> float:
        return self.busy_s / self.n_steps

    def range_device_s(self, name: str):
        """Device seconds a step of the kernels launched inside every
        range ``name`` and inside the backward ops whose sequence numbers
        the range's forward ops carry; None when no range was recorded or
        no kernel was found under it."""
        roots = [e for e in self.events
                 if e.name == name and not _is_device(e)]
        if not roots:
            return None
        fwd = _descendants(roots)
        keys = {(e.thread, e.sequence_nr) for e in fwd
                if e.sequence_nr is not None and e.sequence_nr >= 0}
        bwd_roots = [e for e in self.cpu
                     if e.name.startswith('autograd::engine::evaluate_function')
                     and (e.fwd_thread, e.sequence_nr) in keys]
        seen = {id(e) for e in fwd}
        bwd = [e for e in _descendants(bwd_roots) if id(e) not in seen]
        us = _kernel_us(fwd) + _kernel_us(bwd)
        if us <= 0:
            return None
        return us / 1e6 / self.n_steps

    def top_device_ops(self, k: int = 10):
        by = defaultdict(float)
        for e in self.device:
            by[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        rows = sorted(by.items(), key=lambda r: -r[1])[:k]
        return [[n, s / self.n_steps] for n, s in rows]

    def idle_gaps(self, k: int = 10):
        """The device's idle gaps inside the traced stretch, summed by the
        innermost host operator open when each gap began (a step's
        share, seconds), largest first."""
        ops = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in self.cpu
                     if not e.name.startswith(('cuda', 'cu', 'ProfilerStep')))
        by = defaultdict(float)
        heap, j = [], 0
        for (_, a), (b, _) in zip(self.merged[:-1], self.merged[1:]):
            while j < len(ops) and ops[j][0] <= a:
                heapq.heappush(heap, (-ops[j][0], ops[j][1], ops[j][2]))
                j += 1
            # the latest-started op still open at a is the innermost
            while heap and heap[0][1] < a:
                heapq.heappop(heap)
            by[heap[0][2] if heap else 'no host operator'] += (b - a) / 1e6
        rows = sorted(by.items(), key=lambda r: -r[1])[:k]
        return [[n, s / self.n_steps] for n, s in rows]

    def breakdown(self):
        return {'device_ops': self.top_device_ops(),
                'idle_gaps': self.idle_gaps()}
