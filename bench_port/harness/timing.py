"""Step boundaries and the statistics of the window."""
from __future__ import annotations

import time

import numpy as np
import torch


class Stamps:
    """A mark at the start of each step: a CUDA event recorded on the
    current stream (no synchronise), or the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def durations(self):
        """Seconds between consecutive marks; the last mark is the end of
        the window, not a step."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks[:-1], self.marks[1:])]
        return list(np.diff(self.marks))


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def percentile(values, q):
    """numpy's linear-interpolation percentile."""
    return float(np.percentile(np.asarray(values, np.float64), q))
