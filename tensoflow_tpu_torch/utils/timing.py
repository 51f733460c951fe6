"""Timing, profiling and log helpers of the port (counterpart of
tensoflow_tpu/utils/timing.py; ref: utils/base_utils.py:29-50,
train/train_tools.py:93-108):
  * ``Timing``: a wall-clock block timer that waits for the card
    (``torch.cuda.synchronize``) when a tensor handed to ``sync_on`` lies
    on it;
  * ``profile_trace``: ``torch.profiler`` over the block, which
    writes a Chrome trace (chrome://tracing, Perfetto) under ``logdir``;
  * ``TrainLogger``: append-only text logs per split.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class Timing:
    """``with Timing('name') as t: ... t.sync_on(x)`` prints the block's
    elapsed ms, after the card has finished the work behind ``x``."""

    def __init__(self, name: str, enabled: bool = True):
        self.name = name
        self.enabled = enabled
        self._sync_targets = []

    def sync_on(self, *tensors):
        self._sync_targets.extend(tensors)
        return tensors[0] if len(tensors) == 1 else tensors

    def __enter__(self):
        if self.enabled:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            for dev in {t.device for t in self._sync_targets
                        if torch.is_tensor(t) and t.device.type == 'cuda'}:
                torch.cuda.synchronize(dev)
            dt = (time.perf_counter() - self.t0) * 1000
            print(f'[timing] {self.name}: {dt:.2f} ms', flush=True)
        return False


@contextlib.contextmanager
def profile_trace(logdir: str = 'data/profiles', enabled: bool = True):
    """torch.profiler over the block (host operators, and the card's
    kernels when CUDA is available); the Chrome trace goes to
    <logdir>/trace.json."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
    print(f'[profiler] trace written to {logdir}', flush=True)


class TrainLogger:
    """Append-only txt logs per split (ref: train/train_tools.py:93-108)."""

    def __init__(self, model_dir: str):
        os.makedirs(model_dir, exist_ok=True)
        self.model_dir = model_dir

    def log(self, results: dict, prefix: str = 'train', step: int = 0,
            verbose: bool = False):
        msg = f'step {step} ' + ' '.join(
            f'{k}={v:.5g}' if isinstance(v, float) else f'{k}={v}'
            for k, v in results.items())
        with open(os.path.join(self.model_dir, f'{prefix}.txt'), 'a') as f:
            f.write(msg + '\n')
        if verbose:
            print(msg, flush=True)
