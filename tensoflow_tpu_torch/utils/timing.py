"""Timing, profiling and log helpers of the port (counterpart of
tensoflow_tpu/utils/timing.py; ref: utils/base_utils.py:29-50,
train/train_tools.py:93-108):
  * ``span``: a named profiler range inside the training step (the
    ``tf.*`` spans), recorded only while a profiler session is active
    (``recording``);
  * ``profile_trace``: ``torch.profiler`` over the block, which
    writes a Chrome trace (chrome://tracing, Perfetto) under ``logdir``,
    the spans included;
  * ``TrainLogger``: append-only text logs per split;
  * ``launch_counter``: the registry of the hand-written kernels' launch
    counters (``LAUNCH_COUNTERS``), which a replayed CUDA graph credits
    (train/engine.StepGraph).
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function


# the one context every span returns while no profiler records
_NO_SPAN = contextlib.nullcontext()

# the launch counters ({kernel: launches}, each bumped by its launcher) of
# the port's hand-written kernels, in the order their modules registered
LAUNCH_COUNTERS = []


def launch_counter(counts: dict) -> dict:
    """Register a kernel module's launch counter; returns it."""
    LAUNCH_COUNTERS.append(counts)
    return counts


def recording() -> bool:
    """Whether a profiler session records (the spans record then, and the
    stage-1 step runs eagerly, so that its ranges are there to read)."""
    return _profiler_enabled()


def span(name: str):
    """A named ``torch.profiler.record_function`` range over the block
    while a profiler session records; otherwise one shared null context,
    so that a span off costs one check of the profiler's state."""
    if not _profiler_enabled():
        return _NO_SPAN
    return record_function(name)


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
