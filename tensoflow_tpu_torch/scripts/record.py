"""What every evidence artifact records beside the JAX artifact's keys (the
card, the device, the commit, the wall clock and the stencil kernels'
launches of each phase), and the checks its readers make of it."""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card_name(device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them; None on
    the CPU."""
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return out.stdout.strip().splitlines()[index]


def git_commit() -> Optional[str]:
    """HEAD of the checkout the package runs from; None outside git."""
    try:
        out = subprocess.run(['git', 'rev-parse', 'HEAD'], cwd=ROOT,
                             capture_output=True, text=True, timeout=30)
    except OSError:
        return None
    return out.stdout.strip() if out.returncode == 0 else None


class PhaseClock:
    """Wall clock (the device synchronised at both ends) and stencil kernel
    launches (ops/stencil.LAUNCHES), summed by phase name; ``last_s`` is
    the seconds of the phase that ended last."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.wall_s: Dict[str, float] = {}
        self.last_s = 0.0
        self.launches: Dict[str, Dict[str, int]] = {}

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        from tensoflow_tpu_torch.ops import stencil
        self._sync()
        before = dict(stencil.LAUNCHES)
        t0 = time.perf_counter()
        yield
        self._sync()
        self.last_s = time.perf_counter() - t0
        self.wall_s[name] = self.wall_s.get(name, 0.0) + self.last_s
        acc = self.launches.setdefault(name, dict.fromkeys(before, 0))
        for k, n in stencil.LAUNCHES.items():
            acc[k] += n - before[k]


def run_info(device, clock: PhaseClock, card: Optional[str],
             commit: Optional[str]) -> Dict[str, Any]:
    """The keys every port artifact adds to the JAX artifact's."""
    return {'card': card, 'device': str(device),
            'git_commit': commit if commit else git_commit(),
            'phase_wall_s': {k: round(v, 3) for k, v in clock.wall_s.items()},
            'launches': clock.launches}


def write_json(path: str, record: Dict[str, Any]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(record, f, indent=1)


def missing_keys(ref, got, path: str = '') -> List[str]:
    """Key paths of the reference artifact that ``got`` lacks: dicts key by
    key, a list of rows (dicts) by the union of its rows' keys."""
    if isinstance(ref, dict):
        if not isinstance(got, dict):
            return [path or '/']
        out = []
        for k, v in ref.items():
            if k not in got:
                out.append(f'{path}/{k}')
            else:
                out += missing_keys(v, got[k], f'{path}/{k}')
        return out
    if isinstance(ref, list) and ref and all(isinstance(r, dict) for r in ref):
        if not (isinstance(got, list) and got
                and all(isinstance(r, dict) for r in got)):
            return [path]
        have = set().union(*got)
        return [f'{path}[]/{k}' for k in sorted(set().union(*ref) - have)]
    return []


def nonfinite(record, path: str = '') -> List[str]:
    """Paths of the float values in ``record`` that are NaN or infinite."""
    if isinstance(record, dict):
        return [p for k, v in record.items()
                for p in nonfinite(v, f'{path}/{k}')]
    if isinstance(record, list):
        return [p for i, v in enumerate(record)
                for p in nonfinite(v, f'{path}[{i}]')]
    if isinstance(record, float) and not math.isfinite(record):
        return [path]
    return []
