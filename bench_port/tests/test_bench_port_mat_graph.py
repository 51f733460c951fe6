"""The reader of the material trainer's CUDA-graph count (metrics/
mat_graph_replay_share.py) on fake systems: the share from the counts,
and None without them (a material trainer that keeps none, as before the
stage-2 graph, no system, no step yet, a run off the card)."""
import os
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, load

reader = load(os.path.join(BENCH, 'metrics', 'mat_graph_replay_share.py'),
              'm_mat_graph_replay_share')


def _ctx(stats, device='cuda'):
    trainer = SimpleNamespace() if stats is None else \
        SimpleNamespace(graph_stats=stats)
    return SimpleNamespace(system=SimpleNamespace(
        trainer=trainer, device=torch.device(device)))


def test_share_from_the_counts():
    # the cell's shape: a set-up step, 8 warm-up steps (two of them eager
    # before the capture), 3 compared, a 200-step window, 3 profiled
    got = reader.read(_ctx({'replayed': 209, 'eager': 6, 'captures': 1}))
    assert got == pytest.approx(100.0 * 209 / 215)
    assert reader.read(_ctx({'replayed': 0, 'eager': 215,
                             'captures': 0})) == 0.0


@pytest.mark.parametrize('ctx', [
    _ctx(None), _ctx({'replayed': 0, 'eager': 0, 'captures': 0}),
    _ctx({'replayed': 5, 'eager': 3, 'captures': 1}, device='cpu'),
    SimpleNamespace(system=None), SimpleNamespace()])
def test_none_without_counts(ctx):
    assert reader.read(ctx) is None
