"""The numbers that decide ``correct`` for a training cell.

* ``loss_gap``: the largest relative gap between the program's loss and
  the reference's over the compared steps.
* ``leaf_norm_gap``: for tensors keyed by leaf, the worst leaf's gap
  between the two norms, |‖a‖ - ‖b‖|, over the larger of the reference
  leaf's norm and the median leaf's (the reference's), so that a leaf
  whose gradient is all but zero is not judged on its own scale.
* ``moved_leaves``: the leaves whose reference gradient is at least a
  thousandth of the median leaf's; the others move under Adam by
  round-off alone and are left out of the change's comparison.
"""
from __future__ import annotations

import statistics

import torch

ADAM_BETA1 = 0.9
NEGLIGIBLE_GRAD = 1e-3


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def loss_gap(prog_losses, ref_losses) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog_losses, ref_losses))


def leaf_gaps(prog: dict, ref: dict, keys=None) -> dict:
    """Each leaf's gap between the two norms over the larger of the
    reference leaf's norm and the median leaf's."""
    keys = sorted(ref) if keys is None else sorted(keys)
    pn, rn = norms({k: prog[k] for k in keys}), norms({k: ref[k]
                                                       for k in keys})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def leaf_norm_gap(prog: dict, ref: dict, keys=None):
    """(worst gap, its leaf)."""
    gaps = leaf_gaps(prog, ref, keys)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def first_gradient(m_before: dict, m_after: dict) -> dict:
    """The gradient Adam took at a step, from its first moments before
    and after it: g = (m1 - beta1 m0) / (1 - beta1)."""
    return {k: (m_after[k].double() - ADAM_BETA1 * m_before[k].double())
            / (1.0 - ADAM_BETA1) for k in m_after}


def moved_leaves(ref_grad: dict) -> list:
    n = norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= NEGLIGIBLE_GRAD * med]


def change(before: dict, after: dict) -> dict:
    return {k: after[k].double() - before[k].double() for k in after}
