"""Volume-rendering compositing (counterpart of tensoflow_tpu/ops/composite.py).

Dense [rays, samples] weights and sums (the hierarchical sampler's path),
and the compacted-sample path of the occupancy-grid step: per-ray
transmittance on ray-major compacted slots and scatter-free per-ray sums.
"""
from __future__ import annotations

import torch


def weights_from_alpha(alpha, mask=None):
    """weight_i = alpha_i * prod_{j<i} (1 - alpha_j) over [rn, sn].
    Returns (weights, transmittance-before-sample)."""
    if mask is not None:
        alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
    one_minus = torch.clamp(1.0 - alpha, 0.0, 1.0) + 1e-7
    log_om = torch.log(one_minus)
    trans = torch.exp(torch.cumsum(
        torch.cat([torch.zeros_like(alpha[:, :1]), log_om[:, :-1]], dim=1),
        dim=1))
    return alpha * trans, trans


def _carry_last_valid(seed, flag):
    """out[i] = seed[j] for the most recent j <= i with flag[j] (flag[0]
    must be set): a cummax over flagged indices plus one gather — the
    counterpart of the JAX package's associative scan (:38-46)."""
    ar = torch.arange(flag.shape[0], device=flag.device)
    last = torch.cummax(torch.where(flag, ar, torch.zeros_like(ar)), 0).values
    return seed[last]


def compact_weights(alpha_c, slot_mask, ray_id, n_rays: int):
    """Compositing weights on ray-major compacted samples.

    alpha_c [M]; slot_mask [M] bool; ray_id [M] nondecreasing over valid
    slots.  Returns w_c [M], zero at invalid slots."""
    valid = slot_mask.to(alpha_c.dtype)
    a = alpha_c * valid
    log_om = torch.log(torch.clamp(1.0 - a, 0.0, 1.0) + 1e-7) * valid
    cs = torch.cumsum(log_om, 0)
    excl = cs - log_om
    first = torch.cat([torch.ones((1,), dtype=torch.bool,
                                  device=ray_id.device),
                       ray_id[1:] != ray_id[:-1]])
    start = _carry_last_valid(torch.where(first, excl, torch.zeros_like(excl)),
                              first)
    trans = torch.exp(excl - start)
    return a * trans * valid


def segment_sums_sorted(cols, ray_id, n_rays: int):
    """Per-ray sums of compact columns [M, K] -> [n_rays, K]; ray_id is
    globally nondecreasing (invalid slots carry ray_id >= n_rays)."""
    k = cols.shape[1]
    # scan along the last dim of the [K, M] transpose: CUDA's scan over
    # dim 0 of a narrow [M, K] walks each column sequentially
    cs = torch.cumsum(cols.t().contiguous(), dim=1).t()
    p = torch.cat([torch.zeros((1, k), dtype=cols.dtype, device=cols.device),
                   cs])
    qs = torch.arange(n_rays, dtype=ray_id.dtype, device=ray_id.device)
    left = torch.searchsorted(ray_id, qs, right=False)
    right = torch.searchsorted(ray_id, qs, right=True)
    return p[right] - p[left]


def accumulate(weights, values=None):
    """sum_i w_i * v_i along the sample axis: weights [rn, sn], values
    [rn, sn, C] -> [rn, C]; without values the opacity [rn, 1]."""
    if values is None:
        return torch.sum(weights, dim=1, keepdim=True)
    return torch.sum(weights[..., None] * values, dim=1)


def neus_alpha(sdf, inv_s, iter_cos, dists):
    """NeuS section alpha (ref: shapeRenderer.py:1014-1024)."""
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                       0.0, 1.0)


def neus_alpha_isotropic(sdf, inv_s, step_size):
    """Direction-less alpha for occupancy evaluation (ref: 972-993)."""
    est_next = sdf - step_size * 0.5
    est_prev = sdf + step_size * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                       0.0, 1.0)


def anneal_cos(true_cos, cos_anneal_ratio):
    """NeuS cosine annealing (ref: shapeRenderer.py:1011-1012)."""
    r = cos_anneal_ratio
    return -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - r)
             + torch.relu(-true_cos) * r)


def segment_weights(sdf_mid, cos_val, dists, inv_s, surface_mask):
    """Section weights of a secondary-ray SDF march (ref:
    utils/network_utils.py:149-170): sdf_mid, cos_val, dists, inv_s and
    surface_mask (bool) [rn, sn] -> weights [rn, sn]."""
    cos_val = torch.clamp(cos_val, max=0.0)
    prev_esti = sdf_mid - cos_val * dists * 0.5
    next_esti = sdf_mid + cos_val * dists * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    alpha = alpha * surface_mask.to(alpha.dtype)
    return weights_from_alpha(alpha)[0]
