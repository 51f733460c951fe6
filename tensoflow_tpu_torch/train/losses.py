"""Loss aggregation of both stages (counterpart of tensoflow_tpu/train/losses.py).

Every step-dependent schedule (anneal ramps, ratio switch lists) is
evaluated on the host into a flat dict of float weights; the loss math
itself is plain tensor code.

With an active ``mesh`` (parallel/sharding.py) every term is this rank's
share of the global term: batch means divide by the global count, and a
term of the parameters alone (TV, Gaussian, std) counts on rank 0 only,
so the ranks' terms, and their gradients, sum to the single-device ones.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..parallel import sharding


def schedule_weights(cfg: Dict[str, Any], step: int) -> Dict[str, float]:
    """Host-side evaluation of all loss schedules for ``step``
    (cfg keys follow the reference YAML names)."""
    w = {}
    # eikonal anneal (ref: loss.py:43-59)
    ew = cfg.get('eikonal_weight', 0.1)
    b = cfg.get('eikonal_weight_anneal_begin', 0)
    e = cfg.get('eikonal_weight_anneal_end', 0)
    if step < b:
        w['eikonal'] = 0.0
    elif b <= step < e:
        w['eikonal'] = ew * (step - b) / (e - b)
    else:
        w['eikonal'] = ew

    # sparse / hessian ratio switches (ref: loss.py:85-123)
    def ratio(update_list, ratios):
        r = 1.0
        if update_list:
            for i in range(len(update_list) - 1, 0, -1):
                if step >= update_list[i]:
                    r = ratios[i]
                    break
        return r

    upsample_list = cfg.get('upsample_list')
    sparse_list = cfg.get('sparse_update_list') or upsample_list
    hessian_list = cfg.get('hessian_update_list') or upsample_list
    w['sparse'] = cfg.get('sparse_weight', 0.02) * ratio(
        sparse_list, cfg.get('sparse_ratio', [1.0, 1.0]))
    w['hessian'] = cfg.get('hessian_weight', 5e-4) * ratio(
        hessian_list, cfg.get('hessian_ratio', [1.0, 1.0]))
    w['tv_sdf'] = cfg.get('TV_weight_sdf', 0.1)
    w['gaussian'] = cfg.get('gaussian_weight', 5e-4)
    w['mask'] = cfg.get('mask_loss_weight', 0.01)
    w['nis'] = cfg.get('nis_loss_weight', 0.0001)

    # init-sdf sphere prior anneal (ref: loss.py:174-200)
    reg_step = 1000
    w['init_reg'] = float((np.cos((step / reg_step) * np.pi) + 1) / 2) \
        if step < reg_step else 0.0
    if cfg.get('apply_std_loss', False):
        w['std'] = cfg.get('std_loss_weight', 0.05)
    return {k: float(v) for k, v in w.items()}


def init_sdf_reg_loss(sdf_vals, pts_norm, mask, mesh=None):
    """Sphere prior on the early SDF (ref: loss.py:170-202).
    Returns (small_loss, large_loss); with an active mesh this rank's
    shares (the counts are global)."""
    small_thr, large_thr = 0.1, 1.05
    small_mask = (pts_norm < small_thr) & (mask > 0)
    sl = torch.clamp(sdf_vals - (pts_norm - small_thr), min=0.0) * small_mask
    large_mask = (pts_norm > large_thr) & (mask > 0)
    ll = torch.clamp((pts_norm - large_thr) - sdf_vals, min=0.0) * large_mask
    counts = torch.stack([torch.sum(sl > 1e-5), torch.sum(small_mask),
                          torch.sum(ll > 1e-5), torch.sum(large_mask)])
    counts = sharding.global_sum(mesh, counts)
    # ref normalises by the count of active elements (loss.py:186)
    small_loss = torch.sum(sl) / (counts[0] + 1e-3)
    small_loss = small_loss * (counts[1] > 0)
    large_loss = torch.sum(ll) / (counts[2] + 1e-3)
    large_loss = large_loss * (counts[3] > 0)
    return small_loss, large_loss



def total_loss_shape(outputs: Dict[str, Any], w: Dict[str, float],
                     mesh=None):
    """Scalar stage-1 training loss from renderer outputs and schedule
    weights: the `loss_*` terms the reference trainer sums
    (ref: trainer_inv.py:198-207).  Returns (total, terms)."""
    # the parameters' own terms count once over the ranks
    own = 0.0 if sharding.active(mesh) and not mesh.is_main else 1.0
    terms = {'loss_rgb': sharding.mean_share(mesh, outputs['loss_rgb'])}
    if 'loss_radiance' in outputs:
        terms['loss_radiance'] = sharding.mean_share(mesh, outputs['loss_radiance'])
    terms['loss_eikonal'] = outputs['gradient_error'] * w['eikonal']
    if 'loss_sparse' in outputs:
        terms['loss_sparse'] = outputs['loss_sparse'] * w['sparse']
    if 'loss_hessian' in outputs:
        terms['loss_hessian'] = outputs['loss_hessian'] * w['hessian']
    if 'loss_tv_sdf' in outputs:
        terms['loss_tv_sdf'] = outputs['loss_tv_sdf'] * (w['tv_sdf'] * own)
    if 'loss_gaussian' in outputs:
        terms['loss_gaussian'] = outputs['loss_gaussian'] * (
            w['gaussian'] * own)
    if 'loss_occ' in outputs:
        terms['loss_occ'] = torch.mean(outputs['loss_occ'])
    if 'loss_mask' in outputs:
        terms['loss_mask'] = outputs['loss_mask'] * w['mask']
    if 'sdf_vals' in outputs:
        small, large = init_sdf_reg_loss(
            outputs['sdf_vals'], outputs['sdf_pts_norm'],
            outputs['sdf_mask'], mesh)
        terms['loss_sdf_small'] = small * w['init_reg']
        terms['loss_sdf_large'] = large * w['init_reg']
    if 'std' in w:
        terms['loss_std'] = outputs['std'] * (w['std'] * own)
    total = sum(terms.values())
    return total, terms


def total_loss_material(outputs: Dict[str, Any], w: Dict[str, float],
                        mesh=None):
    """Scalar stage-2 training loss (ref: trainer loss list
    ['nerf_render', 'mat_reg', 'nis'], configs/mat/syn/compressor.yaml).
    Returns (total, terms).  With an active mesh the renderer's
    loss_mat_reg and loss_nis are this rank's shares already."""
    terms = {'loss_rgb': sharding.mean_share(mesh, outputs['loss_rgb'])}
    if 'loss_mat_reg' in outputs:
        terms['loss_mat_reg'] = torch.mean(outputs['loss_mat_reg'])
    if 'loss_diffuse_light' in outputs:
        terms['loss_diffuse_light'] = sharding.mean_share(
            mesh, outputs['loss_diffuse_light'])
    if 'loss_nis' in outputs:
        terms['loss_nis'] = outputs['loss_nis'].reshape(()) * w['nis']
    total = sum(terms.values())
    return total, terms
