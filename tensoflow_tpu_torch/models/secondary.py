"""Secondary-ray visibility by SDF marching (counterpart of
tensoflow_tpu/models/secondary.py): two-pass fixed-count sampling with
NeuS section alphas, accumulated into an occlusion probability.
"""
from __future__ import annotations

import torch

from ..ops.composite import weights_from_alpha
from ..ops.math import get_sphere_intersection, sample_pdf


def march_weights(sdf_fun, inv_s, z_vals, origins, dirs):
    """Section weights + mid sdf along rays (ref: network_utils.py:149-170).
    Returns (weights [pn, sn-1], mid_sdf [pn, sn-1])."""
    pn, sn = z_vals.shape
    points = origins[:, None, :] + dirs[:, None, :] * z_vals[..., None]
    sdf = sdf_fun(points.reshape(-1, 3)).reshape(pn, sn)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = 0.5 * (prev_sdf + next_sdf)
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    surface_mask = cos_val < 0
    cos_val = torch.clamp(cos_val, max=0.0)
    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    alpha = alpha * surface_mask.to(alpha.dtype)
    weights, _ = weights_from_alpha(alpha)
    mid_sdf = torch.where(surface_mask, mid_sdf, torch.full_like(mid_sdf,
                                                                 -1.0))
    return weights, mid_sdf


@torch.no_grad()
def secondary_intersection(sdf_fun, inv_s, pts, dirs, sn0: int = 128,
                           sn1: int = 9):
    """Occlusion march from surface points (ref: network_utils.py:172-202),
    without gradients (the reference marches under no_grad).
    Returns (hit_z [pn, sn1-1], hit_weights [pn, sn1-1], hit_sdf)."""
    inside = torch.linalg.norm(pts, dim=-1) < 0.999
    max_dist = get_sphere_intersection(pts, dirs)
    z = torch.linspace(0.0, 1.0, sn0, dtype=pts.dtype, device=pts.device)
    z_vals = max_dist * z[None, :]
    w, _ = march_weights(sdf_fun, inv_s, z_vals, pts, dirs)
    z_new = sample_pdf(z_vals, w, sn1)
    z_new = torch.sort(z_new, dim=-1).values
    w2, mid_sdf = march_weights(sdf_fun, inv_s, z_new, pts, dirs)
    z_mid = 0.5 * (z_new[:, 1:] + z_new[:, :-1])
    m = inside[:, None].to(pts.dtype)
    return (z_mid * m, w2 * m,
            torch.where(inside[:, None], mid_sdf,
                        torch.full_like(mid_sdf, -1.0)))


def trace_sdf(sdf_fun, grad_fun, inv_s, rays_o, rays_d, sn0: int = 128,
              sn1: int = 9, hit_weight_thresh: float = 0.5):
    """Surface tracing by the occlusion march (secondary.py:74 of the JAX
    package; it has no caller there either): the weight-expected depth as
    the hit depth, ``grad_fun``'s SDF gradient as the normal (flipped to
    face the ray), the accumulated weight as the hit confidence.

    Returns (inters [pn,3], normals [pn,3], depth [pn,1], hit_mask [pn])."""
    z_mid, w, _ = secondary_intersection(sdf_fun, inv_s, rays_o, rays_d,
                                         sn0, sn1)
    acc = torch.sum(w, -1, keepdim=True)
    wn = w / torch.clamp(acc, min=1e-8)
    depth = torch.sum(wn * z_mid, -1, keepdim=True)
    hit_mask = acc[:, 0] > hit_weight_thresh
    inters = rays_o + depth * rays_d
    grad = grad_fun(inters)
    normals = grad / torch.clamp(torch.linalg.norm(grad, dim=-1,
                                                   keepdim=True), min=1e-8)
    flip = torch.sum(normals * rays_d, -1, keepdim=True) >= 0
    normals = torch.where(flip, -normals, normals)
    return inters, normals, depth, hit_mask
