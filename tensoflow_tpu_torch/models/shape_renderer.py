"""Stage-1 shape renderer of the port (counterpart of
tensoflow_tpu/models/shape_renderer.py): NeuS volume rendering over the
TensoSDF field, on the occupancy-grid sampler with global sample
compaction — the path the stage-1 training step runs.

``render_rays(..., eval_extras=True)`` adds what a rendered view shows
beside its colour: depth, the surface normal, the materials and lights at
the surface and the marched occlusion (the render_image outputs).

Not ported yet (see ROADMAP.md): the hierarchical sampler, the alpha mask
and predict_BG.  Random draws come in as pre-drawn noise
(``noise``): the trainer draws them from its torch.Generator, the parity
tests with jax.random from the JAX step's own keys.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device_constant
from ..fields import mlp, shading as shading_mod, tenso_sdf
from ..ops import composite, grid as grid_mod
from ..ops.math import charbonnier, safe_normalize
from ..ops.tensor_field import gaussian_smooth_loss_vm, tv_loss_vm
from . import secondary


class ShapeRendererConfig(NamedTuple):
    sdf: tenso_sdf.SDFConfig = tenso_sdf.SDFConfig()
    shading: shading_mod.ShadingConfig = shading_mod.ShadingConfig()
    aabb: Tuple[Tuple[float, ...], Tuple[float, ...]] = (
        (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    std_act: str = 'exp'
    inv_s_init: float = 0.3
    freeze_inv_s_step: Optional[int] = None
    anneal_end: int = 50000
    train_ray_num: int = 1024
    use_occ_grid: bool = True
    occ_grid_reso: int = 128
    step_ratio: float = 0.5
    occ_max_samples: int = 192
    march_stride: int = 1
    compact_samples_per_ray: int = 64
    rgb_loss: str = 'charbonier'
    apply_occ_loss: bool = True
    apply_tv_loss: bool = True
    apply_sparse_loss: bool = True
    apply_hessian_loss: bool = True
    apply_gaussian_loss: bool = False
    gaussian_loss_step: int = 20000
    occ_loss_step: int = 20000
    occ_loss_max_pn: int = 2048
    occ_sdf_thresh: float = 0.01
    apply_mask_loss: bool = False
    has_radiance_field: bool = False
    radiance_field_step: int = 0
    isBGWhite: bool = True


def aabb_tensor(cfg: ShapeRendererConfig, device):
    return device_constant(('aabb', cfg.aabb), lambda: cfg.aabb, device)


def base_radii(cfg: ShapeRendererConfig) -> float:
    a = np.asarray(cfg.aabb)
    return float((a[1][0] - a[0][0]) / 2.0 / cfg.sdf.grid_size[0])


def step_size(cfg: ShapeRendererConfig) -> float:
    a = np.asarray(cfg.aabb, np.float64)
    units = (a[1] - a[0]) / (np.asarray(cfg.sdf.grid_size) - 1)
    return float(units.mean() * cfg.step_ratio)


def n_march_candidates(cfg: ShapeRendererConfig) -> int:
    a = np.asarray(cfg.aabb, np.float64)
    return int(np.ceil((a[1] - a[0]).max() * 1.7321 / step_size(cfg)))


def init_shape_renderer(gen: torch.Generator, cfg: ShapeRendererConfig,
                        device='cpu') -> Dict[str, Any]:
    return {
        'sdf': tenso_sdf.init_tenso_sdf(gen, cfg.sdf, device),
        'deviation': mlp.init_variance(cfg.inv_s_init, device),
        'shading': shading_mod.init_shading(gen, cfg.shading, device),
    }


def near_far_from_sphere(rays_o, dirs, radius: float = 1.0):
    a = torch.sum(dirs ** 2, -1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * dirs, -1, keepdim=True)
    mid = 0.5 * (-b) / a
    return torch.clamp(mid - radius, min=1e-3), mid + radius


def compute_ball_radii(distance, radii, cos):
    """Cone-footprint radius at distance (tri-miprf; ref: 965-970)."""
    inv_cos = 1.0 / cos
    tmp = torch.sqrt(inv_cos * inv_cos - 1.0) - radii
    return distance * radii * cos / torch.sqrt(tmp * tmp + 1.0)


def draw_noise(gen: torch.Generator, cfg: ShapeRendererConfig, rn: int,
               device):
    """The step's random draws: the sampler's per-ray lattice jitter and
    the occ loss's selection scores (one per compacted slot)."""
    m = rn * cfg.compact_samples_per_ray
    return {'sample_jitter': torch.rand((rn, 1), generator=gen,
                                        device=device),
            'occ_score': torch.rand((m,), generator=gen, device=device)}


def render_rays(params, cfg: ShapeRendererConfig, mips, occ_state,
                ray_batch, step: int, cos_anneal_ratio, noise,
                is_train: bool, radiance_on: bool = False,
                occ_loss_on: bool = False, eval_extras: bool = False):
    """Render a batch of rays; returns the outputs dict (occupancy-grid
    sampler + compacted samples).  ``noise`` is read only when is_train."""
    if not (cfg.use_occ_grid and cfg.compact_samples_per_ray > 0):
        raise NotImplementedError('only the occupancy-grid sampler with '
                                  'sample compaction is ported')
    rays_o, dirs = ray_batch['rays_o'], ray_batch['dirs']
    radii, rays_cos = ray_batch['radiis'], ray_batch['rays_cos']
    dev = rays_o.device
    aabb = aabb_tensor(cfg, dev)
    rn = rays_o.shape[0]
    br = base_radii(cfg)
    near, far = near_far_from_sphere(rays_o, dirs)

    stride = max(int(cfg.march_stride), 1)
    ss = step_size(cfg) * stride
    n_cand = -(-n_march_candidates(cfg) // stride)
    t_starts, t_ends, valid = grid_mod.occ_grid_sampling(
        occ_state, grid_mod.OccGridConfig(resolution=cfg.occ_grid_reso),
        rays_o, dirs, near, far, ss, n_cand, cfg.occ_max_samples,
        noise['sample_jitter'] if is_train else None)

    sn = t_starts.shape[1]
    mid = 0.5 * (t_starts + t_ends)
    dists = t_ends - t_starts
    pts = rays_o[:, None, :] + dirs[:, None, :] * mid[..., None]
    inner = valid & ~torch.any((aabb[0] > pts) | (pts > aabb[1]), -1)
    sbr = compute_ball_radii(mid[..., None], radii[:, None, :],
                             rays_cos[:, None, :])
    levels = torch.log2(sbr[..., 0] / br)
    flat_dirs = dirs[:, None, :].expand(pts.shape).reshape(-1, 3)

    m = rn * cfg.compact_samples_per_ray
    src, slot_mask, _ = grid_mod.compact_indices(inner.reshape(-1), m)
    cols = torch.cat([pts.reshape(-1, 3), levels.reshape(-1, 1), flat_dirs,
                      dists.reshape(-1, 1)], -1)
    s_cols = cols[src]
    s_pts, s_lv = s_cols[:, 0:3], s_cols[:, 3:4]
    s_mid = mid.reshape(-1)[src] if eval_extras else None
    s_dirs, s_dists = s_cols[:, 4:7], s_cols[:, 7]

    sdf, app_feat, grads, hessian = tenso_sdf.sdf_with_grad_hessian(
        params['sdf'], cfg.sdf, s_pts, aabb, s_lv, with_hessian=is_train)
    inv_s = mlp.apply_variance(params['deviation'], cfg.std_act)
    inv_s = torch.clamp(inv_s, 1e-6, 1e6)
    if cfg.freeze_inv_s_step is not None and is_train \
            and step < cfg.freeze_inv_s_step:
        inv_s = inv_s.detach()

    true_cos = torch.sum(s_dirs * grads, -1)
    iter_cos = composite.anneal_cos(true_cos, cos_anneal_ratio)
    alpha_s = composite.neus_alpha(sdf, inv_s, iter_cos, s_dists)

    normals = safe_normalize(grads)
    sampled_color, sampled_radiance, occ_info = shading_mod.apply_shading(
        params['shading'], cfg.shading, mips, s_pts, normals, -s_dirs,
        app_feat, step=(step if radiance_on else None))

    mask_f = inner.to(alpha_s.dtype)
    slot_f = slot_mask.to(alpha_s.dtype)
    # composite in compact space: segmented transmittance + one
    # scatter-free segment reduction; invalid slots carry ray_id = rn
    ray_id = torch.where(slot_mask, src // sn, torch.full_like(src, rn))
    w_c = composite.compact_weights(alpha_s, slot_mask, ray_id, rn)
    w_col = w_c[:, None]
    cols = [w_col, w_col * sampled_color, w_col * grads]
    radiance_cols = radiance_on and sampled_radiance is not None
    if radiance_cols:
        rough_c = occ_info['roughness']
        rough_c = rough_c if rough_c.ndim > 1 else rough_c[:, None]
        cols += [w_col * sampled_radiance, w_col * rough_c]
    if eval_extras:
        cols.append(w_col * s_mid[:, None])
    sums = composite.segment_sums_sorted(torch.cat(cols, -1), ray_id, rn)
    acc = sums[:, 0:1]
    color = sums[:, 1:4]
    acc_normal = sums[:, 4:7]
    if cfg.isBGWhite:
        color = color + (1.0 - acc)

    outputs: Dict[str, Any] = {
        'ray_rgb': color, 'acc': acc,
        'sample_num': torch.sum(mask_f) / rn,
    }
    up = device_constant('up', lambda: [0.0, 0.0, 1.0], dev, acc.dtype)
    outputs['normal'] = safe_normalize(acc_normal * acc + (1.0 - acc) * up)

    nvalid = torch.clamp(torch.sum(slot_f), min=1.0)
    grad_err = (torch.linalg.norm(grads, dim=-1) - 1.0) ** 2
    outputs['gradient_error'] = torch.sum(grad_err * slot_f) / nvalid
    if cfg.apply_sparse_loss:
        reg = torch.exp(-20.0 * torch.abs(sdf))
        outputs['loss_sparse'] = torch.sum(reg * slot_f) / nvalid
    if cfg.apply_hessian_loss and hessian is not None:
        outputs['loss_hessian'] = torch.sum(
            torch.abs(hessian) * slot_f) / nvalid
    if cfg.apply_tv_loss:
        outputs['loss_tv_sdf'] = tv_loss_vm(params['sdf']['field'])
    if cfg.apply_gaussian_loss and is_train:
        outputs['loss_gaussian'] = (
            gaussian_smooth_loss_vm(params['sdf']['field'])
            if step > cfg.gaussian_loss_step
            else torch.zeros((), device=dev))
    outputs['std'] = torch.mean(1.0 / inv_s)

    if radiance_cols:
        radiance = sums[:, 7:10]
        if cfg.isBGWhite:
            radiance = radiance + (1.0 - acc)
        outputs['radiance'] = radiance
        outputs['roughness_weights'] = sums[:, 10].detach()

    outputs['sdf_vals'] = sdf
    outputs['sdf_pts_norm'] = torch.linalg.norm(s_pts, dim=-1)
    outputs['sdf_mask'] = slot_f

    if cfg.apply_occ_loss and is_train:
        outputs['loss_occ'] = (
            _occ_loss(cfg, s_pts, sdf, normals, s_dirs, occ_info, slot_mask,
                      noise['occ_score'], inv_s, occ_state)
            if occ_loss_on else torch.zeros((), device=dev))
    if eval_extras:
        n_cols = 11 if radiance_cols else 7
        outputs.update(_eval_extras(
            params, cfg, mips, aabb, ray_batch, sums[:, n_cols:n_cols + 1],
            inv_s, step))
    return outputs


def _eval_extras(params, cfg: ShapeRendererConfig, mips, aabb, ray_batch,
                 t_depth, inv_s, step):
    """Depth, surface normal, materials and lights at the expected-depth
    surface point, and the occlusion marched on the live field
    (shape_renderer.py:509-538 of the JAX package).  The normal comes from
    the stencil head run forward only."""
    rays_o, dirs = ray_batch['rays_o'], ray_batch['dirs']
    radii, rays_cos = ray_batch['radiis'], ray_batch['rays_cos']
    br = base_radii(cfg)
    packed = tenso_sdf.pack_field(params['sdf'], cfg.sdf)
    out = {'depth': t_depth * rays_cos}
    surf_pts = t_depth * dirs + rays_o
    lv_d = torch.log2(compute_ball_radii(t_depth, radii, rays_cos) / br)
    nrm = safe_normalize(tenso_sdf.gradient_only(params['sdf'], cfg.sdf,
                                                 surf_pts, aabb, lv_d))
    inner_d = (~torch.any((aabb[0] > surf_pts) | (surf_pts > aabb[1]), -1,
                          keepdim=True)).to(nrm.dtype)
    out['normal_vis'] = ((nrm + 1.0) * 0.5) * inner_d
    feat = tenso_sdf.apply_tenso_sdf(params['sdf'], cfg.sdf, surf_pts, aabb,
                                     lv_d, packed=packed)[..., 1:]
    _, _, occ_info, inter = shading_mod.apply_shading(
        params['shading'], cfg.shading, mips, surf_pts, nrm, -dirs, feat,
        step=step, inter_results=True)

    def sdf_fun(x):
        return tenso_sdf.sdf_only(params['sdf'], cfg.sdf, x, aabb,
                                  packed=packed)
    _, occ_w, _ = secondary.secondary_intersection(
        sdf_fun, inv_s, surf_pts, occ_info['reflective'], 128, 9)
    out['occ_prob_gt'] = torch.sum(occ_w, -1, keepdim=True)
    for k, v in inter.items():
        out[k] = v * inner_d
    out['occ_prob'] = occ_info['occ_prob'] * inner_d
    return out


def _occ_loss(cfg: ShapeRendererConfig, flat_pts, sdf, normals, flat_dirs,
              occ_info, flat_inner, score_noise, inv_s, occ_state):
    """Occlusion-probability supervision (ref: shapeRenderer.py:1027-1103),
    marching the baked SDF lattice of the occupancy state: select up to
    occ_loss_max_pn qualifying surface samples by the largest random
    scores, march their reflection rays, L1 against the predicted
    occlusion probability."""
    n = flat_pts.shape[0]
    sdf_mask = torch.abs(sdf) < cfg.occ_sdf_thresh
    normal_mask = torch.sum(normals * flat_dirs, -1) < 0
    mask = flat_inner & sdf_mask & normal_mask
    score = torch.where(mask, score_noise, torch.full_like(score_noise,
                                                           -1.0))
    kk = min(cfg.occ_loss_max_pn, n)
    idx = torch.topk(score, kk, sorted=True).indices
    sel_mask = mask[idx]
    sel_pts = flat_pts[idx]
    sel_ref = occ_info['reflective'][idx]
    sel_occ = occ_info['occ_prob'][idx]
    occ_cfg = grid_mod.OccGridConfig(resolution=cfg.occ_grid_reso)

    def sdf_fun(x):
        return grid_mod.sample_occ_sdf(occ_state, occ_cfg, x)[:, None]

    _, w, _ = secondary.secondary_intersection(sdf_fun, inv_s.detach(),
                                               sel_pts.detach(),
                                               sel_ref.detach(), 64, 16)
    occ_gt = torch.sum(w, -1, keepdim=True)
    l1 = torch.abs(sel_occ - occ_gt)[:, 0] * sel_mask.to(sel_occ.dtype)
    return torch.sum(l1) / torch.clamp(torch.sum(sel_mask), min=1.0)


def compute_rgb_loss(cfg: ShapeRendererConfig, rgb_pr, rgb_gt):
    if cfg.rgb_loss == 'l2':
        return torch.sum((rgb_pr - rgb_gt) ** 2, -1)
    if cfg.rgb_loss == 'l1':
        return torch.sum(torch.abs(rgb_pr - rgb_gt), -1)
    if cfg.rgb_loss == 'charbonier':
        return charbonnier(rgb_pr, rgb_gt)
    raise NotImplementedError(cfg.rgb_loss)


def compute_occ_alpha(params, cfg: ShapeRendererConfig, pts, packed=None):
    """Alpha at grid cell centers for occupancy updates (ref: 972-993)."""
    aabb = aabb_tensor(cfg, pts.device)
    sdf = tenso_sdf.sdf_only(params['sdf'], cfg.sdf, pts, aabb,
                             packed=packed)[:, 0]
    inv_s = torch.clamp(mlp.apply_variance(params['deviation'], cfg.std_act),
                        1e-6, 1e6)
    return composite.neus_alpha_isotropic(sdf, inv_s, step_size(cfg))


def compute_occ_alpha_chunked(params, cfg: ShapeRendererConfig, pts,
                              chunk: int = 131072):
    """compute_occ_alpha over a large point set, chunk by chunk, with the
    field atlas packed once."""
    packed = tenso_sdf.pack_field(params['sdf'], cfg.sdf)
    return torch.cat([compute_occ_alpha(params, cfg, pts[i:i + chunk],
                                        packed=packed)
                      for i in range(0, pts.shape[0], chunk)])


def compute_sdf_chunked(params, cfg: ShapeRendererConfig, pts,
                        chunk: int = 131072, packed=None):
    """Raw SDF over a large point set (the occ-loss bake lattice)."""
    aabb = aabb_tensor(cfg, pts.device)
    if packed is None:
        packed = tenso_sdf.pack_field(params['sdf'], cfg.sdf)
    return torch.cat([tenso_sdf.sdf_only(params['sdf'], cfg.sdf,
                                         pts[i:i + chunk], aabb,
                                         packed=packed)[:, 0]
                      for i in range(0, pts.shape[0], chunk)])


def train_step_outputs(params, cfg: ShapeRendererConfig, mips, occ_state,
                       ray_batch, step: int, noise, radiance_on: bool,
                       occ_loss_on: bool):
    """Training forward: render + rgb/psnr/mask losses
    (ref: shapeRenderer.py:777-794)."""
    anneal = min(1.0, step / cfg.anneal_end) if cfg.anneal_end >= 0 else 1.0
    outputs = render_rays(params, cfg, mips, occ_state, ray_batch, step,
                          anneal, noise, True, radiance_on, occ_loss_on)
    rgb_gt = ray_batch['rgbs']
    outputs['loss_rgb'] = compute_rgb_loss(cfg, outputs['ray_rgb'], rgb_gt)
    mse = torch.mean((outputs['ray_rgb'] - rgb_gt) ** 2)
    outputs['psnr'] = 20.0 * torch.log10(
        1.0 / torch.sqrt(torch.clamp(mse, min=1e-10)))
    if radiance_on:
        outputs['loss_radiance'] = (
            compute_rgb_loss(cfg, outputs['radiance'], rgb_gt)
            * outputs['roughness_weights'])
        outputs['loss_rgb'] = outputs['loss_rgb'] * (
            1.0 - outputs['roughness_weights'])
    if cfg.apply_mask_loss and 'masks' in ray_batch:
        acc = torch.clamp(outputs['acc'], 1e-3, 1.0 - 1e-3)
        m = (ray_batch['masks'] > 0.5).to(acc.dtype)
        outputs['loss_mask'] = torch.mean(
            -(m * torch.log(acc) + (1 - m) * torch.log(1 - acc)))
    return outputs
