"""Stage-1 shape renderer of the port (counterpart of
tensoflow_tpu/models/shape_renderer.py): NeuS volume rendering over the
TensoSDF field, on either sampler of the JAX package.

  * the occupancy grid (``use_occ_grid``): a fixed per-ray budget of
    candidates, compacted globally to ``compact_samples_per_ray`` slots a
    ray, composited in compact space (with ``compact_samples_per_ray``
    0: every candidate through the field and dense compositing, as on
    the hierarchical sampler); the occ loss marches the SDF baked into
    the occupancy state;
  * the NeuS hierarchical sampler: a stratified lattice plus
    ``up_sample_steps`` rounds of importance upsampling, every
    ``[rays, samples]`` sample through the field (culled ones masked, as
    in the JAX package: no compaction), dense compositing, an optional
    alpha mask and NeRF++ background; the occ loss marches the live field.

``render_rays(..., eval_extras=True)`` adds what a rendered view shows
beside its colour: depth, the surface normal, the materials and lights at
the surface and the marched occlusion (the render_image outputs).

Random draws come in as pre-drawn noise (``noise``, see ``draw_noise``):
the trainer draws them from its torch.Generator, the parity tests with
jax.random from the JAX step's own keys.

With an active ``mesh`` (parallel/sharding.py) the batch is this rank's
slice of the global batch and every batch-wide statistic is global: the
compaction keeps what the global prefix sum keeps, the occ loss picks the
global top-k, and every mean divides a local sum by the global count, so
that the ranks' losses and gradients sum to the single-device step's.
The per-ray noise is then this rank's slice, ``occ_score`` the global
draw.  Without a mesh the paths are the single-device ones.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device_constant
from ..fields import mlp, shading as shading_mod, tenso_sdf
from ..ops import composite, grid as grid_mod
from ..ops.math import (charbonnier, safe_normalize, sample_pdf,
                        xla_linspace)
from ..ops.tensor_field import gaussian_smooth_loss_vm, tv_loss_vm
from ..parallel import sharding
from ..utils.timing import span
from . import secondary


class ShapeRendererConfig(NamedTuple):
    sdf: tenso_sdf.SDFConfig = tenso_sdf.SDFConfig()
    shading: shading_mod.ShadingConfig = shading_mod.ShadingConfig()
    aabb: Tuple[Tuple[float, ...], Tuple[float, ...]] = (
        (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    std_act: str = 'exp'
    inv_s_init: float = 0.3
    freeze_inv_s_step: Optional[int] = None
    # the hierarchical sampler (ref: shapeRenderer.py:121-130)
    n_samples: int = 64
    n_importance: int = 64
    up_sample_steps: int = 4
    perturb: float = 1.0
    anneal_end: int = 50000
    train_ray_num: int = 1024
    clip_sample_variance: bool = True
    use_occ_grid: bool = False
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
    # NeRF++ inverted-sphere background
    predict_BG: bool = False
    n_bg_samples: int = 32


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
    params = {
        'sdf': tenso_sdf.init_tenso_sdf(gen, cfg.sdf, device),
        'deviation': mlp.init_variance(cfg.inv_s_init, device),
        'shading': shading_mod.init_shading(gen, cfg.shading, device),
    }
    if cfg.predict_BG:
        params['bg'] = mlp.init_nerf_bg(gen, device=device)
    return params


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


def n_dense_samples(cfg: ShapeRendererConfig) -> int:
    """Samples a ray takes on the hierarchical sampler."""
    ups = cfg.up_sample_steps
    if cfg.n_importance > 0 and ups > 0:
        return cfg.n_samples + ups * (cfg.n_importance // ups)
    return cfg.n_samples


def n_route_samples(cfg: ShapeRendererConfig) -> int:
    """Samples a ray takes through the field on the route that runs:
    its compaction slots on the compacted occupancy-grid route, the
    occupancy sampler's budget (at most its march steps) on the dense
    one, the hierarchical sampler's count off the grid."""
    if not cfg.use_occ_grid:
        return n_dense_samples(cfg)
    if cfg.compact_samples_per_ray > 0:
        return cfg.compact_samples_per_ray
    return min(cfg.occ_max_samples, n_occ_candidates(cfg))


def n_occ_candidates(cfg: ShapeRendererConfig) -> int:
    """March steps a ray takes on the occupancy grid at the current
    march stride."""
    return -(-n_march_candidates(cfg) // max(int(cfg.march_stride), 1))


def draw_noise(gen: torch.Generator, cfg: ShapeRendererConfig, rn: int,
               device):
    """The step's random draws, the shapes the JAX step draws: the
    sampler's per-ray jitter [rn, 1] (k_sample), the occ loss's selection
    scores, one per evaluated sample (k_occ), and with predict_BG the
    background's inverse-radius jitter [rn, n_bg_samples]
    (fold_in(rng, 7))."""
    sn = n_route_samples(cfg)
    noise = {'sample_jitter': torch.rand((rn, 1), generator=gen,
                                         device=device),
             'occ_score': torch.rand((rn * sn,), generator=gen,
                                     device=device)}
    if cfg.predict_BG:
        noise['bg_jitter'] = torch.rand((rn, cfg.n_bg_samples),
                                        generator=gen, device=device)
    return noise


# ---------------------------------------------------------------------------
# the hierarchical sampler (ref: shapeRenderer.py:819-932)
# ---------------------------------------------------------------------------

def _upsample_zvals(rays_o, dirs, z_vals, sdf, n_importance, inv_s):
    """One NeuS importance-upsampling round (ref: shapeRenderer.py:819-849):
    new samples [rn, n_importance] drawn from the section weights of the
    sdf (carries no gradient) at z_vals."""
    pts = rays_o[:, None, :] + dirs[:, None, :] * z_vals[..., None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = 0.5 * (prev_sdf + next_sdf)
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]],
                         -1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere
    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    weights, _ = composite.weights_from_alpha(alpha)
    return sample_pdf(z_vals, weights, n_importance)


def sample_ray_hierarchical(params, cfg: ShapeRendererConfig, rays_o, dirs,
                            near, far, radii, rays_cos, jitter=None,
                            packed=None):
    """Fixed-count stratified + importance sampling (ref: 871-932): the
    lattice over the aabb clip of [near, far], shifted per ray by
    ``jitter`` (uniform [rn, 1]; None: no perturbation), then
    ``up_sample_steps`` rounds of NeuS upsampling, each merged by a stable
    sort.  The SDF queries carry no gradient; the sample positions do
    (through inv_s with clip_sample_variance).
    Returns (t_starts, t_ends, inside-aabb mask), each [rn, n_dense]."""
    dev = rays_o.device
    aabb = aabb_tensor(cfg, dev)
    n_s, n_imp, ups = cfg.n_samples, cfg.n_importance, cfg.up_sample_steps
    br = base_radii(cfg)
    t = device_constant(('linspace', 0.0, 1.0, n_s),
                        lambda: xla_linspace(0.0, 1.0, n_s), dev)
    vec = torch.where(dirs == 0, torch.full_like(dirs, 1e-6), dirs)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.clamp(torch.amax(torch.minimum(rate_a, rate_b), -1),
                        near[:, 0], far[:, 0])[:, None]
    t_max = torch.clamp(torch.amin(torch.maximum(rate_a, rate_b), -1),
                        near[:, 0], far[:, 0])[:, None]
    t_vals = t_min + (t_max - t_min) * t[None, :]
    if jitter is not None and cfg.perturb > 0:
        t_vals = t_vals + (jitter - 0.5) * 2.0 / n_s

    @torch.no_grad()
    def sdf_at(tv):
        pts = rays_o[:, None, :] + dirs[:, None, :] * tv[..., None]
        sbr = compute_ball_radii(tv[..., None], radii[:, None, :],
                                 rays_cos[:, None, :])
        lv = torch.log2(sbr[..., 0] / br)
        return tenso_sdf.sdf_only(
            params['sdf'], cfg.sdf, pts.reshape(-1, 3), aabb,
            lv.reshape(-1, 1), packed=packed).reshape(tv.shape)

    if n_imp > 0:
        sdf = sdf_at(t_vals)
        inv_s0 = mlp.apply_variance(params['deviation'], cfg.std_act)
        for i in range(ups):
            cap = 64.0 * 2 ** i
            inv_s = (torch.clamp(inv_s0, max=cap) if cfg.clip_sample_variance
                     else cap)
            new_t = _upsample_zvals(rays_o, dirs, t_vals, sdf, n_imp // ups,
                                    inv_s)
            # merge (ref cat_z_vals, 851-869); stable as jnp.argsort
            t_vals, order = torch.sort(torch.cat([t_vals, new_t], -1),
                                       stable=True, dim=-1)
            if i + 1 < ups:
                sdf = torch.gather(torch.cat([sdf, sdf_at(new_t)], -1), -1,
                                   order)

    dists = t_vals[:, 1:] - t_vals[:, :-1]
    dists = torch.cat([dists, dists[:, -1:]], -1)
    mid = t_vals + dists * 0.5
    pts = rays_o[:, None, :] + dirs[:, None, :] * mid[..., None]
    outer = torch.any((aabb[0] > pts) | (pts > aabb[1]), -1)
    return t_vals, t_vals + dists, ~outer


# ---------------------------------------------------------------------------
# the NeRF++ background
# ---------------------------------------------------------------------------

def render_background(params_bg, cfg: ShapeRendererConfig, rays_o, dirs,
                      jitter=None):
    """NeRF++ inverted-sphere background colour [rn, 3]: n_bg_samples
    inverse radii 1/r descending in (0, 1] (with ``jitter``, uniform
    [rn, n], each shifted by (u - 1/2) / n, clipped and sorted again), the
    far intersection of the ray with each sphere, the background net on
    (x/r, 1/r) and the view, rgb = exp(output), composited front to back
    with alpha = 1 - exp(-softplus(sigma) * dist)."""
    n = cfg.n_bg_samples
    rn = rays_o.shape[0]
    s = device_constant(('linspace', 1.0, 1.0 / n, n),
                        lambda: xla_linspace(1.0, 1.0 / n, n), rays_o.device)
    if jitter is not None:
        s = torch.clamp(s[None] + (jitter - 0.5) * (1.0 / n), 1e-4, 1.0)
        s = -torch.sort(-s, dim=-1).values
    else:
        s = s[None].expand(rn, n)
    r = 1.0 / s
    od = torch.sum(rays_o * dirs, -1, keepdim=True)
    oo = torch.sum(rays_o * rays_o, -1, keepdim=True)
    t = -od + torch.sqrt(torch.clamp(od ** 2 - oo + r ** 2, min=1e-6))
    pts = rays_o[:, None, :] + dirs[:, None, :] * t[..., None]
    pr = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), min=1e-3)
    pts4 = torch.cat([pts / pr, 1.0 / pr], -1)
    view = dirs[:, None, :].expand(pts.shape)
    sigma, rgb = mlp.apply_nerf_bg(params_bg, pts4.reshape(-1, 4),
                                   view.reshape(-1, 3))
    sigma = sigma.reshape(rn, n)
    rgb = torch.exp(rgb.reshape(rn, n, 3))
    dists = torch.cat([t[:, 1:] - t[:, :-1], torch.full_like(t[:, :1], 1e4)],
                      -1)
    alpha = 1.0 - torch.exp(-torch.nn.functional.softplus(sigma) * dists)
    weights, _ = composite.weights_from_alpha(alpha)
    return composite.accumulate(weights, rgb)


# ---------------------------------------------------------------------------
# render core (ref: 1105-1277)
# ---------------------------------------------------------------------------

def render_rays(params, cfg: ShapeRendererConfig, mips, occ_state,
                ray_batch, step: int, cos_anneal_ratio, noise,
                is_train: bool, radiance_on: bool = False,
                occ_loss_on: bool = False, eval_extras: bool = False,
                alpha_mask: Optional[grid_mod.AlphaGridMask] = None,
                mesh=None):
    """Render a batch of rays; returns the outputs dict.  ``noise``
    (draw_noise's dict) is read only when is_train; ``alpha_mask`` culls
    samples on the hierarchical sampler only; ``mesh``: see the module
    docstring."""
    rays_o, dirs = ray_batch['rays_o'], ray_batch['dirs']
    radii, rays_cos = ray_batch['radiis'], ray_batch['rays_cos']
    dev = rays_o.device
    aabb = aabb_tensor(cfg, dev)
    rn = rays_o.shape[0]
    sharded = sharding.active(mesh)
    rn_all = rn * mesh.size if sharded else rn
    br = base_radii(cfg)
    near, far = near_far_from_sphere(rays_o, dirs)

    # the occupancy-grid sampler's samples are compacted into
    # compact_samples_per_ray slots a ray; with 0 they are rendered
    # densely, as the hierarchical sampler's are
    compact = cfg.use_occ_grid and cfg.compact_samples_per_ray > 0
    with span('tf.sampler'):
        if cfg.use_occ_grid:
            ss = step_size(cfg) * max(int(cfg.march_stride), 1)
            t_starts, t_ends, valid = grid_mod.occ_grid_sampling(
                occ_state,
                grid_mod.OccGridConfig(resolution=cfg.occ_grid_reso),
                rays_o, dirs, near, far, ss, n_occ_candidates(cfg),
                cfg.occ_max_samples,
                noise['sample_jitter'] if is_train else None)
            packed = None
        else:
            # one atlas for the sampler's and the occ march's field
            # queries, neither of which carries a gradient
            with torch.no_grad():
                packed = tenso_sdf.pack_field(params['sdf'], cfg.sdf)
            t_starts, t_ends, valid = sample_ray_hierarchical(
                params, cfg, rays_o, dirs, near, far, radii, rays_cos,
                noise['sample_jitter'] if is_train else None, packed=packed)

    sn = t_starts.shape[1]
    mid = 0.5 * (t_starts + t_ends)
    dists = t_ends - t_starts
    pts = rays_o[:, None, :] + dirs[:, None, :] * mid[..., None]
    inner = valid & ~torch.any((aabb[0] > pts) | (pts > aabb[1]), -1)
    if alpha_mask is not None and not cfg.use_occ_grid:
        # alpha-mask sample culling (ref: shapeRenderer.py:1119-1128)
        am = alpha_mask.sample_alpha(pts.reshape(-1, 3)).reshape(rn, sn)
        inner = inner & (am > 0)
    sbr = compute_ball_radii(mid[..., None], radii[:, None, :],
                             rays_cos[:, None, :])
    levels = torch.log2(sbr[..., 0] / br)
    flat_dirs = dirs[:, None, :].expand(pts.shape).reshape(-1, 3)
    # the rays' camera poses [rn, 3, 4] (human light) or None; each sample
    # takes its ray's on the device, so the step copies only its batch
    human_poses = ray_batch.get('human_poses') \
        if cfg.shading.human_light else None

    # the global index of this rank's first slot (the occ-loss scores are
    # drawn per global slot)
    slot_base = 0
    if compact:
        m = rn_all * cfg.compact_samples_per_ray
        if sharded:
            src, slot_mask, _, plan = grid_mod.compact_indices_sharded(
                inner.reshape(-1), m, mesh)
            slot_base = plan.offset
        else:
            src, slot_mask, _ = grid_mod.compact_indices(inner.reshape(-1),
                                                         m)
        cols = torch.cat([pts.reshape(-1, 3), levels.reshape(-1, 1),
                          flat_dirs, dists.reshape(-1, 1)], -1)
        s_cols = cols[src]
        s_pts, s_lv = s_cols[:, 0:3], s_cols[:, 3:4]
        s_mid = mid.reshape(-1)[src] if eval_extras else None
        s_dirs, s_dists = s_cols[:, 4:7], s_cols[:, 7]
        s_hp = None if human_poses is None else human_poses[src // sn]
    else:
        # every [rays, samples] sample goes through the field, the masked
        # ones included (the JAX package does not compact them)
        s_pts, s_lv = pts.reshape(-1, 3), levels.reshape(-1, 1)
        s_dirs, s_dists = flat_dirs, dists.reshape(-1)
        slot_mask = inner.reshape(-1)
        slot_base = mesh.rank * rn * sn if sharded else 0
        s_hp = None if human_poses is None else human_poses[:, None].expand(
            rn, sn, 3, 4).reshape(-1, 3, 4)

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
    with span('tf.shading'):
        sampled_color, sampled_radiance, occ_info = \
            shading_mod.apply_shading(
                params['shading'], cfg.shading, mips, s_pts, normals,
                -s_dirs, app_feat, s_hp,
                step=(step if radiance_on else None))

    mask_f = inner.to(alpha_s.dtype)
    slot_f = slot_mask.to(alpha_s.dtype)
    radiance_cols = radiance_on and sampled_radiance is not None
    radiance = rw = t_depth = None
    if compact:
        # composite in compact space: segmented transmittance + one
        # scatter-free segment reduction; invalid slots carry ray_id = rn
        ray_id = torch.where(slot_mask, src // sn, torch.full_like(src, rn))
        w_c = composite.compact_weights(alpha_s, slot_mask, ray_id, rn)
        w_col = w_c[:, None]
        cols = [w_col, w_col * sampled_color, w_col * grads]
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
        if radiance_cols:
            radiance, rw = sums[:, 7:10], sums[:, 10]
        if eval_extras:
            n_cols = 11 if radiance_cols else 7
            t_depth = sums[:, n_cols:n_cols + 1]
    else:
        weights, _ = composite.weights_from_alpha(alpha_s.reshape(rn, sn),
                                                  inner)
        acc = composite.accumulate(weights)
        color = composite.accumulate(weights,
                                     sampled_color.reshape(rn, sn, 3))
        acc_normal = composite.accumulate(weights, grads.reshape(rn, sn, 3))
        if radiance_cols:
            radiance = composite.accumulate(
                weights, sampled_radiance.reshape(rn, sn, 3))
            rw = composite.accumulate(
                weights, occ_info['roughness'].reshape(rn, sn, 1))[:, 0]
        if eval_extras:
            t_depth = composite.accumulate(weights, mid[..., None])
    # the background behind the foreground (ref: shapeRenderer.py:1178-1182)
    if cfg.predict_BG:
        bg = render_background(params['bg'], cfg, rays_o, dirs,
                               noise['bg_jitter'] if is_train else None)
        color = color + bg * (1.0 - acc)
    elif cfg.isBGWhite:
        color = color + (1.0 - acc)

    outputs: Dict[str, Any] = {
        'ray_rgb': color, 'acc': acc,
        'sample_num': sharding.global_sum(mesh, torch.sum(mask_f)) / rn_all,
    }
    up = device_constant('up', lambda: [0.0, 0.0, 1.0], dev, acc.dtype)
    outputs['normal'] = safe_normalize(acc_normal * acc + (1.0 - acc) * up)

    nvalid = torch.clamp(sharding.global_sum(mesh, torch.sum(slot_f)),
                         min=1.0)
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
        if not cfg.predict_BG and cfg.isBGWhite:
            radiance = radiance + (1.0 - acc)
        outputs['radiance'] = radiance
        outputs['roughness_weights'] = rw.detach()

    outputs['sdf_vals'] = sdf
    outputs['sdf_pts_norm'] = torch.linalg.norm(s_pts, dim=-1)
    outputs['sdf_mask'] = slot_f

    if cfg.apply_occ_loss and is_train:
        if not occ_loss_on:
            outputs['loss_occ'] = torch.zeros((), device=dev)
        else:
            if cfg.use_occ_grid:
                # the SDF baked at the last occupancy update
                occ_cfg = grid_mod.OccGridConfig(resolution=cfg.occ_grid_reso)

                def sdf_fun(x):
                    return grid_mod.sample_occ_sdf(occ_state, occ_cfg,
                                                   x)[:, None]
            else:
                # the live field (ref get_intersection branch,
                # shapeRenderer.py:1052-1054)
                def sdf_fun(x):
                    return tenso_sdf.sdf_only(params['sdf'], cfg.sdf, x,
                                              aabb, packed=packed)
            score = noise['occ_score']
            if sharded:
                score = _local_scores(score, slot_base, slot_mask.shape[0],
                                      plan.kept if compact else None)
            n_all = m if compact else rn_all * sn
            with span('tf.occ_loss'):
                outputs['loss_occ'] = _occ_loss(
                    cfg, s_pts, sdf, normals, s_dirs, occ_info, slot_mask,
                    score, inv_s, sdf_fun, mesh=mesh, n_all=n_all,
                    base=slot_base)
    if eval_extras:
        outputs.update(_eval_extras(params, cfg, mips, aabb, ray_batch,
                                    t_depth, inv_s, step))
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
                                                 surf_pts, aabb, lv_d,
                                                 packed=packed))
    inner_d = (~torch.any((aabb[0] > surf_pts) | (surf_pts > aabb[1]), -1,
                          keepdim=True)).to(nrm.dtype)
    out['normal_vis'] = ((nrm + 1.0) * 0.5) * inner_d
    feat = tenso_sdf.apply_tenso_sdf(params['sdf'], cfg.sdf, surf_pts, aabb,
                                     lv_d, packed=packed)[..., 1:]
    _, _, occ_info, inter = shading_mod.apply_shading(
        params['shading'], cfg.shading, mips, surf_pts, nrm, -dirs, feat,
        ray_batch.get('human_poses'), step=step, inter_results=True)

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


def _local_scores(score, base: int, n: int, kept):
    """This rank's n slots' scores out of the global draw: slots from
    ``base`` on (only the first ``kept`` of a compacted rank's slots hold
    samples; the rest get 0, their samples being invalid)."""
    take = n if kept is None else kept
    out = score[base:base + take]
    if out.shape[0] < n:
        out = torch.cat([out, out.new_zeros(n - out.shape[0])])
    return out


def _occ_loss(cfg: ShapeRendererConfig, flat_pts, sdf, normals, flat_dirs,
              occ_info, flat_inner, score_noise, inv_s, sdf_fun, mesh=None,
              n_all=None, base: int = 0):
    """Occlusion-probability supervision (ref: shapeRenderer.py:1027-1103):
    select up to occ_loss_max_pn qualifying surface samples by the largest
    random scores, march their reflection rays through ``sdf_fun`` (the
    baked lattice on the occupancy grid, the live field otherwise; no
    gradient either way), L1 against the predicted occlusion
    probability.  With an active mesh the selection is the global top-k
    over ``n_all`` samples (this rank's at global indices base + i) and
    the mean is over the global selection."""
    n = flat_pts.shape[0]
    sdf_mask = torch.abs(sdf) < cfg.occ_sdf_thresh
    normal_mask = torch.sum(normals * flat_dirs, -1) < 0
    mask = flat_inner & sdf_mask & normal_mask
    score = torch.where(mask, score_noise, torch.full_like(score_noise,
                                                           -1.0))
    if sharding.active(mesh):
        kk = min(cfg.occ_loss_max_pn, n_all)
        idx = sharding.global_topk(mesh, score, kk, base)
        if idx.numel() == 0:
            # nothing of the selection here: one masked-out sample keeps
            # the march's shapes non-empty
            idx = torch.zeros((1,), dtype=torch.long, device=score.device)
            mask = torch.zeros_like(mask)
    else:
        kk = min(cfg.occ_loss_max_pn, n)
        idx = torch.topk(score, kk, sorted=True).indices
    sel_mask = mask[idx]
    sel_pts = flat_pts[idx]
    sel_ref = occ_info['reflective'][idx]
    sel_occ = occ_info['occ_prob'][idx]
    _, w, _ = secondary.secondary_intersection(sdf_fun, inv_s.detach(),
                                               sel_pts.detach(),
                                               sel_ref.detach(), 64, 16)
    occ_gt = torch.sum(w, -1, keepdim=True)
    l1 = torch.abs(sel_occ - occ_gt)[:, 0] * sel_mask.to(sel_occ.dtype)
    n_sel = sharding.global_sum(mesh, torch.sum(sel_mask))
    return torch.sum(l1) / torch.clamp(n_sel, min=1.0)


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


def compute_grid_alpha(params, cfg: ShapeRendererConfig, pts,
                       step_length: float, mul_length: float = 10.0,
                       packed=None):
    """Alpha for the alpha-mask update (ref: shapeRenderer.py:299-325):
    isotropic NeuS alpha with near-surface cells forced opaque."""
    aabb = aabb_tensor(cfg, pts.device)
    sdf = tenso_sdf.sdf_only(params['sdf'], cfg.sdf, pts, aabb,
                             packed=packed)[:, 0]
    inv_s = torch.clamp(mlp.apply_variance(params['deviation'], cfg.std_act),
                        1e-6, 1e6)
    alpha = composite.neus_alpha_isotropic(sdf, inv_s, step_length)
    near_surf = torch.abs(sdf) < mul_length * step_length
    return torch.where(near_surf, torch.ones_like(alpha), alpha)


@torch.no_grad()
def build_alpha_mask(params, cfg: ShapeRendererConfig,
                     grid_size: int = 128, mul_length: float = 10.0,
                     alpha_thresh: float = 1e-4,
                     chunk: int = 262144) -> grid_mod.AlphaGridMask:
    """updateAlphaMask equivalent (ref: shapeRenderer.py:256-282): alpha
    on a grid_size^3 lattice over the aabb in chunks, 3^3 max pool,
    threshold.  The mask lives where the parameters do; the field atlas is
    packed once per build."""
    aabb_np = np.asarray(cfg.aabb, np.float32)
    xs = [np.linspace(aabb_np[0][d], aabb_np[1][d], grid_size,
                      dtype=np.float32) for d in range(3)]
    step_length = float(((aabb_np[1] - aabb_np[0])
                         / (grid_size - 1)).mean())
    dev = params['deviation']['variance'].device
    pts = torch.as_tensor(np.stack(np.meshgrid(*xs, indexing='ij'),
                                   -1).reshape(-1, 3), device=dev)
    packed = tenso_sdf.pack_field(params['sdf'], cfg.sdf)
    vol = torch.cat([compute_grid_alpha(params, cfg, pts[i:i + chunk],
                                        step_length, mul_length, packed)
                     for i in range(0, pts.shape[0], chunk)])
    vol = torch.clamp(vol.reshape((grid_size,) * 3), 0.0, 1.0)
    vol = (grid_mod.max_pool_3d_3x3(vol) >= alpha_thresh).float()
    return grid_mod.AlphaGridMask(aabb=aabb_tensor(cfg, dev), volume=vol)


def train_step_outputs(params, cfg: ShapeRendererConfig, mips, occ_state,
                       ray_batch, step: int, noise, radiance_on: bool,
                       occ_loss_on: bool, alpha_mask=None, mesh=None):
    """Training forward: render + rgb/psnr/mask losses
    (ref: shapeRenderer.py:777-794).  With an active mesh, psnr is the
    global batch's and loss_mask this rank's share of the global mean."""
    anneal = min(1.0, step / cfg.anneal_end) if cfg.anneal_end >= 0 else 1.0
    outputs = render_rays(params, cfg, mips, occ_state, ray_batch, step,
                          anneal, noise, True, radiance_on, occ_loss_on,
                          alpha_mask=alpha_mask, mesh=mesh)
    rgb_gt = ray_batch['rgbs']
    outputs['loss_rgb'] = compute_rgb_loss(cfg, outputs['ray_rgb'], rgb_gt)
    mse = sharding.global_sum(mesh, sharding.mean_share(
        mesh, (outputs['ray_rgb'] - rgb_gt) ** 2))
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
        outputs['loss_mask'] = sharding.mean_share(
            mesh, -(m * torch.log(acc) + (1 - m) * torch.log(1 - acc)))
    return outputs

