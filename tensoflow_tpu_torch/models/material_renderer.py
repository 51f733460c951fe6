"""Stage-2 material renderer: surface shading with the MC estimator
(counterpart of tensoflow_tpu/models/material_renderer.py).

Stage-1 geometry arrives as a frozen checkpoint; its SDF is baked to a
dense grid (the analogue of the reference's extracted mesh) and
sphere-traced for primary and secondary visibility.  Primary hits are
refined by a two-pass hierarchical march of the *neural* SDF around the
traced depth, and their normals come from the neural SDF's
finite-difference gradient, flipped to face the ray
(ref: materialRenderer.py:265-343).

Evaluation shades with ``is_train=False``: the analytic samplers take no
azimuth roll and the lattice flow prior no roll either, as in the
reference; only a realnvp flow's Gaussian prior draws at evaluation
(``eval_outputs``'s ``noise``, from mc_shading.draw_eval_noise).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import device_constant
from ..fields import mc_shading, mlp, tenso_sdf
from ..ops import sdf_trace
from ..ops.math import charbonnier, sample_pdf
from ..parallel import sharding
from .secondary import march_weights


class MaterialRendererConfig(NamedTuple):
    """(ref: materialRenderer.py:99-133)"""
    shader: mc_shading.MCShadingConfig = mc_shading.MCShadingConfig()
    sdf: tenso_sdf.SDFConfig = tenso_sdf.SDFConfig()
    aabb: Tuple[Tuple[float, ...], Tuple[float, ...]] = (
        (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    train_ray_num: int = 2048
    test_ray_num: int = 8192
    rgb_loss: str = 'charbonier'
    reg_mat: bool = True
    reg_diffuse_light: bool = True
    reg_diffuse_light_lambda: float = 0.1
    std_act: str = 'exp'
    inv_s_init: float = 0.3
    direct_sn0: int = 128
    direct_sn1: int = 9
    trace_sn0: int = 32
    trace_sn1: int = 9
    bake_resolution: int = 256
    trace_packed: bool = True
    refine_with_neural_sdf: bool = True


def unit_size(cfg: MaterialRendererConfig) -> float:
    """(ref: materialRenderer.py:159)"""
    a = np.asarray(cfg.aabb, np.float64)
    gs = np.asarray(cfg.sdf.grid_size)
    return float(((a[1] - a[0]) / (gs - 1)).mean())


def radius_of(cfg: MaterialRendererConfig) -> float:
    a = np.asarray(cfg.aabb, np.float64)
    center = a.mean(0)
    return float((a[1] - center).mean())


def aabb_tensor(cfg: MaterialRendererConfig, device):
    return device_constant(('aabb', cfg.aabb), lambda: cfg.aabb, device)


def sdf_fun_of(geo_params, cfg: MaterialRendererConfig, device):
    """[M,3] -> [M,1] evaluator of the frozen stage-1 SDF (its 2x2 patch
    atlas is packed once, here)."""
    aabb = aabb_tensor(cfg, device)
    packed = tenso_sdf.pack_field(geo_params['sdf'], cfg.sdf)

    def sdf_fun(x):
        return tenso_sdf.sdf_only(geo_params['sdf'], cfg.sdf, x, aabb,
                                  packed=packed)
    return sdf_fun


@torch.no_grad()
def bake_geometry(geo_params, cfg: MaterialRendererConfig, device):
    """Bake the frozen stage-1 SDF.  Returns the packed trace
    representation (ops/sdf_trace.pack_sdf_grid), with the visibility
    cache when the shader budgets its coarse march; ``trace_packed=False``
    returns the dense reference grid."""
    dense = sdf_trace.bake_sdf_grid(
        sdf_fun_of(geo_params, cfg, device), cfg.aabb, cfg.bake_resolution,
        device=device)
    if not cfg.trace_packed:
        return dense
    pg = sdf_trace.pack_sdf_grid(dense)
    if 0.0 < cfg.shader.a1_budget < 1.0:
        # the apex pad reserves the 2*unit_size launch offset, so that
        # get_lights can key ONE cache row per surface point
        pg = sdf_trace.bake_vis_cache(pg, apex_pad=2.0 * unit_size(cfg))
    return pg


def near_far_from_sphere(rays_o, rays_d, radius: float):
    """(ref: materialRenderer.py:345-355)"""
    a = torch.sum(rays_d ** 2, -1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, -1, keepdim=True)
    mid = 0.5 * (-b) / a
    return torch.clamp(mid - radius, min=1e-3), mid + radius


@torch.no_grad()
def trace_surface(geo_params, cfg: MaterialRendererConfig, grid, rays_o,
                  rays_d):
    """Primary-ray surface intersection with optional neural refinement
    (ref: materialRenderer.py:281-343 trace_sdf_with_mesh).
    Returns (inters [pn,3], normals [pn,3], depth [pn,1], hit [pn])."""
    aabb = aabb_tensor(cfg, rays_o.device)
    inters, g_normals, depth, hit = sdf_trace.sphere_trace(
        grid, rays_o, rays_d, n_steps=64)
    if not cfg.refine_with_neural_sdf:
        return inters, g_normals, depth, hit

    sdf_fun = sdf_fun_of(geo_params, cfg, rays_o.device)
    inv_s = torch.clamp(mlp.apply_variance(geo_params['deviation'],
                                           cfg.std_act), 1e-6, 1e6)
    us = unit_size(cfg)
    near, far = near_far_from_sphere(rays_o, rays_d, radius_of(cfg))
    hit1 = hit[:, None]
    m_depth = torch.where(hit1, depth, 0.5 * (near + far))
    t_min = torch.minimum(torch.maximum(m_depth - us * 4, near), far)
    t_max = torch.minimum(torch.maximum(m_depth + us * 4, near), far)
    z = torch.linspace(0.0, 1.0, cfg.trace_sn0, dtype=rays_o.dtype,
                       device=rays_o.device)
    z_vals = t_min + (t_max - t_min) * z[None, :]
    w, _ = march_weights(sdf_fun, inv_s, z_vals, rays_o, rays_d)
    z_new = torch.sort(sample_pdf(z_vals, w, cfg.trace_sn1), -1).values
    w2, _ = march_weights(sdf_fun, inv_s, z_new, rays_o, rays_d)
    z_mid = 0.5 * (z_new[:, 1:] + z_new[:, :-1])
    wsum = torch.sum(w2, -1, keepdim=True)
    wn = torch.where(wsum > 1e-6, w2 / torch.clamp(wsum, min=1e-6),
                     torch.full_like(w2, 1.0 / (cfg.trace_sn1 - 1)))
    ref_depth = torch.sum(wn * z_mid, -1, keepdim=True)
    depth = torch.where(hit1, ref_depth, depth)
    inters = torch.where(hit1, rays_o + depth * rays_d, inters)

    grad = tenso_sdf.gradient_only(geo_params['sdf'], cfg.sdf, inters, aabb)
    n = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True),
                           min=1e-8)
    n = torch.where(torch.sum(n * rays_d, -1, keepdim=True) >= 0, -n, n)
    return inters, torch.where(hit1, n, g_normals), depth, hit


def compute_rgb_loss(cfg: MaterialRendererConfig, rgb_pr, rgb_gt):
    """(ref: materialRenderer.py:523-531)"""
    if cfg.rgb_loss == 'l1':
        return torch.sum(torch.abs(rgb_pr - rgb_gt), -1)
    if cfg.rgb_loss == 'charbonier':
        return charbonnier(rgb_pr, rgb_gt)
    raise NotImplementedError(cfg.rgb_loss)


def diffuse_light_regularization(diffuse_lights, lam: float):
    """White-light prior (ref: materialRenderer.py:533-535)."""
    return torch.sum(torch.abs(
        diffuse_lights - torch.mean(diffuse_lights, -1, keepdim=True)),
        -1) * lam


def reg_minmax_factor(step: int) -> float:
    """The material clamps' factor at ``step``: on (1.0) while step <
    2000, then off."""
    return 1.0 if step < 2000 else 0.0


def train_step_outputs(params, cfg: MaterialRendererConfig, grid, batch,
                       phase: mc_shading.ShadePhase, noise, step: int,
                       flow_diffuse_copy=None, flow_specular_copy=None,
                       mesh=None, reg_minmax=None):
    """Training forward on precomputed surface hits
    (ref: materialRenderer.py:537-564).  noise: mc_shading.draw_shade_noise's
    dict.  mesh: on an active mesh the hits and noise are this rank's
    shard, psnr is global and the losses are this rank's shares
    (mc_shading.shade_mixed).  ``reg_minmax`` (default reg_minmax_factor
    at ``step``) may be a 0-d tensor on the device, as the trainer's CUDA
    graph feeds it."""
    if reg_minmax is None:
        reg_minmax = reg_minmax_factor(step)
    pts = batch['inters']
    aabb = aabb_tensor(cfg, pts.device)
    normals = batch['normals']
    rgb_gt = batch['rgb']
    outputs = mc_shading.mc_forward(
        params, cfg.shader, grid, unit_size(cfg), aabb, pts,
        -batch['rays_d'], normals, phase, noise, True, flow_diffuse_copy,
        flow_specular_copy, human_poses=batch.get('human_poses'), mesh=mesh)
    outputs['rgb_gt'] = rgb_gt
    outputs['loss_rgb'] = compute_rgb_loss(cfg, outputs['rgb_pr'], rgb_gt)
    mse = sharding.global_sum(mesh, sharding.mean_share(
        mesh, (outputs['rgb_pr'] - rgb_gt) ** 2))
    outputs['psnr'] = 20.0 * torch.log10(
        1.0 / torch.sqrt(torch.clamp(mse, min=1e-10)))
    if cfg.reg_mat:
        outputs['loss_mat_reg'] = mc_shading.material_regularization(
            params, cfg.shader, pts, normals, outputs['metallic'],
            outputs['roughness'], outputs['albedo'], reg_minmax, mesh)
    if cfg.reg_diffuse_light:
        outputs['loss_diffuse_light'] = diffuse_light_regularization(
            outputs['diffuse_light'], cfg.reg_diffuse_light_lambda)
    return outputs


def eval_outputs(params, cfg: MaterialRendererConfig, grid, batch,
                 flow_diffuse_copy=None, flow_specular_copy=None,
                 with_nis: bool = True, noise=None):
    """Eval forward on traced hits: the analytic pass, then the ``_nis``
    pass (both flow copies sampled; a shade_mixed_all model reads its
    combined copy from the diffuse slot) when the copies exist
    (ref: materialRenderer.py:566-639; fields.py:1465-1473).  noise: the
    ``_nis`` pass's flow-prior draws (mc_shading.draw_eval_noise).  Like
    the reference it passes no human poses: a human-light scene renders
    without the photographer light."""
    pts = batch['inters']
    aabb = aabb_tensor(cfg, pts.device)
    args = (params, cfg.shader, grid, unit_size(cfg), aabb, pts,
            -batch['rays_d'], batch['normals'])
    out = mc_shading.mc_forward(*args, mc_shading.ShadePhase(), None, False)
    if with_nis and flow_diffuse_copy is not None:
        out_nis = mc_shading.mc_forward(
            *args, mc_shading.ShadePhase(nis_sample_diffuse=True,
                                         nis_sample_specular=True),
            noise, False, flow_diffuse_copy, flow_specular_copy)
        out.update({k + '_nis': v for k, v in out_nis.items()})
    return out


@torch.no_grad()
def predict_vertex_materials(params, cfg: MaterialRendererConfig, verts,
                             batch_size: int = 8192):
    """Materials at mesh vertices [V, 3] (numpy) in chunks of
    ``batch_size``, the last one zero-padded (ref: materialRenderer.py:
    770-782).  Returns numpy arrays; roughness un-squared."""
    dev = params['metallic']['layers'][0]['b'].device
    aabb = aabb_tensor(cfg, dev)
    n = verts.shape[0]
    pad = (-n) % batch_size
    verts_p = np.concatenate([verts, np.zeros((pad, 3), verts.dtype)], 0)
    outs = []
    for i in range(0, len(verts_p), batch_size):
        v = torch.as_tensor(verts_p[i:i + batch_size], dtype=torch.float32,
                            device=dev)
        m, r, a = mc_shading.predict_materials(params, cfg.shader, v, aabb)
        r = torch.sqrt(torch.clamp(r, min=1e-7))
        outs.append(torch.cat([m, r, a], -1).cpu().numpy())
    out = np.concatenate(outs, 0)[:n]
    return {'metallic': out[:, 0:1], 'roughness': out[:, 1:2],
            'albedo': out[:, 2:5]}
