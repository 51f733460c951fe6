"""Stage-1 shading network of the port (counterpart of
tensoflow_tpu/fields/shading.py): split-sum PBR at each ray sample.

Material MLP -> albedo/roughness/metallic; diffuse = albedo x cosine-
prefiltered envlight(normal); specular = FG-LUT(NoV, roughness) x the
light blended between an indirect-light MLP and the prefiltered envlight
by a learned occlusion probability; with ``human_light`` the envlight
part is blended with a photographer light predicted where the reflected
ray meets the capturing camera's plane.  The FG LUT is the port's own
asset (assets/fg_lut_256_1024.npy, the JAX package's table), the cache
of compute_fg_lut(256, 1024).
"""
from __future__ import annotations

import functools
import os
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import device_constant
from ..ops.math import (get_camera_plane_intersection, ide_dim,
                        integrated_dir_encoding,
                        integrated_positional_encoding, linear_to_srgb,
                        pe_dim, positional_encoding, safe_normalize)
from ..ops.tensor_field import sample_bilinear_packed
from . import light as envlight_mod
from . import mlp

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets')


class ShadingConfig(NamedTuple):
    human_light: bool = False
    sphere_direction: bool = False
    light_pos_freq: int = 8
    inner_init: float = -0.95
    light_exp_max: float = 0.0
    app_feats_dim: int = 128
    has_radiance_field: bool = False
    radiance_field_step: int = 0
    mat_pos_multires: int = -1
    env: envlight_mod.EnvLightConfig = envlight_mod.EnvLightConfig()


@functools.lru_cache(maxsize=2)
def compute_fg_lut_packed(res: int = 256, n_samples: int = 1024):
    """compute_fg_lut as a patch_pack_2d row table: ((rows, 8), (H, W))."""
    lut = compute_fg_lut(res, n_samples)
    h, w, c = lut.shape
    pad = np.pad(lut, ((1, 1), (1, 1), (0, 0)), mode='edge')
    slots = [pad[d0:d0 + h + 1, d1:d1 + w + 1]
             for d0 in (0, 1) for d1 in (0, 1)]
    packed = np.concatenate(slots, -1).reshape((h + 1) * (w + 1), 4 * c)
    return packed, (h, w)


@functools.lru_cache(maxsize=2)
def compute_fg_lut(res: int = 256, n_samples: int = 1024) -> np.ndarray:
    """Split-sum environment-BRDF LUT [roughness, NoV, 2], the JAX
    package's numpy integration as it is.

    A(NoV, r), B(NoV, r) such that specular ~ F0 * A + B.  GGX importance
    sampling (alpha = roughness^2) with the height-correlated Smith
    masking-shadowing term.  Read from assets/fg_lut_<res>_<n>.npy when
    that cache exists, else computed (~1 min at full res) and cached
    there."""
    cache = os.path.join(ASSETS, f'fg_lut_{res}_{n_samples}.npy')
    if os.path.exists(cache):
        return np.load(cache)

    nov = np.linspace(0.5 / res, 1 - 0.5 / res, res)[None, :, None]   # [1,R,1]
    rough = np.linspace(0.5 / res, 1 - 0.5 / res, res)[:, None, None]  # [R,1,1]

    # hammersley sequence
    i = np.arange(n_samples)
    xi1 = (i + 0.5) / n_samples
    xi2 = np.array([int(bin(x)[2:].zfill(32)[::-1], 2) for x in i],
                   np.float64) / 2 ** 32

    a = rough ** 2
    phi = 2 * np.pi * xi1[None, None, :]
    cos_t = np.sqrt((1 - xi2[None, None, :])
                    / (1 + (a ** 2 - 1) * xi2[None, None, :]))
    sin_t = np.sqrt(np.maximum(1 - cos_t ** 2, 0))

    # view vector in tangent space (n = +z)
    v = np.stack([np.sqrt(np.maximum(1 - nov ** 2, 0))
                  * np.ones_like(cos_t),
                  np.zeros_like(cos_t * nov),
                  nov * np.ones_like(cos_t)], -1)
    h = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1)
    voh = np.sum(v * h, -1)
    l = 2 * voh[..., None] * h - v                      # noqa: E741
    nol = l[..., 2]
    noh = np.clip(cos_t, 0, 1)
    voh = np.clip(voh, 0, 1)

    def lam(a2, c):
        c2 = c * c
        t2 = (1 - c2) / np.maximum(c2, 1e-9)
        return 0.5 * np.sqrt(1 + a2 * t2) - 0.5

    g = 1.0 / (1.0 + lam(a * a, nov) + lam(a * a, np.clip(nol, 1e-6, 1)))
    g_vis = np.where(nol > 0, g * voh / np.maximum(noh * nov, 1e-6), 0.0)
    fc = (1 - voh) ** 5
    a_term = np.mean((1 - fc) * g_vis, -1)
    b_term = np.mean(fc * g_vis, -1)
    out = np.stack([a_term, b_term], -1).astype(np.float32)
    try:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.save(cache, out)
    except OSError:
        pass
    return out


@functools.lru_cache(maxsize=4)
def fg_lut_packed(device: str):
    """The shipped 256 x 256 LUT (1,024 samples) packed, on ``device``
    (uploaded once per device)."""
    packed, hw = compute_fg_lut_packed(256, 1024)
    return torch.as_tensor(packed, dtype=torch.float32, device=device), hw


def init_shading(gen: torch.Generator, cfg: ShadingConfig,
                 device='cpu') -> Dict[str, Any]:
    feats = cfg.app_feats_dim
    sph_dim = ide_dim(5)
    dir_dim = pe_dim(3, 6)
    pos_dim = pe_dim(3, cfg.light_pos_freq)
    pos_in = (pe_dim(3, cfg.mat_pos_multires) if cfg.mat_pos_multires > 0
              else 3 if cfg.mat_pos_multires == 0 else 0)
    kw = dict(device=device)
    params = {
        'mat_mlp': mlp.init_predictor(gen, feats + pos_in, 5, 3, run_dim=128,
                                      **kw),
        'outer_light': mlp.init_predictor(
            gen, sph_dim * (2 if cfg.sphere_direction else 1), 3, 3,
            final_bias=float(np.log(0.5)), **kw),
        'envlight': envlight_mod.init_env_light(cfg.env, device),
        'inner_light': mlp.init_predictor(gen, pos_dim + sph_dim, 3, 3,
                                          final_bias=float(np.log(0.5)),
                                          **kw),
        'inner_weight': mlp.init_predictor(gen, pos_dim + dir_dim, 1, 3,
                                           final_bias=cfg.inner_init, **kw),
    }
    if cfg.has_radiance_field:
        params['rad_mlp'] = mlp.init_predictor(
            gen, feats + 3 + pe_dim(3, 4) + 3, 3, 3, run_dim=128, **kw)
    if cfg.human_light:
        params['human_light'] = mlp.init_predictor(
            gen, 2 * 2 * 6, 4, 3, final_bias=float(np.log(0.01)), **kw)
    return params


def _fix_normals(normals):
    """(ref: fields.py:484-485) avoid exactly-vertical zero-xy normals."""
    normals = safe_normalize(normals)
    degen = (normals[:, 0:1] + normals[:, 1:2]) == 0.0
    fallback = device_constant('normal_fallback', lambda: [0.0, 1e-6, 1.0],
                               normals.device, normals.dtype)
    return torch.where(degen, fallback[None, :], normals)


def predict_human_light(params, points, reflective, human_poses, roughness):
    """The photographer light (ref: fields.py:377-393): the reflected ray
    meets the camera's XoY plane (human_poses [N, 3, 4]); an IPE of the
    hit, widened by roughness and distance, feeds the human_light MLP.
    Returns (light [N, 3], blend weight [N, 1]), zero off the plane."""
    inter, dists, hits = get_camera_plane_intersection(
        points, reflective, human_poses)
    scale = 0.3
    mean = inter[..., :2] * scale
    var = roughness * (dists[:, None] * scale) ** 2
    hits = hits & (torch.linalg.norm(mean, dim=-1) < 1.5) & (dists > 0)
    hits = hits.to(torch.float32)[:, None]
    mean = mean * hits
    var = (var * hits).expand(mean.shape)
    enc = integrated_positional_encoding(mean, var, 0, 6)
    hl = mlp.apply_predictor(params['human_light'], enc, 'exp', 5.0) * hits
    return hl[..., :3], torch.clamp(hl[..., 3:], 0.0, 1.0)


def apply_shading(params, cfg: ShadingConfig, mips, points, normals,
                  view_dirs, feature_vectors, human_poses=None,
                  step: Optional[int] = None, inter_results: bool = False):
    """Forward shading (ref: fields.py:448-567).  human_poses [N, 3, 4]
    (with cfg.human_light) blends in the photographer light; step=None
    disables the radiance head.  Returns (color [N,3], radiance or None,
    occ_info), and with inter_results the intermediates dict (materials,
    lights and colours, the displayed ones as clipped sRGB; with
    cfg.human_light also 'human_light') as a fourth item."""
    normals = _fix_normals(normals)
    view_dirs = safe_normalize(view_dirs)
    reflective = torch.sum(view_dirs * normals, -1, keepdim=True) \
        * normals * 2 - view_dirs
    nov = torch.sum(normals * view_dirs, -1, keepdim=True)

    if cfg.mat_pos_multires > 0:
        mat_in = torch.cat([feature_vectors, positional_encoding(
            points, cfg.mat_pos_multires)], -1)
    elif cfg.mat_pos_multires == 0:
        mat_in = torch.cat([feature_vectors, points], -1)
    else:
        mat_in = feature_vectors
    mat = mlp.apply_predictor(params['mat_mlp'], mat_in, 'sigmoid')
    albedo, roughness, metallic = mat[..., :3], mat[..., 3:4], mat[..., 4:]
    albedo = albedo * 0.77 + 0.03
    roughness = roughness * 0.9 + 0.09

    radiance = None
    if cfg.has_radiance_field and step is not None \
            and step > cfg.radiance_field_step:
        rad_in = torch.cat([feature_vectors, points,
                            positional_encoding(view_dirs, 4), normals], -1)
        radiance = mlp.apply_predictor(params['rad_mlp'], rad_in, 'sigmoid')

    diffuse_albedo = (1.0 - metallic) * albedo
    diffuse_light = envlight_mod.shade(mips, normals, None, cfg.env)
    diffuse_color = diffuse_albedo * diffuse_light

    specular_albedo = 0.04 * (1.0 - metallic) + metallic * albedo
    ref_rough = integrated_dir_encoding(reflective, roughness, 5)
    direct_light = envlight_mod.shade(mips, reflective, roughness, cfg.env)
    pts_enc = positional_encoding(points, cfg.light_pos_freq)
    indirect_light = mlp.apply_predictor(
        params['inner_light'], torch.cat([pts_enc, ref_rough], -1),
        'exp', cfg.light_exp_max)
    ref_enc = positional_encoding(reflective, 6)
    occ_in = torch.cat([pts_enc, ref_enc], -1).detach()
    occ_prob = mlp.apply_predictor(params['inner_weight'], occ_in, 'none')
    occ_prob = occ_prob * 0.5 + 0.5
    occ_prob_c = torch.clamp(occ_prob, 0.0, 1.0)

    human_light, human_weight = 0.0, 0.0
    if cfg.human_light and human_poses is not None:
        human_light, human_weight = predict_human_light(
            params, points, reflective, human_poses, roughness)
    specular_light = (indirect_light * occ_prob_c
                      + (human_light * human_weight
                         + direct_light * (1.0 - human_weight))
                      * (1.0 - occ_prob_c))

    lut_p, (res_h, res_w) = fg_lut_packed(str(points.device))
    fg = sample_bilinear_packed(
        lut_p, res_h, res_w,
        torch.clamp(roughness[:, 0], 0.0, 1.0) * res_h - 0.5,
        torch.clamp(nov[:, 0], 0.0, 1.0) * res_w - 0.5)
    specular_ref = specular_albedo * fg[:, 0:1] + fg[:, 1:2]
    specular_color = specular_ref * specular_light

    color = torch.clamp(linear_to_srgb(diffuse_color + specular_color),
                        0.0, 1.0)
    occ_info = {'reflective': reflective, 'occ_prob': occ_prob,
                'roughness': roughness}
    if inter_results:
        def srgb01(x):
            return torch.clamp(linear_to_srgb(x), 0.0, 1.0)
        inter = {
            'specular_albedo': specular_albedo,
            'specular_ref': torch.clamp(specular_ref, 0.0, 1.0),
            'specular_direct_light': direct_light,
            'specular_light': srgb01(specular_light),
            'specular_color': srgb01(specular_color),
            'diffuse_albedo': diffuse_albedo,
            'diffuse_light': srgb01(diffuse_light),
            'diffuse_color': srgb01(diffuse_color),
            'metallic': metallic,
            'roughness': roughness,
            'albedo': albedo,
            'occ_prob': occ_prob_c,
            'indirect_light': indirect_light * occ_prob_c,
        }
        if cfg.human_light:
            hl = human_light * human_weight     # 0.0 without poses
            inter['human_light'] = linear_to_srgb(
                hl if torch.is_tensor(hl) else specular_light.new_zeros(()))
        return color, radiance, occ_info, inter
    return color, radiance, occ_info
