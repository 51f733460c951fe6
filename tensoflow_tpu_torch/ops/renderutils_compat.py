"""The renderutils BSDF / normal / loss / transform set in PyTorch
(counterpart of tensoflow_tpu/ops/renderutils_compat.py; ref:
network/renderutils/ops.py:23-84, python oracles renderutils/bsdf.py and
loss.py).  The reference's main path uses only the cubemap
pre-integration (ops/cubemap.py); these are here for capability parity and
are used by tests only.  Plain tensor functions, differentiable with
autograd.
"""
from __future__ import annotations

import numpy as np
import torch

from .math import dot, linear_to_srgb, safe_normalize

SPECULAR_EPSILON = 1e-4
NORMAL_THRESHOLD = 0.1


# ---------------------------------------------------------------------------
# diffuse lobes (ref: renderutils/bsdf.py lambert/frostbite)
# ---------------------------------------------------------------------------

def lambert(nrm, wi):
    return torch.clamp(dot(nrm, wi), min=0.0) / np.pi


def fresnel_schlick90(f0, f90, cos_theta):
    """Schlick fresnel with explicit f90 and the reference's epsilon
    clamp (ref: bsdf.py:99-101)."""
    ct = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - ct) ** 5.0


def frostbite_diffuse(nrm, wi, wo, linear_roughness):
    """Frostbite energy-conserving diffuse (ref: bsdf.py:66-81: the scatter
    product only, no NdotL / pi factor)."""
    wi_dot_n = dot(nrm, wi)
    wo_dot_n = dot(nrm, wo)
    h = safe_normalize(wi + wo)
    wi_dot_h = dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_dot_h * wi_dot_h * linear_roughness
    wi_scatter = fresnel_schlick90(1.0, f90, wi_dot_n)
    wo_scatter = fresnel_schlick90(1.0, f90, wo_dot_n)
    mask = (wi_dot_n > 0) & (wo_dot_n > 0)
    out = wi_scatter * wo_scatter * energy_factor
    return torch.where(mask, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# microfacet terms
# ---------------------------------------------------------------------------

def ndf_ggx(alpha_sqr, cos_theta):
    ct = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (ct * alpha_sqr - ct) * ct + 1.0
    return alpha_sqr / (d * d * np.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    ct = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    ct2 = ct * ct
    tan2 = (1.0 - ct2) / ct2
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan2) - 1.0)


def masking_smith_ggx_correlated(alpha_sqr, cos_theta_i, cos_theta_o):
    li = lambda_ggx(alpha_sqr, cos_theta_i)
    lo = lambda_ggx(alpha_sqr, cos_theta_o)
    return 1.0 / (1.0 + li + lo)


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness: float = 0.08):
    """Cook-Torrance specular lobe (renderutils pbr_specular semantics)."""
    alpha = torch.clamp(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = alpha * alpha
    h = safe_normalize(wo + wi)
    wo_dot_n = dot(nrm, wo)
    wi_dot_n = dot(nrm, wi)
    wo_dot_h = dot(h, wo)
    n_dot_h = dot(nrm, h)
    d = ndf_ggx(alpha_sqr, n_dot_h)
    g = masking_smith_ggx_correlated(alpha_sqr, wo_dot_n, wi_dot_n)
    f = fresnel_schlick90(col, 1.0, wo_dot_h)
    w = f * d * g * 0.25 / torch.clamp(wo_dot_n, min=SPECULAR_EPSILON)
    frontfacing = (wo_dot_n > SPECULAR_EPSILON) & (wi_dot_n > SPECULAR_EPSILON)
    return torch.where(frontfacing, w, torch.zeros_like(w))


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos,
             min_roughness: float = 0.08, bsdf: int = 0):
    """Full PBR BSDF (diffuse + specular), renderutils layout: kd [...,3]
    albedo; arm [...,3] = (ao, roughness, metallic); bsdf 0 = lambert
    diffuse, 1 = frostbite (ref: bsdf.py:138-160)."""
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd_eff = kd * (1.0 - metallic)
    if bsdf == 0:
        diffuse = kd_eff * lambert(nrm, wi)
    else:
        diffuse = kd_eff * frostbite_diffuse(nrm, wi, wo, roughness)
    alpha = roughness * roughness
    specular = pbr_specular(ks, nrm, wo, wi, alpha, min_roughness)
    return diffuse + specular


# ---------------------------------------------------------------------------
# normals (ref: c_src/normal.cu prepare_shading_normal)
# ---------------------------------------------------------------------------

def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm,
                           smooth_tng, geom_nrm, two_sided_shading=True,
                           opengl=True):
    """Tangent-space normal perturbation, two-sided / backface handling and
    the grazing-angle bend toward the geometric normal
    (ref: bsdf.py:28-52)."""
    smooth_nrm = safe_normalize(smooth_nrm)
    smooth_tng = safe_normalize(smooth_tng)
    view_vec = safe_normalize(view_pos - pos)
    smooth_bitang = safe_normalize(torch.cross(smooth_tng, smooth_nrm,
                                               dim=-1))
    sign = -1.0 if opengl else 1.0
    shading_nrm = (smooth_tng * perturbed_nrm[..., 0:1]
                   + sign * smooth_bitang * perturbed_nrm[..., 1:2]
                   + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3],
                                              min=0.0))
    shading_nrm = safe_normalize(shading_nrm)
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        shading_nrm = torch.where(front, shading_nrm, -shading_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, shading_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (shading_nrm - geom_nrm)


# ---------------------------------------------------------------------------
# image losses (ref: c_src/loss.cu; python oracle renderutils/loss.py)
# ---------------------------------------------------------------------------

def _tonemap(img, mode: str):
    if mode == 'none':
        return img
    if mode == 'log_srgb':
        return linear_to_srgb(torch.log(torch.clamp(img, 0, 65535) + 1.0))
    raise NotImplementedError(mode)


def image_loss(img, target, loss: str = 'l1', tonemapper: str = 'none'):
    """Tone-mapped image loss (renderutils image_loss semantics)."""
    img = _tonemap(img, tonemapper)
    target = _tonemap(target, tonemapper)
    if loss == 'l1':
        return torch.mean(torch.abs(img - target))
    if loss == 'mse':
        return torch.mean((img - target) ** 2)
    if loss == 'smape':
        return torch.mean(torch.abs(img - target)
                          / (torch.abs(img) + torch.abs(target) + 0.01))
    if loss == 'relmse':
        return torch.mean((img - target) ** 2 / (target ** 2 + 0.1))
    raise NotImplementedError(loss)


# ---------------------------------------------------------------------------
# transforms (ref: c_src/mesh.cu xfm_points / xfm_vectors)
# ---------------------------------------------------------------------------

def xfm_points(points, matrix):
    """points [...,N,3], matrix [...,4,4] -> homogeneous transform
    [...,N,4]."""
    p4 = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    return torch.einsum('...nj,...ij->...ni', p4, matrix)


def xfm_vectors(vectors, matrix):
    """vectors [...,N,3], matrix [...,4,4] -> rotated vectors [...,N,3]."""
    return torch.einsum('...nj,...ij->...ni', vectors, matrix[..., :3, :3])
