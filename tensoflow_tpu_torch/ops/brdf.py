"""Microfacet BRDF terms (counterpart of tensoflow_tpu/ops/brdf.py).

The convention throughout: ``roughness`` is the GGX alpha, i.e. the
*already squared* perceptual roughness (ref: fields.py:865,988).
"""
from __future__ import annotations

import math

import torch

from .math import safe_normalize, saturate_dot

EPS = 1e-6


def fresnel_schlick(f0, hov):
    """(ref: fields.py:977-978)"""
    return f0 + (1.0 - f0) * torch.clamp(1.0 - hov, 0.0, 1.0) ** 5.0


def fresnel_schlick_directions(f0, view_dirs, light_dirs):
    """Half vector + Fresnel for view/light pairs (ref: fields.py:980-985)."""
    h = safe_normalize(view_dirs + light_dirs)
    hov = saturate_dot(h, view_dirs)
    return fresnel_schlick(f0, hov), h, hov


def distribution_ggx(noh, alpha):
    """GGX NDF D(h) (ref: fields.py:1019-1024)."""
    a2 = alpha * alpha
    noh2 = noh * noh
    denom = noh2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * denom * denom, min=EPS)


def geometry_schlick_ggx(nov, alpha):
    """(ref: fields.py:987-993)"""
    k = alpha / 2.0
    return nov / (nov * (1.0 - k) + k + 1e-5)


def geometry_schlick(nov, nol, alpha):
    """Smith-Schlick masking-shadowing (ref: fields.py:995-998)."""
    return geometry_schlick_ggx(nov, alpha) * geometry_schlick_ggx(nol, alpha)


def geometry_ggx_smith_correlated(nov, nol, alpha):
    """Height-correlated Smith (ref: fields.py:1000-1008)."""
    def lam(a2, cos_t):
        cos2 = cos_t * cos_t
        tan2 = (1.0 - cos2) / (cos2 + 1e-7)
        return 0.5 * torch.sqrt(1.0 + a2 * tan2) - 0.5
    a2 = alpha * alpha
    return 1.0 / (1.0 + lam(a2, nov) + lam(a2, nol))


def geometry(nov, nol, alpha, geometry_type: str = 'schlick'):
    if geometry_type == 'schlick':
        return geometry_schlick(nov, nol, alpha)
    if geometry_type == 'ggx_smith':
        return geometry_ggx_smith_correlated(nov, nol, alpha)
    raise NotImplementedError(geometry_type)


def specular_weight(normals, view_dirs, light_dirs, f0, alpha,
                    geometry_type: str = 'schlick'):
    """D*F*G / (4 NoV), the per-sample MC specular weight
    (ref: fields.py:1216-1224).  Returns (weight, NoL [..., 1])."""
    fresnel, h, _ = fresnel_schlick_directions(f0, view_dirs, light_dirs)
    nov = saturate_dot(normals, view_dirs)
    nol = saturate_dot(normals, light_dirs)
    g = geometry(nov, nol, alpha, geometry_type)
    noh = saturate_dot(normals, h)
    d = distribution_ggx(noh, alpha)
    return d * fresnel * g / torch.clamp(4.0 * nov, min=EPS), nol


def get_orthogonal_directions(directions):
    """A tangent vector orthogonal to each direction (ref: fields.py:812-822)."""
    x, y, z = directions[..., 0:1], directions[..., 1:2], directions[..., 2:3]
    zeros = torch.zeros_like(x)
    otho0 = torch.cat([y, -x, zeros], dim=-1)
    otho1 = torch.cat([-z, zeros, x], dim=-1)
    n0 = torch.linalg.norm(otho0, dim=-1, keepdim=True)
    n1 = torch.linalg.norm(otho1, dim=-1, keepdim=True)
    otho = torch.where(n0 > n1, otho0, otho1)
    return safe_normalize(otho)


def tangent_frame(normals):
    """Orthonormal (x, y, z=normal) frame per point (ref: fields.py:826-830)."""
    z = normals
    x = get_orthogonal_directions(normals)
    y = torch.linalg.cross(z, x, dim=-1)
    return x, y, z
