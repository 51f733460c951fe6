"""Math primitives of the port (counterpart of tensoflow_tpu/ops/math.py).

Channel layouts match the JAX package exactly.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import device_constant

EPS = 1e-6


def dot(a, b, keepdim: bool = True):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def saturate_dot(a, b):
    """clamp(<a,b>, 0, 1) (ref: utils/network_utils.py:63-64)."""
    return torch.clamp(dot(a, b), 0.0, 1.0)


def safe_normalize(x, eps: float = 1e-20):
    """Normalize along the last axis with NaN-free gradients at 0."""
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(n2, min=eps))


def reflect(v, n):
    """Reflect direction ``v`` about normal ``n`` (both [..., 3])."""
    return 2.0 * dot(v, n) * n - v


def safe_sqrt(x, eps: float = 1e-12):
    return torch.sqrt(torch.clamp(x, min=eps))


def safe_acos(x, eps: float = EPS):
    return torch.arccos(torch.clamp(x, -1.0 + eps, 1.0 - eps))


def safe_log(x, eps: float = EPS):
    return torch.log(torch.clamp(x, min=eps))


def charbonnier(pred, gt, eps: float = 1e-3):
    """Charbonnier RGB loss summed over channels (ref: shapeRenderer.py:803-805)."""
    return torch.sqrt(torch.sum((gt - pred) ** 2, dim=-1) + eps)


def linear_to_srgb(linear):
    """(ref: utils/raw_utils.py:4-13)"""
    eps = float(np.finfo(np.float32).eps)
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.clamp(linear, min=eps) ** (5.0 / 12.0)
             - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb):
    """(ref: utils/raw_utils.py:19-28)"""
    eps = float(np.finfo(np.float32).eps)
    lin0 = 25.0 / 323.0 * srgb
    lin1 = torch.clamp((200.0 * srgb + 11.0) / 211.0, min=eps) ** (12.0 / 5.0)
    return torch.where(srgb <= 0.04045, lin0, lin1)


def contraction(xyz, aabb):
    """Map world coords into the unit cube [0,1]^3 (ref: network_utils.py:90-91)."""
    lo, hi = aabb[0], aabb[1]
    return (xyz - lo) / (hi - lo)


def normalize_coord(xyz, aabb):
    """Map world coords into [-1,1]^3 (ref: network_utils.py:93-94)."""
    lo, hi = aabb[0], aabb[1]
    return 2.0 * (xyz - lo) / (hi - lo) - 1.0


def to_sphere_angles(d):
    """Cartesian direction -> (phi, theta), phi in [0,2pi), theta in [0,pi]."""
    theta = safe_acos(d[..., 2:3])
    phi = torch.remainder(torch.atan2(d[..., 1:2], d[..., 0:1]), 2.0 * np.pi)
    return torch.cat([phi, theta], dim=-1)


def from_sphere_angles(angles):
    """(phi, theta) -> unit direction (ref: network_utils.py:101-106)."""
    phi, theta = angles[..., 0:1], angles[..., 1:2]
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.cat([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def get_sphere_intersection(pts, dirs, radius: float = 1.0):
    """Distance along ``dirs`` from ``pts`` (inside) to the radius-1 sphere
    (ref: utils/network_utils.py:108-114)."""
    dtx = dot(pts, dirs)
    xtx = dot(pts, pts)
    disc = dtx * dtx - xtx + radius * radius
    return -dtx + torch.sqrt(torch.clamp(disc, min=0.0) + 1e-6)


def get_camera_plane_intersection(pts, dirs, poses):
    """Ray / camera-XoY-plane intersection in "human" coordinates
    (ref: utils/network_utils.py:69-88).

    pts, dirs [..., 3]; poses [..., 3, 4] with the batch dims of pts, or
    [P, 3, 4] for pts [P, S, 3] (one pose for all S rays of a point: a
    batched product, no broadcast copy of the poses).
    Returns (inter [..., 3], dist [...], hits [...])."""
    R, t = poses[..., :3], poses[..., 3]
    if poses.dim() == pts.dim():
        rt = R.transpose(-1, -2)
        pts_ = torch.matmul(pts, rt) + t[:, None, :]
        dirs_ = torch.matmul(dirs, rt)
    else:
        pts_ = torch.matmul(R, pts[..., None])[..., 0] + t
        dirs_ = torch.matmul(R, dirs[..., None])[..., 0]
    hits = torch.abs(dirs_[..., 2]) > 1e-4
    dz = torch.where(hits, dirs_[..., 2], torch.full_like(dirs_[..., 2],
                                                          1e-4))
    dist = -pts_[..., 2] / dz
    inter = pts_ + dist[..., None] * dirs_
    return inter, dist, hits


def positional_encoding(x, n_freqs: int, include_input: bool = True):
    """NeRF-style PE: [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]."""
    outs = [x] if include_input else []
    for i in range(n_freqs):
        f = 2.0 ** i
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1) if outs else x


def pe_dim(input_dims: int, n_freqs: int, include_input: bool = True) -> int:
    return input_dims * ((1 if include_input else 0) + 2 * n_freqs)


def expected_sin(mean, var):
    """E[sin(x)], x ~ N(mean, var) (ref: network_utils.py:52-54)."""
    return torch.exp(-0.5 * var) * torch.sin(mean)


def integrated_positional_encoding(mean, var, min_deg: int, max_deg: int):
    """mip-NeRF IPE (ref: network_utils.py:56-61).

    mean, var: [..., d]. Returns [..., 2 * d * (max_deg - min_deg)]."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=mean.dtype,
                                 device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    sm = torch.reshape(mean[..., None, :] * scales[:, None], shape)
    sv = torch.reshape(var[..., None, :] * (scales[:, None] ** 2), shape)
    return expected_sin(torch.cat([sm, sm + 0.5 * math.pi], dim=-1),
                        torch.cat([sv, sv], dim=-1))


def _generalized_binomial_coeff(a, k):
    return np.prod(a - np.arange(k)) / math.factorial(k)


def _assoc_legendre_coeff(l, m, k):
    return ((-1) ** m * 2 ** l * math.factorial(l) / math.factorial(k)
            / math.factorial(l - k - m)
            * _generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def _sph_harm_coeff(l, m, k):
    return (np.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                    / (4.0 * np.pi * math.factorial(l + m)))
            * _assoc_legendre_coeff(l, m, k))


@functools.lru_cache(maxsize=8)
def _ide_tables(deg_view: int):
    """(ref: utils/ref_utils.py:40-83) host-side tables (numpy)."""
    ml_list = []
    for i in range(deg_view):
        l = 2 ** i
        for m in range(l + 1):
            ml_list.append((m, l))
    ml_array = np.array(ml_list).T
    l_max = 2 ** (deg_view - 1)
    mat = np.zeros((l_max + 1, ml_array.shape[1]))
    for i, (m, l) in enumerate(ml_array.T):
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(l, m, k)
    sigma = 0.5 * ml_array[1, :] * (ml_array[1, :] + 1)
    return (mat.astype(np.float32), ml_array.astype(np.int32),
            sigma.astype(np.float32))


def ide_dim(deg_view: int) -> int:
    _, ml_array, _ = _ide_tables(deg_view)
    return 2 * ml_array.shape[1]


def integrated_dir_encoding(xyz, kappa_inv, deg_view: int = 5):
    """Ref-NeRF integrated directional encoding (ref: ref_utils.py:85-115),
    in real arithmetic as in the JAX package."""
    dev, dt = xyz.device, xyz.dtype
    mat = device_constant(('ide_mat', deg_view),
                          lambda: _ide_tables(deg_view)[0], dev, dt)
    m_f = device_constant(('ide_m', deg_view),
                          lambda: _ide_tables(deg_view)[1][0, :], dev, dt)
    sigma = device_constant(('ide_sigma', deg_view),
                            lambda: _ide_tables(deg_view)[2], dev, dt)
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    vmz = torch.cat([z ** i for i in range(mat.shape[0])], dim=-1)
    zpart = vmz @ mat
    r = torch.sqrt(torch.clamp(x * x + y * y, min=0.0))
    phi = torch.atan2(y, x)
    r_pow = torch.where((r == 0.0) & (m_f > 0), torch.zeros_like(r * m_f),
                        torch.clamp(r, min=1e-30) ** m_f)
    re_xy = r_pow * torch.cos(m_f * phi)
    im_xy = r_pow * torch.sin(m_f * phi)
    atten = torch.exp(-sigma * kappa_inv)
    return torch.cat([re_xy * zpart * atten, im_xy * zpart * atten], dim=-1)


def spherical_harmonics(levels: int, directions):
    """Real SH components up to ``levels`` (ref: ref_utils.py:130-193)."""
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [0.4886025119029199 * y,
                  0.4886025119029199 * z,
                  0.4886025119029199 * x]
    if levels > 2:
        comps += [1.0925484305920792 * x * y,
                  1.0925484305920792 * y * z,
                  0.9461746957575601 * zz - 0.31539156525251999,
                  1.0925484305920792 * x * z,
                  0.5462742152960396 * (xx - yy)]
    if levels > 3:
        comps += [0.5900435899266435 * y * (3 * xx - yy),
                  2.890611442640554 * x * y * z,
                  0.4570457994644658 * y * (5 * zz - 1),
                  0.3731763325901154 * z * (5 * zz - 3),
                  0.4570457994644658 * x * (5 * zz - 1),
                  1.445305721320277 * z * (xx - yy),
                  0.5900435899266435 * x * (xx - 3 * yy)]
    if levels > 4:
        comps += [2.5033429417967046 * x * y * (xx - yy),
                  1.7701307697799304 * y * z * (3 * xx - yy),
                  0.9461746957575601 * x * y * (7 * zz - 1),
                  0.6690465435572892 * y * z * (7 * zz - 3),
                  0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
                  0.6690465435572892 * x * z * (7 * zz - 3),
                  0.47308734787878004 * (xx - yy) * (7 * zz - 1),
                  1.7701307697799304 * x * z * (xx - 3 * yy),
                  0.6258357354491761 * (xx * (xx - 3 * yy)
                                        - yy * (3 * xx - yy))]
    return torch.stack(comps, dim=-1)


def xla_linspace(start: float, stop: float, n: int) -> np.ndarray:
    """float32 [n]: jnp.linspace(start, stop, n) as XLA computes it under
    jit, start * (1 - t) + stop * t with t = i * (1 / (n - 1)) in float32
    and the last value exactly stop (torch.linspace rounds some values
    the other way)."""
    f = np.float32
    if n == 1:
        return np.full((1,), start, f)
    t = np.arange(n, dtype=f) * (f(1.0) / f(n - 1))
    out = f(start) * (f(1.0) - t) + f(stop) * t
    out[-1] = f(stop)
    return out


def sample_pdf(bins, weights, n_samples: int, u=None):
    """Inverse-transform sampling of piecewise-constant pdfs; u None ->
    deterministic midpoints (ref: network_utils.py:117-147)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device)
        u = u.expand(cdf.shape[:-1] + (n_samples,))
    inds = torch.sum(cdf[..., None, :] <= u[..., :, None], dim=-1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
