"""Cubemap sampling, converters and pre-integration (counterpart of
tensoflow_tpu/ops/cubemap.py): the packed lookups fields/light reaches,
the unpacked ``sample_cubemap`` / ``sample_cubemap_mip`` and the
latlong <-> cubemap converters that relighting reaches.  Layout
[6, R, R, C], face convention and packed patch rows are the JAX
package's; indices are clamped where the JAX package's
``jnp.take(mode='clip')`` clamps them.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import device_constant
from .tensor_field import sample_bilinear_2d, sample_bilinear_packed


def _cube_to_dir_np(s, x, y):
    one = np.ones_like(x)
    if s == 0:
        rx, ry, rz = one, -y, -x
    elif s == 1:
        rx, ry, rz = -one, -y, x
    elif s == 2:
        rx, ry, rz = x, one, y
    elif s == 3:
        rx, ry, rz = x, -one, -y
    elif s == 4:
        rx, ry, rz = x, -y, one
    else:
        rx, ry, rz = -x, -y, -one
    return np.stack([rx, ry, rz], -1)


@functools.lru_cache(maxsize=16)
def cubemap_dirs(res: int) -> np.ndarray:
    """[6, res, res, 3] unit direction of each texel center."""
    g = np.linspace(-1.0 + 1.0 / res, 1.0 - 1.0 / res, res)
    gy, gx = np.meshgrid(g, g, indexing='ij')
    faces = []
    for s in range(6):
        v = _cube_to_dir_np(s, gx, gy)
        faces.append(v / np.linalg.norm(v, axis=-1, keepdims=True))
    return np.stack(faces, 0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def cubemap_solid_angles(res: int) -> np.ndarray:
    """[6, res, res] solid angle of each texel."""
    edges = np.linspace(-1.0, 1.0, res + 1)

    def area(x, y):
        return np.arctan2(x * y, np.sqrt(x * x + y * y + 1.0))

    a = area(edges[:, None], edges[None, :])
    sa = (a[1:, 1:] - a[:-1, 1:] - a[1:, :-1] + a[:-1, :-1])
    return np.broadcast_to(sa[None], (6, res, res)).astype(np.float32)


def dir_to_cube_uv(d):
    """Directions [N,3] -> (face [N] int64, u [N], v [N]) in [0,1]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3),
                    torch.where(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-12)
    sc_opts = torch.stack([-z, z, x, x, x, -x], 0)
    tc_opts = torch.stack([-y, -y, z, -z, -y, -y], 0)
    sc = torch.gather(sc_opts, 0, face[None])[0]
    tc = torch.gather(tc_opts, 0, face[None])[0]
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    return face, u, v


def _bilinear_taps(buf, base, u, v, r):
    """Clamped bilinear lookup of the [r, r] face at row ``base`` of the
    flat [T, C] texel buffer; u indexes x within the face, v its rows.
    ``r`` is an int or a per-point int64 tensor."""
    rf = r.to(u.dtype) if torch.is_tensor(r) else float(r)
    uf = u * rf - 0.5
    vf = v * rf - 0.5
    u0 = torch.floor(uf)
    v0 = torch.floor(vf)
    fu = (uf - u0)[:, None]
    fv = (vf - v0)[:, None]
    hi = r - 1

    def clip(i):
        if torch.is_tensor(hi):
            return torch.minimum(torch.clamp(i, min=0), hi)
        return torch.clamp(i, 0, hi)
    u0i, u1i = clip(u0.long()), clip(u0.long() + 1)
    v0i, v1i = clip(v0.long()), clip(v0.long() + 1)
    n = buf.shape[0] - 1

    def g(vi, ui):
        return buf[torch.clamp(base + vi * r + ui, 0, n)]

    return ((1 - fv) * ((1 - fu) * g(v0i, u0i) + fu * g(v0i, u1i))
            + fv * ((1 - fu) * g(v1i, u0i) + fu * g(v1i, u1i)))


def sample_cubemap(cubemap, dirs):
    """Bilinear cubemap lookup, clamped per face.  cubemap [6,R,R,C];
    dirs [N,3] -> [N,C]."""
    _, r, _, c = cubemap.shape
    face, u, v = dir_to_cube_uv(dirs)
    return _bilinear_taps(cubemap.reshape(-1, c), face * r * r, u, v, r)


def sample_cubemap_mip(pyramid, dirs, level):
    """Trilinear (bilinear + mip lerp) cubemap lookup.  pyramid: list of
    [6,R/2^l,R/2^l,C]; level [N] fractional.  Only the two levels adjacent
    to each point's level are gathered (the others weigh zero)."""
    n_levels = len(pyramid)
    if n_levels == 1:
        return sample_cubemap(pyramid[0], dirs)
    c = pyramid[0].shape[-1]
    offs, ress, off = [], [], 0
    for tex in pyramid:
        f, r, _, _ = tex.shape
        offs.append(off)
        ress.append(r)
        off += f * r * r
    buf = torch.cat([tex.reshape(-1, c) for tex in pyramid], dim=0)
    offs_t, ress_t = device_constant(('mip_flat', tuple(offs), tuple(ress)),
                                     lambda: [offs, ress], dirs.device,
                                     torch.int64)
    face, u, v = dir_to_cube_uv(dirs)
    lv = torch.clamp(level, 0.0, n_levels - 1.0)
    l0 = torch.clamp(torch.floor(lv).long(), 0, n_levels - 2)
    frac = (lv - l0.to(lv.dtype))[:, None]

    def level_lookup(li):
        r = ress_t[li]
        return _bilinear_taps(buf, offs_t[li] + face * r * r, u, v, r)

    return (1 - frac) * level_lookup(l0) + frac * level_lookup(l0 + 1)


def pack_cubemap_patches(cubemap):
    """[6,R,R,C] -> [6*(R+1)^2, 4C] per-face 2x2 patch rows (face-clamped)."""
    f, r, _, c = cubemap.shape
    x = cubemap.permute(0, 3, 1, 2)                        # [6, C, R, R]
    pad = F.pad(x, (1, 1, 1, 1), mode='replicate').permute(0, 2, 3, 1)
    slots = [pad[:, d0:d0 + r + 1, d1:d1 + r + 1]
             for d0 in (0, 1) for d1 in (0, 1)]
    return torch.cat(slots, -1).reshape(f * (r + 1) * (r + 1), 4 * c)


def sample_cubemap_packed(pbuf, r: int, dirs, base=0):
    """One-gather bilinear cubemap lookup on pack_cubemap_patches rows."""
    face, u, v = dir_to_cube_uv(dirs)
    fb = base + face * (r + 1) * (r + 1)
    return sample_bilinear_packed(pbuf, r, r, v * float(r) - 0.5,
                                  u * float(r) - 0.5, fb)


def pack_cubemap_pyramid_patches(pyramid):
    """Every level's patch rows in one buffer -> (pbuf, offsets, res)."""
    parts, offs, ress = [], [], []
    off = 0
    for tex in pyramid:
        f, r, _, _ = tex.shape
        parts.append(pack_cubemap_patches(tex))
        offs.append(off)
        ress.append(r)
        off += f * (r + 1) * (r + 1)
    return torch.cat(parts, dim=0), tuple(offs), tuple(ress)


def sample_cubemap_mip_packed(pbuf, offsets, ress, dirs, level):
    """Trilinear cubemap lookup on a packed pyramid (two adjacent levels)."""
    n_levels = len(ress)
    if n_levels == 1:
        return sample_cubemap_packed(pbuf, ress[0], dirs, offsets[0])
    offs_t, ress_t = device_constant(('mip_offsets', offsets, ress),
                                     lambda: [offsets, ress], dirs.device,
                                     torch.int64)
    lv = torch.clamp(level, 0.0, n_levels - 1.0)
    l0 = torch.clamp(torch.floor(lv).long(), 0, n_levels - 2)
    frac = (lv - l0.to(lv.dtype))[:, None]
    face, u, v = dir_to_cube_uv(dirs)
    n = dirs.shape[0]

    def idx_weights(li):
        off = offs_t[li]
        r = ress_t[li]
        rf = r.to(u.dtype)
        t0 = v * rf - 0.5
        t1 = u * rf - 0.5
        f0 = torch.floor(t0)
        f1 = torch.floor(t1)
        a0 = torch.minimum(torch.clamp(f0.long() + 1, min=0), r)
        a1 = torch.minimum(torch.clamp(f1.long() + 1, min=0), r)
        idx = off + face * (r + 1) * (r + 1) + a0 * (r + 1) + a1
        return idx, (t0 - f0)[:, None], (t1 - f1)[:, None]

    i0, wa0, wa1 = idx_weights(l0)
    i1, wb0, wb1 = idx_weights(l0 + 1)
    idx = torch.clamp(torch.cat([i0, i1]), 0, pbuf.shape[0] - 1)
    rows = pbuf[idx]
    c = rows.shape[-1] // 4

    def lerp(rw, w0, w1):
        return (((1 - w0) * (1 - w1)) * rw[:, :c]
                + ((1 - w0) * w1) * rw[:, c:2 * c]
                + (w0 * (1 - w1)) * rw[:, 2 * c:3 * c]
                + (w0 * w1) * rw[:, 3 * c:])

    return ((1 - frac) * lerp(rows[:n], wa0, wa1)
            + frac * lerp(rows[n:], wb0, wb1))


def cubemap_mip(cubemap):
    """2x avg-pool of [6,R,R,C]."""
    f, r, _, c = cubemap.shape
    return cubemap.reshape(f, r // 2, 2, r // 2, 2, c).mean(dim=(2, 4))


def build_cubemap_pyramid(base, min_res: int = 16):
    pyr = [base]
    while pyr[-1].shape[1] > min_res:
        pyr.append(cubemap_mip(pyr[-1]))
    return pyr


# ---------------------------------------------------------------------------
# latlong <-> cubemap.  The coordinates of both converters are constants of
# the resolution, built once on the host in float32 with the C library's
# atan2f / sinf / cosf: the functions the JAX package's CPU backend calls,
# where torch's vectorised float32 kernels differ in the last place (a
# 1e-6 step of a lookup into a 64-texel map).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library('m'))
    for name, n in (('atan2f', 2), ('sinf', 1), ('cosf', 1), ('sqrtf', 1)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * n
    return lib


def _f32(name, *args):
    """Elementwise float32 C-library function over host arrays."""
    fn = getattr(_libm(), name)
    flat = [np.asarray(a, np.float32).reshape(-1) for a in args]
    return np.array([fn(*v) for v in zip(*(a.tolist() for a in flat))],
                    np.float32).reshape(np.shape(args[0]))


def _linspace_f32(start: float, stop: float, n: int) -> np.ndarray:
    """jnp.linspace in float32: start * (1 - i c) + i (stop c), c = 1/(n-1),
    the last sum fused, the last value exactly stop."""
    f = np.float32
    if n == 1:
        return np.full((1,), start, f)
    c = f(1.0 / (n - 1))
    i = np.arange(n - 1, dtype=f)
    head = f(start) * (f(1.0) - i * c)
    out = (i.astype(np.float64) * float(f(stop) * c) + head).astype(f)
    return np.concatenate([out, [f(stop)]])


@functools.lru_cache(maxsize=8)
def _texel_latlong_uv(res: int) -> np.ndarray:
    """[6 res^2, 2] (row, col) = (tv, tu) latlong coordinates of the texel
    directions; arccos(y) = atan2(sqrt((1 - y)(1 + y)), y)."""
    f = np.float32
    d = cubemap_dirs(res).reshape(-1, 3)
    tu = _f32('atan2f', d[:, 0], -d[:, 2]) / f(2 * np.pi) + f(0.5)
    y = np.clip(d[:, 1], -1, 1)
    tv = _f32('atan2f', _f32('sqrtf', (f(1) - y) * (f(1) + y)), y) / f(np.pi)
    return np.stack([tv, tu], -1).astype(f)


@functools.lru_cache(maxsize=8)
def _latlong_dirs(h: int, w: int) -> np.ndarray:
    """[h w, 3] directions of the latlong pixel centres."""
    f = np.float32
    gy, gx = np.meshgrid(_linspace_f32(1.0 / h, 1.0 - 1.0 / h, h),
                         _linspace_f32(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w),
                         indexing='ij')
    ay, ax = gy * f(np.pi), gx * f(np.pi)
    st, ct = _f32('sinf', ay), _f32('cosf', ay)
    sp, cp = _f32('sinf', ax), _f32('cosf', ax)
    return np.stack([st * sp, ct, -st * cp], -1).reshape(-1, 3)


def latlong_to_cubemap(latlong, res: int):
    """[H,W,C] equirectangular -> [6,res,res,C] (ref: light_utils.py:34-47);
    the latlong is sampled at uv = (row, col) = (tv, tu)."""
    uv = device_constant(('texel_latlong_uv', res),
                         lambda: _texel_latlong_uv(res), latlong.device)
    vals = sample_bilinear_2d(latlong, uv)
    return vals.reshape(6, res, res, latlong.shape[-1])


def cubemap_to_latlong(cubemap, res_hw):
    """[6,R,R,C] -> [H,W,C] equirectangular (ref: light_utils.py:50-63)."""
    h, w = res_hw
    refl = device_constant(('latlong_dirs', h, w),
                           lambda: _latlong_dirs(h, w), cubemap.device)
    return sample_cubemap(cubemap, refl).reshape(h, w, cubemap.shape[-1])


def _dirs_and_solid_angles(r: int, device):
    """[6r^2, 3] texel directions and [6r^2] solid angles, on the device."""
    return (device_constant(('cube_dirs', r),
                            lambda: cubemap_dirs(r).reshape(-1, 3), device),
            device_constant(('cube_solid_angles', r),
                            lambda: cubemap_solid_angles(r).reshape(-1),
                            device))


def diffuse_cubemap(cubemap):
    """Cosine-hemisphere pre-integration as a dense [T,T] product."""
    f, r, _, c = cubemap.shape
    dirs, sa = _dirs_and_solid_angles(r, cubemap.device)
    cos = torch.clamp(dirs @ dirs.t(), min=0.0)
    w = cos * sa[None, :]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    return (w @ cubemap.reshape(-1, c)).reshape(f, r, r, c)


def specular_cubemap(cubemap, roughness: float, cutoff: float = 0.99):
    """GGX pre-integration as a dense [T,T] product (res <= 32)."""
    f, r, _, c = cubemap.shape
    dirs, sa = _dirs_and_solid_angles(r, cubemap.device)
    cos = torch.clamp(dirs @ dirs.t(), min=0.0)
    a = max(float(roughness), 1e-3)
    a2 = a * a
    noh2 = (1.0 + cos) / 2.0
    d = a2 / torch.clamp(np.pi * (noh2 * (a2 - 1.0) + 1.0) ** 2, min=1e-9)
    w = d * cos * sa[None, :]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    return (w @ cubemap.reshape(-1, c)).reshape(f, r, r, c)
