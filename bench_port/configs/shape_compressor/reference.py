"""Plain PyTorch reference of the stage-1 training step at
configs/shape/syn/compressor.yaml (the hierarchical sampler, the TensoSDF
VM field with its 7-point finite-difference stencil, split-sum shading,
NeuS compositing, the loss terms and the Adam update).

Written from the published method's equations, with the program's layouts
(parameter names, channel orders) so that states can be handed across.
It imports nothing of the program, of JAX or of the JAX package, and
takes no table or weight the program has made: the field is sampled
straight from the raw planes and lines (no atlas, no fused head), the
stencil evaluates the whole field at each of its 7 points, the envlight
is pre-filtered here, and the split-sum LUT is integrated here.

Precision: float32 throughout.  ``precision('tf32')`` turns TF32 on for
matrix products and convolutions: the control of the comparison.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
ADAM_BETAS = (0.9, 0.99)
ADAM_EPS = 1e-8
SIZES = dict(alpha_mask_grid=128, occ_march=(64, 16), env_min_res=16,
              env_rough=(0.08, 0.5), env_exact_ggx_max_res=32,
              light_pos_freq=8, lut=(256, 1024))


@contextlib.contextmanager
def precision(mode: str):
    """'float32': matrix products and convolutions in full float32;
    'tf32': both in TF32 (the lower precision the control runs in)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == 'tf32'
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# small math
# ---------------------------------------------------------------------------

def normalize(x, eps=1e-20):
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True),
                                       min=eps))


def pe(x, n_freqs):
    out = [x]
    for i in range(n_freqs):
        out += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(out, -1)


def softplus100(x):
    z = 100.0 * x
    return (torch.maximum(z, torch.zeros_like(z))
            + torch.log1p(torch.exp(-z.abs()))) / 100.0


def linear_to_srgb(x):
    eps = float(np.finfo(np.float32).eps)
    return torch.where(x <= 0.0031308, 323.0 / 25.0 * x,
                       (211.0 * torch.clamp(x, min=eps) ** (5.0 / 12.0)
                        - 11.0) / 200.0)


def charbonnier(pred, gt, eps=1e-3):
    return torch.sqrt(torch.sum((gt - pred) ** 2, -1) + eps)


def linspace32(start, stop, n):
    t = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(n - 1))
    out = np.float32(start) * (np.float32(1.0) - t) + np.float32(stop) * t
    out[-1] = np.float32(stop)
    return out


def sample_pdf(bins, weights, n):
    """Inverse-CDF samples at the deterministic midpoints of [0, 1]."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / torch.sum(w, -1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = torch.linspace(0.5 / n, 1.0 - 0.5 / n, n, device=bins.device)
    u = u.expand(cdf.shape[:-1] + (n,))
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def composite_weights(alpha):
    """w_i = alpha_i prod_{j<i}(1 - alpha_j), as the NeuS release's
    cumprod of (1 - alpha + 1e-7)."""
    log_om = torch.log(torch.clamp(1.0 - alpha, 0.0, 1.0) + 1e-7)
    trans = torch.exp(torch.cumsum(torch.cat(
        [torch.zeros_like(alpha[:, :1]), log_om[:, :-1]], 1), 1))
    return alpha * trans


# ---------------------------------------------------------------------------
# the VM field
# ---------------------------------------------------------------------------

def _pool2(tex):
    h, w, c = tex.shape
    return tex.reshape(h // 2, 2, w // 2, 2, c).mean(dim=(1, 3))


def _pool1(tex):
    n, c = tex.shape
    return tex.reshape(n // 2, 2, c).mean(dim=1)


def field_pyramids(field, n_levels):
    planes, lines = [], []
    for p, ln in zip(field['planes'], field['lines']):
        pp, ll = [p], [ln]
        for _ in range(n_levels - 1):
            pp.append(_pool2(pp[-1]))
            ll.append(_pool1(ll[-1]))
        planes.append(pp)
        lines.append(ll)
    return planes, lines


def _bilinear(tex, u, v):
    """Clamped bilinear lookup of [H, W, C] at u (along H), v in [0, 1],
    texel centres at (i + 1/2) / size."""
    h, w, _ = tex.shape
    x = u * h - 0.5
    y = v * w - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    xa, xb = torch.clamp(x0, 0, h - 1), torch.clamp(x0 + 1, 0, h - 1)
    ya, yb = torch.clamp(y0, 0, w - 1), torch.clamp(y0 + 1, 0, w - 1)
    return ((1 - fx) * ((1 - fy) * tex[xa, ya] + fy * tex[xa, yb])
            + fx * ((1 - fy) * tex[xb, ya] + fy * tex[xb, yb]))


def _linear(tex, u):
    n = tex.shape[0]
    x = u * n - 0.5
    x0 = torch.floor(x)
    f = (x - x0)[:, None]
    x0 = x0.long()
    return ((1 - f) * tex[torch.clamp(x0, 0, n - 1)]
            + f * tex[torch.clamp(x0 + 1, 0, n - 1)])


def vm_features(pyr, xyz01, level):
    """[N, 3C]: plane_i * line_i at contracted coords (clamped to the
    unit cube), blended over the two mip levels around ``level`` [N]
    (None: level 0)."""
    planes, lines = pyr
    n_levels = len(planes[0])
    x = torch.clamp(xyz01, 0.0, 1.0)
    if level is None or n_levels == 1:
        ws = [torch.ones_like(x[:, 0])] + [None] * (n_levels - 1)
    else:
        lv = torch.clamp(level, 0.0, n_levels - 1.0)
        ws = [torch.clamp(1.0 - torch.abs(lv - l), min=0.0)
              for l in range(n_levels)]
    out = []
    for i in range(3):
        a, b = MAT_MODE[i]
        pf = lf = 0.0
        for l in range(n_levels):
            if ws[l] is None:
                continue
            pf = pf + ws[l][:, None] * _bilinear(planes[i][l], x[:, a],
                                                 x[:, b])
            lf = lf + ws[l][:, None] * _linear(lines[i][l], x[:, VEC_MODE[i]])
        out.append(pf * lf)
    return torch.cat(out, -1)


def field_hidden(params, pyr, xyz01, level, multires):
    """The head's hidden layer at contracted coords (no clamp on the
    positional encoding, as the release encodes the contracted point)."""
    feats = vm_features(pyr, xyz01, level)
    x = torch.cat([feats, pe(xyz01, multires)], -1)
    m = params['sdf']['mlp']
    return softplus100(x @ m[0]['w'] + m[0]['b'])


def sdf_only(params, pyr, aabb, xyz, level, multires):
    m = params['sdf']['mlp']
    xyz01 = (xyz - aabb[0]) / (aabb[1] - aabb[0])
    h = field_hidden(params, pyr, xyz01, level, multires)
    return h @ m[1]['w'][:, :1] + m[1]['b'][:1]


def stencil(params, pyr, aabb, grid_size, xyz, level, multires):
    """SDF, features, finite-difference gradient and normal-projected
    Hessian from the whole field at the centre and at +-1/grid_size (in
    contracted units) along each axis, every point at the centre's mip
    level."""
    m = params['sdf']['mlp']
    n = xyz.shape[0]
    gs = torch.tensor(grid_size, dtype=torch.float32, device=xyz.device)
    eps = (aabb[1] - aabb[0]) / gs
    xyz01 = ((xyz - aabb[0]) / (aabb[1] - aabb[0])).detach()
    offs = torch.zeros((7, 3), device=xyz.device)
    for a in range(3):
        offs[1 + 2 * a, a] = 1.0 / grid_size[a]
        offs[2 + 2 * a, a] = -1.0 / grid_size[a]
    pts = (xyz01[None] + offs[:, None]).reshape(7 * n, 3)
    lv = None if level is None else level.detach().repeat(7)
    h = field_hidden(params, pyr, pts, lv, multires)
    out = h[:n] @ m[1]['w'] + m[1]['b']
    s = (h[n:] @ m[1]['w'][:, :1])[:, 0] + m[1]['b'][0]
    s = s.reshape(3, 2, n)
    sdf = out[:, 0]
    grad = ((s[:, 0] - s[:, 1]) / (2.0 * eps[:, None])).t()
    hess = ((s[:, 0] + s[:, 1] - 2.0 * sdf[None]) / eps[:, None] ** 2).t()
    nh = torch.sum(grad * hess, -1) / (torch.sum(grad ** 2, -1) + 1e-5)
    return sdf, out[:, 1:], grad, nh


# ---------------------------------------------------------------------------
# the environment light (cubemap [6, R, R, 3] of log radiance)
# ---------------------------------------------------------------------------

def _face_dirs(res):
    g = np.linspace(-1.0 + 1.0 / res, 1.0 - 1.0 / res, res)
    gy, gx = np.meshgrid(g, g, indexing='ij')
    one = np.ones_like(gx)
    faces = [(one, -gy, -gx), (-one, -gy, gx), (gx, one, gy),
             (gx, -one, -gy), (gx, -gy, one), (-gx, -gy, -one)]
    d = np.stack([np.stack(f, -1) for f in faces], 0)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).reshape(-1, 3)


def _solid_angles(res):
    e = np.linspace(-1.0, 1.0, res + 1)
    a = np.arctan2(e[:, None] * e[None, :],
                   np.sqrt(e[:, None] ** 2 + e[None, :] ** 2 + 1.0))
    sa = a[1:, 1:] - a[:-1, 1:] - a[1:, :-1] + a[:-1, :-1]
    return np.broadcast_to(sa[None], (6, res, res)).reshape(-1)


def _convolve(cube, lobe):
    f, r, _, c = cube.shape
    dev = cube.device
    d = torch.tensor(_face_dirs(r), dtype=torch.float32, device=dev)
    sa = torch.tensor(_solid_angles(r), dtype=torch.float32, device=dev)
    cos = torch.clamp(d @ d.t(), min=0.0)
    w = lobe(cos) * sa[None]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    return (w @ cube.reshape(-1, c)).reshape(f, r, r, c)


def _ggx_lobe(rough):
    a2 = max(float(rough), 1e-3) ** 2

    def lobe(cos):
        noh2 = (1.0 + cos) / 2.0
        d = a2 / torch.clamp(np.pi * (noh2 * (a2 - 1.0) + 1.0) ** 2,
                             min=1e-9)
        return d * cos
    return lobe


def env_mips(base):
    """Box-filtered chain down to 16^2; the last level cosine-convolved
    (diffuse); the specular chain GGX-convolved at 32^2 and below with
    roughness spaced from 0.08 to 0.5, the last at 1."""
    chain = [base]
    while chain[-1].shape[1] > SIZES['env_min_res']:
        f, r, _, c = chain[-1].shape
        chain.append(chain[-1].reshape(f, r // 2, 2, r // 2, 2, c)
                     .mean(dim=(2, 4)))
    diffuse = _convolve(chain[-1], lambda cos: cos)
    n = len(chain)
    lo, hi = SIZES['env_rough']
    spec = []
    for i, lvl in enumerate(chain):
        rough = (i / max(n - 2, 1)) * (hi - lo) + lo if i < n - 1 else 1.0
        if lvl.shape[1] <= SIZES['env_exact_ggx_max_res']:
            lvl = _convolve(lvl, _ggx_lobe(rough))
        spec.append(lvl)
    return diffuse, spec


def _cube_uv(d):
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)),
                     min=1e-12)
    sc = torch.stack([-z, z, x, x, x, -x], 0).gather(0, face[None])[0]
    tc = torch.stack([-y, -y, z, -z, -y, -y], 0).gather(0, face[None])[0]
    return face, 0.5 * (sc / ma + 1.0), 0.5 * (tc / ma + 1.0)


def _cube_lookup(cube, face, u, v):
    """Bilinear lookup clamped to the face (u across, v down a face)."""
    _, r, _, _ = cube.shape
    x = u * r - 0.5
    y = v * r - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    xa, xb = torch.clamp(x0, 0, r - 1), torch.clamp(x0 + 1, 0, r - 1)
    ya, yb = torch.clamp(y0, 0, r - 1), torch.clamp(y0 + 1, 0, r - 1)
    return ((1 - fy) * ((1 - fx) * cube[face, ya, xa]
                        + fx * cube[face, ya, xb])
            + fy * ((1 - fx) * cube[face, yb, xa] + fx * cube[face, yb, xb]))


def env_diffuse(diffuse, dirs):
    face, u, v = _cube_uv(dirs)
    return torch.exp(_cube_lookup(diffuse, face, u, v))


def env_specular(spec, dirs, rough):
    n = len(spec)
    lo, hi = SIZES['env_rough']
    below = (torch.clamp(rough, lo, hi) - lo) / (hi - lo) * (n - 2)
    above = (torch.clamp(rough, hi, 1.0) - hi) / (1.0 - hi) + n - 2
    lv = torch.clamp(torch.where(rough < hi, below, above), 0.0, n - 1.0)
    l0 = torch.clamp(torch.floor(lv).long(), 0, n - 2)
    frac = (lv - l0.float())[:, None]
    face, u, v = _cube_uv(dirs)
    out = 0.0
    for l in range(n):
        look = _cube_lookup(spec[l], face, u, v)
        w = torch.where(l0 == l, 1.0 - frac[:, 0],
                        torch.where(l0 + 1 == l, frac[:, 0],
                                    torch.zeros_like(frac[:, 0])))
        out = out + w[:, None] * look
    return torch.exp(out)


def fg_lut(res=256, n=1024, rows=16):
    """Split-sum DFG table [roughness, NoV, (A, B)]: GGX importance
    sampling (alpha = roughness^2) over a Hammersley set, height-correlated
    Smith visibility, Schlick's Fresnel (Karis 2013); float64, ``rows``
    roughness rows at a time."""
    nov = np.linspace(0.5 / res, 1 - 0.5 / res, res)[None, :, None]
    rough_all = np.linspace(0.5 / res, 1 - 0.5 / res, res)[:, None, None]
    i = np.arange(n)
    xi1 = (i + 0.5) / n
    xi2 = np.array([int(format(k, '032b')[::-1], 2) for k in i],
                   np.float64) / 2 ** 32
    phi = 2 * np.pi * xi1[None, None, :]

    def lam(a2, c):
        t2 = (1 - c * c) / np.maximum(c * c, 1e-9)
        return 0.5 * np.sqrt(1 + a2 * t2) - 0.5

    out = []
    for r0 in range(0, res, rows):
        a = rough_all[r0:r0 + rows] ** 2
        cos_t = np.sqrt((1 - xi2[None, None])
                        / (1 + (a ** 2 - 1) * xi2[None, None]))
        sin_t = np.sqrt(np.maximum(1 - cos_t ** 2, 0))
        vx = np.sqrt(np.maximum(1 - nov ** 2, 0))
        hx, hz = sin_t * np.cos(phi), cos_t
        voh = vx * hx + nov * hz
        nol = 2 * voh * hz - nov
        noh = np.clip(cos_t, 0, 1)
        voh = np.clip(voh, 0, 1)
        g = 1.0 / (1.0 + lam(a * a, nov)
                   + lam(a * a, np.clip(nol, 1e-6, 1)))
        gv = np.where(nol > 0, g * voh / np.maximum(noh * nov, 1e-6), 0.0)
        fc = (1 - voh) ** 5
        out.append(np.stack([np.mean((1 - fc) * gv, -1),
                             np.mean(fc * gv, -1)], -1))
    return np.concatenate(out, 0).astype(np.float32)


# ---------------------------------------------------------------------------
# shading networks
# ---------------------------------------------------------------------------

def predictor(p, x, act):
    layers = p['layers']
    for i, layer in enumerate(layers):
        w = layer['v'] * (layer['g'] / torch.clamp(
            torch.linalg.norm(layer['v'], dim=0), min=1e-12))
        x = x @ w + layer['b']
        if i < len(layers) - 1:
            x = torch.relu(x)
    if act == 'sigmoid':
        return torch.sigmoid(x)
    if act == 'exp':
        return torch.exp(torch.clamp(x, max=0.0))
    return x


def _assoc_legendre(l, m, k):
    return ((-1) ** m * 2 ** l * math.factorial(l) / math.factorial(k)
            / math.factorial(l - k - m) * _binom(0.5 * (l + k + m - 1.0), l))


def _binom(a, k):
    return np.prod(a - np.arange(k)) / math.factorial(k)


def ide_tables(deg):
    ml = [(m, 2 ** i) for i in range(deg) for m in range(2 ** i + 1)]
    l_max = 2 ** (deg - 1)
    mat = np.zeros((l_max + 1, len(ml)))
    for j, (m, l) in enumerate(ml):
        for k in range(l - m + 1):
            mat[k, j] = np.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                                / (4.0 * np.pi * math.factorial(l + m))) \
                * _assoc_legendre(l, m, k)
    m_arr = np.array([m for m, _ in ml], np.float32)
    sigma = np.array([0.5 * l * (l + 1) for _, l in ml], np.float32)
    return mat.astype(np.float32), m_arr, sigma


def ide(xyz, kappa_inv, tables):
    """Ref-NeRF's integrated directional encoding in real arithmetic."""
    mat, m, sigma = tables
    x, y, z = xyz[:, 0:1], xyz[:, 1:2], xyz[:, 2:3]
    zpart = torch.cat([z ** i for i in range(mat.shape[0])], -1) @ mat
    r = torch.sqrt(torch.clamp(x * x + y * y, min=0.0))
    phi = torch.atan2(y, x)
    r_pow = torch.where((r == 0.0) & (m > 0), torch.zeros_like(r * m),
                        torch.clamp(r, min=1e-30) ** m)
    att = torch.exp(-sigma * kappa_inv)
    return torch.cat([r_pow * torch.cos(m * phi) * zpart * att,
                      r_pow * torch.sin(m * phi) * zpart * att], -1)


class Constants:
    """Tables built once per device: the IDE coefficients and the DFG LUT."""

    def __init__(self, device):
        self.ide = tuple(torch.tensor(t, device=device)
                         for t in ide_tables(5))
        self.lut = torch.tensor(fg_lut(*SIZES['lut']), device=device)


def shade(params, consts, env, pts, normals, view, feats, radiance_on):
    diffuse_map, spec = env
    sh = params['shading']
    n = normalize(normals)
    degen = (n[:, 0:1] + n[:, 1:2]) == 0.0
    n = torch.where(degen, torch.tensor([0.0, 1e-6, 1.0], device=n.device),
                    n)
    v = normalize(view)
    refl = torch.sum(v * n, -1, keepdim=True) * n * 2 - v
    nov = torch.sum(n * v, -1, keepdim=True)
    mat = predictor(sh['mat_mlp'], feats, 'sigmoid')
    albedo = mat[:, :3] * 0.77 + 0.03
    rough = mat[:, 3:4] * 0.9 + 0.09
    metal = mat[:, 4:]
    radiance = None
    if radiance_on:
        radiance = predictor(sh['rad_mlp'], torch.cat(
            [feats, pts, pe(v, 4), n], -1), 'sigmoid')
    diffuse = (1.0 - metal) * albedo * env_diffuse(diffuse_map, n)
    spec_albedo = 0.04 * (1.0 - metal) + metal * albedo
    direct = env_specular(spec, refl, rough[:, 0])
    pts_enc = pe(pts, SIZES['light_pos_freq'])
    indirect = predictor(sh['inner_light'], torch.cat(
        [pts_enc, ide(refl, rough, consts.ide)], -1), 'exp')
    occ_in = torch.cat([pts_enc, pe(refl, 6)], -1).detach()
    occ = predictor(sh['inner_weight'], occ_in, 'none') * 0.5 + 0.5
    occ_c = torch.clamp(occ, 0.0, 1.0)
    light = indirect * occ_c + direct * (1.0 - occ_c)
    fg = _bilinear(consts.lut, torch.clamp(rough[:, 0], 0, 1),
                   torch.clamp(nov[:, 0], 0, 1))
    color = torch.clamp(linear_to_srgb(
        diffuse + (spec_albedo * fg[:, 0:1] + fg[:, 1:2]) * light), 0.0, 1.0)
    return color, radiance, {'reflective': refl, 'occ_prob': occ,
                             'roughness': rough}


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

def ball_radii(dist, radii, cos):
    inv = 1.0 / cos
    t = torch.sqrt(inv * inv - 1.0) - radii
    return dist * radii * cos / torch.sqrt(t * t + 1.0)


def inv_s_of(params):
    return torch.exp(params['deviation']['variance'] * 10.0)


def hierarchical_samples(params, pyr, cfg, aabb, rays_o, dirs, radii, rcos,
                         jitter, base_r):
    """The stratified lattice over the aabb clip of the unit-sphere
    bounds, jittered per ray, then ``up_sample_steps`` rounds of NeuS
    importance sampling with inv_s = 64 * 2^i, merged by a stable sort;
    every SDF query without gradient."""
    n_s, n_imp, ups = cfg['n_samples'], cfg['n_importance'], \
        cfg['up_sample_steps']
    mult = cfg['sdf_multires']
    a = torch.sum(dirs ** 2, -1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * dirs, -1, keepdim=True)
    mid = 0.5 * (-b) / a
    near, far = torch.clamp(mid - 1.0, min=1e-3), mid + 1.0
    vec = torch.where(dirs == 0, torch.full_like(dirs, 1e-6), dirs)
    ra, rb = (aabb[1] - rays_o) / vec, (aabb[0] - rays_o) / vec
    t_min = torch.clamp(torch.amax(torch.minimum(ra, rb), -1),
                        near[:, 0], far[:, 0])[:, None]
    t_max = torch.clamp(torch.amin(torch.maximum(ra, rb), -1),
                        near[:, 0], far[:, 0])[:, None]
    lin = torch.tensor(linspace32(0.0, 1.0, n_s), device=dirs.device)
    t = t_min + (t_max - t_min) * lin[None]
    if cfg['perturb'] > 0:
        t = t + (jitter - 0.5) * 2.0 / n_s

    @torch.no_grad()
    def sdf_at(tv):
        p = rays_o[:, None] + dirs[:, None] * tv[..., None]
        lv = torch.log2(ball_radii(tv[..., None], radii[:, None],
                                   rcos[:, None])[..., 0] / base_r)
        return sdf_only(params, pyr, aabb, p.reshape(-1, 3), lv.reshape(-1),
                        mult).reshape(tv.shape)

    sdf = sdf_at(t)
    inv_s0 = inv_s_of(params)
    for i in range(ups):
        cap = 64.0 * 2 ** i
        inv_s = torch.clamp(inv_s0, max=cap) \
            if cfg['clip_sample_variance'] else cap
        p = rays_o[:, None] + dirs[:, None] * t[..., None]
        inside = (torch.linalg.norm(p, dim=-1)[:, :-1] < 1.0) | \
            (torch.linalg.norm(p, dim=-1)[:, 1:] < 1.0)
        mid_sdf = 0.5 * (sdf[:, :-1] + sdf[:, 1:])
        cos = (sdf[:, 1:] - sdf[:, :-1]) / (t[:, 1:] - t[:, :-1] + 1e-5)
        prev = torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1)
        cos = torch.clamp(torch.minimum(prev, cos), -1e3, 0.0) * inside
        dist = t[:, 1:] - t[:, :-1]
        pc = torch.sigmoid((mid_sdf - cos * dist * 0.5) * inv_s)
        nc = torch.sigmoid((mid_sdf + cos * dist * 0.5) * inv_s)
        alpha = (pc - nc + 1e-5) / (pc + 1e-5)
        new_t = sample_pdf(t, composite_weights(alpha), n_imp // ups)
        t, order = torch.sort(torch.cat([t, new_t], -1), stable=True, dim=-1)
        if i + 1 < ups:
            sdf = torch.gather(torch.cat([sdf, sdf_at(new_t)], -1), -1,
                               order)
    d = t[:, 1:] - t[:, :-1]
    return t, torch.cat([d, d[:, -1:]], -1)


def trilinear_mask(volume, aabb, pts):
    u = torch.clamp((pts - aabb[0]) / (aabb[1] - aabb[0]), 0.0, 1.0)
    dims = volume.shape
    c = [u[:, k] * (dims[k] - 1) for k in range(3)]
    i0 = [torch.clamp(torch.floor(x).long(), 0, dims[k] - 1)
          for k, x in enumerate(c)]
    i1 = [torch.clamp(i + 1, 0, dims[k] - 1) for k, i in enumerate(i0)]
    f = [x - torch.floor(x) for x in c]
    out = 0.0
    for bx, wx in ((i0[0], 1 - f[0]), (i1[0], f[0])):
        for by, wy in ((i0[1], 1 - f[1]), (i1[1], f[1])):
            for bz, wz in ((i0[2], 1 - f[2]), (i1[2], f[2])):
                out = out + wx * wy * wz * volume[bx, by, bz]
    return out


@torch.no_grad()
def occlusion_march(params, pyr, aabb, inv_s, pts, dirs, mult):
    """Accumulated section weights of a 64-sample march to the unit
    sphere, refined by 16 importance samples (no gradient)."""
    sn0, sn1 = SIZES['occ_march']
    inside = torch.linalg.norm(pts, dim=-1) < 0.999
    dtx = torch.sum(pts * dirs, -1, keepdim=True)
    xtx = torch.sum(pts * pts, -1, keepdim=True)
    max_d = -dtx + torch.sqrt(torch.clamp(dtx * dtx - xtx + 1.0, min=0.0)
                              + 1e-6)
    z = max_d * torch.linspace(0.0, 1.0, sn0, device=pts.device)[None]

    def weights(zv):
        p = pts[:, None] + dirs[:, None] * zv[..., None]
        sdf = sdf_only(params, pyr, aabb, p.reshape(-1, 3), None,
                       mult).reshape(zv.shape)
        mid = 0.5 * (sdf[:, :-1] + sdf[:, 1:])
        cos = (sdf[:, 1:] - sdf[:, :-1]) / (zv[:, 1:] - zv[:, :-1] + 1e-5)
        surf = cos < 0
        cos = torch.clamp(cos, max=0.0)
        dist = zv[:, 1:] - zv[:, :-1]
        pc = torch.sigmoid((mid - cos * dist * 0.5) * inv_s)
        nc = torch.sigmoid((mid + cos * dist * 0.5) * inv_s)
        return composite_weights((pc - nc + 1e-5) / (pc + 1e-5) * surf)

    z2 = torch.sort(sample_pdf(z, weights(z), sn1), dim=-1).values
    return torch.sum(weights(z2), -1, keepdim=True) * inside[:, None]


def forward_losses(params, state, cfg, consts, batch, noise, step):
    """The step's loss terms (dict of 0-d tensors) and their sum."""
    dev = batch['rays_o'].device
    aabb = torch.tensor(cfg['aabb'], dtype=torch.float32, device=dev)
    grid_size, n_levels = state['grid_size'], state['n_levels']
    mult = cfg['sdf_multires']
    rays_o, dirs = batch['rays_o'], batch['dirs']
    radii, rcos = batch['radiis'], batch['rays_cos']
    rn = rays_o.shape[0]
    base_r = float((cfg['aabb'][1][0] - cfg['aabb'][0][0]) / 2.0
                   / grid_size[0])
    pyr = field_pyramids(params['sdf']['field'], n_levels)
    pyr_ng = tuple([[t.detach() for t in lv] for lv in part] for part in pyr)
    t, dists = hierarchical_samples(params, pyr_ng, cfg, aabb, rays_o, dirs,
                                    radii, rcos, noise['sample_jitter'],
                                    base_r)
    sn = t.shape[1]
    mid = t + dists * 0.5
    pts = rays_o[:, None] + dirs[:, None] * mid[..., None]
    inner = ~torch.any((aabb[0] > pts) | (pts > aabb[1]), -1)
    if state.get('alpha_mask') is not None:
        am = trilinear_mask(state['alpha_mask'], aabb, pts.reshape(-1, 3))
        inner = inner & (am.reshape(rn, sn) > 0)
    lv = torch.log2(ball_radii(mid[..., None], radii[:, None],
                               rcos[:, None])[..., 0] / base_r)
    flat_pts = pts.reshape(-1, 3)
    flat_dirs = dirs[:, None].expand(pts.shape).reshape(-1, 3)
    sdf, app, grads, hess = stencil(params, pyr, aabb, grid_size, flat_pts,
                                    lv.reshape(-1), mult)
    inv_s = torch.clamp(inv_s_of(params), 1e-6, 1e6)
    if cfg['freeze_inv_s_step'] is not None and \
            step < cfg['freeze_inv_s_step']:
        inv_s = inv_s.detach()
    anneal = min(1.0, step / cfg['anneal_end'])
    true_cos = torch.sum(flat_dirs * grads, -1)
    it_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
               + torch.relu(-true_cos) * anneal)
    d = dists.reshape(-1)
    pc = torch.sigmoid((sdf - it_cos * d * 0.5) * inv_s)
    nc = torch.sigmoid((sdf + it_cos * d * 0.5) * inv_s)
    alpha = torch.clamp((pc - nc + 1e-5) / (pc + 1e-5), 0.0, 1.0)
    normals = normalize(grads)
    radiance_on = cfg['has_radiance_field'] and \
        step > cfg['radiance_field_step']
    env = env_mips(params['shading']['envlight']['base'])
    color_s, rad_s, occ_info = shade(params, consts, env, flat_pts, normals,
                                     -flat_dirs, app, radiance_on)
    alpha2 = torch.where(inner, alpha.reshape(rn, sn),
                         torch.zeros_like(alpha.reshape(rn, sn)))
    w = composite_weights(alpha2)
    acc = torch.sum(w, 1, keepdim=True)
    color = torch.sum(w[..., None] * color_s.reshape(rn, sn, 3), 1) \
        + (1.0 - acc)
    mask_f = inner.reshape(-1).float()
    nvalid = torch.clamp(mask_f.sum(), min=1.0)
    gt = batch['rgbs']
    terms = {}
    loss_rgb = charbonnier(color, gt)
    if radiance_on:
        rw = torch.sum(w * occ_info['roughness'].reshape(rn, sn), 1).detach()
        radiance = torch.sum(w[..., None] * rad_s.reshape(rn, sn, 3), 1) \
            + (1.0 - acc)
        terms['loss_radiance'] = torch.mean(charbonnier(radiance, gt) * rw)
        loss_rgb = loss_rgb * (1.0 - rw)
    terms['loss_rgb'] = torch.mean(loss_rgb)
    wt = weights_of(cfg, step)
    terms['loss_eikonal'] = torch.sum(
        (torch.linalg.norm(grads, dim=-1) - 1.0) ** 2 * mask_f) / nvalid \
        * wt['eikonal']
    terms['loss_sparse'] = torch.sum(torch.exp(-20.0 * sdf.abs()) * mask_f) \
        / nvalid * wt['sparse']
    terms['loss_hessian'] = torch.sum(hess.abs() * mask_f) / nvalid \
        * wt['hessian']
    field = params['sdf']['field']
    terms['loss_tv_sdf'] = tv_loss(field) * wt['tv_sdf']
    if step > cfg['gaussianLoss_step']:
        terms['loss_gaussian'] = gaussian_loss(field) * wt['gaussian']
    else:
        terms['loss_gaussian'] = torch.zeros((), device=dev)
    if step >= cfg['occ_loss_step']:
        sel = inner.reshape(-1) & (sdf.abs() < cfg['occ_sdf_thresh']) & \
            (torch.sum(normals * flat_dirs, -1) < 0)
        score = torch.where(sel, noise['occ_score'],
                            torch.full_like(noise['occ_score'], -1.0))
        idx = torch.topk(score, min(cfg['occ_loss_max_pn'], score.shape[0]),
                         sorted=True).indices
        occ_gt = occlusion_march(params, pyr_ng, aabb, inv_s.detach(),
                                 flat_pts[idx].detach(),
                                 occ_info['reflective'][idx].detach(), mult)
        m = sel[idx].float()
        # how many samples lie within float32 rounding of the selection's
        # threshold: each may fall on the other side in another program
        near = inner.reshape(-1) & ((sdf.abs() - cfg['occ_sdf_thresh']).abs()
                                    < 1e-6)
        diag = {'occ_selected': float(m.sum()), 'occ_near_thresh':
                float(near.sum())}
        terms['loss_occ'] = torch.sum(
            (occ_info['occ_prob'][idx] - occ_gt).abs()[:, 0] * m) \
            / torch.clamp(m.sum(), min=1.0)
    else:
        terms['loss_occ'] = torch.zeros((), device=dev)
        diag = {}
    accm = torch.clamp(acc, 1e-3, 1.0 - 1e-3)
    mk = (batch['masks'] > 0.5).float()
    terms['loss_mask'] = torch.mean(-(mk * torch.log(accm) + (1 - mk)
                                      * torch.log(1 - accm))) * wt['mask']
    pn = torch.linalg.norm(flat_pts, dim=-1)
    small_m = (pn < 0.1) & (mask_f > 0)
    sl = torch.clamp(sdf - (pn - 0.1), min=0.0) * small_m
    large_m = (pn > 1.05) & (mask_f > 0)
    ll = torch.clamp((pn - 1.05) - sdf, min=0.0) * large_m
    terms['loss_sdf_small'] = torch.sum(sl) / ((sl > 1e-5).sum() + 1e-3) \
        * (small_m.sum() > 0) * wt['init_reg']
    terms['loss_sdf_large'] = torch.sum(ll) / ((ll > 1e-5).sum() + 1e-3) \
        * (large_m.sum() > 0) * wt['init_reg']
    return sum(terms.values()), terms, diag


def weights_of(cfg, step):
    """The loss weights at ``step`` (eikonal ramp, the sparse and Hessian
    ratio switches at the upsample steps, the init-SDF prior's cosine)."""
    w = {}
    ew, b, e = cfg['eikonal_weight'], cfg['eikonal_weight_anneal_begin'], \
        cfg['eikonal_weight_anneal_end']
    w['eikonal'] = 0.0 if step < b else (
        ew * (step - b) / (e - b) if step < e else ew)

    def ratio(lst, ratios):
        for i in range(len(lst or []) - 1, 0, -1):
            if step >= lst[i]:
                return ratios[i]
        return 1.0
    w['sparse'] = cfg['sparse_weight'] * ratio(cfg['sparse_update_list'],
                                               cfg['sparse_ratio'])
    w['hessian'] = cfg['hessian_weight'] * ratio(cfg['hessian_update_list'],
                                                 cfg['hessian_ratio'])
    w['tv_sdf'] = cfg['TV_weight_sdf']
    w['gaussian'] = cfg['gaussian_weight']
    w['mask'] = cfg['mask_loss_weight']
    w['init_reg'] = float((np.cos(step / 1000 * np.pi) + 1) / 2) \
        if step < 1000 else 0.0
    return w


def tv_loss(field):
    total = 0.0
    for p in field['planes']:
        h, w, c = p.shape
        total = total + 2.0 * (
            torch.sum((p[1:] - p[:-1]) ** 2) / ((h - 1) * w * c)
            + torch.sum((p[:, 1:] - p[:, :-1]) ** 2) / (h * (w - 1) * c))
    for ln in field['lines']:
        n, c = ln.shape
        total = total + 2.0 * torch.sum((ln[1:] - ln[:-1]) ** 2) / (
            (n - 1) * c)
    return total


def gaussian_loss(field, k=5, sigma=0.5):
    x = np.arange(-(k // 2), k // 2 + 1, dtype=np.float64)
    k1 = np.exp(-x ** 2 / (2 * sigma ** 2))
    dev = field['planes'][0].device
    k1 = torch.tensor(k1 / k1.sum(), dtype=torch.float32, device=dev)
    r = k // 2
    total = 0.0
    for p in field['planes']:
        blur = F.conv2d(p.permute(2, 0, 1)[:, None],
                        (k1[:, None] * k1[None])[None, None],
                        padding=r)[:, 0].permute(1, 2, 0)
        total = total + torch.sum((p[r:-r, r:-r] - blur[r:-r, r:-r]) ** 2)
    for ln in field['lines']:
        blur = F.conv1d(ln.t()[:, None], k1[None, None], padding=r)[:, 0].t()
        total = total + torch.sum((ln[r:-r] - blur[r:-r]) ** 2)
    return total


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def group_of(path):
    if 'field' in path:
        return 'xyz'
    if 'envlight' in path:
        return 'env'
    return 'net'


def lr_factor(cfg, step):
    r = cfg['lr_decay_target_ratio']
    return (math.cos(math.pi * step / cfg['lr_decay_iters']) + 1.0) * 0.5 \
        * (1 - r) + r


def adam_step(cfg, params, opt, grads):
    """Adam (betas 0.9 / 0.99, eps 1e-8, bias-corrected) on every leaf,
    a leaf without gradient taking a zero one; learning rate of the
    leaf's group times the cosine factor at reset + count over its value
    at the reset."""
    base = {'xyz': cfg['lr_xyz_init'], 'net': cfg['lr_net_init'],
            'env': cfg['lr_env_init']}
    scale = lr_factor(cfg, opt['reset_step'] + opt['count']) \
        / lr_factor(cfg, opt['reset_step'])
    b1, b2 = ADAM_BETAS
    with torch.no_grad():
        for path, p in leaves(params):
            k = str(path)
            g = grads.get(k)
            g = torch.zeros_like(p) if g is None else g
            opt['t'][k] += 1
            t = opt['t'][k]
            m = opt['m'][k].mul_(b1).add_(g, alpha=1 - b1)
            v = opt['v'][k].mul_(b2).addcmul_(g, g, value=1 - b2)
            lr = base[group_of(path)] * scale
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(ADAM_EPS)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
    opt['count'] += 1


def train_steps(cfg, state, steps: List[Dict], mode: str = 'float32'):
    """Follow the program from ``state`` (params, Adam moments and counts,
    alpha mask, grid) through ``steps`` (each {'step', 'batch', 'noise'}).
    Returns the per-step loss terms (floats), the Adam first moments after
    the first step, and the params after the last."""
    params = state['params']
    for _, p in leaves(params):
        p.requires_grad_(True)
    consts = Constants(params['deviation']['variance'].device)
    logs, m_after_first = [], None
    with precision(mode):
        for i, s in enumerate(steps):
            total, terms, diag = forward_losses(params, state, cfg, consts,
                                                s['batch'], s['noise'],
                                                s['step'])
            named = leaves(params)
            gs = torch.autograd.grad(total, [p for _, p in named],
                                     allow_unused=True)
            grads = {str(pth): g for (pth, _), g in zip(named, gs)}
            del gs
            adam_step(cfg, params, state['opt'], grads)
            del grads
            logs.append({'loss': float(total.detach()),
                         **{k: float(v.detach()) for k, v in terms.items()},
                         'diag': diag})
            if i == 0:
                m_after_first = {k: v.clone()
                                 for k, v in state['opt']['m'].items()}
            del total, terms
    return logs, m_after_first, {str(p): t.detach() for p, t in
                                 leaves(params)}


# ---------------------------------------------------------------------------
# the stages the comparison starts after: init, upsample, alpha mask
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _predictor_init(gen, d_in, d_out, run_dim=128, final_bias=None):
    dims = [d_in, run_dim, run_dim, d_out]
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(a)
        w = _uniform(gen, (a, b), -bound, bound)
        bias = _uniform(gen, (b,), -bound, bound)
        layers.append({'v': w, 'g': torch.linalg.norm(w, dim=0), 'b': bias})
    if final_bias is not None:
        layers[-1]['b'] = torch.full_like(layers[-1]['b'], final_bias)
    return {'layers': layers}


def init_params(cfg, grid_size):
    """The initial parameters from cfg['random_seed'] on a CPU generator:
    circle-SDF planes (radius 0.2) and constant lines, the geometric head
    init, inv_s 0.3, and the shading networks (uniform +-1/sqrt(fan_in),
    weight-normed) in the release's order."""
    gen = torch.Generator().manual_seed(cfg['random_seed'])
    C, H, app = cfg['sdf_n_comp'], cfg['sdf_dim'], cfg['app_dim']
    r0 = float(cfg.get('init_radius', 0.2))
    planes, lines = [], []
    for i in range(3):
        hw = (grid_size[MAT_MODE[i][0]], grid_size[MAT_MODE[i][1]])
        x = np.linspace(-1, 1, hw[0])
        y = np.linspace(-1, 1, hw[1])
        xx, yy = np.meshgrid(x, y, indexing='ij')
        circ = (np.sqrt(xx ** 2 + yy ** 2) - r0).astype(np.float32)
        planes.append(torch.tensor(circ)[..., None].repeat(1, 1, C))
        lines.append(torch.full((grid_size[VEC_MODE[i]], C), 1.0 / (C * 3)))
    e = 3 * (1 + 2 * cfg['sdf_multires'])
    std0 = np.sqrt(2.0) / np.sqrt(H)
    w0 = torch.zeros((3 * C + e, H))
    w0[3 * C:3 * C + 3] = torch.randn((3, H), generator=gen) * std0
    w1 = torch.randn((H, 1 + app), generator=gen) * 1e-4 \
        + np.sqrt(np.pi) / np.sqrt(H)
    sph = 2 * sum(2 ** i + 1 for i in range(5))
    shading = {
        'mat_mlp': _predictor_init(gen, app, 5),
        'outer_light': _predictor_init(gen, sph, 3,
                                       final_bias=float(np.log(0.5))),
        'envlight': {'base': torch.full((6, 128, 128, 3),
                                        float(np.log(0.5)))},
        'inner_light': _predictor_init(gen, 3 * 17 + sph, 3,
                                       final_bias=float(np.log(0.5))),
        'inner_weight': _predictor_init(gen, 3 * 17 + 3 * 13, 1,
                                        final_bias=-0.95),
        'rad_mlp': _predictor_init(gen, app + 3 + 27 + 3, 3),
    }
    return {'sdf': {'field': {'planes': planes, 'lines': lines},
                    'mlp': [{'w': w0, 'b': torch.zeros(H)},
                            {'w': w1, 'b': torch.full((1 + app,), -r0)}]},
            'deviation': {'variance': torch.tensor(float(cfg['inv_s_init']))},
            'shading': shading}


def _resize_taps(n_in, n_out, device):
    """Source taps and weights of an align-corners linear resize, the
    positions taken as i * ((n_in - 1) * (1 / (n_out - 1))) in float32,
    the last exactly n_in - 1."""
    stop = np.float32(n_in - 1.0)
    pos = np.zeros((n_out,), np.float32)
    pos[:-1] = np.arange(n_out - 1, dtype=np.float32) * (
        stop * (np.float32(1.0) / np.float32(n_out - 1)))
    pos[-1] = stop
    i0 = np.floor(pos).astype(np.int64)
    f = (pos - i0.astype(np.float32)).astype(np.float32)
    return (torch.tensor(i0, device=device),
            torch.tensor(np.minimum(i0 + 1, n_in - 1), device=device),
            torch.tensor(f, device=device))


def upsample_field(field, res):
    """Align-corners bilinear / linear resize of every plane and line."""
    out = {'planes': [], 'lines': []}
    for i in range(3):
        p = field['planes'][i]
        u0, u1, fu = _resize_taps(p.shape[0], res[MAT_MODE[i][0]], p.device)
        v0, v1, fv = _resize_taps(p.shape[1], res[MAT_MODE[i][1]], p.device)
        fu, fv = fu[:, None, None], fv[None, :, None]
        r0, r1 = p[u0], p[u1]
        out['planes'].append((1 - fu) * ((1 - fv) * r0[:, v0] + fv * r0[:, v1])
                             + fu * ((1 - fv) * r1[:, v0] + fv * r1[:, v1]))
        ln = field['lines'][i]
        x0, x1, f = _resize_taps(ln.shape[0], res[VEC_MODE[i]], ln.device)
        out['lines'].append((1 - f[:, None]) * ln[x0] + f[:, None] * ln[x1])
    return out


@torch.no_grad()
def alpha_mask(params, cfg, n_levels, chunk=262144):
    """Isotropic NeuS alpha on a 128^3 lattice over the aabb (forced to 1
    within mul_length lattice steps of the surface), 3^3 max pool,
    thresholded at alphaMask_thres."""
    g = SIZES['alpha_mask_grid']
    dev = params['deviation']['variance'].device
    aabb_np = np.asarray(cfg['aabb'], np.float32)
    aabb = torch.tensor(aabb_np, device=dev)
    xs = [np.linspace(aabb_np[0][d], aabb_np[1][d], g, dtype=np.float32)
          for d in range(3)]
    step_len = float(((aabb_np[1] - aabb_np[0]) / (g - 1)).mean())
    pts = torch.tensor(np.stack(np.meshgrid(*xs, indexing='ij'), -1)
                       .reshape(-1, 3), device=dev)
    pyr = field_pyramids(params['sdf']['field'], n_levels)
    inv_s = torch.clamp(inv_s_of(params), 1e-6, 1e6)
    vals = []
    for i in range(0, pts.shape[0], chunk):
        sdf = sdf_only(params, pyr, aabb, pts[i:i + chunk], None,
                       cfg['sdf_multires'])[:, 0]
        pc = torch.sigmoid((sdf + step_len * 0.5) * inv_s)
        nc = torch.sigmoid((sdf - step_len * 0.5) * inv_s)
        a = torch.clamp((pc - nc + 1e-5) / (pc + 1e-5), 0.0, 1.0)
        near = sdf.abs() < cfg['mul_length'] * step_len
        vals.append(torch.where(near, torch.ones_like(a), a))
    vol = torch.clamp(torch.cat(vals).reshape(g, g, g), 0.0, 1.0)
    vol = F.max_pool3d(vol[None, None], 3, stride=1, padding=1)[0, 0]
    return (vol >= cfg['alphaMask_thres']).float()
