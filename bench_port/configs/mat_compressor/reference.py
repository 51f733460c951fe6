"""Plain PyTorch reference of the stage-2 (material) training step at
configs/mat/syn/compressor.yaml in its NIS phases: the material field and
its three predictors, the analytic direction samplers, the two
conditional flows (conditioning, coupling blocks, the piecewise-quadratic
spline both ways with its log-Jacobians), sampling through the frozen
flow copies, the budgeted secondary trace of the baked SDF with its slot
selection, the inner and outer lights, the GGX / Schlick BRDF, the
Monte-Carlo estimator, the losses and the Adam update.

Written from the published method's equations and the program's
semantics, with the program's layouts (parameter names, channel orders)
so that states can be handed across.  It imports nothing of the program,
of JAX or of the JAX package and calls no kernel: every field is sampled
from its raw planes and lines, the envlight from its raw cubemap, and the
secondary trace is plain trilinear taps over blocks of rays.  The trace
reads only the program's packed full-resolution blocks of the bake,
which are compared with the bake and the bake with a plain evaluation of
the frozen stage-1 field (``sdf_only``); its other tables, the mid and
coarse grids and the direction-binned visibility cache, are built here
from those blocks (``trace_grid``).

Quirks of the published release that lie on this path, kept as they are:

* the specular flow samples REPLACE the analytic GGX samples, where the
  diffuse flow samples are put in front of the analytic ones
  (``shade``);
* the coarse-march (a1) budget never adapts: the trainer adapts the
  refinement and inner-light budgets only (the inputs carry the budgets
  in force);
* ``feats_network`` is drawn at init and never applied: its leaves take
  zero gradients, and Adam moves them only by its moments' decay.

bf16 (``estimator_dtype: bf16``): the program states bf16 operands at
these places, and the reference rounds there and nowhere else:

* the estimator chains: normals, view directions, sample directions,
  metallic, albedo, roughness, the lights and the clamped pdfs are cast
  to bf16, and the BRDF weights, Fresnel, the Schlick geometry term and
  the light products are computed in bf16 arithmetic; the GGX NDF is
  computed in float32 and cast after; every sum over the samples axis
  accumulates in float32 (``dtype=float32``);
* the inner-light MLP: the operands of each of its four products are
  rounded to bf16 and multiplied in float32.

The flows, the trace, the direction sampling and the NIS log densities
stay float32.  ``precision('tf32')`` turns TF32 on for matrix products
and convolutions: the control of the comparison.
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
EPS = 1e-6
TWO_PI = 2.0 * math.pi
MISS_DEPTH = 10.0
SQRT3 = float(np.sqrt(3.0))
# the flows' widths (the release's TensoFlow defaults)
FLOW = dict(n_comp=12, dim=64, feat=16, multires=3, refl_multires=3,
            rough_multires=3, angle_multires=3, n_bins=10, d_hidden=64,
            n_hidden=3)
# the budgeted trace's iteration counts and margins
TRACE = dict(n_coarse=8, n_fine=7, n_newton=2, n_polish=2, step_scale=0.9,
             max_dist=4.0, c_cap_cells=12.0, cert_factor=0.6, h_min=0.12)
CHUNK = 1 << 19          # rays of one block of the trace
# the trace's tables: node strides of the mid and coarse grids in the
# full-resolution bake, and the visibility cache's octahedral bins (16 x
# 16, 8 words of 32) and cone-march steps
MID_STRIDE, COARSE_STRIDE = 2, 4
VIS_NB, VIS_STEPS = 16, 16


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


def sdot(a, b):
    return torch.clamp(torch.sum(a * b, -1, keepdim=True), 0.0, 1.0)


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


def _binom(a, k):
    return np.prod(a - np.arange(k)) / math.factorial(k)


def _assoc_legendre(l, m, k):
    return ((-1) ** m * 2 ** l * math.factorial(l) / math.factorial(k)
            / math.factorial(l - k - m) * _binom(0.5 * (l + k + m - 1.0), l))


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


def ide(xyz, tables):
    """Ref-NeRF's integrated directional encoding (kappa_inv = 0) in real
    arithmetic."""
    mat, m, sigma = tables
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    zpart = torch.cat([z ** i for i in range(mat.shape[0])], -1) @ mat
    r = torch.sqrt(torch.clamp(x * x + y * y, min=0.0))
    phi = torch.atan2(y, x)
    r_pow = torch.where((r == 0.0) & (m > 0), torch.zeros_like(r * m),
                        torch.clamp(r, min=1e-30) ** m)
    att = torch.exp(-sigma * 0.0)
    return torch.cat([r_pow * torch.cos(m * phi) * zpart * att,
                      r_pow * torch.sin(m * phi) * zpart * att], -1)


# ---------------------------------------------------------------------------
# tangent frames, direction tables and samplers
# ---------------------------------------------------------------------------

def frame(n):
    """(x, y, z = n): x orthogonal to n from the larger of (ny, -nx, 0) and
    (-nz, 0, nx), y = n x x."""
    a, b, c = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    zero = torch.zeros_like(a)
    o0 = torch.cat([b, -a, zero], -1)
    o1 = torch.cat([-c, zero, a], -1)
    pick = torch.linalg.norm(o0, dim=-1, keepdim=True) > \
        torch.linalg.norm(o1, dim=-1, keepdim=True)
    x = normalize(torch.where(pick, o0, o1))
    return x, torch.linalg.cross(n, x, dim=-1), n


def angles_in(dirs, fr):
    """(phi, theta) of dirs [pn, sn, 3] in the frame of each point."""
    x, y, z = fr
    cx = torch.sum(x[..., None, :] * dirs, -1, keepdim=True)
    cy = torch.sum(y[..., None, :] * dirs, -1, keepdim=True)
    cz = torch.clamp(torch.sum(z[..., None, :] * dirs, -1, keepdim=True),
                     -1 + EPS, 1 - EPS)
    phi = torch.remainder(torch.atan2(cy, cx) + TWO_PI, TWO_PI)
    return torch.cat([phi, torch.acos(cz)], -1)


def fibonacci_table(n):
    """The shader's (azimuth, elevation) lattice in [0, 1]^2: a Fibonacci
    lattice on the upper hemisphere, float32 [n, 2]."""
    num = int(n // (1 - 0.5))
    phi = (np.sqrt(5) - 1.0) / 2.0
    ns = np.arange(num - n, num, dtype=np.float64)
    z = 2.0 * ns / num - 1.0
    az = (2 * np.pi * ns * phi) % (2 * np.pi)
    el = np.arcsin(z)
    return np.stack([az * 0.5 / np.pi, 1.0 - 2.0 * el / np.pi],
                    -1).astype(np.float32)


def prior_lattice(n):
    """The flows' prior: a Fibonacci lattice from 1 degree of elevation
    up, in normalised (phi, theta) [0, 1]^2, float32 [n, 2]."""
    num = int(n // (1 - 91.0 / 180.0))
    phi = (np.sqrt(5) - 1.0) / 2.0
    ns = np.arange(num - n, num, dtype=np.float64)
    z = 2.0 * ns / num - 1.0
    return np.stack([(2 * np.pi * ns * phi) % (2 * np.pi) / (2 * np.pi),
                     np.arcsin(z) / (0.5 * np.pi)], -1).astype(np.float32)


def ggx_d(noh, a):
    a2 = a * a
    den = noh * noh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * den * den, min=EPS)


def fresnel(f0, hov):
    return f0 + (1.0 - f0) * torch.clamp(1.0 - hov, 0.0, 1.0) ** 5.0


def schlick_ggx(cos, a):
    k = a / 2.0
    return cos / (cos * (1.0 - k) + k + 1e-5)


def diffuse_samples(table, normals, view, roll):
    """Cosine-hemisphere directions about each normal from the lattice,
    rolled in azimuth by ``roll`` [pn, 1, 1]; (dirs, pdf, half angles)."""
    fr = frame(normals)
    x, y, z = fr
    az = table[None, :, 0:1] * TWO_PI
    el = table[None, :, 1:2]
    el_sqrt = torch.sqrt(el + 1e-7)
    if roll is not None:
        az = torch.remainder(az + roll * TWO_PI, TWO_PI)
    cz = torch.sqrt(1.0 - el + 1e-7)
    dirs = (el_sqrt * torch.cos(az) * x[:, None, :]
            + el_sqrt * torch.sin(az) * y[:, None, :] + cz * z[:, None, :])
    pdf = (sdot(dirs, normals[:, None, :]) / math.pi
           * (torch.cos((1.0 - el) * math.pi / 2) * math.pi / 2))
    return dirs, pdf, angles_in(normalize(dirs + view[:, None, :]), fr)


def specular_samples(table, normals, view, rough, roll):
    """GGX half-vector sampling (alpha = roughness) reflected about the
    view; (dirs, pdf, half angles)."""
    pn, sn = normals.shape[0], table.shape[0]
    x, y, z = frame(normals)
    a = rough[:, None, :]
    phi = table[None, :, 0:1] * TWO_PI
    el = table[None, :, 1:2]
    cos_t = torch.sqrt(torch.clamp(
        (1.0 - el) / torch.clamp(1.0 + (a * a - 1.0) * el, min=EPS),
        min=EPS))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=EPS))
    if roll is not None:
        phi = torch.remainder(phi + roll * TWO_PI, TWO_PI)
    half = torch.cat([phi.expand(pn, sn, 1),
                      torch.asin(torch.clamp(sin_t, 0.0, 1.0 - EPS))], -1)
    h = (torch.cos(phi) * sin_t * x[:, None, :]
         + torch.sin(phi) * sin_t * y[:, None, :] + cos_t * z[:, None, :])
    voh = sdot(view[:, None, :], h)
    dirs = voh * h * 2.0 - view[:, None, :]
    noh = torch.clamp(cos_t, min=0.0)
    pdf = (ggx_d(noh, a) * noh / torch.clamp(4.0 * voh, min=EPS)
           * (torch.cos((1.0 - el) * math.pi / 2) * math.pi / 2))
    return dirs, pdf, half


def half_to_dirs(half, normals, view):
    """Half-vector angles -> the view reflected about them; (dirs,
    h.v)."""
    phi, theta = half[..., 0:1], half[..., 1:2]
    x, y, z = frame(normals)
    h = (torch.sin(theta) * torch.cos(phi) * x[:, None, :]
         + torch.sin(theta) * torch.sin(phi) * y[:, None, :]
         + torch.cos(theta) * z[:, None, :])
    hov = sdot(view[:, None, :], h)
    return hov * h * 2.0 - view[:, None, :], hov


# ---------------------------------------------------------------------------
# VM fields and MLPs
# ---------------------------------------------------------------------------

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


def vm_features(field, xyz01):
    """[N, 3C]: plane_i * line_i at contracted coords (clamped to the
    unit cube, no gradient to them), the finest level only."""
    x = torch.clamp(xyz01.detach(), 0.0, 1.0)
    out = []
    for i in range(3):
        a, b = MAT_MODE[i]
        out.append(_bilinear(field['planes'][i], x[:, a], x[:, b])
                   * _linear(field['lines'][i], x[:, VEC_MODE[i]]))
    return torch.cat(out, -1)


def predictor(p, x, act, exp_max=0.0, bf16=False):
    """Weight-normed ReLU MLP; ``bf16`` rounds the operands of every
    product to bf16 (a float32 product of the rounded values)."""
    layers = p['layers']
    for i, layer in enumerate(layers):
        w = layer['v'] * (layer['g'] / torch.clamp(
            torch.linalg.norm(layer['v'], dim=0), min=1e-12))
        if bf16:
            x = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() \
                + layer['b']
        else:
            x = x @ w + layer['b']
        if i < len(layers) - 1:
            x = torch.relu(x)
    if act == 'sigmoid':
        return torch.sigmoid(x)
    return torch.exp(torch.clamp(x, max=exp_max))


def materials(params, pts, aabb):
    """(metallic, roughness = GGX alpha in [0.04^2, 1], albedo)."""
    feats = vm_features(params['mat_field'], (pts - aabb[0])
                        / (aabb[1] - aabb[0]))
    metallic = predictor(params['metallic'], feats, 'sigmoid')
    rough = predictor(params['roughness'], feats, 'sigmoid')
    rough = rough * (1.0 - 0.04 ** 2) + 0.04 ** 2
    return metallic, rough, predictor(params['albedo'], feats, 'sigmoid')


# ---------------------------------------------------------------------------
# the conditional flow (pwquad, two coupling blocks)
# ---------------------------------------------------------------------------

def _spline(wv):
    """Raw spline parameters [N, 1, 2b+1] (clipped to +-10) -> bin widths
    w [N,1,b], their cumulative edges [N,1,b+1], vertex heights v
    [N,1,b+1] normalised to a unit integral, and the cumulative
    integral at the edges [N,1,b+1]."""
    nb1 = (wv.shape[-1] + 1) // 2
    wv = torch.clamp(wv, -10.0, 10.0)
    w = torch.clamp(torch.exp(wv[..., nb1:]), min=1e-6)
    ws = torch.cumsum(w, -1)
    w = torch.clamp(w / ws[..., -1:], min=1e-6)
    ws = ws / ws[..., -1:]
    edges = torch.cat([torch.zeros_like(ws[..., :1]), ws], -1)
    v = torch.exp(wv[..., :nb1])
    v = torch.clamp(v / torch.sum((v[..., :-1] + v[..., 1:]) / 2 * w, -1,
                                  keepdim=True), min=1e-6)
    area = torch.cat([torch.zeros_like(v[..., :1]),
                      torch.cumsum((v[..., :-1] + v[..., 1:]) / 2 * w, -1)],
                     -1)
    return w, edges, v, area


def _bin_of(right_edges, q):
    return torch.clamp(torch.sum(right_edges <= q[..., None], -1), 0,
                       right_edges.shape[-1] - 1)


def _at(a, i):
    return torch.gather(a, -1, i[..., None])[..., 0]


def spline_eval(x, wv):
    """x -> y = the spline's integral at x, with log dy/dx."""
    w, edges, v, area = _spline(wv)
    k = _bin_of(edges[..., 1:], x)
    wk = _at(w, k)
    al = torch.clamp((x - _at(edges, k)) / wk, 0.0, 1.0)
    v0, v1 = _at(v, k), _at(v, k + 1)
    y = al ** 2 / 2 * (v1 - v0) * wk + al * v0 * wk + _at(area, k)
    y = torch.clamp(y, 1e-6, 1.0 - 1e-6)
    logj = torch.sum(torch.log(torch.clamp(v0 + (v1 - v0) * al, min=1e-12)),
                     -1, keepdim=True)
    return y, logj


def spline_invert(y, wv):
    """y -> x solving the bin's quadratic, with log dx/dy."""
    w, edges, v, area = _spline(wv)
    k = _bin_of(area[..., 1:], y)
    wk = _at(w, k)
    v0, v1 = _at(v, k), _at(v, k + 1)
    a = (v1 - v0) * wk
    b = v0 * wk
    c = _at(area, k) - y
    eps = torch.finfo(a.dtype).eps
    a = torch.where(a.abs() < eps, torch.full_like(a, eps), a)
    d = torch.clamp(b * b - 2 * a * c, min=0.0)
    s1 = (-b - torch.sqrt(d)) / a
    s2 = (-b + torch.sqrt(d)) / a
    s = torch.clamp(torch.where((s1 >= 0) & (s1 < 1), s1, s2), eps, 1 - eps)
    x = torch.clamp(wk * s + _at(edges, k), eps, 1.0 - eps)
    logj = -torch.sum(torch.log(torch.clamp(v0 + (v1 - v0) * s, min=1e-12)),
                      -1, keepdim=True)
    return x, logj


def flow_condition(fp, pts, aabb, refl01):
    """[pn, F]: the flow's VM field -> MLP to 16, PE of the reflection
    angles, and a zero roughness embedding (zeroed in the release)."""
    feats = vm_features(fp['field'], (pts - aabb[0]) / (aabb[1] - aabb[0]))
    h = torch.cat([feats, pe(pts, FLOW['multires'])], -1)
    h = softplus100(h @ fp['nis_mat'][0]['w'] + fp['nis_mat'][0]['b'])
    feat = h @ fp['nis_mat'][1]['w'] + fp['nis_mat'][1]['b']
    rough = torch.zeros(pts.shape[:-1] + (1 + 2 * FLOW['rough_multires'],),
                        dtype=pts.dtype, device=pts.device)
    return torch.cat([feat, pe(refl01, FLOW['refl_multires']), rough], -1)


def _coupling(block, y, logj, cond, keep, inverse):
    """One coupling block: dim ``keep`` passes through and conditions the
    spline moving the other dim (evaluated for a density, inverted for a
    sample)."""
    move = 1 - keep
    h = torch.cat([pe(y[:, keep:keep + 1], FLOW['angle_multires']), cond],
                  -1) * 2.0 - 1.0
    layers = block['layers']
    for i, layer in enumerate(layers):
        h = h @ layer['w'] + layer['b']
        if i < len(layers) - 1:
            h = F.leaky_relu(h, 0.01)
    wv = h.reshape(h.shape[0], 1, -1)
    fn = spline_eval if inverse else spline_invert
    ym, dl = fn(y[:, move:move + 1], wv)
    parts = [y[:, 0:1], ym] if keep == 0 else [ym, y[:, 1:2]]
    return torch.cat(parts, -1), logj + dl


def flow_sample(fp, pts, aabb, refl01, lattice, roll):
    """The prior lattice rolled in phi by ``roll`` [pn, sn, 1], pushed
    through the blocks (block 0 keeps phi, then block 1 keeps theta);
    returns (x [pn,sn,2], -log q)."""
    pn, sn = pts.shape[0], lattice.shape[0]
    x = lattice[None].expand(pn, sn, 2)
    if roll is not None:
        x = torch.cat([torch.remainder(x[..., :1] + roll, 1.0), x[..., 1:]],
                      -1)
    x = torch.clamp(x, 1e-6, 1 - 1e-6)
    logj = -torch.log(torch.cos(x[..., 1:] * (0.5 * math.pi)))
    cond = flow_condition(fp, pts, aabb, refl01)
    cond = cond[:, None, :].expand(pn, sn, cond.shape[-1]).reshape(
        pn * sn, -1)
    x, logj = x.reshape(-1, 2), logj.reshape(-1, 1)
    for keep in (0, 1):
        x, logj = _coupling(fp['blocks'][keep], x, logj, cond, keep, False)
    return x.reshape(pn, sn, 2), logj.reshape(pn, sn, 1)


def flow_log_density(fp, pts, aabb, refl01, x):
    """log q(x) [pn, sn, 1]: the blocks in reverse, plus the prior's log
    density cos(theta pi / 2)."""
    pn, sn = x.shape[:2]
    x = torch.clamp(x, 1e-6, 1 - 1e-6).reshape(-1, 2)
    cond = flow_condition(fp, pts, aabb, refl01)
    cond = cond[:, None, :].expand(pn, sn, cond.shape[-1]).reshape(
        pn * sn, -1)
    logj = torch.zeros((pn * sn, 1), dtype=x.dtype, device=x.device)
    for keep in (1, 0):
        x, logj = _coupling(fp['blocks'][keep], x, logj, cond, keep, True)
    z = x.reshape(pn, sn, 2)
    return logj.reshape(pn, sn, 1) + torch.log(torch.cos(
        z[..., 1:] * (0.5 * math.pi)))


def flow_directions(copy, pts, aabb, refl01, lattice, roll, normals, view):
    """Samples of a frozen flow copy as outgoing directions, their
    solid-angle pdf and their half-vector angles."""
    x, neg_logq = flow_sample(copy, pts, aabb, refl01, lattice, roll)
    half = torch.cat([x[..., :1] * (2 * math.pi),
                      x[..., 1:2] * (0.5 * math.pi)], -1)
    dirs, hov = half_to_dirs(half, normals, view)
    prob = torch.exp(-torch.clamp(neg_logq, -8.0, 8.0)) / torch.clamp(
        4.0 * math.pi ** 2 * hov * torch.sin(half[..., 1:2]), min=EPS)
    return dirs, prob, half


def half_x(half):
    return torch.clamp(torch.cat([half[..., 0:1] / (2 * math.pi),
                                  half[..., 1:2] / (0.5 * math.pi)], -1),
                       EPS, 1 - EPS)


# ---------------------------------------------------------------------------
# lights
# ---------------------------------------------------------------------------

def cube_uv(d):
    """Directions -> (face, u, v) of the cubemap."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)),
                     min=1e-12)
    sc = torch.gather(torch.stack([-z, z, x, x, x, -x], 0), 0, face[None])[0]
    tc = torch.gather(torch.stack([-y, -y, z, -z, -y, -y], 0), 0,
                      face[None])[0]
    return face, 0.5 * (sc / ma + 1.0), 0.5 * (tc / ma + 1.0)


def env_light(base, d):
    """exp of the clamped bilinear lookup of the raw cubemap [6,R,R,3]."""
    r = base.shape[1]
    face, u, v = cube_uv(d)
    t0, t1 = v * float(r) - 0.5, u * float(r) - 0.5
    f0, f1 = torch.floor(t0), torch.floor(t1)
    w0, w1 = (t0 - f0)[:, None], (t1 - f1)[:, None]
    i0, i1 = f0.long(), f1.long()

    def tex(a, b):
        return base[face, torch.clamp(a, 0, r - 1), torch.clamp(b, 0, r - 1)]
    return torch.exp(((1 - w0) * (1 - w1)) * tex(i0, i1)
                     + ((1 - w0) * w1) * tex(i0, i1 + 1)
                     + (w0 * (1 - w1)) * tex(i0 + 1, i1)
                     + (w0 * w1) * tex(i0 + 1, i1 + 1))


def inner_light(params, tables, pts, view_out, normals, exp_max, bf16):
    """The inner-light MLP on PE(8) of the hit point and the IDE (degree
    5) of the view reflected about the hit normal."""
    n = normalize(normals)
    v = normalize(view_out)
    refl = torch.sum(v * n, -1, keepdim=True) * n * 2 - v
    return predictor(params['inner_light'],
                     torch.cat([pe(pts, 8), ide(refl, tables)], -1), 'exp',
                     exp_max, bf16)


# ---------------------------------------------------------------------------
# the budgeted secondary trace of the packed bake
# ---------------------------------------------------------------------------

_LANE = np.arange(8)


def tap(rows, aabb, pts, want_grad=False):
    """Trilinear value (and world gradient) at [N,3] of cell-corner rows
    [R,R,R,8] (corner (di*2+dj)*2+dk); 1.0 outside the aabb."""
    r = rows.shape[0]
    lo, hi = aabb[0], aabb[1]
    u = (pts - lo) / (hi - lo)
    inside = torch.all((u >= 0.0) & (u <= 1.0), -1)
    x = torch.clamp(u, 0.0, 1.0) * (r - 1.0)
    b = torch.clamp(x.long(), 0, r - 2)
    f = x - b.to(x.dtype)
    idx = (b[:, 0] * r + b[:, 1]) * r + b[:, 2]
    row = rows.reshape(-1, 8)[torch.clamp(idx, 0, r ** 3 - 1)].float()
    sx, sy, sz = (torch.as_tensor(((_LANE >> s) & 1).astype(np.float32),
                                  device=pts.device) for s in (2, 1, 0))
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    wx = (1.0 - fx) + sx * (2.0 * fx - 1.0)
    wy = (1.0 - fy) + sy * (2.0 * fy - 1.0)
    wz = (1.0 - fz) + sz * (2.0 * fz - 1.0)
    ryz = row * wy * wz
    val = torch.where(inside, torch.sum(ryz * wx, -1),
                      torch.ones_like(x[:, 0]))
    if not want_grad:
        return val
    rx = row * wx
    g = torch.stack([torch.sum(ryz * (2.0 * sx - 1.0), -1),
                     torch.sum(rx * wz * (2.0 * sy - 1.0), -1),
                     torch.sum(rx * wy * (2.0 * sz - 1.0), -1)], -1)
    return val, g * ((r - 1.0) / (hi - lo))


def block_tap(blocks, reso, aabb, pts):
    """Full-resolution trilinear value and world gradient from the 4^3
    node block (stride 3, edge-clamped) holding each point's cell."""
    nb = (reso + 2) // 3
    lo, hi = aabb[0], aabb[1]
    u = (pts - lo) / (hi - lo)
    inside = torch.all((u >= 0.0) & (u <= 1.0), -1)
    x = torch.clamp(u, 0.0, 1.0) * (reso - 1.0)
    c = torch.clamp(x.long(), 0, reso - 2)
    b = torch.clamp(c // 3, max=nb - 1)
    idx = (b[:, 0] * nb + b[:, 1]) * nb + b[:, 2]
    rw = blocks[torch.clamp(idx, 0, blocks.shape[0] - 1)].float()
    loc = x - 3.0 * b.to(x.dtype)
    ks = torch.arange(4.0, device=pts.device)

    def hat(l):
        t = l - ks
        return (torch.clamp(1.0 - t.abs(), min=0.0),
                torch.where(t.abs() < 1.0, -torch.sign(t),
                            torch.zeros_like(t)))
    (wx, gx), (wy, gy), (wz, gz) = (hat(loc[:, i:i + 1]) for i in range(3))
    rwb = rw.reshape(-1, 4, 16)
    a = torch.sum(rwb * wx[:, :, None], 1).reshape(-1, 4, 4)
    bv = torch.sum(a * wy[:, :, None], 1)
    val = torch.where(inside, torch.sum(bv * wz, -1), torch.ones_like(x[:, 0]))
    axg = torch.sum(rwb * gx[:, :, None], 1).reshape(-1, 4, 4)
    g = torch.stack([torch.sum(torch.sum(axg * wy[:, :, None], 1) * wz, -1),
                     torch.sum(torch.sum(a * gy[:, :, None], 1) * wz, -1),
                     torch.sum(bv * gz, -1)], -1)
    return val, g * ((reso - 1.0) / (hi - lo))


def octa_bin(d, nb=VIS_NB):
    s = torch.sum(d.abs(), -1, keepdim=True)
    p = d / torch.clamp(s, min=1e-12)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    u = torch.where(pz < 0, (1.0 - py.abs()) * torch.sign(px), px)
    v = torch.where(pz < 0, (1.0 - px.abs()) * torch.sign(py), py)
    iu = torch.clamp(((u * 0.5 + 0.5) * nb).long(), 0, nb - 1)
    iv = torch.clamp(((v * 0.5 + 0.5) * nb).long(), 0, nb - 1)
    return iv * nb + iu


# ---------------------------------------------------------------------------
# the trace's tables, built here from the packed bake
# ---------------------------------------------------------------------------

def strided_nodes(blocks, reso, stride):
    """[n, n, n] bake values of the nodes (stride i, stride j, stride k),
    read from the packed 4^3 blocks: node i of an axis lies in block
    min(i // 3, nb - 1) at offset i - 3 b."""
    nb = (reso + 2) // 3
    ax = torch.arange(0, reso, stride, device=blocks.device)
    b = torch.clamp(ax // 3, max=nb - 1)
    off = ax - 3 * b
    row = (b[:, None, None] * nb + b[None, :, None]) * nb + b[None, None, :]
    lane = (off[:, None, None] * 4 + off[None, :, None]) * 4 \
        + off[None, None, :]
    return blocks[row, lane]


def cell_rows(values):
    """[n, n, n] node values -> [n, n, n, 8]: the corners (i + di, j + dj,
    k + dk) of each cell, clamped to the last node, corner (di * 2 + dj)
    * 2 + dk."""
    n = values.shape[0]
    nxt = torch.clamp(torch.arange(n, device=values.device) + 1, max=n - 1)
    rows = []
    for lane in range(8):
        v = values
        if lane & 4:
            v = v[nxt]
        if lane & 2:
            v = v[:, nxt]
        if lane & 1:
            v = v[:, :, nxt]
        rows.append(v)
    return torch.stack(rows, -1)


def _octa_decode(u, v):
    z = 1.0 - np.abs(u) - np.abs(v)
    x = np.where(z < 0, (1.0 - np.abs(v)) * np.sign(u), u)
    y = np.where(z < 0, (1.0 - np.abs(u)) * np.sign(v), v)
    d = np.stack([x, y, z], -1)
    return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)


def octa_table(nb=VIS_NB):
    """Each octahedral bin's centre direction [nb^2, 3] and its chord
    [nb^2]: the largest |d - centre| over the unit directions d of a grid
    16 times finer that fall in the bin, times 1.05, plus 1e-3."""
    c = (np.arange(nb) + 0.5) / nb * 2.0 - 1.0
    cu, cv = np.meshgrid(c, c, indexing='xy')
    centres = _octa_decode(cu.reshape(-1), cv.reshape(-1))
    s = (np.arange(16 * nb) + 0.5) / (16 * nb) * 2.0 - 1.0
    gu, gv = (a.reshape(-1) for a in np.meshgrid(s, s, indexing='xy'))
    iu = np.clip(((gu * 0.5 + 0.5) * nb).astype(np.int32), 0, nb - 1)
    iv = np.clip(((gv * 0.5 + 0.5) * nb).astype(np.int32), 0, nb - 1)
    bins = iv * nb + iu
    chord = np.zeros(nb * nb, np.float64)
    np.maximum.at(chord, bins, np.linalg.norm(
        _octa_decode(gu, gv) - centres[bins], axis=-1))
    return centres.astype(np.float32), (chord * 1.05 + 1e-3).astype(
        np.float32)


def scales64(aabb, mid_n, coarse_n):
    """The trace's cell scales as float64 numbers: mid and coarse cell
    sizes over the mean extent, the coarse diagonal, the switch distance
    to the mid grid, the launch arm and offset, and the launch corridor's
    end T0."""
    a = aabb.detach().cpu().double().numpy()
    ext = float(np.mean(a[1] - a[0]))
    m_cell, c_cell = ext / (mid_n - 1), ext / (coarse_n - 1)
    c_diag = SQRT3 * c_cell
    switch = c_diag + 2.0 * m_cell
    arm, delta = 1.25 * switch, 1.5 * m_cell
    return dict(m_cell=m_cell, c_cell=c_cell, c_diag=c_diag,
                t0=2.0 * (arm - delta))


@torch.no_grad()
def vis_bake(coarse_rows, aabb, apex_pad, sc):
    """The visibility cache [Rc, Rc, Rc, 8] (int64 words, bin = word * 32
    + bit): for each coarse node and octahedral bin, a cone march of the
    coarse interpolant along the bin's centre from T0, 16 steps of 0.9 of
    the distance past the margin (at least a tenth of a coarse cell, at
    most 12 cells).  The margin at t is 0.75 c_diag (half a coarse cell
    of launch offset, a quarter of interpolation error) + the apex pad +
    t * the bin's chord + the distance the point lies outside the aabb
    (the tap is taken at the point clamped into it).  A bit is 1, every
    ray of the cone certified clear to the aabb's exit, where the cone
    left the aabb (the outside distance beyond the rest of the margin)
    before the distance fell within its margin."""
    rc = coarse_rows.shape[0]
    dev = coarse_rows.device
    lo, hi = aabb[0], aabb[1]
    ax = torch.linspace(0.0, 1.0, rc, dtype=torch.float32, device=dev)
    nodes = lo + torch.stack(torch.meshgrid(ax, ax, ax, indexing='ij'),
                             -1).reshape(-1, 3) * (hi - lo)
    nn = nodes.shape[0]
    centres, chords = (torch.as_tensor(a, device=dev) for a in octa_table())
    base = 0.75 * sc['c_diag'] + apex_pad
    c_cap = 12.0 * sc['c_cell']
    shifts = torch.arange(32, dtype=torch.int64, device=dev)[:, None]
    words = []
    for w in range(0, VIS_NB * VIS_NB, 32):
        d = centres[w:w + 32, None, :]
        chord = chords[w:w + 32, None]
        t = torch.full((32, nn), sc['t0'], dtype=torch.float32, device=dev)
        blocked = torch.zeros((32, nn), dtype=torch.bool, device=dev)
        cleared = torch.zeros((32, nn), dtype=torch.bool, device=dev)
        for _ in range(VIS_STEPS):
            pos = nodes[None] + d * t[..., None]
            inside = torch.minimum(torch.maximum(pos, lo), hi)
            out = torch.linalg.norm(pos - inside, dim=-1)
            dist = tap(coarse_rows, aabb, inside.reshape(-1, 3)).reshape(
                32, nn)
            eff = dist - (base + t * chord + out)
            cleared = cleared | (~blocked & (out > (base + t * chord)))
            blocked = blocked | (~cleared & (eff <= 0.0))
            t = torch.where(blocked | cleared, t, t + torch.clamp(
                eff * 0.9, 0.1 * sc['c_cell'], c_cap))
        words.append(torch.sum((cleared & ~blocked).long() << shifts, 0))
    return torch.stack(words, -1).reshape(rc, rc, rc, VIS_NB * VIS_NB // 32)


def trace_grid(blocks, reso, aabb, apex_pad):
    """The trace's tables built from the packed bake (the blocks, checked
    against the bake): the cell rows of the mid and coarse grids (the
    nodes at strides 2 and 4, their bf16 values as the blocks hold them)
    and the visibility cache baked over the coarse grid."""
    mid = cell_rows(strided_nodes(blocks, reso, MID_STRIDE))
    coarse = cell_rows(strided_nodes(blocks, reso, COARSE_STRIDE))
    sc = scales64(aabb, mid.shape[0], coarse.shape[0])
    return {'blocks': blocks, 'reso': reso, 'aabb': aabb, 'mid_rows': mid,
            'coarse_rows': coarse,
            'vis_rows': vis_bake(coarse, aabb, apex_pad, sc)}


def budget_slots(n, budget):
    return max((int(n * budget) // 128) * 128, 128)


def first_k(mask, k):
    """The first ``k`` set entries of a flat mask, in order: the slots a
    budget of ``k`` gives."""
    return mask & (torch.cumsum(mask.long(), 0) <= k)


def _slab(aabb, o, d):
    vec = torch.where(d == 0, torch.full_like(d, 1e-6), d)
    ra, rb = (aabb[1] - o) / vec, (aabb[0] - o) / vec
    return (torch.clamp(torch.max(torch.minimum(ra, rb), -1).values, min=0.0),
            torch.clamp(torch.min(torch.maximum(ra, rb), -1).values,
                        max=TRACE['max_dist']))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _newton(t, dv, g, d, lo, hi):
    s = torch.sum(g * d, -1)
    s = torch.where(s.abs() < 0.1, torch.sign(s) * 0.1 + torch.where(
        s == 0, torch.full_like(s, 0.1), torch.zeros_like(s)), s)
    return _clip(t - dv / s, lo, hi)


class Scales:
    def __init__(self, grid):
        ext = torch.mean(grid['aabb'][1] - grid['aabb'][0])
        self.m_cell = ext / (grid['mid_rows'].shape[0] - 1)
        self.c_cell = ext / (grid['coarse_rows'].shape[0] - 1)
        self.c_diag = SQRT3 * self.c_cell
        self.switch = self.c_diag + 2.0 * self.m_cell
        self.arm = 1.25 * self.switch
        self.delta = 1.5 * self.m_cell


def _phase_a(grid, sc, o, d, h0, word_rows):
    """The launch test of one block of rays: the corridor crossed
    analytically with one coarse probe, then the visibility cache's bit
    and a second probe over the gap; returns (cand0, need, t0, t_enter,
    t_exit)."""
    t_enter, t_exit = _slab(grid['aabb'], o, d)
    into = h0 <= 0.0
    t0 = torch.minimum((sc.arm - sc.delta) / torch.clamp(
        h0, min=TRACE['h_min']), t_exit)
    d_probe = tap(grid['coarse_rows'], grid['aabb'], o + d * t0[:, None]) \
        - 0.25 * sc.c_diag
    pred = sc.delta + t0 * torch.clamp(h0, min=0.0)
    clear = (h0 >= TRACE['h_min']) & (
        d_probe > TRACE['cert_factor'] * torch.minimum(pred, sc.arm))
    cand0 = ~clear & ~into
    t0max = 2.0 * (sc.arm - sc.delta)
    bins = octa_bin(d)
    word = torch.gather(word_rows, 1, (bins >> 5)[:, None])[:, 0]
    bit = ((word >> (bins & 31)) & 1) > 0
    gap = torch.clamp(t0max - t0, min=0.0)
    d2 = tap(grid['coarse_rows'], grid['aabb'], o + d * t0max) \
        - 0.25 * sc.c_diag
    corridor = (gap <= 0.0) | (d_probe + torch.clamp(d2, min=0.0) > gap)
    need = clear & ~(clear & bit & corridor)
    return cand0, need, t0, t_enter, t_exit


def _coarse(grid, sc, o, d, t, t_exit):
    near = torch.zeros_like(t, dtype=torch.bool)
    c_cap = TRACE['c_cap_cells'] * sc.c_cell
    for _ in range(TRACE['n_coarse']):
        dd = tap(grid['coarse_rows'], grid['aabb'], o + d * t[:, None])
        near = near | (dd < sc.switch)
        done = near | (t > t_exit)
        t = torch.where(done, t, t + torch.clamp(
            torch.minimum(TRACE['step_scale'] * dd, c_cap) - sc.c_diag,
            min=0.0))
    return t, near | (t <= t_exit)


def _refine(grid, sc, o, d, t, t_exit):
    """The mid-grid march, Newton on the mid interpolant, and the
    full-resolution polish; returns (hit, t, normal)."""
    eps_m = 0.75 * sc.m_cell
    done = torch.zeros_like(t, dtype=torch.bool)
    prev = (2.0 * sc.m_cell).expand(t.shape[0])
    for _ in range(TRACE['n_fine']):
        dd = tap(grid['mid_rows'], grid['aabb'], o + d * t[:, None])
        done = done | (dd < eps_m) | (t > t_exit)
        step = torch.minimum(torch.maximum(dd, eps_m * 0.5)
                             * TRACE['step_scale'], 4.0 * sc.m_cell)
        t = torch.where(done, t, t + step)
        prev = torch.where(done, prev, step)
    lo = torch.clamp(t - torch.maximum(prev, 2.0 * sc.m_cell), min=0.0)
    hi = t + 0.5 * sc.m_cell
    d_end = torch.zeros_like(t)
    for _ in range(TRACE['n_newton']):
        d_end, g = tap(grid['mid_rows'], grid['aabb'], o + d * t[:, None],
                       want_grad=True)
        s = torch.sum(g * d, -1)
        s = torch.where(s.abs() < 0.1, torch.where(
            s < 0, torch.full_like(s, -0.1), torch.full_like(s, 0.1)), s)
        t = _clip(t - d_end / s, lo, hi)
    hit = done & (d_end < 2.0 * eps_m) & (t <= t_exit)
    b_lo, b_hi = t - 2.0 * sc.m_cell, t + 2.0 * sc.m_cell
    for _ in range(TRACE['n_polish'] - 1):
        dv, g = block_tap(grid['blocks'], grid['reso'], grid['aabb'],
                          o + d * t[:, None])
        t = _newton(t, dv, g, d, b_lo, b_hi)
    dv, g = block_tap(grid['blocks'], grid['reso'], grid['aabb'],
                      o + d * t[:, None])
    t = _newton(t, dv, g, d, b_lo, b_hi)
    n = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-8)
    n = torch.where(torch.sum(n * d, -1, keepdim=True) >= 0, -n, n)
    return hit, t, n


@torch.no_grad()
def trace(grid, o, d, h0, cache_rows, sn, m, a1_budget):
    """The secondary trace of N = pn * sn rays (a point's sn rays
    consecutive): the launch test of every ray; the first
    budget_slots(N, a1_budget) rays that need it march the coarse grid
    (those past that budget become candidates from their corridor end);
    the first ``m`` candidates are refined.  Selections are taken over
    the whole step's rays first, then the rays are traced in blocks.
    Returns per ray: refined (got a slot), hit (refined and hit), depth,
    hit point and normal, and the candidate and coarse-march masks."""
    n, dev = o.shape[0], o.device
    sc = Scales(grid)
    blocks = [(a, min(a + CHUNK, n)) for a in range(0, n, CHUNK)]

    def rows_of(a, b):
        return cache_rows[torch.arange(a, b, device=dev) // sn]
    cand0, need, t0, t_exit = (torch.empty(n, dtype=torch.bool, device=dev),
                               torch.empty(n, dtype=torch.bool, device=dev),
                               torch.empty(n, device=dev),
                               torch.empty(n, device=dev))
    tc0 = torch.empty(n, device=dev)
    for a, b in blocks:
        c0, nd, tt, te, tx = _phase_a(grid, sc, o[a:b], d[a:b], h0[a:b],
                                      rows_of(a, b))
        cand0[a:b], need[a:b], t0[a:b], t_exit[a:b] = c0, nd, tt, tx
        tc0[a:b] = torch.maximum(tt, te)
    marched = first_k(need, budget_slots(n, a1_budget))
    overflow = need & ~marched
    cand = cand0 | overflow
    t = torch.where(overflow, tc0, torch.zeros_like(tc0))
    idx = torch.nonzero(marched)[:, 0]
    for a in range(0, idx.shape[0], CHUNK):
        i = idx[a:a + CHUNK]
        ta, ca = _coarse(grid, sc, o[i], d[i], tc0[i], t_exit[i])
        t[i] = torch.where(cand0[i], torch.zeros_like(ta), ta)
        cand[i] = cand0[i] | ca
    refined = first_k(cand, m)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    depth = torch.full((n,), MISS_DEPTH, device=dev)
    pts = torch.zeros((n, 3), device=dev)
    nrm = torch.zeros((n, 3), device=dev)
    idx = torch.nonzero(refined)[:, 0]
    for a in range(0, idx.shape[0], CHUNK):
        i = idx[a:a + CHUNK]
        h, tr, nr = _refine(grid, sc, o[i], d[i], t[i], t_exit[i])
        hit[i] = h
        depth[i] = torch.where(h, tr, torch.full_like(tr, MISS_DEPTH))
        pts[i] = o[i] + d[i] * torch.where(h, tr,
                                           torch.zeros_like(tr))[:, None]
        nrm[i] = nr
    return {'refined': refined, 'hit': hit, 'depth': depth, 'pts': pts,
            'normals': nrm, 'cand': cand, 'need': need}


def lights(params, shader, grid, unit_size, tables, pts, dirs, normals,
           stats):
    """Secondary radiance [pn, sn, 3] of the directions [pn, sn, 3] from
    the surface points: the outer light where the traced ray misses, the
    inner-light MLP where it hits and holds one of the inner budget's
    slots, the outer light on a hit past that budget; zero where the hit
    lies within 1e-5 of the origin."""
    pn, sn = dirs.shape[:2]
    eps = 1e-5
    o = (pts[:, None, :] + dirs * eps).reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n_rays = o.shape[0]
    outer = env_light(params['outer_light']['base'], d)
    aabb = grid['aabb']
    with torch.no_grad():
        dn = d.detach()
        m_cell = torch.mean(aabb[1] - aabb[0]) / (
            grid['mid_rows'].shape[0] - 1)
        nrm = normals[:, None, :].expand(pn, sn, 3).reshape(-1, 3)
        o_tr = o.detach() + 2.0 * unit_size * dn + 1.5 * m_cell * nrm
        h0 = torch.sum(dn * nrm, -1)
        # one visibility-cache row a surface point: the node nearest the
        # point lifted off its surface
        rv = grid['vis_rows'].shape[0]
        lift = pts[:, :] + 1.5 * m_cell * normals
        ci = torch.clamp(torch.round(torch.clamp(
            (lift - aabb[0]) / (aabb[1] - aabb[0]), 0.0, 1.0)
            * (rv - 1)).long(), 0, rv - 1)
        cache_rows = grid['vis_rows'].reshape(-1, 8)[torch.clamp(
            (ci[:, 0] * rv + ci[:, 1]) * rv + ci[:, 2], 0, rv ** 3 - 1)]
        m = budget_slots(n_rays, shader['secondary_budget'])
        tr = trace(grid, o_tr, dn, h0, cache_rows, sn, m, shader['a1_budget'])
        hit_slot = tr['hit']
        stats['secondary_cand_rate'] = float(tr['cand'].sum()) / n_rays
        stats['secondary_hit_rate'] = float(hit_slot.sum()) / n_rays
        stats['secondary_a1_rate'] = float(tr['need'].sum()) / n_rays
        m2 = budget_slots(n_rays, min(shader['inner_light_budget'],
                                      shader['secondary_budget']))
        use_inner = first_k(hit_slot, m2)
        idx = torch.nonzero(use_inner)[:, 0]
    inner = inner_light(params, tables, tr['pts'][idx], -dn[idx],
                        tr['normals'][idx], shader['inner_light_exp_max'],
                        shader['estimator_dtype'] == 'bf16')
    out = outer.index_put((idx,), inner)
    out = out * (tr['depth'] > eps).to(out.dtype)[:, None]
    return out.reshape(pn, sn, 3), hit_slot.reshape(pn, sn)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class Constants:
    def __init__(self, shader, device):
        self.ide = tuple(torch.tensor(t, device=device)
                         for t in ide_tables(5))
        self.diffuse = torch.tensor(
            fibonacci_table(shader['diffuse_sample_num']), device=device)
        self.specular = torch.tensor(
            fibonacci_table(shader['specular_sample_num']), device=device)
        self.prior_d = torch.tensor(
            prior_lattice(shader['nis_diffuse_sample_num']), device=device)
        self.prior_s = torch.tensor(
            prior_lattice(shader['nis_specular_sample_num']), device=device)


def shade(params, shader, grid, unit_size, consts, aabb, pts, normals, view,
          metallic, rough, albedo, phase, noise, copies, stats,
          fault=None):
    """The mixed estimator: the diffuse flow copy's samples in front of
    the analytic diffuse ones, the specular flow copy's samples in place
    of the GGX ones, one trace of all secondary rays, and the NIS
    losses.  ``fault='specular_copy'`` keeps the GGX samples (unrolled)
    where the specular copy samples: a planted fault of the control."""
    f32 = torch.float32
    bf = torch.bfloat16 if shader['estimator_dtype'] == 'bf16' else f32
    x_, y_, z_ = frame(normals)
    refl01 = angles_in(view[:, None, :], (x_, y_, z_))[:, 0] / torch.tensor(
        [2 * np.pi, 0.5 * np.pi], dtype=f32, device=pts.device)

    d_dirs, d_prob, d_half = diffuse_samples(consts.diffuse, normals, view,
                                             noise.get('az_diffuse'))
    if phase['nis_sample_diffuse']:
        fd, fp, fh = flow_directions(copies['diffuse'], pts, aabb, refl01,
                                     consts.prior_d,
                                     noise.get('flow_diffuse'), normals,
                                     view)
        d_dirs = torch.cat([fd, d_dirs], 1)
        d_prob = torch.cat([fp, d_prob], 1)
        d_half = torch.cat([fh, d_half], 1)
    hov_d = sdot(normalize(view[:, None, :] + d_dirs), view[:, None, :])

    if phase['nis_sample_specular'] and fault != 'specular_copy':
        s_dirs, s_prob, s_half = flow_directions(
            copies['specular'], pts, aabb, refl01, consts.prior_s,
            noise.get('flow_specular'), normals, view)
    else:
        s_dirs, s_prob, s_half = specular_samples(
            consts.specular, normals, view, rough, noise.get('az_specular'))
    spec_num = s_dirs.shape[1]

    nc, vc = normals.to(bf), view.to(bf)
    met, alb, rgh = metallic.to(bf), albedo.to(bf), rough.to(bf)
    kd = 1.0 - met[:, None, :]
    s_mask = torch.sum(s_dirs * normals[:, None, :], -1) > 0
    s_mask_c = s_mask[..., None].to(bf)
    f0 = 0.04 * (1.0 - met) + met * alb
    h_s = normalize(view[:, None, :] + s_dirs)
    hov_s = sdot(h_s, view[:, None, :])
    fres = fresnel(f0[:, None, :], hov_s.to(bf))
    nov = sdot(nc, vc)[:, None, :]
    nol = sdot(nc[:, None, :], s_dirs.to(bf))
    geom = schlick_ggx(nov, rgh[:, None, :]) \
        * schlick_ggx(nol, rgh[:, None, :])
    dist = ggx_d(sdot(normals[:, None, :], h_s), rough[:, None, :]).to(bf)

    dn = d_dirs.shape[1]
    all_dirs = torch.cat([d_dirs, s_dirs], 1)
    all_l, _ = lights(params, shader, grid, unit_size, consts.ide, pts,
                      all_dirs, normals, stats)
    d_l, s_l = all_l[:, :dn], all_l[:, dn:]
    dl, sl = d_l.to(bf), s_l.to(bf)
    dp = torch.clamp(d_prob, min=EPS).to(bf)
    sp = torch.clamp(s_prob, min=EPS).to(bf)
    d_w = alb[:, None, :] * kd * (sdot(d_dirs.to(bf), nc[:, None, :])
                                  / math.pi)
    d_col = torch.mean(d_w * dl / dp, 1, dtype=f32)
    s_w = dist * fres * geom / torch.clamp(4.0 * nov, min=EPS)
    s_col = torch.sum(s_mask_c * s_w * sl / sp, 1, dtype=f32) / spec_num
    out = {'rgb_pr': linear_to_srgb(d_col + s_col),
           'diffuse_light': torch.clamp(linear_to_srgb(torch.mean(d_l, 1)),
                                        0, 1)}

    zero = torch.zeros((), dtype=f32, device=pts.device)
    fx_d = d_w * dl
    if phase['nis_loss_diffuse']:
        sn = shader['nis_diffuse_sample_num']
        logq = flow_log_density(params['flow_diffuse'], pts, aabb, refl01,
                                half_x(d_half[:, :sn])) - torch.log(
            torch.clamp(4 * math.pi ** 2 * hov_d[:, :sn]
                        * torch.sin(d_half[:, :sn, 1:2]), min=EPS))
        out['loss_nis_diffuse'] = -torch.mean(
            fx_d[:, :sn].float() * logq
            / torch.clamp(d_prob[:, :sn], min=EPS))
    else:
        out['loss_nis_diffuse'] = zero
    fx_s = s_w * sl
    if phase['nis_loss_specular']:
        logq = flow_log_density(params['flow_specular'], pts, aabb, refl01,
                                half_x(s_half)) - torch.log(torch.clamp(
                                    4 * math.pi ** 2 * hov_s
                                    * torch.sin(s_half[..., 1:2]), min=EPS))
        term = fx_s.float() * logq / torch.clamp(s_prob, min=EPS) \
            * s_mask[..., None].float()
        out['loss_nis_specular'] = -torch.sum(term) / torch.clamp(
            torch.sum(s_mask.float()) * 3.0, min=1.0)
    else:
        out['loss_nis_specular'] = zero
    out['loss_nis'] = out['loss_nis_diffuse'] + out['loss_nis_specular']
    return out


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


def forward_losses(params, cfg, state, consts, s, fault=None):
    """The step's loss and its terms from one batch: materials, the
    estimator, the charbonnier rgb loss, the material regulariser (TV of
    the material field, and the saturation clamps before step 2000), the
    white-diffuse-light prior and the weighted NIS loss."""
    b, aabb = s['batch'], state['aabb']
    view = normalize(-b['rays_d'])
    normals = normalize(b['normals'])
    pts = b['inters']
    metallic, rough, albedo = materials(params, pts, aabb)
    stats = {}
    out = shade(params, s['shader'], state['grid'], state['unit_size'],
                consts, aabb, pts, normals, view, metallic, rough, albedo,
                s['phase'], s['noise'], state['copies'], stats, fault)
    terms = {'loss_rgb': torch.mean(charbonnier(out['rgb_pr'], b['rgb']))}
    if cfg['reg_mat']:
        reg = tv_loss(params['mat_field']) * 0.1
        clamp = (torch.sum(torch.relu(rough - 0.9 ** 2))
                 + torch.sum(torch.relu(0.1 ** 2 - rough))
                 + torch.sum(torch.relu(metallic - 0.98))
                 + torch.sum(torch.relu(0.02 - metallic)))
        terms['loss_mat_reg'] = torch.mean(
            reg + clamp * (1.0 if s['step'] < 2000 else 0.0))
    if cfg['reg_diffuse_light']:
        dl = out['diffuse_light']
        terms['loss_diffuse_light'] = torch.mean(torch.sum(torch.abs(
            dl - torch.mean(dl, -1, keepdim=True)), -1)
            * cfg['reg_diffuse_light_lambda'])
    terms['loss_nis'] = out['loss_nis'].reshape(()) * s['weights']['nis']
    total = sum(terms.values())
    return total, terms, stats


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
    if 'planes' in path or 'lines' in path:
        return 'xyz'
    if 'outer_light' in path and 'base' in path:
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


def train_steps(cfg, state, steps: List[Dict], mode: str = 'float32',
                fault=None, keep_grads=False):
    """Follow the program from ``state`` (params, Adam moments and counts,
    the frozen flow copies, the trace grid, aabb, unit size) through
    ``steps`` (each {'step', 'batch', 'noise', 'phase', 'weights',
    'shader'}).  Returns the per-step loss terms and trace rates
    (floats), the Adam first moments after the first step, the params
    after the last, and (``keep_grads``) each step's gradients."""
    params = state['params']
    for _, p in leaves(params):
        p.requires_grad_(True)
    consts = Constants(steps[0]['shader'], state['aabb'].device)
    logs, m_after_first, grads_all = [], None, []
    with precision(mode):
        for i, s in enumerate(steps):
            total, terms, stats = forward_losses(params, cfg, state, consts,
                                                 s, fault)
            named = leaves(params)
            gs = torch.autograd.grad(total, [p for _, p in named],
                                     allow_unused=True)
            grads = {str(pth): g for (pth, _), g in zip(named, gs)}
            del gs
            if keep_grads:
                grads_all.append({k: v.detach().clone() for k, v in
                                  grads.items() if v is not None})
            adam_step(cfg, params, state['opt'], grads)
            del grads
            logs.append({'loss': float(total.detach()),
                         **{k: float(v.detach()) for k, v in terms.items()},
                         **stats})
            if i == 0:
                m_after_first = {k: v.clone()
                                 for k, v in state['opt']['m'].items()}
            del total, terms
    out = (logs, m_after_first, {str(p): t.detach() for p, t in
                                 leaves(params)})
    return out + (grads_all,) if keep_grads else out


# ---------------------------------------------------------------------------
# the stages the comparison starts after: init and the bake
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _linear_init(gen, a, b, weight_norm):
    bound = 1.0 / math.sqrt(a)
    w = _uniform(gen, (a, b), -bound, bound)
    bias = _uniform(gen, (b,), -bound, bound)
    if weight_norm:
        return {'v': w, 'g': torch.linalg.norm(w, dim=0), 'b': bias}
    return {'w': w, 'b': bias}


def _predictor_init(gen, dims, final_bias=None):
    layers = [_linear_init(gen, a, b, True) for a, b in zip(dims[:-1],
                                                          dims[1:])]
    if final_bias is not None:
        layers[-1]['b'] = torch.full_like(layers[-1]['b'], final_bias)
    return {'layers': layers}


def _vm_random(gen, grid_size, c):
    planes, lines = [], []
    for i in range(3):
        hw = (grid_size[MAT_MODE[i][0]], grid_size[MAT_MODE[i][1]])
        planes.append(1e-4 * (2.0 * torch.rand(hw + (c,), generator=gen)
                              - 1.0))
        lines.append(torch.full((grid_size[VEC_MODE[i]], c), 1.0 / (c * 3)))
    return {'planes': planes, 'lines': lines}


def _flow_init(gen, grid_size):
    c = FLOW['n_comp']
    field = _vm_random(gen, grid_size, c)
    xyz_ch = 3 * (1 + 2 * FLOW['multires'])
    nis_mat = [_linear_init(gen, 3 * c + xyz_ch, FLOW['dim'], False),
               _linear_init(gen, FLOW['dim'], FLOW['feat'], False)]
    feat = (FLOW['feat'] + 2 * (1 + 2 * FLOW['refl_multires'])
            + (1 + 2 * FLOW['rough_multires']))
    dims = ([(1 + 2 * FLOW['angle_multires']) + feat]
            + [FLOW['d_hidden']] * FLOW['n_hidden']
            + [2 * FLOW['n_bins'] + 1])
    blocks = [{'layers': [_linear_init(gen, a, b, False)
                          for a, b in zip(dims[:-1], dims[1:])]}
              for _ in range(2)]
    return {'field': field, 'nis_mat': nis_mat, 'blocks': blocks}


def init_params(shader, seed):
    """The initial parameters from ``seed`` on a CPU generator, in the
    release's order: the material field (uniform +-1e-4 planes, constant
    lines), the three predictors and the skip MLP of material features
    (uniform +-1/sqrt(fan_in), weight-normed), the inner light (final
    bias log 0.5), the envlight (log 0.5), then the diffuse and the
    specular flow."""
    gen = torch.Generator().manual_seed(seed)
    gs, c = tuple(shader['grid_size']), shader['mat_n_comp']
    pos, sph = 3 * 17, 2 * sum(2 ** i + 1 for i in range(5))
    params = {'mat_field': _vm_random(gen, gs, c)}
    params['metallic'] = _predictor_init(gen, [3 * c, 128, 1])
    params['roughness'] = _predictor_init(gen, [3 * c, 128, 1])
    params['albedo'] = _predictor_init(gen, [3 * c, 128, 3])
    params['feats_network'] = {
        'm0': [_linear_init(gen, a, b, True) for a, b in
               zip([pos, 256, 256, 256], [256] * 4)],
        'm1': [_linear_init(gen, a, b, True) for a, b in
               zip([pos + 256, 256, 256, 256], [256] * 4)]}
    params['inner_light'] = _predictor_init(gen, [pos + sph] + [256] * 3
                                            + [3], float(np.log(0.5)))
    r = shader['light_reso']
    params['outer_light'] = {'base': torch.full((6, r, r, 3),
                                                float(np.log(0.5)))}
    params['flow_diffuse'] = _flow_init(gen, gs)
    params['flow_specular'] = _flow_init(gen, gs)
    return params


def sdf_only(geo, sdf_cfg, aabb, xyz):
    """The frozen stage-1 SDF at world points [N, 3]: the VM field's
    finest level, PE(3) of the contracted point, the softplus(100) hidden
    layer and the SDF column of the head, float32."""
    xyz01 = (xyz - aabb[0]) / (aabb[1] - aabb[0])
    feats = vm_features(geo['sdf']['field'], xyz01)
    src = xyz01 if sdf_cfg['sdf_multires'] == 3 else xyz
    m = geo['sdf']['mlp']
    h = softplus100(torch.cat([feats, pe(src, sdf_cfg['sdf_multires'])], -1)
                    @ m[0]['w'] + m[0]['b'])
    return h @ m[1]['w'][:, :1] + m[1]['b'][:1]


def bake_nodes(aabb_np, reso, flat_idx):
    """World positions of the bake's nodes ``flat_idx`` (i*R + j)*R + k
    of an R^3 lattice spanning the aabb (float32 linspace per axis)."""
    a = np.asarray(aabb_np, np.float32)
    axes = [np.linspace(a[0][k], a[1][k], reso, dtype=np.float32)
            for k in range(3)]
    idx = np.asarray(flat_idx)
    ijk = [idx // (reso * reso), (idx // reso) % reso, idx % reso]
    return np.stack([axes[k][ijk[k]] for k in range(3)], -1)


def block_values(blocks, reso, flat_idx):
    """The node values the packed 4^3 blocks hold for ``flat_idx``: node i
    of an axis lies in block min(i // 3, nb - 1) at offset i - 3 b."""
    nb = (reso + 2) // 3
    idx = np.asarray(flat_idx)
    ijk = [idx // (reso * reso), (idx // reso) % reso, idx % reso]
    b = [np.minimum(x // 3, nb - 1) for x in ijk]
    row = (b[0] * nb + b[1]) * nb + b[2]
    lane = ((ijk[0] - 3 * b[0]) * 4 + (ijk[1] - 3 * b[1])) * 4 \
        + (ijk[2] - 3 * b[2])
    return blocks[torch.as_tensor(row), torch.as_tensor(lane)]
