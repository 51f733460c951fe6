"""TensoFlow: the conditional normalizing flow for neural importance
sampling (counterpart of tensoflow_tpu/fields/flow.py).

A 2-D flow on the unit square (normalized half-vector angles) built from
two alternating-mask coupling blocks whose element-wise transform is a
piecewise-quadratic ('pwquad') or piecewise-linear ('pwlinear') spline or
an affine map ('realnvp', with a Gaussian prior and a sigmoid output
cell); conditioning = tensorial VM feature of the surface point, embedded
reflection angles and a (zeroed) roughness embedding.  Frozen sampling
copies are second parameter trees handled by the caller.

Sign convention: ``flow_sample`` returns -log q, ``flow_log_density``
+log q.

The prior's draws are an argument (``noise``: the azimuth roll, uniforms
[pn, sn, 1], for the lattice prior; standard normals [pn, sn, 2] for
realnvp's Gaussian) or come from the given torch.Generator.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import device_constant
from ..ops import tensor_field as tfield
from ..ops.math import contraction, pe_dim, positional_encoding
from ..ops.samplers import sphere_prior_angles_01
from . import mlp

EPS_BIN = 1e-6


class FlowConfig(NamedTuple):
    d: int = 2
    grid_size: Tuple[int, int, int] = (512, 512, 512)
    nis_n_comp: int = 12
    nis_dim: int = 64
    nis_feature_dim: int = 16
    nis_multires: int = 3
    refl_multires: int = 3
    roughness_multires: int = 3
    angle_multires: int = 3
    flow_type: str = 'pwquad'
    n_bins: int = 10
    n_levels: int = 3
    d_hidden: int = 64
    n_hidden: int = 3
    disable_tensorial: bool = False
    disable_reflected: bool = False

    @property
    def refl_ch(self) -> int:
        return pe_dim(2, self.refl_multires) if self.refl_multires > 0 else 2

    @property
    def rough_ch(self) -> int:
        return (pe_dim(1, self.roughness_multires)
                if self.roughness_multires > 0 else 1)

    @property
    def feature_dim(self) -> int:
        return self.nis_feature_dim + self.refl_ch + self.rough_ch

    @property
    def param_len(self) -> int:
        """Per-dim spline parameter count (ref: flow.py:644-648 bin_fn)."""
        if self.flow_type == 'pwquad':
            return 2 * self.n_bins + 1
        if self.flow_type == 'pwlinear':
            return self.n_bins
        if self.flow_type == 'realnvp':
            return 2
        raise ValueError(f'unknown flow_type {self.flow_type!r}')


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------

def sphere_prior_sample(pn: int, sn: int, roll=None, device='cpu'):
    """Fibonacci cos-weighted lattice prior (ref: flow.py:52-90).

    roll: [pn, sn, 1] uniforms (the train-time azimuth roll) or None.
    Returns (x [pn,sn,2] in (0,1)^2, logj [pn,sn,1] = -log_prob)."""
    lattice = device_constant(('sphere_prior_angles_01', sn),
                              lambda: sphere_prior_angles_01(sn), device)
    x = lattice[None].expand(pn, sn, 2)
    if roll is not None:
        x = torch.cat([torch.remainder(x[..., :1] + roll, 1.0), x[..., 1:]],
                      dim=-1)
    x = torch.clamp(x, 1e-6, 1 - 1e-6)
    return x, -sphere_prior_log_prob(x)


def sphere_prior_log_prob(x):
    """pdf(theta01) = cos(theta01 * pi/2) (ref: flow.py:78-80)."""
    return torch.log(torch.cos(x[..., 1:] * (0.5 * math.pi)))


def ggx_prior_sample(pn: int, sn: int, a: float = 0.04, gen=None,
                     noise=None, device='cpu'):
    """(ref: flow.py:92-120); a = 0.2^2.  ``noise`` [pn, sn, 2] uniforms,
    else drawn from ``gen``."""
    u = noise if noise is not None else torch.rand(
        (pn, sn, 2), generator=gen, device=device)
    e_phi, e_theta = u[..., :1], u[..., 1:]
    a2 = a * a
    cos_t = torch.sqrt(torch.clamp(
        (1 - e_theta) / torch.clamp(1 + (a2 - 1) * e_theta, min=1e-6),
        min=1e-6))
    x = torch.clamp(torch.cat([e_phi, cos_t ** 2], -1), 1e-6, 1 - 1e-6)
    return x, -ggx_prior_log_prob(x, a)


def ggx_prior_log_prob(x, a: float = 0.04):
    a2 = a * a
    cos2 = x[..., 1:]
    pdf = a2 / (cos2 * (a2 - 1) + 1) ** 2
    return torch.log(torch.clamp(pdf, min=1e-6))


def uniform_prior_sample(pn: int, sn: int, d: int = 2, gen=None,
                         noise=None, device='cpu'):
    x = noise if noise is not None else torch.rand(
        (pn, sn, d), generator=gen, device=device)
    return x, torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype,
                          device=x.device)


# ---------------------------------------------------------------------------
# element-wise transforms
# ---------------------------------------------------------------------------

def _modified_softmax(v_tilde, w):
    """Vertex values normalized so the spline integrates to 1
    (ref: flow.py:166-168)."""
    v = torch.exp(v_tilde)
    norm = torch.sum((v[..., :-1] + v[..., 1:]) / 2 * w, -1, keepdim=True)
    return v / norm


def _pwquad_prepare(wv_tilde):
    """Split + normalize spline params. wv_tilde [N,k,2b+1] ->
    (w [N,k,b], wsum_shift [N,k,b+1], v [N,k,b+1], vw [N,k,b+1])."""
    nb1 = (wv_tilde.shape[-1] + 1) // 2
    # clip raw spline params: keeps exp() finite in fp32 and bins
    # invertible under adversarial weights
    wv_tilde = torch.clamp(wv_tilde, -10.0, 10.0)
    v_tilde = wv_tilde[..., :nb1]
    w_tilde = wv_tilde[..., nb1:]
    w = torch.clamp(torch.exp(w_tilde), min=1e-6)
    wsum = torch.cumsum(w, -1)
    wnorm = wsum[..., -1:]
    w = torch.clamp(w / wnorm, min=1e-6)
    wsum = wsum / wnorm
    wsum_shift = torch.cat([torch.zeros_like(wsum[..., :1]), wsum], -1)
    v = torch.clamp(_modified_softmax(v_tilde, w), min=1e-6)
    vw = torch.cat(
        [torch.zeros_like(v[..., :1]),
         torch.cumsum((v[..., :-1] + v[..., 1:]) / 2 * w, -1)], -1)
    return w, wsum_shift, v, vw


def _searchsorted_batch(sorted_vals, queries, max_bin=None):
    """sorted_vals [..., m] (bin right edges, increasing), queries [...] ->
    bin indices clipped to [0, max_bin] (default m - 1), by counting."""
    m = sorted_vals.shape[-1]
    if max_bin is None:
        max_bin = m - 1
    idx = torch.sum(sorted_vals <= queries[..., None], dim=-1)
    return torch.clamp(idx, 0, max_bin)


def _take_bin(arr, mx):
    """arr [..., B], mx [...] -> arr[..., mx] elementwise."""
    return torch.gather(arr, -1, mx[..., None])[..., 0]


def pwquad_flow_inv(x, wv_tilde):
    """x -> y: evaluate the quadratic spline (ref: flow.py:332-413).
    x [N,k] in (0,1); wv_tilde [N,k,2b+1].  Returns (y [N,k], logj [N,1])."""
    w, wsum_shift, v, vw = _pwquad_prepare(wv_tilde)
    mx = _searchsorted_batch(wsum_shift[..., 1:], x)
    w_m = _take_bin(w, mx)
    alphas = torch.clamp((x - _take_bin(wsum_shift, mx)) / w_m, 0.0, 1.0)
    v0 = _take_bin(v, mx)
    v1 = _take_bin(v, mx + 1)
    out = (alphas ** 2 / 2 * (v1 - v0) * w_m + alphas * v0 * w_m
           + _take_bin(vw, mx))
    out = torch.clamp(out, EPS_BIN, 1.0 - EPS_BIN)
    deriv = v0 + (v1 - v0) * alphas
    logj = torch.sum(torch.log(torch.clamp(deriv, min=1e-12)), -1,
                     keepdim=True)
    return out, logj


def pwquad_flow(y, wv_tilde):
    """y -> x: invert the spline by quadratic solve (ref: flow.py:415-525)."""
    w, wsum_shift, v, vw = _pwquad_prepare(wv_tilde)
    mx = _searchsorted_batch(vw[..., 1:], y)
    w_m = _take_bin(w, mx)
    v0 = _take_bin(v, mx)
    v1 = _take_bin(v, mx + 1)
    a = (v1 - v0) * w_m
    b = v0 * w_m
    c = _take_bin(vw, mx) - y
    eps = torch.finfo(a.dtype).eps
    a = torch.where(a.abs() < eps, torch.full_like(a, eps), a)
    d = torch.clamp(b * b - 2 * a * c, min=0.0)
    sol1 = (-b - torch.sqrt(d)) / a
    sol2 = (-b + torch.sqrt(d)) / a
    sol = torch.where((sol1 >= 0) & (sol1 < 1), sol1, sol2)
    sol = torch.clamp(sol, eps, 1.0 - eps)
    x = torch.clamp(w_m * sol + _take_bin(wsum_shift, mx), eps, 1.0 - eps)
    deriv = v0 + (v1 - v0) * sol
    logj = -torch.sum(torch.log(torch.clamp(deriv, min=1e-12)), -1,
                      keepdim=True)
    return x, logj


def _pwlinear_bins(q_tilde):
    """Slopes q [N,k,b] and left values q_left [N,k,b] of the
    piecewise-linear CDF, bin width w = 1/b."""
    b = q_tilde.shape[-1]
    w = 1.0 / b
    q = torch.clamp(torch.softmax(q_tilde, -1), min=1e-6) / w
    q_left = torch.cat([torch.zeros_like(q[..., :1]),
                        torch.cumsum(q, -1)[..., :-1] * w], -1)
    return q, q_left, b, w


def pwlinear_flow_inv(x, q_tilde):
    """(ref: flow.py:193-249)"""
    q, q_left, b, w = _pwlinear_bins(q_tilde)
    mx = torch.clamp(torch.floor(b * x).to(torch.int64), 0, b - 1)
    slopes = _take_bin(q, mx)
    out = (x - mx * w) * slopes + _take_bin(q_left, mx)
    eps = torch.finfo(out.dtype).eps
    out = torch.clamp(out, eps, 1 - eps)
    logj = torch.sum(torch.log(slopes), -1, keepdim=True)
    return out, logj


def pwlinear_flow(y, q_tilde):
    """(ref: flow.py:251-311)"""
    q, q_left, b, w = _pwlinear_bins(q_tilde)
    mx = _searchsorted_batch(q_left[..., 1:], y, max_bin=b - 1)
    q_m = _take_bin(q, mx)
    x = (y - _take_bin(q_left, mx)) / q_m + mx * w
    eps = torch.finfo(x.dtype).eps
    x = torch.clamp(x, eps, 1 - eps)
    logj = -torch.sum(torch.log(q_m), -1, keepdim=True)
    return x, logj


def affine_flow(x, st):
    """RealNVP affine transform (ref: flow.py:528-547)."""
    es = torch.exp(st[..., 0])
    y = es * x + st[..., 1]
    logj = torch.sum(torch.log(torch.clamp(es, min=1e-6)), -1, keepdim=True)
    return y, logj


def affine_flow_inv(x, st):
    es = torch.exp(-st[..., 0])
    y = es * (x - st[..., 1])
    logj = torch.sum(torch.log(torch.clamp(es, min=1e-6)), -1, keepdim=True)
    return y, logj


_TRANSFORMS = {
    'pwquad': (pwquad_flow, pwquad_flow_inv),
    'pwlinear': (pwlinear_flow, pwlinear_flow_inv),
    'realnvp': (affine_flow, affine_flow_inv),
}
FLOW_TYPES = tuple(_TRANSFORMS)


# ---------------------------------------------------------------------------
# coupling blocks
# ---------------------------------------------------------------------------

def init_block(gen, cfg: FlowConfig, device='cpu') -> Dict[str, Any]:
    """One coupling block (ref: flow.py:549-598)."""
    d_pass = 1                                        # d=2, one passthrough
    d_in = (pe_dim(d_pass, cfg.angle_multires)
            if cfg.angle_multires > 0 else d_pass)
    d_out = (cfg.d - d_pass) * cfg.param_len
    dims = [d_in + cfg.feature_dim] + [cfg.d_hidden] * cfg.n_hidden + [d_out]
    return {'layers': [mlp.init_linear(gen, dims[i], dims[i + 1],
                                       device=device)
                       for i in range(len(dims) - 1)]}


def _block_params(block, y_pass, feature, cfg: FlowConfig):
    """Spline params from the conditioning MLP (Reshift input activation +
    LeakyReLU hidden layers, ref: flow.py:576-598)."""
    if cfg.angle_multires > 0:
        y_emb = positional_encoding(y_pass, cfg.angle_multires)
    else:
        y_emb = y_pass
    h = torch.cat([y_emb, feature], -1)
    if cfg.flow_type != 'realnvp':
        # Reshift input activation: pwquad / pwlinear only; the realnvp
        # registry entry has input_activation=None (ref: flow.py:644-648)
        h = h * 2.0 - 1.0
    n = len(block['layers'])
    for i, layer in enumerate(block['layers']):
        h = mlp.apply_linear(layer, h)
        if i < n - 1:
            h = F.leaky_relu(h, 0.01)
    return h.reshape(h.shape[:-1] + (cfg.d - 1, cfg.param_len))


def block_flow(block, y, logj, feature, cfg: FlowConfig, mask_idx: int,
               inverse: bool):
    """Apply one coupling block in 'flow' (sampling) or 'flow_inv'
    (density) direction (ref: flow.py:600-641).  mask_idx 0 keeps dim 0,
    mask_idx 1 keeps dim 1."""
    keep, move = (0, 1) if mask_idx == 0 else (1, 0)
    y_n = y[..., keep:keep + 1]
    y_m = y[..., move:move + 1]
    st = _block_params(block, y_n, feature, cfg)
    fwd, inv = _TRANSFORMS[cfg.flow_type]
    y_m_new, dlogj = (inv if inverse else fwd)(y_m, st)
    out = torch.cat([y_n, y_m_new] if keep == 0 else [y_m_new, y_n], -1)
    return out, logj + dlogj


# ---------------------------------------------------------------------------
# the conditional flow
# ---------------------------------------------------------------------------

def init_tenso_flow(gen, cfg: FlowConfig, device='cpu') -> Dict[str, Any]:
    """(ref: flow.py:649-707)"""
    field = tfield.init_vm_random(gen, cfg.grid_size, cfg.nis_n_comp,
                                  device=device)
    feat_in = cfg.nis_n_comp * 3
    xyz_ch = pe_dim(3, cfg.nis_multires) if cfg.nis_multires > 0 else 3
    nis_mat = [mlp.init_linear(gen, feat_in + xyz_ch, cfg.nis_dim,
                               device=device),
               mlp.init_linear(gen, cfg.nis_dim, cfg.nis_feature_dim,
                               device=device)]
    return {'field': field, 'nis_mat': nis_mat,
            'blocks': [init_block(gen, cfg, device),
                       init_block(gen, cfg, device)]}


def flow_pack(params, cfg: FlowConfig):
    """Pack the flow's VM conditioning field into its gather atlas, once
    per step and parameter tree, for ``packed=`` below."""
    return tfield.pack_vm_field(params['field'], cfg.n_levels)


def flow_feature(params, cfg: FlowConfig, pts, aabb, refl_angles01,
                 roughness, packed=None):
    """Conditioning feature (ref: flow.py:709-744, 801-816): VM field ->
    MLP(16), PE(reflection angles), zeroed roughness embedding.  Without
    ``packed`` the field is sampled from its raw planes at level 0 (a flow
    conditions on a few thousand points per step); the same numbers as
    the packed atlas's level 0."""
    xyz01 = contraction(pts, aabb)
    if packed is None:
        feats = tfield.vm_features(params['field'], xyz01)
    else:
        feats = tfield.vm_features_packed(packed, xyz01)
    if cfg.nis_multires > 0:
        xyz_in = positional_encoding(pts, cfg.nis_multires)
    else:
        xyz_in = pts
    h = torch.cat([feats, xyz_in], -1)
    h = mlp.apply_linear(params['nis_mat'][0], h)
    h = mlp.softplus100(h)
    feat = mlp.apply_linear(params['nis_mat'][1], h)
    if cfg.disable_tensorial:
        feat = torch.zeros_like(feat)
    if cfg.refl_multires > 0:
        refl = positional_encoding(refl_angles01, cfg.refl_multires)
    else:
        refl = refl_angles01
    if cfg.disable_reflected:
        refl = torch.zeros_like(refl)
    # the roughness embedding is zeroed in the reference (flow.py:814, 847)
    rough = torch.zeros(pts.shape[:-1] + (cfg.rough_ch,), dtype=pts.dtype,
                        device=pts.device)
    return torch.cat([feat, refl, rough], -1)


def _run_blocks(params, cfg: FlowConfig, x, logj, feature, inverse: bool):
    """x [pn,sn,2] or [M,2]; feature [pn,F] broadcast over sn."""
    pre_shape = x.shape[:-1]
    if x.ndim == 3:
        feature = feature[:, None, :].expand(x.shape[0], x.shape[1],
                                             feature.shape[-1])
    x = x.reshape(-1, cfg.d)
    logj = logj.reshape(-1, 1)
    feature = feature.reshape(-1, feature.shape[-1])
    for mi in ((1, 0) if inverse else (0, 1)):
        x, logj = block_flow(params['blocks'][mi], x, logj, feature, cfg,
                             mi, inverse)
    return x.reshape(*pre_shape, cfg.d), logj.reshape(*pre_shape, 1)


def _prior_log_prob(cfg: FlowConfig, z):
    """Prior density per flow variant (ref registry flow.py:644-648:
    pwquad/pwlinear -> SphereSampler, realnvp -> factorized Gaussian)."""
    if cfg.flow_type == 'realnvp':
        return torch.sum(-0.5 * z ** 2 - 0.5 * math.log(2 * math.pi), -1,
                         keepdim=True)
    return sphere_prior_log_prob(z)


def _prior_sample(cfg: FlowConfig, gen, pn: int, sn: int, train: bool,
                  noise, device):
    """realnvp: standard normals [pn, sn, 2] (``noise`` or drawn, also
    when not training, as the reference does); the lattice prior: its
    azimuth roll while training."""
    if cfg.flow_type == 'realnvp':
        z = noise if noise is not None else torch.randn(
            (pn, sn, cfg.d), generator=gen, device=device)
        return z, -_prior_log_prob(cfg, z)
    roll = None
    if train:
        roll = noise if noise is not None else torch.rand(
            (pn, sn, 1), generator=gen, device=device)
    return sphere_prior_sample(pn, sn, roll, device)


def flow_log_density(params, cfg: FlowConfig, pts, aabb, refl_angles01,
                     roughness, x, rays_id=None, packed=None):
    """Density evaluation: x -> (z, log q(x)) (ref: flow.py:801-831).
    pts [pn,3]; x [pn,sn,2] or [M,2] with rays_id [M] into pn."""
    x = torch.clamp(x, 1e-6, 1 - 1e-6)
    feature = flow_feature(params, cfg, pts, aabb, refl_angles01, roughness,
                           packed=packed)
    if rays_id is not None:
        feature = torch.index_select(
            feature, 0, torch.clamp(rays_id, 0, feature.shape[0] - 1))
    logj = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    if cfg.flow_type == 'realnvp':
        # output sigmoid cell (ref: flow.py:126-144): invert it first
        z0 = torch.clamp(x, 1e-6, 1 - 1e-6)
        logj = logj - torch.sum(
            torch.log(torch.clamp(z0 * (1 - z0), min=1e-6)), -1,
            keepdim=True)
        x = torch.log(z0 / (1 - z0))
    z, logj = _run_blocks(params, cfg, x, logj, feature, inverse=True)
    return z, logj + _prior_log_prob(cfg, z)


def flow_sample(params, cfg: FlowConfig, gen, pts, aabb, refl_angles01,
                roughness, n_samples: int, train: bool = True, noise=None,
                packed=None):
    """Sampling: prior -> x with -log q (ref: flow.py:833-855).

    The prior's draws are ``noise`` when given (see the module
    docstring), else drawn from ``gen``.
    Returns (x [pn,sn,2], -log q [pn,sn,1])."""
    pn = pts.shape[0]
    x, logj = _prior_sample(cfg, gen, pn, n_samples, train, noise,
                            pts.device)
    feature = flow_feature(params, cfg, pts, aabb, refl_angles01, roughness,
                           packed=packed)
    x, logj = _run_blocks(params, cfg, x, logj, feature, inverse=False)
    if cfg.flow_type == 'realnvp':
        y = torch.clamp(torch.sigmoid(x), 1e-6, 1 - 1e-6)
        logj = logj + torch.sum(
            torch.log(torch.clamp(y * (1 - y), min=1e-6)), -1, keepdim=True)
        x = y
    return x, logj
