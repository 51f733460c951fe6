"""TensoSDF field of the port (counterpart of tensoflow_tpu/fields/tenso_sdf.py).

VM-decomposed SDF + appearance field: 3 planes + 3 lines with circle-SDF
init, a 2-layer softplus(beta=100) MLP head producing [sdf, app_feat],
and first/second-order derivatives by a 7-point central FD stencil.

``stencil_impl`` picks the stencil's route, as in the JAX package
(tenso_sdf.py:220-283):

  * 'auto' and 'pallas' (the default): the patch atlas + the fused stencil
    head (ops/stencil.py): the Hopper kernels on CUDA tensors, their plain
    version on CPU tensors;
  * 'xla': the deduplicated split-feature route in plain torch
    (tensor_field.vm_stencil_features_split on the 2x2 atlas, the unfused
    head, only the sdf column at the 6 offset points).  No kernel; taken
    only when the config names it, never chosen by itself.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from .. import device_constant
from ..ops import stencil
from ..ops import tensor_field as tfield
from ..ops.math import contraction, pe_dim, positional_encoding
from ..utils.timing import span
from . import mlp


class SDFConfig(NamedTuple):
    grid_size: Tuple[int, int, int] = (128, 128, 128)
    n_comp: int = 36
    sdf_dim: int = 256
    app_dim: int = 128
    n_levels: int = 1
    sdf_multires: int = 3
    init_radius: float = 0.2
    # 'float32' | 'bfloat16': storage dtype of the gathered atlas rows
    # (params stay f32 for Adam; cast once per step)
    gather_dtype: str = 'float32'
    # 'auto' | 'pallas' (the stencil kernels) | 'xla' (the split route)
    stencil_impl: str = 'auto'


def stencil_route(cfg: SDFConfig) -> str:
    """'kernel' (ops/stencil.py) for 'auto' / 'pallas', 'split' for any
    other value, as the JAX package sends every value but 'pallas' (after
    'auto') to its 'xla' route (tenso_sdf.py:219-223 there)."""
    return 'kernel' if cfg.stencil_impl in ('auto', 'pallas') else 'split'


def units(cfg: SDFConfig, aabb):
    """FD stencil step per axis: aabbSize/gridSize, as the JAX package has
    it (tenso_sdf.py:47-56; the reference uses gridSize-1)."""
    gs = device_constant(('grid_size', cfg.grid_size), lambda: cfg.grid_size,
                         aabb.device)
    return (aabb[1] - aabb[0]) / gs


def _gather_dtype(cfg: SDFConfig):
    return torch.bfloat16 if cfg.gather_dtype == 'bfloat16' else None


def _compute_dtype(cfg: SDFConfig):
    return torch.bfloat16 if cfg.gather_dtype == 'bfloat16' \
        else torch.float32


def init_tenso_sdf(gen: torch.Generator, cfg: SDFConfig,
                   device='cpu') -> Dict[str, Any]:
    """Circle init + geometric MLP init (ref: fields.py:64-91, 101-131)."""
    field = tfield.init_vm_circle(cfg.grid_size, cfg.n_comp, cfg.init_radius,
                                  device)
    feat_ch = cfg.n_comp * 3
    xyz_ch = pe_dim(3, cfg.sdf_multires) if cfg.sdf_multires > 0 else 3
    out_ch = 1 + cfg.app_dim
    std0 = np.sqrt(2.0) / np.sqrt(cfg.sdf_dim)
    w0 = torch.zeros((feat_ch + xyz_ch, cfg.sdf_dim))
    if cfg.sdf_multires > 0:
        w0[feat_ch:feat_ch + 3] = torch.randn(
            (3, cfg.sdf_dim), generator=gen) * std0
    else:
        w0 = torch.randn(w0.shape, generator=gen) * std0
    w1 = (torch.randn((cfg.sdf_dim, out_ch), generator=gen) * 1e-4
          + np.sqrt(np.pi) / np.sqrt(cfg.sdf_dim))
    return {'field': field, 'mlp': [
        {'w': w0.to(device), 'b': torch.zeros(cfg.sdf_dim, device=device)},
        {'w': w1.to(device),
         'b': torch.full((out_ch,), -cfg.init_radius, device=device)}]}


def pack_field(params, cfg: SDFConfig) -> tfield.PackedVMField:
    """2x2 patch atlas for single-point evals; build once per step."""
    return tfield.pack_vm_field(params['field'], cfg.n_levels,
                                _gather_dtype(cfg))


def _dot_f32(a, b, cd):
    """Product of T-rounded operands with f32 accumulation."""
    return a.to(cd).float() @ b.to(cd).float()


def _pe_in(cfg: SDFConfig, xyz, xyz01):
    if cfg.sdf_multires > 0:
        # multires==3 embeds the *contracted* coords (ref: fields.py:294-295)
        src = xyz01 if cfg.sdf_multires == 3 else xyz
        return positional_encoding(src, cfg.sdf_multires)
    return xyz


def _mlp_head(params, cfg: SDFConfig, feats_list, xyz_in):
    """The head's first layer: per-plane feats [[M, C]] * 3 + embedded
    coords [M, E] -> softplus100 hidden [M, hidden] (one product over the
    concatenated inputs, operands in the gather dtype, f32 accumulation)."""
    cd = _compute_dtype(cfg)
    x = torch.cat([f.to(cd) for f in feats_list] + [xyz_in.to(cd)], dim=-1)
    h = _dot_f32(x, params['mlp'][0]['w'], cd) + params['mlp'][0]['b']
    return mlp.softplus100(h)


def _hidden(params, cfg: SDFConfig, packed, xyz, aabb, level):
    xyz01 = contraction(xyz, aabb)
    feats = tfield.vm_features_split(packed, xyz01, level)
    return (_mlp_head(params, cfg, feats, _pe_in(cfg, xyz, xyz01)),
            _compute_dtype(cfg))


def apply_tenso_sdf(params, cfg: SDFConfig, xyz, aabb, level=None,
                    packed=None):
    """Field forward: [N,3] world coords -> [N, 1+app_dim]."""
    if packed is None:
        packed = pack_field(params, cfg)
    h, cd = _hidden(params, cfg, packed, xyz, aabb, level)
    return _dot_f32(h, params['mlp'][1]['w'], cd) + params['mlp'][1]['b']


def sdf_only(params, cfg: SDFConfig, xyz, aabb, level=None, packed=None):
    """[N,3] -> [N,1]: only the sdf column of the output head."""
    if packed is None:
        packed = pack_field(params, cfg)
    h, cd = _hidden(params, cfg, packed, xyz, aabb, level)
    return (_dot_f32(h, params['mlp'][1]['w'][:, :1], cd)
            + params['mlp'][1]['b'][:1])


def _stencil_delta01(cfg: SDFConfig):
    """Per-axis stencil offset in contracted units: 1/grid_size."""
    return [1.0 / g for g in cfg.grid_size]


def _stencil_offsets(d01):
    """[7, 3] stencil offsets in contracted units: centre, then +-axis."""
    offs = np.zeros((7, 3), np.float32)
    for a in range(3):
        offs[1 + 2 * a, a] = d01[a]
        offs[2 + 2 * a, a] = -d01[a]
    return offs


def _pe_rot_table(offs, n_freqs: int):
    """[S, 4, E] table expressing PE(x + off) from PE(x):
    pe_s = pe*A0 + roll(pe,-3)*A1 + roll(pe,+3)*A2 + A3 (trig addition over
    the layout [x, sin(2^i x), cos(2^i x), ...])."""
    s_pts = offs.shape[0]
    dev = offs.device
    f = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=dev)
    ang = offs[:, None, :] * f[None, :, None]                # [S, F, 3]
    c, s = torch.cos(ang), torch.sin(ang)
    ones3 = torch.ones((s_pts, 3), device=dev)
    zeros3 = torch.zeros((s_pts, 3), device=dev)
    a0, a1, a2, a3 = [ones3], [zeros3], [zeros3], [offs]
    for i in range(n_freqs):
        a0 += [c[:, i], c[:, i]]
        a1 += [s[:, i], zeros3]
        a2 += [zeros3, -s[:, i]]
        a3 += [zeros3, zeros3]
    return torch.stack([torch.cat(x, -1) for x in (a0, a1, a2, a3)], dim=1)


def sdf_with_grad_hessian(params, cfg: SDFConfig, xyz, aabb, level=None,
                          with_hessian: bool = True, packed=None):
    """SDF + app features + FD gradient (+ normal-projected hessian) by one
    7-point stencil, on the route ``cfg.stencil_impl`` names (module
    docstring); ``packed`` (pack_field) serves the 'xla' route.
    Returns (sdf [N], app [N, app_dim], grad [N, 3], hessian [N] or None).
    """
    n = xyz.shape[0]
    eps = units(cfg, aabb)
    d01 = _stencil_delta01(cfg)
    xyz01 = contraction(xyz, aabb)
    offs01 = device_constant(('stencil_offsets', tuple(d01)),
                             lambda: _stencil_offsets(d01), xyz.device)
    w1, b1 = params['mlp'][1]['w'], params['mlp'][1]['b']
    if stencil_route(cfg) == 'split':
        sdf, app, s = _stencil_split(params, cfg, xyz, xyz01, aabb, level,
                                     packed, offs01, d01)
    else:
        sdf, app, s = _stencil_kernel(params, cfg, xyz, xyz01, aabb, level,
                                      offs01, d01)
    grad = ((s[:, 0] - s[:, 1]) / (2.0 * eps[:, None])).t()
    if not with_hessian:
        return sdf, app, grad, None
    hess = ((s[:, 0] + s[:, 1] - 2.0 * sdf[None, :])
            / (eps[:, None] ** 2)).t()
    normal_hessian = torch.sum(grad * hess, -1) / (
        torch.sum(grad ** 2, -1) + 1e-5)
    return sdf, app, grad, normal_hessian


def _stencil_split(params, cfg: SDFConfig, xyz, xyz01, aabb, level, packed,
                   offs01, d01):
    """The 'xla' route (JAX tenso_sdf.py:258-282): deduplicated stencil
    taps of the 2x2 atlas, the unfused head over [7N] rows, the full
    output layer at the centre and only its sdf column at the 6 offset
    points.  Returns (sdf [N], app [N, app_dim], s [3, 2, N])."""
    n = xyz.shape[0]
    with span('tf.gather'):
        if packed is None:
            packed = pack_field(params, cfg)
        feats = tfield.vm_stencil_features_split(packed, xyz01, d01, level)
    cd = _compute_dtype(cfg)
    w1, b1 = params['mlp'][1]['w'], params['mlp'][1]['b']
    # embedded coords of the 7 stencil points, stencil-major [7, N, E]
    if cfg.sdf_multires > 0:
        if cfg.sdf_multires == 3:
            pe_in = xyz01[None] + offs01[:, None, :]
        else:
            pe_in = xyz[None] + (offs01 * (aabb[1] - aabb[0])[None, :])[
                :, None, :]
        xyz_in = positional_encoding(pe_in, cfg.sdf_multires)
    else:
        xyz_in = xyz[None] + (offs01 * (aabb[1] - aabb[0])[None, :])[
            :, None, :]
    h = _mlp_head(params, cfg, [f.reshape(7 * n, f.shape[-1])
                                for f in feats], xyz_in.reshape(7 * n, -1))
    h = h.reshape(7, n, -1)
    out_c = _dot_f32(h[0], w1, cd) + b1
    s_off = _dot_f32(h[1:].reshape(6 * n, -1), w1[:, :1], cd)[:, 0] + b1[0]
    return out_c[:, 0], out_c[:, 1:], s_off.reshape(3, 2, n)


def _stencil_kernel(params, cfg: SDFConfig, xyz, xyz01, aabb, level,
                    offs01, d01):
    """The kernel route: the patch atlas and the fused stencil head
    (ops/stencil.py).  Returns (sdf [N], app [N, app_dim], s [3, 2, N])."""
    n = xyz.shape[0]
    w1, b1 = params['mlp'][1]['w'], params['mlp'][1]['b']
    with span('tf.gather'):
        atlas = tfield.pack_vm_patches(params['field'], cfg.n_levels,
                                       _gather_dtype(cfg))
        pp, lp, fr, sigmas = tfield.vm_patch_gather(atlas, xyz01, d01,
                                                    level)
    if cfg.sdf_multires > 0:
        if cfg.sdf_multires == 3:
            pe_c = positional_encoding(xyz01, cfg.sdf_multires)
            offs = offs01
        else:
            pe_c = positional_encoding(xyz, cfg.sdf_multires)
            offs = offs01 * (aabb[1] - aabb[0])[None, :]
        rot = _pe_rot_table(offs, cfg.sdf_multires)
    else:
        pe_c = xyz
        rot = _pe_rot_table(offs01 * (aabb[1] - aabb[0])[None, :], 0)
    C = cfg.n_comp
    w0 = params['mlp'][0]['w']
    w0_parts = (w0[:C], w0[C:2 * C], w0[2 * C:3 * C], w0[3 * C:])
    out_c, s_off6 = stencil.stencil_head(
        [p for row in pp for p in row], [l for row in lp for l in row],
        fr, sigmas, pe_c, rot, w0_parts, params['mlp'][0]['b'], w1, b1)
    return out_c[:, 0], out_c[:, 1:], s_off6.reshape(3, 2, n)


def gradient_only(params, cfg: SDFConfig, xyz, aabb, level=None,
                  packed=None):
    """FD gradient without hessian (ref: fields.py:227-248)."""
    return sdf_with_grad_hessian(params, cfg, xyz, aabb, level,
                                 with_hessian=False, packed=packed)[2]


def upsample_tenso_sdf(params, cfg: SDFConfig, res_target
                       ) -> Tuple[Dict[str, Any], SDFConfig]:
    """Coarse-to-fine upsample (ref: fields.py:168-178): the resolution is
    rounded down to a multiple of 2^(n_levels_new - 1), n_levels goes up by
    one, the MLP is carried over unchanged.  No gradient flows through."""
    new_levels = cfg.n_levels + 1
    q = 2 ** (new_levels - 1)
    res = [(int(r) // q) * q for r in res_target]
    with torch.no_grad():
        new_field = tfield.upsample_vm(params['field'], res)
    return ({'field': new_field, 'mlp': params['mlp']},
            cfg._replace(grid_size=tuple(res), n_levels=new_levels))
