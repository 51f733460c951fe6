"""VM-decomposed tensor fields (counterpart of tensoflow_tpu/ops/tensor_field.py).

A field is 3 planes ``[H, W, C]`` + 3 lines ``[L, C]`` (matMode
[[0,1],[0,2],[1,2]], vecMode [2,1,0]).  The port keeps the JAX package's
layouts and atlas formats so its tests compare like with like:

  * the raw planes (``vm_features``, with mip pyramids when n_levels > 1)
    for the stage-2 material and flow fields;
  * ``pack_vm_field``  — 2x2 patch rows for the single-point field eval
    (occupancy update, sdf_only, ``vm_features_packed``) and the
    deduplicated 7-point stencil lookups of the split route
    (``vm_stencil_features_split``, fields/tenso_sdf.py 'xla');
  * ``pack_vm_patches`` — the patch atlas feeding the stencil head
    (ops/stencil.py): 4x4 (p16) rows, one gathered row per texture per mip
    branch, or, from a 256x256 top plane up, 1x4 (p4) rows, four gathered
    rows per plane per mip branch reassembled into the same 4x4 block.

Coordinates are detached (FD stencil, ref fields.py:268-270); the field
gradient flows through the row gathers, whose backward is index_add_.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import device_constant

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
FRAC_STRIDE = 32        # fr lanes per mip branch (see vm_patch_gather)
SMALL_TABLE_ROWS = 4096
# top-plane size (texels) from which the whole patch atlas takes p4 rows
# (tensor_field.py:601-605 of the JAX package)
PACK_P4_MIN_TEXELS = 256 * 256

FieldParams = Dict[str, Any]   # {'planes': [3 x (H,W,C)], 'lines': [3 x (L,C)]}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def circle_init_plane(grid_hw: Sequence[int], radius: float) -> np.ndarray:
    """2D circle SDF used to initialise the SDF planes -> [H, W, 1]."""
    x = np.linspace(-1, 1, grid_hw[0])
    y = np.linspace(-1, 1, grid_hw[1])
    xx, yy = np.meshgrid(x, y, indexing='ij')
    return (np.sqrt(xx ** 2 + yy ** 2) - radius)[..., None].astype(np.float32)


def init_vm_circle(grid_size: Sequence[int], n_comp: int,
                   radius: float = 0.2, device='cpu') -> FieldParams:
    """Circle-SDF init of a VM field (ref: fields.py:101-111)."""
    planes, lines = [], []
    for i in range(3):
        hw = [grid_size[MAT_MODE[i][0]], grid_size[MAT_MODE[i][1]]]
        ln = grid_size[VEC_MODE[i]]
        plane = np.broadcast_to(circle_init_plane(hw, radius),
                                (hw[0], hw[1], n_comp)).copy()
        line = np.full((ln, n_comp), 1.0 / (n_comp * 3), np.float32)
        planes.append(torch.tensor(plane, device=device))
        lines.append(torch.tensor(line, device=device))
    return {'planes': planes, 'lines': lines}


def init_vm_random(gen: torch.Generator, grid_size: Sequence[int],
                   n_comp: int, scale: float = 1e-4,
                   device='cpu') -> FieldParams:
    """Small-random init used by the material and flow fields
    (ref: fields.py:765-774)."""
    planes, lines = [], []
    for i in range(3):
        hw = (grid_size[MAT_MODE[i][0]], grid_size[MAT_MODE[i][1]])
        ln = grid_size[VEC_MODE[i]]
        u = torch.rand(hw + (n_comp,), generator=gen, dtype=torch.float32)
        planes.append((scale * (2.0 * u - 1.0)).to(device))
        lines.append(torch.full((ln, n_comp), 1.0 / (n_comp * 3),
                                device=device))
    return {'planes': planes, 'lines': lines}


# ---------------------------------------------------------------------------
# mip pyramids
# ---------------------------------------------------------------------------

def _avg_pool_2x2(tex):
    h, w, c = tex.shape
    return tex.reshape(h // 2, 2, w // 2, 2, c).mean(dim=(1, 3))


def _avg_pool_2x1d(tex):
    l, c = tex.shape
    return tex.reshape(l // 2, 2, c).mean(dim=1)


def build_pyramid_2d(tex, n_levels: int) -> List[torch.Tensor]:
    pyr = [tex]
    for _ in range(n_levels - 1):
        pyr.append(_avg_pool_2x2(pyr[-1]))
    return pyr


def build_pyramid_1d(tex, n_levels: int) -> List[torch.Tensor]:
    pyr = [tex]
    for _ in range(n_levels - 1):
        pyr.append(_avg_pool_2x1d(pyr[-1]))
    return pyr


def _edge_pad_2d(tex, p: int):
    """[H,W,C] edge-replicated by p texels on both spatial axes."""
    x = tex.permute(2, 0, 1)[None]
    return F.pad(x, (p, p, p, p), mode='replicate')[0].permute(1, 2, 0)


def _edge_pad_1d(tex, p: int):
    """[L,C] edge-replicated by p texels."""
    return F.pad(tex.t()[None], (p, p), mode='replicate')[0].t()


def _take(buf, idx):
    """Row gather with clamped indices (jnp.take mode='clip')."""
    idx = torch.clamp(idx, 0, buf.shape[0] - 1)
    return torch.index_select(buf, 0, idx.reshape(-1)).reshape(
        idx.shape + buf.shape[1:])


# ---------------------------------------------------------------------------
# raw-plane sampling (the stage-2 material and flow fields: a few thousand
# points per step at level 0, so no atlas is built)
# ---------------------------------------------------------------------------

def sample_bilinear_2d(tex, uv):
    """Clamped bilinear lookup.  tex [H,W,C]; uv [N,2] in [0,1] (u indexes
    H); texel centers at (i + 0.5)/size."""
    h, w, _ = tex.shape
    u = uv[:, 0] * h - 0.5
    v = uv[:, 1] * w - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    u0i = torch.clamp(u0.long(), 0, h - 1)
    u1i = torch.clamp(u0.long() + 1, 0, h - 1)
    v0i = torch.clamp(v0.long(), 0, w - 1)
    v1i = torch.clamp(v0.long() + 1, 0, w - 1)
    flat = tex.reshape(h * w, -1)
    t00 = _take(flat, u0i * w + v0i)
    t01 = _take(flat, u0i * w + v1i)
    t10 = _take(flat, u1i * w + v0i)
    t11 = _take(flat, u1i * w + v1i)
    out = ((1 - fu) * ((1 - fv) * t00 + fv * t01)
           + fu * ((1 - fv) * t10 + fv * t11))
    return out.float()


def sample_linear_1d(tex, u):
    """Clamped linear lookup.  tex [L,C]; u [N] in [0,1]."""
    l, _ = tex.shape
    x = u * l - 0.5
    x0 = torch.floor(x)
    f = (x - x0)[:, None]
    x0i = torch.clamp(x0.long(), 0, l - 1)
    x1i = torch.clamp(x0.long() + 1, 0, l - 1)
    return ((1 - f) * _take(tex, x0i) + f * _take(tex, x1i)).float()


def _mip_weights(level, n_levels: int):
    """Per-level trilinear blending weights for a fractional mip level:
    level [N] (clamped to [0, n_levels-1]) -> [n_levels, N]."""
    lv = torch.clamp(level, 0.0, n_levels - 1)
    ls = torch.arange(n_levels, dtype=lv.dtype, device=lv.device)[:, None]
    return torch.clamp(1.0 - torch.abs(lv[None, :] - ls), min=0.0)


def sample_mip_2d(pyramid: Sequence[torch.Tensor], uv, level):
    """dr.texture(..., mip_level_bias=level, boundary='clamp'): pyramid of
    [H/2^l, W/2^l, C]; uv [N,2]; level [N] -> [N, C]."""
    ws = _mip_weights(level, len(pyramid))
    out = 0.0
    for l, tex in enumerate(pyramid):
        out = out + ws[l][:, None] * sample_bilinear_2d(tex, uv)
    return out


def sample_mip_1d(pyramid: Sequence[torch.Tensor], u, level):
    ws = _mip_weights(level, len(pyramid))
    out = 0.0
    for l, tex in enumerate(pyramid):
        out = out + ws[l][:, None] * sample_linear_1d(tex, u)
    return out


def vm_features(field: FieldParams, xyz01, level=None, n_levels: int = 1,
                gather_dtype=None):
    """Features of a VM field at contracted coords [N,3] in [0,1] ->
    [N, 3*C] (plane_i * line_i concatenated over i), sampled from the raw
    planes; with n_levels > 1 from their mip pyramids at the fractional
    ``level`` [N] (None: level 0).  ``gather_dtype`` casts the texture
    once; weights and outputs stay float32.  Coordinates and level are
    detached."""
    xyz01 = torch.clamp(xyz01.detach(), 0.0, 1.0)
    n = xyz01.shape[0]
    if level is None:
        level = torch.zeros((n,), dtype=xyz01.dtype, device=xyz01.device)
    else:
        level = level.detach().reshape(n)
    if gather_dtype is not None:
        field = {'planes': [p.to(gather_dtype) for p in field['planes']],
                 'lines': [l.to(gather_dtype) for l in field['lines']]}
    cols = [xyz01[:, 0], xyz01[:, 1], xyz01[:, 2]]
    feats = []
    for i in range(3):
        uv = torch.stack([cols[MAT_MODE[i][0]], cols[MAT_MODE[i][1]]], dim=1)
        w = cols[VEC_MODE[i]]
        if n_levels > 1:
            pf = sample_mip_2d(build_pyramid_2d(field['planes'][i], n_levels),
                               uv, level)
            lf = sample_mip_1d(build_pyramid_1d(field['lines'][i], n_levels),
                               w, level)
        else:
            pf = sample_bilinear_2d(field['planes'][i], uv)
            lf = sample_linear_1d(field['lines'][i], w)
        feats.append(pf * lf)
    return torch.cat(feats, dim=-1)


# ---------------------------------------------------------------------------
# 2x2 patch atlas (single-point field evaluation)
# ---------------------------------------------------------------------------

def patch_pack_2d(tex):
    """[H,W,C] -> [(H+1)*(W+1), 4C] rows of 2x2 edge-clamped texel blocks."""
    h, w, c = tex.shape
    pad = _edge_pad_2d(tex, 1)
    slots = [pad[d0:d0 + h + 1, d1:d1 + w + 1]
             for d0 in (0, 1) for d1 in (0, 1)]
    return torch.cat(slots, -1).reshape((h + 1) * (w + 1), 4 * c)


def sample_bilinear_packed(buf, h, w, t0, t1, base=0):
    """One-gather clamped bilinear on a patch_pack_2d buffer at continuous
    texel coords t0/t1; h/w/base: ints or [N] int64 tensors."""
    f0 = torch.floor(t0)
    f1 = torch.floor(t1)
    w0 = (t0 - f0)[:, None]
    w1 = (t1 - f1)[:, None]
    a0 = _clip_idx(f0.long() + 1, h)
    a1 = _clip_idx(f1.long() + 1, w)
    rows = _take(buf, base + a0 * (w + 1) + a1)
    c = rows.shape[-1] // 4
    return (((1 - w0) * (1 - w1)) * rows[:, :c] + ((1 - w0) * w1)
            * rows[:, c:2 * c] + (w0 * (1 - w1)) * rows[:, 2 * c:3 * c]
            + (w0 * w1) * rows[:, 3 * c:]).float()


def _clip_idx(a, hi):
    """clip(a, 0, hi) for an int or per-row tensor upper bound."""
    if isinstance(hi, int):
        return torch.clamp(a, 0, hi)
    return torch.minimum(torch.clamp(a, min=0), hi)


class PackedMeta(NamedTuple):
    plane_offsets: Tuple[Tuple[int, ...], ...]
    plane_shapes: Tuple[Tuple[Tuple[int, int], ...], ...]
    line_offsets: Tuple[Tuple[int, ...], ...]
    line_lens: Tuple[Tuple[int, ...], ...]
    n_levels: int
    n_comp: int


class PackedVMField(NamedTuple):
    """A VM field flattened into one gather atlas [T, 4C]."""
    buffer: torch.Tensor
    meta: PackedMeta


def pack_vm_field(field: FieldParams, n_levels: int = 1,
                  gather_dtype=None) -> PackedVMField:
    """All planes, lines and mip levels as 2x2 patch rows in one buffer
    (lines: [2C texels + 2C zero pad]).  Differentiable."""
    parts = []
    offset = 0
    p_offs, p_shapes, l_offs, l_lens = [], [], [], []
    for i in range(3):
        offs, shps = [], []
        for tex in build_pyramid_2d(field['planes'][i], n_levels):
            h, w, _ = tex.shape
            parts.append(patch_pack_2d(tex))
            offs.append(offset)
            shps.append((h, w))
            offset += (h + 1) * (w + 1)
        p_offs.append(tuple(offs))
        p_shapes.append(tuple(shps))
    for i in range(3):
        offs, lens = [], []
        for tex in build_pyramid_1d(field['lines'][i], n_levels):
            l, c = tex.shape
            pad = _edge_pad_1d(tex, 1)
            row = torch.cat([pad[0:l + 1], pad[1:l + 2]], -1)
            parts.append(F.pad(row, (0, 2 * c)))
            offs.append(offset)
            lens.append(l)
            offset += l + 1
        l_offs.append(tuple(offs))
        l_lens.append(tuple(lens))
    buf = torch.cat(parts, dim=0)
    if gather_dtype is not None:
        buf = buf.to(gather_dtype)
    meta = PackedMeta(tuple(p_offs), tuple(p_shapes), tuple(l_offs),
                      tuple(l_lens), n_levels,
                      int(field['planes'][0].shape[-1]))
    return PackedVMField(buf, meta)


def _level_branches(n_levels: int, level, n):
    """Adjacent-mip branches [(l0 int or [N] int64, weight [N] or None)]."""
    if n_levels == 1 or level is None:
        return [(0, None)]
    lv = torch.clamp(level.reshape(n), 0.0, n_levels - 1.0)
    l0 = torch.clamp(torch.floor(lv).long(), 0, n_levels - 2)
    f = lv - l0.to(lv.dtype)
    return [(l0, 1.0 - f), (l0 + 1, f)]


def _table(vals, like_idx):
    """Per-level ints as an int64 tensor on like_idx's device (cached: a
    host-to-device copy would make the step wait for the device)."""
    vals = tuple(vals)
    return device_constant(('level_table', vals), lambda: vals,
                           like_idx.device, torch.int64)


def _plane_params(meta, i: int, l0):
    """(base, h, w, hf, wf) for plane i at mip l0 (int or [N] tensor)."""
    if isinstance(l0, int):
        h, w = meta.plane_shapes[i][l0]
        return meta.plane_offsets[i][l0], h, w, float(h), float(w)
    h = _table([s[0] for s in meta.plane_shapes[i]], l0)[l0]
    w = _table([s[1] for s in meta.plane_shapes[i]], l0)[l0]
    base = _table(meta.plane_offsets[i], l0)[l0]
    return base, h, w, h.float(), w.float()


def _line_params(meta, i: int, l0):
    if isinstance(l0, int):
        ln = meta.line_lens[i][l0]
        return meta.line_offsets[i][l0], ln, float(ln)
    ln = _table(meta.line_lens[i], l0)[l0]
    base = _table(meta.line_offsets[i], l0)[l0]
    return base, ln, ln.float()


def vm_features_split(packed: PackedVMField, xyz01, level=None):
    """Per-plane features [3 x [N, C]] (plane_i * line_i) on the 2x2 atlas."""
    meta = packed.meta
    xyz01 = torch.clamp(xyz01.detach(), 0.0, 1.0)
    n = xyz01.shape[0]
    if level is not None:
        level = level.detach()
    cols = [xyz01[:, 0], xyz01[:, 1], xyz01[:, 2]]
    P = [None, None, None]
    L = [None, None, None]
    for l0, mw in _level_branches(meta.n_levels, level, n):
        mwc = None if mw is None else mw[:, None]
        idxs, pw, lw = [], [], []
        for i in range(3):
            base, h, w, hf, wf = _plane_params(meta, i, l0)
            t0 = cols[MAT_MODE[i][0]] * hf - 0.5
            t1 = cols[MAT_MODE[i][1]] * wf - 0.5
            f0 = torch.floor(t0)
            f1 = torch.floor(t1)
            a0 = _clip_idx(f0.long() + 1, h)
            a1 = _clip_idx(f1.long() + 1, w)
            idxs.append(base + a0 * (w + 1) + a1)
            pw.append(((t0 - f0)[:, None], (t1 - f1)[:, None]))
        for i in range(3):
            base, ln, lf = _line_params(meta, i, l0)
            xt = cols[VEC_MODE[i]] * lf - 0.5
            x0 = torch.floor(xt)
            idxs.append(base + _clip_idx(x0.long() + 1, ln))
            lw.append((xt - x0)[:, None])
        rows = _take(packed.buffer, torch.cat(idxs))
        c = rows.shape[-1] // 4
        for i in range(3):
            r = rows[i * n:(i + 1) * n]
            w0, w1 = pw[i]
            p = (((1 - w0) * (1 - w1)) * r[:, :c]
                 + ((1 - w0) * w1) * r[:, c:2 * c]
                 + (w0 * (1 - w1)) * r[:, 2 * c:3 * c]
                 + (w0 * w1) * r[:, 3 * c:]).float()
            r = rows[(3 + i) * n:(4 + i) * n]
            f = lw[i]
            ll = ((1 - f) * r[:, :c] + f * r[:, c:2 * c]).float()
            if mwc is not None:
                p = p * mwc
                ll = ll * mwc
            P[i] = p if P[i] is None else P[i] + p
            L[i] = ll if L[i] is None else L[i] + ll
    return [P[i] * L[i] for i in range(3)]


def vm_features_packed(packed: PackedVMField, xyz01, level=None):
    """vm_features on the 2x2 atlas: [N,3] -> [N, 3C] (concat form)."""
    return torch.cat(vm_features_split(packed, xyz01, level), -1)


def _linear_take(buffer, base, l, xt):
    """Clamped linear lookup on the 2x2 atlas: one row -> [N, C] f32."""
    x0 = torch.floor(xt)
    f = (xt - x0)[:, None]
    rows = _take(buffer, base + _clip_idx(x0.long() + 1, l))
    c = rows.shape[-1] // 4
    return ((1 - f) * rows[:, :c] + f * rows[:, c:2 * c]).float()


# stencil point -> (plane variant, line variant).  Plane lookup variants:
# [center, u+, u-, v+, v-]; line variants: [center, x+, x-].  Stencil
# order [center, +x, -x, +y, -y, +z, -z] matches fields/tenso_sdf.
_PLANE_SHIFTS = ((0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0),
                 (0.0, -1.0))
_LINE_SHIFTS = (0.0, 1.0, -1.0)
_STENCIL = ((None, 0), (0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))


def vm_stencil_variants(packed: PackedVMField, xyz01, delta01, level=None):
    """Deduplicated texture lookups of the 7-point FD stencil.

    xyz01 [N,3] contracted coords; delta01 [3] per-axis offsets in
    contracted units.  Per plane only 5 distinct bilinear lookups exist
    (center, +-u, +-v) and per line 3 (center, +-x).  Returns (P, L):
    P[i][vi] [N, C] for plane i and variant vi in _PLANE_SHIFTS order,
    L[i][vi] over _LINE_SHIFTS; each mip-blended."""
    meta = packed.meta
    xyz01 = torch.clamp(xyz01.detach(), 0.0, 1.0)
    n = xyz01.shape[0]
    if level is not None:
        level = level.detach()
    cols = [xyz01[:, 0], xyz01[:, 1], xyz01[:, 2]]
    d01 = [float(delta01[0]), float(delta01[1]), float(delta01[2])]
    P = [[None] * 5 for _ in range(3)]
    L = [[None] * 3 for _ in range(3)]
    for l0, mw in _level_branches(meta.n_levels, level, n):
        mwc = None if mw is None else mw[:, None]
        for i in range(3):
            a, b = MAT_MODE[i]
            base, h, w, hf, wf = _plane_params(meta, i, l0)
            ut0 = cols[a] * hf - 0.5
            vt0 = cols[b] * wf - 0.5
            dut = d01[a] * hf
            dvt = d01[b] * wf
            for vi, (su, sv) in enumerate(_PLANE_SHIFTS):
                p = sample_bilinear_packed(packed.buffer, h, w,
                                           ut0 + su * dut, vt0 + sv * dvt,
                                           base)
                if mwc is not None:
                    p = p * mwc
                P[i][vi] = p if P[i][vi] is None else P[i][vi] + p
            c = VEC_MODE[i]
            base, ln, lf = _line_params(meta, i, l0)
            xt0 = cols[c] * lf - 0.5
            dxt = d01[c] * lf
            for vi, sx in enumerate(_LINE_SHIFTS):
                ll = _linear_take(packed.buffer, base, ln, xt0 + sx * dxt)
                if mwc is not None:
                    ll = ll * mwc
                L[i][vi] = ll if L[i][vi] is None else L[i][vi] + ll
    return P, L


def vm_stencil_features_split(packed: PackedVMField, xyz01, delta01,
                              level=None):
    """Per-plane features of the 7-point FD stencil, deduplicated: a list
    of 3 tensors [7, N, C] (stencil-major)."""
    P, L = vm_stencil_variants(packed, xyz01, delta01, level)
    out = []
    for i in range(3):
        a, b = MAT_MODE[i]
        c = VEC_MODE[i]
        feats = []
        for d, sign in _STENCIL:
            pi, li = 0, 0
            if d == a:
                pi = 1 if sign > 0 else 2
            elif d == b:
                pi = 3 if sign > 0 else 4
            elif d == c:
                li = 1 if sign > 0 else 2
            feats.append(P[i][pi] * L[i][li])
        out.append(torch.stack(feats, dim=0))
    return out


def vm_stencil_features(packed: PackedVMField, xyz01, delta01, level=None):
    """Concat form of vm_stencil_features_split: [7, N, 3C]."""
    return torch.cat(vm_stencil_features_split(packed, xyz01, delta01,
                                               level), dim=-1)


# ---------------------------------------------------------------------------
# 4x4 patch atlas (stencil head input)
# ---------------------------------------------------------------------------

class PatchMeta(NamedTuple):
    plane_offsets: Tuple[Tuple[int, ...], ...]
    plane_shapes: Tuple[Tuple[Tuple[int, int], ...], ...]
    line_offsets: Tuple[Tuple[int, ...], ...]
    line_lens: Tuple[Tuple[int, ...], ...]
    n_levels: int
    n_comp: int
    # 'p16': rows are whole 4x4 patches [16C], one gather per sample;
    # 'p4': rows are 1x4 dv-spans [4C] of the edge-padded texture, four
    # consecutive padded rows per sample (one format per atlas, so that
    # the dynamic-mip branches index one buffer alike)
    plane_fmt: str = 'p16'


class PatchAtlas(NamedTuple):
    """Planes [Tp, 16C] (p16 rows) or [Tp, 4C] (p4 rows), lines [Tl, 4C]."""
    plane_buf: torch.Tensor
    line_buf: torch.Tensor
    meta: PatchMeta


def pack_vm_patches(field: FieldParams, n_levels: int = 1,
                    gather_dtype=None, pack_impl: str = 'auto') -> PatchAtlas:
    """Patch atlas of the stencil head.  Differentiable; built once per
    step.

    p16 rows (a_u*(W+1) + a_v) hold the 16 edge-clamped texels
    (clip(a_u-1+du), clip(a_v-1+dv)), du,dv in [-1,2], slot-major du*4+dv.
    p4 rows (u_p*(W+1) + a_v, u_p in [0, H+3]) hold the 4 texels
    pad[u_p, a_v..a_v+3] of one row of the texture edge-padded by 2, so
    that padded rows a_u..a_u+3 make up the p16 row a_u*(W+1) + a_v (the
    gather side reassembles it, vm_patch_gather).  p4 packs 4x the plane
    bytes instead of 16x.  Each line row holds the 4 texels clip(a-1+dx).

    pack_impl: 'auto' takes p4 when the top plane has at least
    PACK_P4_MIN_TEXELS texels, else p16; 'p4' / 'p16' force a format."""
    if pack_impl not in ('auto', 'p4', 'p16'):
        raise ValueError(f'pack_impl={pack_impl!r}: auto, p4 or p16')
    top = field['planes'][0].shape
    fmt = pack_impl
    if fmt == 'auto':
        fmt = 'p4' if top[0] * top[1] >= PACK_P4_MIN_TEXELS else 'p16'
    pparts, lparts = [], []
    p_offs, p_shapes, l_offs, l_lens = [], [], [], []
    poff = loff = 0
    for i in range(3):
        offs, shps = [], []
        for tex in build_pyramid_2d(field['planes'][i], n_levels):
            h, w, c = tex.shape
            pad = _edge_pad_2d(tex, 2)
            if fmt == 'p4':
                slots = [pad[:, dv + 1:dv + 2 + w] for dv in (-1, 0, 1, 2)]
                rows = h + 4
            else:
                slots = [pad[du + 1:du + 2 + h, dv + 1:dv + 2 + w]
                         for du in (-1, 0, 1, 2) for dv in (-1, 0, 1, 2)]
                rows = h + 1
            pparts.append(torch.cat(slots, -1).reshape(
                rows * (w + 1), len(slots) * c))
            offs.append(poff)
            shps.append((h, w))
            poff += rows * (w + 1)
        p_offs.append(tuple(offs))
        p_shapes.append(tuple(shps))
    for i in range(3):
        offs, lens = [], []
        for tex in build_pyramid_1d(field['lines'][i], n_levels):
            l, c = tex.shape
            pad = _edge_pad_1d(tex, 2)
            slots = [pad[dx + 1:dx + 2 + l] for dx in (-1, 0, 1, 2)]
            lparts.append(torch.cat(slots, -1))
            offs.append(loff)
            lens.append(l)
            loff += l + 1
        l_offs.append(tuple(offs))
        l_lens.append(tuple(lens))
    pbuf = torch.cat(pparts, dim=0)
    lbuf = torch.cat(lparts, dim=0)
    if gather_dtype is not None:
        pbuf = pbuf.to(gather_dtype)
        lbuf = lbuf.to(gather_dtype)
    meta = PatchMeta(tuple(p_offs), tuple(p_shapes), tuple(l_offs),
                     tuple(l_lens), n_levels,
                     int(field['planes'][0].shape[-1]), plane_fmt=fmt)
    return PatchAtlas(pbuf, lbuf, meta)


class _TakeRowsSmall(torch.autograd.Function):
    """Row gather whose backward is index_add_ of the cotangent rounded to
    bfloat16 and summed in float32 — the arithmetic of the JAX package's
    one-hot-matmul VJP (tensor_field._take_rows_small_bwd), which casts
    the cotangent to bf16 before its f32-accumulated product."""

    @staticmethod
    def forward(ctx, buf, idx):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype = buf.shape[0], buf.dtype
        return torch.index_select(buf, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.to(torch.bfloat16).float()
        dbuf = torch.zeros((ctx.rows, g.shape[1]), dtype=torch.float32,
                           device=g.device)
        dbuf.index_add_(0, idx, g)
        return dbuf.to(ctx.dtype), None


def take_rows_small(buf, idx):
    """Row gather for small tables (<= SMALL_TABLE_ROWS rows)."""
    idx = torch.clamp(idx, 0, buf.shape[0] - 1)
    return _TakeRowsSmall.apply(buf, idx)


def vm_patch_gather(atlas: PatchAtlas, xyz01, delta01, level=None):
    """Gather stencil patches + pack fractions for the stencil head.

    Returns (pp, lp, fr, sigmas): pp[b][i] [N, 16C] plane patches and
    lp[b][i] [N, 4C] line patches per mip branch b; fr [N, 64] f32 with
    branch b at lanes 32b+: 0..5 = (fu_i, fv_i), 6..8 = fx_i,
    9 = branch blend weight, 10..15 = (sigma_u_i, sigma_v_i),
    16..18 = sigma_x_i.  sigmas[b][i] = (su, sv, sx) python floats when the
    branch's mip is static (n_levels == 1), else None (the head reads the
    sigma lanes).  Same layout as the JAX package (tensor_field.py:785-791).
    """
    meta = atlas.meta
    xyz01 = torch.clamp(xyz01.detach(), 0.0, 1.0)
    n = xyz01.shape[0]
    if level is not None:
        level = level.detach()
    cols = [xyz01[:, 0], xyz01[:, 1], xyz01[:, 2]]
    d01 = [float(delta01[0]), float(delta01[1]), float(delta01[2])]
    ones = torch.ones((n,), dtype=torch.float32, device=xyz01.device)

    pp, lp, sigmas, fr_cols = [], [], [], []
    for l0, mw in _level_branches(meta.n_levels, level, n):
        static = isinstance(l0, int)
        sgs, fracs, sig_lanes, p_idx, l_idx, sig_x = [], [], [], [], [], []
        p_strides = []
        for i in range(3):
            a, b = MAT_MODE[i]
            base, hi, wi, hf, wf = _plane_params(meta, i, l0)
            ut = cols[a] * hf - 0.5
            vt = cols[b] * wf - 0.5
            u0 = torch.floor(ut)
            v0 = torch.floor(vt)
            fracs += [ut - u0, vt - v0]
            sig_lanes += [d01[a] * hf * ones, d01[b] * wf * ones]
            au = _clip_idx(u0.long() + 1, hi)
            av = _clip_idx(v0.long() + 1, wi)
            p_idx.append(base + au * (wi + 1) + av)
            p_strides.append(wi + 1)
            sgs.append((d01[a] * hf, d01[b] * wf) if static else None)
        for i in range(3):
            c = VEC_MODE[i]
            base, li, lf = _line_params(meta, i, l0)
            xt = cols[c] * lf - 0.5
            x0 = torch.floor(xt)
            fracs.append(xt - x0)
            sig_x.append(d01[c] * lf * ones)
            l_idx.append(_clip_idx(x0.long() + 1, li) + base)
            if static:
                sgs[i] = sgs[i] + (d01[c] * lf,)
        if meta.plane_fmt == 'p4':
            # padded rows a_u..a_u+3 (stride W+1) side by side make up the
            # same slot-major [N, 16C] block as a p16 row
            k4 = device_constant('p4_rows', lambda: range(4), xyz01.device,
                                 torch.int64)[None, :]
            pps = [_take(atlas.plane_buf, ix[:, None] + k4 * (
                       st if isinstance(st, int) else st[:, None])
                   ).reshape(n, -1) for ix, st in zip(p_idx, p_strides)]
        else:
            pps = [_take(atlas.plane_buf, ix) for ix in p_idx]
        small = atlas.line_buf.shape[0] <= SMALL_TABLE_ROWS
        lps = [take_rows_small(atlas.line_buf, ix) if small
               else _take(atlas.line_buf, ix) for ix in l_idx]
        wcol = ones if mw is None else mw.float()
        fr_b = fracs + [wcol] + sig_lanes + sig_x
        blk = torch.stack(fr_b, dim=1).float()                  # [N, 19]
        fr_cols.append(F.pad(blk, (0, FRAC_STRIDE - 19)))
        pp.append(pps)
        lp.append(lps)
        sigmas.append(tuple(sgs) if static else None)
    fr = torch.cat(fr_cols, dim=-1)
    if fr.shape[-1] < 2 * FRAC_STRIDE:
        fr = F.pad(fr, (0, 2 * FRAC_STRIDE - fr.shape[-1]))
    return pp, lp, fr, tuple(sigmas)


# ---------------------------------------------------------------------------
# grid upsampling
# ---------------------------------------------------------------------------

def _align_corners_taps(n_in: int, n_out: int, device):
    """(i0, i1, f) of an align-corners linear resize n_in -> n_out at the
    positions jnp.linspace(0, n_in - 1, n_out) takes in the JAX package:
    XLA folds its start * (1 - t) + stop * t, t = i / (n_out - 1), into
    i * (stop * (1 / (n_out - 1))) in float32 (equal on every size pair
    tried), the last one exactly stop.  floor() and the fractions round
    as the JAX package's do."""
    stop = np.float32(n_in - 1.0)
    pos = np.zeros((n_out,), np.float32)
    if n_out > 1:
        rate = stop * (np.float32(1.0) / np.float32(n_out - 1))
        pos[:-1] = np.arange(n_out - 1, dtype=np.float32) * rate
        pos[-1] = stop
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = (pos - i0.astype(np.float32)).astype(np.float32)
    return (torch.as_tensor(i0, device=device),
            torch.as_tensor(i1, device=device),
            torch.as_tensor(f, device=device))


def _interp_bilinear_resize(tex, out_hw):
    """align_corners=True bilinear resize of [H,W,C] (ref: fields.py:154-166)
    by index gathers, as the JAX package computes it."""
    h, w, _ = tex.shape
    u0, u1, fu = _align_corners_taps(h, out_hw[0], tex.device)
    v0, v1, fv = _align_corners_taps(w, out_hw[1], tex.device)
    fu = fu[:, None, None]
    fv = fv[None, :, None]
    r0, r1 = tex[u0], tex[u1]
    t00, t01 = r0[:, v0], r0[:, v1]
    t10, t11 = r1[:, v0], r1[:, v1]
    return ((1 - fu) * ((1 - fv) * t00 + fv * t01)
            + fu * ((1 - fv) * t10 + fv * t11))


def _interp_linear_resize(line, out_l: int):
    x0, x1, f = _align_corners_taps(line.shape[0], out_l, line.device)
    f = f[:, None]
    return (1 - f) * line[x0] + f * line[x1]


def upsample_vm(field: FieldParams, res_target: Sequence[int]) -> FieldParams:
    """Coarse-to-fine grid upsampling (ref: fields.py:154-178)."""
    planes, lines = [], []
    for i in range(3):
        hw = (int(res_target[MAT_MODE[i][0]]), int(res_target[MAT_MODE[i][1]]))
        planes.append(_interp_bilinear_resize(field['planes'][i], hw))
        lines.append(_interp_linear_resize(field['lines'][i],
                                           int(res_target[VEC_MODE[i]])))
    return {'planes': planes, 'lines': lines}


# ---------------------------------------------------------------------------
# regularizers
# ---------------------------------------------------------------------------

def shrink_vm(field: FieldParams, grid_size, aabb, new_aabb):
    """Crop the VM grids to a tightened aabb (ref: fields.py:180-203).
    Host-side (the shapes change).  Returns (field, new_grid_size)."""
    aabb = np.asarray(aabb, np.float64)
    new_aabb = np.asarray(new_aabb, np.float64)
    gs = np.asarray(grid_size)
    units = (aabb[1] - aabb[0]) / (gs - 1)
    t_l = np.round((new_aabb[0] - aabb[0]) / units).astype(int)
    b_r = np.minimum(np.round((new_aabb[1] - aabb[0]) / units).astype(int)
                     + 1, gs)
    planes, lines = [], []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        v = VEC_MODE[i]
        planes.append(field['planes'][i][t_l[m0]:b_r[m0], t_l[m1]:b_r[m1]])
        lines.append(field['lines'][i][t_l[v]:b_r[v]])
    new_size = tuple(int(x) for x in (b_r - t_l))
    return {'planes': planes, 'lines': lines}, new_size


def tv_loss_vm(field: FieldParams):
    """Total-variation regularizer over planes+lines
    (ref: other_field.py:170-191 applied at fields.py:133-138)."""
    total = 0.0
    for p in field['planes']:
        h, w, c = p.shape
        dh = torch.sum((p[1:, :, :] - p[:-1, :, :]) ** 2) / ((h - 1) * w * c)
        dw = torch.sum((p[:, 1:, :] - p[:, :-1, :]) ** 2) / (h * (w - 1) * c)
        total = total + 2.0 * (dh + dw)
    for l in field['lines']:
        ln, c = l.shape
        total = total + 2.0 * torch.sum((l[1:] - l[:-1]) ** 2) / (
            (ln - 1) * c)
    return total


def _gaussian_kernel_1d(kernel_size: int, sigma: float) -> np.ndarray:
    x = np.arange(-(kernel_size // 2), kernel_size // 2 + 1, dtype=np.float64)
    k = np.exp(-x ** 2 / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth_loss_vm(field: FieldParams, kernel_size: int = 5,
                            sigma: float = 0.5):
    """Squared difference between the grids and their Gaussian blur,
    borders excluded (ref: fields.py:301-309)."""
    dev = field['planes'][0].device
    k1 = device_constant(('gaussian_1d', kernel_size, sigma),
                         lambda: _gaussian_kernel_1d(kernel_size, sigma), dev)
    k2 = k1[:, None] * k1[None, :]
    kk = kernel_size // 2
    total = 0.0
    for p in field['planes']:
        x = p.permute(2, 0, 1)[:, None]                    # [C,1,H,W]
        blur = F.conv2d(x, k2[None, None], padding=kk)[:, 0].permute(1, 2, 0)
        total = total + torch.sum(
            (p[kk:-kk, kk:-kk] - blur[kk:-kk, kk:-kk]) ** 2)
    for l in field['lines']:
        x = l.t()[:, None, :]                              # [C,1,L]
        blur = F.conv1d(x, k1[None, None], padding=kk)[:, 0].t()
        total = total + torch.sum((l[kk:-kk] - blur[kk:-kk]) ** 2)
    return total
