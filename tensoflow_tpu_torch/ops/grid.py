"""Occupancy grid, fixed-budget marching, sample compaction, the packed
trilinear tap and the alpha mask (counterpart of tensoflow_tpu/ops/grid.py).

Same state layout as the JAX package: 'occs' [R,R,R] f32, 'binary'
[R,R,R] bool, 'blocks' [R^3, 2] 4^3-block bitmask rows (the JAX uint32
words are held in int64 with identical bits), 'sdf_rows' [R,R,R,8] bf16
baked-SDF cell-corner rows for the occ-loss march.

Random jitter is an argument (pre-drawn noise): the trainer draws it from
its torch.Generator, the parity tests from jax.random.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import device_constant

_WORD = 0xFFFFFFFF


class OccGridConfig(NamedTuple):
    resolution: int = 128
    aabb_min: float = -1.0
    aabb_max: float = 1.0
    ema_decay: float = 0.95
    occ_threshold: float = 1e-2
    warmup_steps: int = 10000


def init_occ_grid(cfg: OccGridConfig, device='cpu'):
    r = cfg.resolution
    return {
        'occs': torch.zeros((r, r, r), device=device),
        'binary': torch.ones((r, r, r), dtype=torch.bool, device=device),
        'blocks': torch.full((r * r * r, 2), _WORD, dtype=torch.int64,
                             device=device),
        # +1 everywhere = 'all empty' until the first update bakes the SDF
        'sdf_rows': torch.ones((r, r, r, 8), dtype=torch.bfloat16,
                               device=device),
    }


def occ_grid_cell_centers(cfg: OccGridConfig, device='cpu'):
    """[R^3, 3] world-space cell centers."""
    r = cfg.resolution
    xs = (torch.arange(r, device=device) + 0.5) / r
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing='ij'), -1)
    return cfg.aabb_min + grid.reshape(-1, 3) * (cfg.aabb_max - cfg.aabb_min)


def update_occ_grid(state, cfg: OccGridConfig, alphas, sdf=None,
                    prune: bool = True):
    """EMA update: occs <- max(occs*decay, alpha); binary <- occs >
    min(mean(occs), thresh), or all occupied while prune is False (the
    trainer's warmup window).  sdf [R^3] at unjittered centers re-bakes
    the occ-loss lattice."""
    r = cfg.resolution
    occs = torch.maximum(state['occs'] * cfg.ema_decay,
                         alphas.reshape(r, r, r))
    if prune:
        thresh = torch.clamp(torch.mean(occs), max=cfg.occ_threshold)
        binary = occs > thresh
    else:
        binary = torch.ones((r, r, r), dtype=torch.bool, device=occs.device)
    new = {'occs': occs, 'binary': binary, 'blocks': pack_occ_blocks(binary)}
    if sdf is not None:
        new['sdf_rows'] = pack_cell_rows(sdf.reshape(r, r, r),
                                         torch.bfloat16)
    elif 'sdf_rows' in state:
        new['sdf_rows'] = state['sdf_rows']
    return new


def occ_sdf_aabb(cfg: OccGridConfig, device='cpu'):
    """aabb of the baked-SDF node lattice (the R^3 cell centers)."""
    h = (cfg.aabb_max - cfg.aabb_min) / cfg.resolution
    return device_constant(('occ_sdf_aabb', cfg), lambda: [
        [cfg.aabb_min + 0.5 * h] * 3, [cfg.aabb_max - 0.5 * h] * 3], device)


def sample_occ_sdf(state, cfg: OccGridConfig, pts):
    """Trilinear baked-SDF lookup at [N,3] -> [N] (+1 outside)."""
    return packed_trilinear_tap(state['sdf_rows'],
                                occ_sdf_aabb(cfg, pts.device), pts)


def pack_cell_rows(values, dtype):
    """[R,R,R] node values -> [R,R,R,8] rows of the cell corners
    (clip(i+di), clip(j+dj), clip(k+dk)), corner (di*2+dj)*2+dk."""
    r = values.shape[0]
    nxt = torch.clamp(torch.arange(r, device=values.device) + 1, max=r - 1)
    corners = []
    for di in (0, 1):
        vi = values if di == 0 else values[nxt]
        for dj in (0, 1):
            vj = vi if dj == 0 else vi[:, nxt]
            for dk in (0, 1):
                corners.append(vj if dk == 0 else vj[:, :, nxt])
    return torch.stack(corners, dim=-1).to(dtype)


def packed_trilinear_tap(rows4, aabb, pts, want_grad: bool = False):
    """One trilinear tap per point from pack_cell_rows rows -> [N] f32
    (1.0 outside the aabb) and, if want_grad, the world-space gradient
    [N,3] of the interpolant."""
    r = rows4.shape[0]
    lo, hi = aabb[0], aabb[1]
    u = (pts - lo) / (hi - lo)
    inside = torch.all((u >= 0.0) & (u <= 1.0), dim=-1)
    x = torch.clamp(u, 0.0, 1.0) * (r - 1.0)
    b = torch.clamp(x.long(), 0, r - 2)
    f = x - b.to(x.dtype)
    idx = (b[:, 0] * r + b[:, 1]) * r + b[:, 2]
    row = rows4.reshape(-1, 8)[torch.clamp(idx, 0, r ** 3 - 1)].float()
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    lane = np.arange(8)
    sx, sy, sz = device_constant(
        'corner_bits', lambda: [(lane >> 2) & 1, (lane >> 1) & 1, lane & 1],
        pts.device, row.dtype)
    wx = (1.0 - fx) + sx * (2.0 * fx - 1.0)
    wy = (1.0 - fy) + sy * (2.0 * fy - 1.0)
    wz = (1.0 - fz) + sz * (2.0 * fz - 1.0)
    ryz = row * wy * wz
    val = torch.sum(ryz * wx, -1)
    val = torch.where(inside, val, torch.ones_like(val))
    if not want_grad:
        return val
    gx = torch.sum(ryz * (2.0 * sx - 1.0), -1)          # d/dfx
    rx = row * wx
    gy = torch.sum(rx * wz * (2.0 * sy - 1.0), -1)      # d/dfy
    gz = torch.sum(rx * wy * (2.0 * sz - 1.0), -1)      # d/dfz
    scale = (r - 1.0) / (hi - lo)                       # [3]
    return val, torch.stack([gx, gy, gz], -1) * scale


def trilinear_sample_3d(volume, xyz01):
    """align_corners=True trilinear sampling of [X,Y,Z] at coords [N,3] in
    [0,1]^3 -> [N] (eight corner gathers; the dense reference path)."""
    dims = volume.shape
    coords = [xyz01[:, d] * (dims[d] - 1) for d in range(3)]
    i0 = [torch.clamp(torch.floor(c).long(), 0, dims[d] - 1)
          for d, c in enumerate(coords)]
    i1 = [torch.clamp(i + 1, 0, dims[d] - 1) for d, i in enumerate(i0)]
    f = [c - torch.floor(c) for c in coords]
    flat = volume.reshape(-1)
    sy, sz = dims[1] * dims[2], dims[2]
    out = 0.0
    for bx, wx in ((i0[0], 1 - f[0]), (i1[0], f[0])):
        for by, wy in ((i0[1], 1 - f[1]), (i1[1], f[1])):
            for bz, wz in ((i0[2], 1 - f[2]), (i1[2], f[2])):
                out = out + wx * wy * wz * flat[bx * sy + by * sz + bz]
    return out


class AlphaGridMask(NamedTuple):
    """Binary alpha-mask volume over an aabb (ref: shapeRenderer.py:79-97):
    aabb [2, 3], volume [X, Y, Z] float 0/1."""
    aabb: torch.Tensor
    volume: torch.Tensor

    def sample_alpha(self, pts):
        """Trilinear mask value at world points [N, 3] -> [N]."""
        u = (pts - self.aabb[0]) / (self.aabb[1] - self.aabb[0])
        return trilinear_sample_3d(self.volume, torch.clamp(u, 0.0, 1.0))


def max_pool_3d_3x3(vol):
    """3x3x3 stride-1 max pool of [X, Y, Z], padded with -inf (ref:
    shapeRenderer.py:265)."""
    return torch.nn.functional.max_pool3d(vol[None, None], 3, stride=1,
                                          padding=1)[0, 0]


def pack_occ_blocks(binary):
    """[R,R,R] bool -> [R^3, 2] rows: the row at anchor a holds the
    edge-clamped 4^3 block binary[clip(a+d)], d in [0,3]^3, as a 64-bit
    mask with bit (dx*4+dy)*4+dz (bit>>5 selects the 32-bit word)."""
    r = binary.shape[0]
    ar = torch.arange(r, device=binary.device)
    idx = [torch.clamp(ar + d, max=r - 1) for d in range(4)]
    words = []
    for wi in range(2):
        acc = torch.zeros((r, r, r), dtype=torch.int64, device=binary.device)
        for dxl in (0, 1):
            vx = binary[idx[2 * wi + dxl]]
            for dy in range(4):
                vxy = vx[:, idx[dy]]
                for dz in range(4):
                    bit = (dxl * 4 + dy) * 4 + dz
                    acc = acc | (vxy[:, :, idx[dz]].long() << bit)
        words.append(acc.reshape(-1))
    return torch.stack(words, dim=-1)


def _query_blocks(blocks, cfg: OccGridConfig, pts, anchors, G: int):
    """Occupancy of per-step cells from per-group block rows -> [rn, S]."""
    r = cfg.resolution
    rn, s0, _ = pts.shape
    aidx = (anchors[..., 0] * r + anchors[..., 1]) * r + anchors[..., 2]
    rows = blocks[torch.clamp(aidx, 0, blocks.shape[0] - 1)]   # [rn, ng, 2]
    rows = rows[:, :, None, :].expand(rn, s0 // G, G, 2).reshape(rn, s0, 2)
    u = (pts - cfg.aabb_min) / (cfg.aabb_max - cfg.aabb_min)
    inside = torch.all((u >= 0.0) & (u < 1.0), dim=-1)
    v = torch.clamp((u * r).long(), 0, r - 1)
    anc = anchors[:, :, None, :].expand(rn, s0 // G, G, 3).reshape(rn, s0, 3)
    loc = torch.clamp(v - anc, 0, 3)
    b = (loc[..., 0] * 4 + loc[..., 1]) * 4 + loc[..., 2]
    word = torch.where(b < 32, rows[..., 0], rows[..., 1])
    return (((word >> (b & 31)) & 1) > 0) & inside


def query_binary(state, cfg: OccGridConfig, pts):
    """Nearest-cell binary occupancy at [N,3] -> bool [N]."""
    r = cfg.resolution
    u = (pts - cfg.aabb_min) / (cfg.aabb_max - cfg.aabb_min)
    inside = torch.all((u >= 0.0) & (u < 1.0), dim=-1)
    idx = torch.clamp((u * r).long(), 0, r - 1)
    flat = idx[:, 0] * r * r + idx[:, 1] * r + idx[:, 2]
    return state['binary'].reshape(-1)[flat] & inside


def occ_grid_sampling(state, cfg: OccGridConfig, rays_o, dirs, near, far,
                      step_size: float, n_candidates: int,
                      max_samples: int, jitter=None):
    """Empty-space-skipping sampling with a fixed per-ray budget.

    jitter: [rn, 1] uniforms in [0,1) (stratified lattice offset per ray)
    or None (no jitter).  Returns t_starts, t_ends, valid [rn, S]."""
    rn = rays_o.shape[0]
    voxel = (cfg.aabb_max - cfg.aabb_min) / cfg.resolution
    G = 1
    if 'blocks' in state:
        for g in (4, 2):
            if (g - 1) * 0.5 * float(step_size) <= voxel:
                G = g
                break
    s0 = -(-n_candidates // G) * G
    dev, dt = rays_o.device, rays_o.dtype
    i = torch.arange(s0, dtype=dt, device=dev)
    if jitter is None:
        jitter = torch.zeros((rn, 1), dtype=dt, device=dev)
    tm = near + (i[None, :] + jitter + 0.5) * step_size
    pts = rays_o[:, None, :] + dirs[:, None, :] * tm[..., None]
    if G == 1:
        occ = query_binary(state, cfg, pts.reshape(-1, 3)).reshape(rn, s0)
    else:
        gg = torch.arange(s0 // G, dtype=dt, device=dev)
        tc = near + (gg[None, :] * G + jitter + 0.5 * G) * step_size
        pc = rays_o[:, None, :] + dirs[:, None, :] * tc[..., None]
        uc = (pc - cfg.aabb_min) / (cfg.aabb_max - cfg.aabb_min)
        vc = torch.clamp((uc * cfg.resolution).long(), 0,
                         cfg.resolution - 1)
        anchors = torch.clamp(vc - 1, 0, cfg.resolution - 4)
        occ = _query_blocks(state['blocks'], cfg, pts, anchors, G)
    occ = occ[:, :n_candidates] & (tm[:, :n_candidates] < far)
    # the first max_samples occupied steps, in order: occupied keys keep
    # their index, empty ones get index + n_candidates (keys are unique)
    ii = torch.arange(n_candidates, device=dev)
    key = torch.where(occ, ii[None, :], n_candidates + ii[None, :])
    key = torch.sort(key, dim=1, stable=True).values[:, :max_samples]
    valid = key < n_candidates
    idx = torch.clamp(key, max=n_candidates - 1).to(dt)
    t_starts = near + (idx + jitter) * step_size
    return t_starts, t_starts + step_size, valid


def compact_indices(valid_flat, m: int, limit: Optional[int] = None):
    """Stable compaction of valid slots into a budget of m.

    Returns (src [M] int64, slot_mask [M] bool, dest [N] int64 — compacted
    slot per source, or M for dropped/invalid).  ``limit`` (<= m) keeps
    only the first ``limit`` valid entries (a rank's share of a global
    compaction, compact_indices_sharded)."""
    n = valid_flat.shape[0]
    dev = valid_flat.device
    limit = m if limit is None else limit
    pos = torch.cumsum(valid_flat.long(), 0) - 1
    keep = valid_flat & (pos < limit)
    dest = torch.where(keep, pos, torch.full_like(pos, m))
    keys = torch.where(keep, dest, torch.full_like(dest, n + 1))
    order = torch.sort(keys, stable=True).indices
    if n >= m:
        src = order[:m]
    else:
        src = torch.cat([order, order.new_zeros(m - n)])
    n_valid = torch.clamp(valid_flat.long().sum(), max=limit)
    slot_mask = torch.arange(m, device=dev) < n_valid
    return src, slot_mask, dest


def compact_indices_sharded(valid_flat, m: int, mesh):
    """This rank's share of the compaction of the global flat axis (the
    ranks' axes in rank order) into m slots: the valid entries the global
    prefix sum keeps, in ``plan.slots`` local slots, local slot j being
    global slot ``plan.offset + j``.  Returns (src, slot_mask, dest, plan)
    as compact_indices, with M = plan.slots."""
    from ..parallel import sharding
    plan = sharding.compact_plan(mesh, valid_flat, m)
    return compact_indices(valid_flat, plan.slots, plan.kept) + (plan,)


def compact_indices_mesh(valid_flat, m: int, mesh=None):
    """compact_indices, or on an active mesh this rank's share of the
    global compaction (compact_indices_sharded): (src, slot_mask, dest)
    with M = src.shape[0] local slots."""
    from ..parallel import sharding
    if sharding.active(mesh):
        return compact_indices_sharded(valid_flat, m, mesh)[:3]
    return compact_indices(valid_flat, m)


def _mask_rows(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


class _ScatterBackInv(torch.autograd.Function):
    """scatter_back whose backward is the inverse gather: dest is
    injective on mapped sources, so d values_m[j] = g[src[j]] * mask[j]."""

    @staticmethod
    def forward(ctx, values_m, dest, src, slot_mask, fill):
        ctx.save_for_backward(src, slot_mask)
        return _scatter_back_dense(values_m, dest, fill)

    @staticmethod
    def backward(ctx, g):
        src, slot_mask = ctx.saved_tensors
        dv = torch.index_select(g, 0, torch.clamp(src, 0, g.shape[0] - 1))
        dv = torch.where(_mask_rows(slot_mask, dv), dv, torch.zeros_like(dv))
        return dv, None, None, None, None


def _scatter_back_dense(values_m, dest, fill=0.0):
    m = values_m.shape[0]
    mapped = dest < m
    gathered = torch.index_select(values_m, 0, torch.clamp(dest, 0, m - 1))
    return torch.where(_mask_rows(mapped, gathered), gathered,
                       torch.full_like(gathered, fill))


def scatter_back(values_m, dest, fill: float = 0.0, src=None,
                 slot_mask=None):
    """Expand compacted per-slot values [M, ...] back to flat [N, ...]:
    out[i] = values_m[dest[i]] for mapped sources, ``fill`` elsewhere.
    With ``src``/``slot_mask`` of the same compact_indices call the
    backward is a gather by ``src`` instead of a scatter-add."""
    if src is None:
        return _scatter_back_dense(values_m, dest, fill)
    return _ScatterBackInv.apply(values_m, dest, src, slot_mask, fill)


class _CompactTake(torch.autograd.Function):
    """values[src] whose backward is the inverse gather by ``dest``:
    d values[i] = g[dest[i]] for mapped i, 0 elsewhere."""

    @staticmethod
    def forward(ctx, values, src, dest):
        ctx.save_for_backward(dest)
        ctx.m = src.shape[0]
        return torch.index_select(
            values, 0, torch.clamp(src, 0, values.shape[0] - 1))

    @staticmethod
    def backward(ctx, g):
        dest, = ctx.saved_tensors
        m = ctx.m
        dv = torch.index_select(g, 0, torch.clamp(dest, 0, m - 1))
        dv = torch.where(_mask_rows(dest < m, dv), dv, torch.zeros_like(dv))
        return dv, None, None


def compact_take(values, src, dest, slot_mask=None):
    """[N, C] -> [M, C] gather by ``src`` (see _CompactTake)."""
    return _CompactTake.apply(values, src, dest)
