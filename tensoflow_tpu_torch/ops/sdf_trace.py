"""Baked-SDF sphere tracing: the secondary-ray visibility oracle
(counterpart of tensoflow_tpu/ops/sdf_trace.py).

The frozen stage-1 SDF is baked into a dense voxel grid once at stage-2
init and sphere-traced: fixed iteration counts, one trilinear tap per
step, hit normals from the grid.  Rays are offset from the surface before
tracing (ref: materialRenderer.py:223), misses report depth MISS_DEPTH
(ref: materialRenderer.py:261).

Everything here runs without gradients (the reference's ray tracer is a
non-differentiable operator); callers wrap the calls in torch.no_grad()
so that no tap keeps its inputs alive for a backward pass.

Differences from the JAX module, all outside the arithmetic: the loops are
Python loops; the visibility cache's uint32 words are held in int64 with
the same bits; the layout pins the JAX module applies to its gather
tables on its accelerator have no counterpart here and are left out.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device_constant
from .grid import (compact_indices_mesh, pack_cell_rows, packed_trilinear_tap,
                   scatter_back, trilinear_sample_3d)

MISS_DEPTH = 10.0
SQRT3 = float(np.sqrt(3.0))


class SDFGrid(NamedTuple):
    values: torch.Tensor    # [R,R,R] signed distances
    aabb: torch.Tensor      # [2,3]

    @property
    def resolution(self) -> int:
        return self.values.shape[0]


@torch.no_grad()
def bake_sdf_grid(sdf_fun, aabb, resolution: int = 256,
                  chunk: int = 262144, device='cpu') -> SDFGrid:
    """Evaluate the (frozen) neural SDF on a dense lattice, in chunks,
    once at stage-2 init (the reference extracts a mesh instead,
    extract_mesh.py:41).  sdf_fun: [M,3] -> [M,1] on ``device``."""
    a = np.asarray(aabb, np.float32)
    xs = [np.linspace(a[0][d], a[1][d], resolution, dtype=np.float32)
          for d in range(3)]
    grid = torch.as_tensor(
        np.stack(np.meshgrid(*xs, indexing='ij'), -1).reshape(-1, 3),
        device=device)
    vals = [sdf_fun(grid[i:i + chunk]).reshape(-1)
            for i in range(0, grid.shape[0], chunk)]
    values = torch.cat(vals, 0).reshape(resolution, resolution, resolution)
    return SDFGrid(values=values.float(),
                   aabb=torch.as_tensor(a, device=device))


def sample_sdf_grid(grid: SDFGrid, pts):
    """Trilinear SDF lookup; points outside the aabb get a large positive
    distance (never 'hit')."""
    lo, hi = grid.aabb[0], grid.aabb[1]
    u = (pts - lo) / (hi - lo)
    inside = torch.all((u >= 0.0) & (u <= 1.0), dim=-1)
    val = trilinear_sample_3d(grid.values, torch.clamp(u, 0.0, 1.0))
    return torch.where(inside, val, torch.ones_like(val))


def sdf_grid_normal(grid: SDFGrid, pts, eps_scale: float = 1.0):
    """Central-difference normal from the baked grid."""
    cell = (grid.aabb[1] - grid.aabb[0]) / grid.resolution * eps_scale
    offs = torch.diag(cell)
    n = pts.shape[0]
    plus = sample_sdf_grid(grid, (pts[:, None, :] + offs[None]).reshape(-1, 3)
                           ).reshape(n, 3)
    minus = sample_sdf_grid(grid,
                            (pts[:, None, :] - offs[None]).reshape(-1, 3)
                            ).reshape(n, 3)
    g = (plus - minus) / (2.0 * cell[None, :])
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                           min=1e-8)


def _slab(aabb, rays_o, rays_d):
    """Ray/aabb slab parameters ra, rb [N,3]."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    return (aabb[1] - rays_o) / vec, (aabb[0] - rays_o) / vec


def _flip_to_face(normals, rays_d):
    """Flip normals to face the incoming ray (ref:
    materialRenderer.py:256-257)."""
    flip = torch.sum(normals * rays_d, -1, keepdim=True) >= 0
    return torch.where(flip, -normals, normals)


def sphere_trace(grid, rays_o, rays_d, n_steps: int = 48,
                 n_bisect: int = 8, hit_eps=None,
                 step_scale: float = 0.9, max_dist: float = 4.0):
    """Fixed-iteration sphere trace of the baked SDF.

    rays_o/rays_d: [N,3] (dirs unit).  Returns (inters [N,3], normals
    [N,3], depth [N,1], hit_mask [N]); misses get depth = MISS_DEPTH.
    Takes a dense ``SDFGrid`` (the reference path: 8 corner gathers per
    tap) or a ``PackedSDFGrid`` (see sphere_trace_packed)."""
    if isinstance(grid, PackedSDFGrid):
        return sphere_trace_packed(grid, rays_o, rays_d, n_bisect=n_bisect,
                                   step_scale=step_scale,
                                   max_dist=max_dist)
    n = rays_o.shape[0]
    ext = grid.aabb[1] - grid.aabb[0]
    cell = torch.mean(ext) / grid.resolution
    diag = torch.linalg.norm(ext)
    if hit_eps is None:
        hit_eps = 0.75 * cell
    # cap the step so a (possibly non-metric) baked field cannot tunnel
    # through thin geometry, while n_steps * cap still spans the aabb
    step_cap = torch.maximum(2.0 * diag / n_steps, 4.0 * cell)

    # start at the ray/aabb entry (slab method): outside the grid the
    # field carries no distance information
    ra, rb = _slab(grid.aabb, rays_o, rays_d)
    t = torch.clamp(torch.max(torch.minimum(ra, rb), -1,
                              keepdim=True).values, min=0.0)
    done = torch.zeros((n,), dtype=torch.bool, device=rays_o.device)
    prev_step = (2.0 * cell).to(rays_o.dtype).expand(n, 1)
    for _ in range(n_steps):
        d = sample_sdf_grid(grid, rays_o + rays_d * t)
        done = done | (d < hit_eps) | (t[:, 0] > max_dist)
        step = torch.minimum(torch.maximum(d, hit_eps * 0.5)[:, None]
                             * step_scale, step_cap)
        t = torch.where(done[:, None], t, t + step)
        prev_step = torch.where(done[:, None], prev_step, step)

    d_end = sample_sdf_grid(grid, rays_o + rays_d * t)
    hit = done & (d_end < 2.0 * hit_eps) & (t[:, 0] <= max_dist)

    # bisection refinement over the last step taken (sign-change bracket)
    lo = torch.clamp(t - torch.maximum(prev_step, 2.0 * cell), min=0.0)
    hi = t
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        go_low = sample_sdf_grid(grid, rays_o + rays_d * mid)[:, None] > 0.0
        lo, hi = torch.where(go_low, mid, lo), torch.where(go_low, hi, mid)
    t_ref = 0.5 * (lo + hi)
    t_final = torch.where(hit[:, None], t_ref,
                          torch.full_like(t, MISS_DEPTH))
    inters = rays_o + rays_d * torch.where(hit[:, None], t_ref,
                                           torch.zeros_like(t_ref))
    normals = _flip_to_face(sdf_grid_normal(grid, inters), rays_d)
    return inters, normals, t_final, hit


# ---------------------------------------------------------------------------
# packed trace: one row gather per trilinear tap + coarse empty-space leaps
# ---------------------------------------------------------------------------

class PackedSDFGrid:
    """Multi-resolution packed trace representation.

    * ``coarse_rows`` [Rc,Rc,Rc,8]: strided-subsample cell-corner rows for
      Lipschitz-safe empty-space leaps.
    * ``mid_rows`` [Rm,Rm,Rm,8]: mid-resolution cell-corner rows, the
      marching level.
    * ``blocks`` [NB^3, 64]: full-resolution stride-3 4^3 corner blocks
      (node span [3b, 3b+3], edge-clamped): the final hit polish and the
      analytic normal read ONE such row per ray.
    * ``vis_rows`` [Rc,Rc,Rc,8] int64 or None: direction-binned visibility
      cache (bake_vis_cache), 8 words of 32 bins each; the JAX package's
      uint32 words with the same bits.  ``vis_pad`` is the extra apex
      margin (world units) the bake reserved.

    ``reso`` is the full node resolution R.
    """

    def __init__(self, mid_rows, blocks, coarse_rows, aabb, reso: int,
                 vis_rows=None, vis_pad: float = 0.0):
        self.mid_rows = mid_rows
        self.blocks = blocks
        self.coarse_rows = coarse_rows
        self.aabb = aabb
        self.reso = int(reso)
        self.vis_rows = vis_rows
        self.vis_pad = float(vis_pad)

    @property
    def resolution(self) -> int:
        return self.reso


def pack_corner_blocks(values, dtype):
    """[R,R,R] node values -> [NB^3, 64] stride-3 4^3 corner blocks.

    Block b covers nodes clip(3b + [0,3]) per axis; NB = (R+2)//3.  Lane
    order (i*4+j)*4+k for node offset (i,j,k)."""
    r = values.shape[0]
    nb = (r + 2) // 3
    ar = np.minimum(3 * np.arange(nb)[:, None] + np.arange(4), r - 1)
    ar = torch.as_tensor(ar.reshape(-1), device=values.device)   # [nb*4]
    z = values[ar][:, ar][:, :, ar].reshape(nb, 4, nb, 4, nb, 4)
    return z.permute(0, 2, 4, 1, 3, 5).reshape(nb ** 3, 64).to(dtype)


def pack_sdf_grid(grid: SDFGrid, coarse_factor: int = 4,
                  dtype=torch.bfloat16, mid_factor: int = 2
                  ) -> PackedSDFGrid:
    """Build the packed trace representation (once, at stage-2 init).

    Coarse/mid nodes are strided subsamples (exact baked values); the
    tracer subtracts the coarse cell diagonal from every coarse step, which
    bounds the coarse interpolant's overestimate under the SDF's Lipschitz
    continuity.  bfloat16 storage halves the trace's traffic."""
    v = grid.values.to(dtype)
    r = v.shape[0]
    mid_rows = pack_cell_rows(v[::mid_factor, ::mid_factor, ::mid_factor],
                              dtype)
    blocks = pack_corner_blocks(v, dtype).contiguous()
    coarse_rows = pack_cell_rows(
        v[::coarse_factor, ::coarse_factor, ::coarse_factor], dtype)
    return PackedSDFGrid(mid_rows=mid_rows, blocks=blocks,
                         coarse_rows=coarse_rows,
                         aabb=grid.aabb.float(), reso=r)


def _trace_scales(pg: PackedSDFGrid):
    """Host-side (python float) trace geometry scales shared by
    sphere_trace_budget and bake_vis_cache: the bake's certified interval
    [T0, exit] must match the trace's corridor split exactly.  Reads the
    aabb from the device; used at init only."""
    aabb = pg.aabb.detach().cpu().numpy().astype(np.float64)
    ext_mean = float(np.mean(aabb[1] - aabb[0]))
    rm = pg.mid_rows.shape[0]
    rc = pg.coarse_rows.shape[0]
    m_cell = ext_mean / (rm - 1)
    c_cell = ext_mean / (rc - 1)
    c_diag = SQRT3 * c_cell
    switch = c_diag + 2.0 * m_cell
    arm = 1.25 * switch
    delta = 1.5 * m_cell
    t0_max = 2.0 * (arm - delta)      # T0: max launch-corridor length
    return dict(ext_mean=ext_mean, m_cell=m_cell, c_cell=c_cell,
                c_diag=c_diag, switch=switch, arm=arm, delta=delta,
                t0_max=t0_max)


# ---------------------------------------------------------------------------
# direction-binned visibility cache (bake once at stage-2 init)
# ---------------------------------------------------------------------------

VIS_NB = 16                     # octahedral bins per axis (16x16 = 256)


def octa_bin(d, nb: int = VIS_NB):
    """[...,3] directions -> octahedral bin id (int64) in [0, nb*nb)."""
    s = torch.sum(d.abs(), -1, keepdim=True)
    p = d / torch.clamp(s, min=1e-12)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    fx = (1.0 - py.abs()) * torch.sign(px)
    fy = (1.0 - px.abs()) * torch.sign(py)
    u = torch.where(pz < 0, fx, px)
    v = torch.where(pz < 0, fy, py)
    # truncate, then clip (the order the JAX module has)
    iu = torch.clamp(((u * 0.5 + 0.5) * nb).long(), 0, nb - 1)
    iv = torch.clamp(((v * 0.5 + 0.5) * nb).long(), 0, nb - 1)
    return iv * nb + iu


def _octa_decode_np(u, v):
    """Octahedral uv in [-1,1]^2 -> unit directions (numpy)."""
    z = 1.0 - np.abs(u) - np.abs(v)
    x = np.where(z < 0, (1.0 - np.abs(v)) * np.sign(u), u)
    y = np.where(z < 0, (1.0 - np.abs(u)) * np.sign(v), v)
    d = np.stack([x, y, z], -1)
    return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)


def _octa_bin_table(nb: int = VIS_NB):
    """Per-bin (center direction [nb*nb,3], conservative chord [nb*nb])
    with chord >= |d - center| for every unit d binned into the bin,
    estimated from a dense 16x-oversampled direction grid."""
    cu = (np.arange(nb) + 0.5) / nb * 2.0 - 1.0
    uu, vv = np.meshgrid(cu, cu, indexing='xy')
    centers = _octa_decode_np(uu.reshape(-1), vv.reshape(-1))  # iv*nb+iu

    f = 16 * nb
    su = (np.arange(f) + 0.5) / f * 2.0 - 1.0
    gu, gv = np.meshgrid(su, su, indexing='xy')
    dirs = _octa_decode_np(gu.reshape(-1), gv.reshape(-1))
    iu = np.clip(((gu.reshape(-1) * 0.5 + 0.5) * nb).astype(np.int32),
                 0, nb - 1)
    iv = np.clip(((gv.reshape(-1) * 0.5 + 0.5) * nb).astype(np.int32),
                 0, nb - 1)
    bins = iv * nb + iu
    chord = np.linalg.norm(dirs - centers[bins], axis=-1)
    cmax = np.zeros(nb * nb, np.float64)
    np.maximum.at(cmax, bins, chord)
    return centers.astype(np.float32), (cmax * 1.05 + 1e-3).astype(
        np.float32)


@torch.no_grad()
def bake_vis_cache(pg: PackedSDFGrid, nb: int = VIS_NB, n_steps: int = 16,
                   apex_pad: float = 0.0) -> PackedSDFGrid:
    """Bake the per-cell direction-binned visibility cache.

    For every coarse NODE c and octa bin b, cone-march the coarse grid
    from t = T0 to past the aabb exit along the bin's center direction
    with margin(t) = 0.5*c_diag (apex offset: a launch origin binned to
    the node is within half a coarse cell) + t*chord_b (the bin's angular
    width) + 0.25*c_diag (interpolant error).  Bit == 1 certifies that
    every ray in the (node, bin) cone misses the surface over [T0, its
    aabb exit]; 0 means uncertain (the trace falls back to the coarse
    march).  The 32 bins of one word are marched together."""
    sc = _trace_scales(pg)
    rc = pg.coarse_rows.shape[0]
    dev = pg.aabb.device
    lo, hi = pg.aabb[0], pg.aabb[1]
    ax = torch.linspace(0.0, 1.0, rc, dtype=torch.float32, device=dev)
    nodes01 = torch.stack(torch.meshgrid(ax, ax, ax, indexing='ij'),
                          -1).reshape(-1, 3)
    nodes = lo + nodes01 * (hi - lo)                       # [rc^3,3]
    nn = nodes.shape[0]

    centers_np, chords_np = _octa_bin_table(nb)
    centers = torch.as_tensor(centers_np, device=dev)
    chords = torch.as_tensor(chords_np, device=dev)
    # 0.5*c_diag apex offset + apex_pad (callers reserve 2*unit_size so
    # get_lights may key the cache row on the pre-offset surface point)
    # + 0.25*c_diag interpolant error
    base_margin = 0.75 * sc['c_diag'] + apex_pad
    c_cap = 12.0 * sc['c_cell']
    t0 = sc['t0_max']
    shifts = torch.arange(32, dtype=torch.int64, device=dev)[:, None]
    words = []
    for w0 in range(0, nb * nb, 32):
        dvec = centers[w0:w0 + 32, None, :]                # [32,1,3]
        chord = chords[w0:w0 + 32, None]                   # [32,1]
        t = torch.full((32, nn), t0, dtype=torch.float32, device=dev)
        blocked = torch.zeros((32, nn), dtype=torch.bool, device=dev)
        cleared = torch.zeros((32, nn), dtype=torch.bool, device=dev)
        for _ in range(n_steps):
            pos = nodes[None] + dvec * t[..., None]
            pos_c = torch.minimum(torch.maximum(pos, lo), hi)
            # the clamped tap plus `out` in the margin keeps the test
            # sound past the aabb boundary (an un-clamped tap reads 1.0
            # outside and would certify rays that re-graze the interior)
            out = torch.linalg.norm(pos - pos_c, dim=-1)
            d = packed_trilinear_tap(pg.coarse_rows, pg.aabb,
                                     pos_c.reshape(-1, 3)).reshape(32, nn)
            margin = base_margin + t * chord + out
            eff = d - margin
            # every cone ray is surely outside the aabb: certified exit
            done_clear = out > (base_margin + t * chord)
            cleared = cleared | (~blocked & done_clear)
            blocked = blocked | (~cleared & (eff <= 0.0))
            step = torch.clamp(eff * 0.9, 0.1 * sc['c_cell'], c_cap)
            t = torch.where(blocked | cleared, t, t + step)
        clear = cleared & ~blocked                         # [32, nn]
        words.append(torch.sum(clear.long() << shifts, 0))  # bin = w*32+bit
    vis_rows = torch.stack(words, -1).reshape(rc, rc, rc, nb * nb // 32)
    return PackedSDFGrid(mid_rows=pg.mid_rows, blocks=pg.blocks,
                         coarse_rows=pg.coarse_rows, aabb=pg.aabb,
                         reso=pg.reso, vis_rows=vis_rows, vis_pad=apex_pad)


def _hat_axis(loc, want_grad: bool = False):
    """loc [N,1] in [0,3] -> hat weights [N,4] over node offsets 0..3 (and
    d/dloc if asked): linear B-spline interpolation weights."""
    ks = device_constant('hat_ks', lambda: np.arange(4.0), loc.device,
                         loc.dtype)
    t = loc - ks
    w = torch.clamp(1.0 - t.abs(), min=0.0)
    if not want_grad:
        return w, None
    g = torch.where(t.abs() < 1.0, -torch.sign(t), torch.zeros_like(t))
    return w, g


def block_tap(pg: PackedSDFGrid, pts, want_grad: bool = False):
    """Full-resolution trilinear value (and world gradient) at [N,3]
    points from ONE gathered 4^3 corner-block row per point."""
    r = pg.reso
    nb = (r + 2) // 3
    lo, hi = pg.aabb[0], pg.aabb[1]
    u01 = (pts - lo) / (hi - lo)
    inside = torch.all((u01 >= 0.0) & (u01 <= 1.0), dim=-1)
    x = torch.clamp(u01, 0.0, 1.0) * (r - 1.0)               # node coords
    c = torch.clamp(x.long(), 0, r - 2)                      # cell
    b = torch.clamp(c // 3, max=nb - 1)
    idx = (b[:, 0] * nb + b[:, 1]) * nb + b[:, 2]
    rw = torch.index_select(
        pg.blocks, 0, torch.clamp(idx, 0, pg.blocks.shape[0] - 1)).float()
    locf = x - 3.0 * b.to(x.dtype)                           # [N,3] in [0,3]
    wx, gx = _hat_axis(locf[:, 0:1], want_grad)
    wy, gy = _hat_axis(locf[:, 1:2], want_grad)
    wz, gz = _hat_axis(locf[:, 2:3], want_grad)
    # per-axis contraction [N,64] -> [N,16] -> [N,4] -> [N]
    rwb = rw.reshape(-1, 4, 16)
    a = torch.sum(rwb * wx[:, :, None], 1)                   # [N,16] (y,z)
    ab = a.reshape(-1, 4, 4)
    bv = torch.sum(ab * wy[:, :, None], 1)                   # [N,4]  (z)
    val = torch.sum(bv * wz, -1)
    val = torch.where(inside, val, torch.ones_like(val))
    if not want_grad:
        return val, None
    scale = (r - 1.0) / (hi - lo)                            # [3]
    axg = torch.sum(rwb * gx[:, :, None], 1).reshape(-1, 4, 4)
    gxv = torch.sum(torch.sum(axg * wy[:, :, None], 1) * wz, -1)
    gyv = torch.sum(torch.sum(ab * gy[:, :, None], 1) * wz, -1)
    gzv = torch.sum(bv * gz, -1)
    return val, torch.stack([gxv, gyv, gzv], -1) * scale


def _cells(pg: PackedSDFGrid):
    """(m_cell, c_cell): the mid and coarse cell sizes as 0-dim float32
    tensors, computed from the aabb on its device (no host read)."""
    ext_mean = torch.mean(pg.aabb[1] - pg.aabb[0])
    return (ext_mean / (pg.mid_rows.shape[0] - 1),
            ext_mean / (pg.coarse_rows.shape[0] - 1))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _newton_step(t, dv, g, dirs, lo, hi):
    """One clamped Newton update of t on an interpolant with value dv and
    gradient g; slopes below 0.1 in magnitude are pushed out to +-0.1."""
    slope = torch.sum(g * dirs, -1)
    slope = torch.where(
        slope.abs() < 0.1,
        torch.sign(slope) * 0.1 + torch.where(
            slope == 0, torch.full_like(slope, 0.1),
            torch.zeros_like(slope)), slope)
    return _clip(t - dv / slope, lo, hi)


def _unit(g):
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                           min=1e-8)


def _fine_march(pg, o, d, t, t_exit, n_fine, hit_eps_m, step_scale,
                step_cap, m_cell):
    """Mid-grid march from t; returns (t, done, prev_step), all [N]."""
    n = o.shape[0]
    done = torch.zeros((n,), dtype=torch.bool, device=o.device)
    prev_step = (2.0 * m_cell).to(o.dtype).expand(n)
    for _ in range(n_fine):
        dd = packed_trilinear_tap(pg.mid_rows, pg.aabb, o + d * t[:, None])
        done = done | (dd < hit_eps_m) | (t > t_exit)
        step = torch.minimum(torch.maximum(dd, hit_eps_m * 0.5) * step_scale,
                             step_cap)
        t = torch.where(done, t, t + step)
        prev_step = torch.where(done, prev_step, step)
    return t, done, prev_step


def sphere_trace_packed(pg: PackedSDFGrid, rays_o, rays_d,
                        n_coarse: int = 12, n_fine: int = 10,
                        n_bisect: int = 4, n_polish: int = 2,
                        step_scale: float = 0.9, max_dist: float = 4.0):
    """Coarse-to-fine sphere trace on the packed multi-resolution grid.

    Same contract as sphere_trace.  Phase 1 leaps through empty space on
    the coarse grid with steps of ``min(scale*d_c, cap) - coarse_diag``
    (Lipschitz-safe); phase 2 marches the mid grid; phase 3 bisects on the
    mid grid; phase 4 polishes the crossing with clamped Newton steps on
    the full-resolution block interpolant and takes its analytic gradient
    as the normal."""
    n = rays_o.shape[0]
    m_cell, c_cell = _cells(pg)
    c_diag = SQRT3 * c_cell
    hit_eps_m = 0.75 * m_cell
    step_cap = 4.0 * m_cell        # distrust the baked field (non-metric)
    c_cap = 8.0 * c_cell
    switch = c_diag + 2.0 * m_cell  # the coarse grid can't resolve closer

    # ray/aabb entry AND exit: nothing can be hit past the exit
    ra, rb = _slab(pg.aabb, rays_o, rays_d)
    t = torch.clamp(torch.max(torch.minimum(ra, rb), -1).values, min=0.0)
    t_exit = torch.clamp(torch.min(torch.maximum(ra, rb), -1).values,
                         max=max_dist)

    done = torch.zeros((n,), dtype=torch.bool, device=rays_o.device)
    for _ in range(n_coarse):
        d = packed_trilinear_tap(pg.coarse_rows, pg.aabb,
                                 rays_o + rays_d * t[:, None])
        done = done | (d < switch) | (t > t_exit)
        step = torch.minimum(step_scale * d, c_cap) - c_diag
        t = torch.where(done, t, t + torch.clamp(step, min=0.0))

    t, done, prev_step = _fine_march(pg, rays_o, rays_d, t, t_exit, n_fine,
                                     hit_eps_m, step_scale, step_cap, m_cell)
    d_end = packed_trilinear_tap(pg.mid_rows, pg.aabb,
                                 rays_o + rays_d * t[:, None])
    hit = done & (d_end < 2.0 * hit_eps_m) & (t <= t_exit)

    lo = torch.clamp(t - torch.maximum(prev_step, 2.0 * m_cell), min=0.0)
    hi = t
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        go_low = packed_trilinear_tap(
            pg.mid_rows, pg.aabb, rays_o + rays_d * mid[:, None]) > 0.0
        lo, hi = torch.where(go_low, mid, lo), torch.where(go_low, hi, mid)

    # full-resolution polish: the mid-grid crossing can sit up to ~m_cell
    # from the full-res crossing (outside [lo, hi]), so clamped Newton
    # steps on the block interpolant finish the job; the LAST iteration's
    # block row also supplies the normal
    t_mid = 0.5 * (lo + hi)
    b_lo, b_hi = t_mid - 2.0 * m_cell, t_mid + 2.0 * m_cell
    t = t_mid
    for _ in range(max(n_polish - 1, 0)):
        dv, g = block_tap(pg, rays_o + rays_d * t[:, None], want_grad=True)
        t = _newton_step(t, dv, g, rays_d, b_lo, b_hi)
    dv, g = block_tap(pg, rays_o + rays_d * t[:, None], want_grad=True)
    t_ref = _newton_step(t, dv, g, rays_d, b_lo, b_hi)[:, None]
    hit2 = hit[:, None]
    t_final = torch.where(hit2, t_ref, torch.full_like(t_ref, MISS_DEPTH))
    inters = rays_o + rays_d * torch.where(hit2, t_ref,
                                           torch.zeros_like(t_ref))
    normals = _flip_to_face(_unit(g), rays_d)
    return inters, normals, t_final, hit


# ---------------------------------------------------------------------------
# budgeted secondary trace: dense coarse classification + compacted refine
# ---------------------------------------------------------------------------
#
# The stage-2 shader fires ~1.8M secondary rays per step.  Most of them
# only need the BINARY answer (miss -> environment lookup); hit position
# and normal matter only for the rays that feed the inner-light MLP.  So:
#
#   phase A (all N rays): an analytic launch-corridor test with one coarse
#     probe, the baked visibility cache, and coarse sphere-trace leaps for
#     the rays neither certifies.  The leap margin makes the
#     classification conservative under the SDF's Lipschitz bound.
#   phase B (compacted M candidate rays): mid-grid march + Newton on the
#     mid interpolant + full-res block polish + analytic normal.
#
# Same hit semantics as sphere_trace_packed; results return compacted,
# with the (src, dest, slot_mask) mapping, so that the caller can run the
# inner-light MLP on the compacted rows.


class CompactSecondary(NamedTuple):
    """All refined quantities stay compacted ([M] slots); callers expand
    hit/depth in ONE wide scatter_back together with their per-slot
    payload (see mc_shading.get_lights)."""
    src: torch.Tensor        # [M] flat source ray per slot
    slot_mask: torch.Tensor  # [M] slot holds a real candidate
    dest: torch.Tensor       # [N] slot per ray (M = dropped/miss)
    inters: torch.Tensor     # [M,3] refined hit points
    normals: torch.Tensor    # [M,3] refined hit normals (flipped)
    view_out: torch.Tensor   # [M,3] -d of the compacted rays
    hit_m: torch.Tensor      # [M] refined hit verdict per slot
    depth_m: torch.Tensor    # [M] refined depth (miss = MISS_DEPTH)
    cand: torch.Tensor       # [N] refinement-candidate mask
    a1_need: torch.Tensor    # [N] rays that needed the coarse march


def budget_slots(n: int, budget: float) -> int:
    """Static slot count of a budget fraction: multiples of 128, >= 128."""
    return max((int(n * budget) // 128) * 128, 128)


def _coarse_march(pg, o, d, t, t_exit, n_coarse, switch, step_scale, c_cap,
                  c_diag):
    """Coarse leaps from t; returns (t, near)."""
    near = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(n_coarse):
        dd = packed_trilinear_tap(pg.coarse_rows, pg.aabb, o + d * t[:, None])
        near = near | (dd < switch)
        done = near | (t > t_exit)
        step = torch.clamp(torch.minimum(step_scale * dd, c_cap) - c_diag,
                           min=0.0)
        t = torch.where(done, t, t + step)
    return t, near


def sphere_trace_budget(pg: PackedSDFGrid, rays_o, rays_d, m: int,
                        h0=None, n_coarse: int = 8, n_fine: int = 7,
                        n_newton: int = 2, n_polish: int = 2,
                        step_scale: float = 0.9, max_dist: float = 4.0,
                        c_cap_cells: float = 12.0,
                        cert_factor: float = 0.6, h_min: float = 0.12,
                        a1_budget: float = 0.0,
                        vis_rows_flat=None, mesh=None) -> CompactSecondary:
    """Budgeted two-phase secondary trace (see the comment above).

    m: refinement budget (slots).  h0: optional [N] cosine between the
    ray and the launch-surface normal (rays originate ON the traced
    surface).  With h0 the launch shell is crossed ANALYTICALLY (the
    surface is locally its tangent plane, so the ray clears the
    coarse-march resolvability band ``switch`` at t0 = (arm - height(0))
    / h0) and ONE coarse probe at t0 validates the plane assumption.
    Tangent rays (h0 < h_min) go straight to refinement; h0 <= 0 rays
    (into the surface) are misses.  Callers offset rays_o by ~1.5 mid
    cells along the surface normal (see get_lights).

    vis_rows_flat: caller-supplied cache rows, [N, 8] (one per ray) or
    [P, 8] with N = P * sn (one per surface point, its sn rays
    consecutive).

    mesh: on an active mesh (parallel/sharding.py) the rays are this
    rank's slice of the global set and ``m`` the global budget: both
    compactions keep what the global prefix sum keeps, so the returned
    slots (src.shape[0] of them) are this rank's share of the global
    ones."""
    n = rays_o.shape[0]
    dev = rays_o.device
    n_all = n * mesh.size if mesh is not None and mesh.distributed else n
    m_cell, c_cell = _cells(pg)
    c_diag = SQRT3 * c_cell
    hit_eps_m = 0.75 * m_cell
    step_cap = 4.0 * m_cell
    c_cap = c_cap_cells * c_cell
    switch = c_diag + 2.0 * m_cell

    ra, rb = _slab(pg.aabb, rays_o, rays_d)
    t_enter = torch.clamp(torch.max(torch.minimum(ra, rb), -1).values,
                          min=0.0)
    t_exit = torch.clamp(torch.min(torch.maximum(ra, rb), -1).values,
                         max=max_dist)

    # ---- phase A0: analytic launch-shell crossing + one-probe check ----
    arm = 1.25 * switch
    delta = 1.5 * m_cell          # callers' normal-offset height
    if h0 is not None:
        into = h0 <= 0.0
        hs = torch.clamp(h0, min=h_min)
        t0 = torch.minimum((arm - delta) / hs, t_exit)
        # probe the COARSE grid with a 0.25*c_diag conservative margin
        d_probe = packed_trilinear_tap(
            pg.coarse_rows, pg.aabb, rays_o + rays_d * t0[:, None]) \
            - 0.25 * c_diag
        pred = delta + t0 * torch.clamp(h0, min=0.0)
        clear = (h0 >= h_min) & (
            d_probe > cert_factor * torch.minimum(pred, arm))
        cand0 = ~clear & ~into
    else:
        t0 = t_enter
        clear = torch.ones((n,), dtype=torch.bool, device=dev)
        cand0 = torch.zeros((n,), dtype=torch.bool, device=dev)

    # ---- phase A-cache: direction-binned visibility certification ----
    # a baked (cell, octa-bin) bit certifies the cone over [T0, exit]; the
    # A0 probe covers [0, t0] analytically and, when t0 < T0, one extra
    # margined probe at T0 ball-covers the [t0, T0] gap.
    use_cache = ((pg.vis_rows is not None or vis_rows_flat is not None)
                 and h0 is not None and 0.0 < a1_budget < 1.0)
    if use_cache:
        rc_t0max = 2.0 * (arm - delta)
        bins = octa_bin(rays_d)
        wsel = bins >> 5
        if vis_rows_flat is not None and vis_rows_flat.shape[0] != n:
            sn = n // vis_rows_flat.shape[0]
            word = torch.gather(vis_rows_flat, 1,
                                wsel.reshape(-1, sn)).reshape(-1)
        else:
            if vis_rows_flat is not None:
                vrow = vis_rows_flat
            else:
                rv = pg.vis_rows.shape[0]
                lo_, hi_ = pg.aabb[0], pg.aabb[1]
                u01 = torch.clamp((rays_o - lo_) / (hi_ - lo_), 0.0, 1.0)
                ci = torch.clamp(torch.round(u01 * (rv - 1)).long(),
                                 0, rv - 1)
                flat = (ci[:, 0] * rv + ci[:, 1]) * rv + ci[:, 2]
                vrow = torch.index_select(
                    pg.vis_rows.reshape(-1, 8), 0,
                    torch.clamp(flat, 0, rv ** 3 - 1))         # [N,8]
            word = torch.gather(vrow, 1, wsel[:, None])[:, 0]
        cache_clear = ((word >> (bins & 31)) & 1) > 0
        gap = torch.clamp(rc_t0max - t0, min=0.0)
        d2 = packed_trilinear_tap(pg.coarse_rows, pg.aabb,
                                  rays_o + rays_d * rc_t0max) - 0.25 * c_diag
        corridor = (gap <= 0.0) | (d_probe + torch.clamp(d2, min=0.0) > gap)
        certified = clear & cache_clear & corridor
    else:
        certified = torch.zeros((n,), dtype=torch.bool, device=dev)
    need = clear & ~certified

    # ---- phase A1: coarse classification of the un-certified rays ----
    zero = torch.zeros((), dtype=rays_o.dtype, device=dev)
    if use_cache:
        srcA, maskA, destA = compact_indices_mesh(
            need, budget_slots(n_all, a1_budget), mesh)
        ma = srcA.shape[0]
        tc0 = torch.maximum(t0, t_enter)
        payA = torch.cat([rays_o, rays_d, tc0[:, None], t_exit[:, None]], -1)
        pA = torch.index_select(payA, 0, torch.clamp(srcA, 0, n - 1))
        tA, nearA = _coarse_march(pg, pA[:, 0:3], pA[:, 3:6], pA[:, 6],
                                  pA[:, 7], n_coarse, switch, step_scale,
                                  c_cap, c_diag)
        candA = nearA | (tA <= pA[:, 7])
        back = scatter_back(torch.stack([tA, candA.to(tA.dtype)], -1),
                            destA, src=srcA, slot_mask=maskA)     # [N,2]
        # budget overflow: un-marched rays become candidates from tc0
        # (the fine march takes over from the launch corridor)
        overflow = need & (destA >= ma)
        cand = cand0 | (need & ((back[:, 1] > 0.5) | overflow))
        t = torch.where(cand0, zero, torch.where(overflow, tc0, back[:, 0]))
    else:
        tc0 = torch.where(need, torch.maximum(t0, t_enter), t_exit + 1.0)
        t, near = _coarse_march(pg, rays_o, rays_d, tc0, t_exit, n_coarse,
                                switch, step_scale, c_cap, c_diag)
        # candidates: launch-uncertified rays (refine from t=0), plus clear
        # rays whose coarse march got near the surface or ran out of
        # steps while still inside the grid (conservative)
        cand = cand0 | (need & (near | (t <= t_exit)))
        t = torch.where(cand0, zero, t)

    # ---- compact candidates into the refinement budget ----
    src, slot_mask, dest = compact_indices_mesh(cand, m, mesh)
    m = src.shape[0]
    payload = torch.cat([rays_o, rays_d, t[:, None], t_exit[:, None]], -1)
    pm = torch.index_select(payload, 0, torch.clamp(src, 0, n - 1))  # [M,8]
    om, dm = pm[:, 0:3], pm[:, 3:6]
    tm, txm = pm[:, 6], pm[:, 7]

    # ---- phase B: compacted mid march + Newton + full-res polish ----
    tm, done, prev_step = _fine_march(pg, om, dm, tm, txm, n_fine, hit_eps_m,
                                      step_scale, step_cap, m_cell)
    # Newton on the mid interpolant inside the last-step bracket
    lo = torch.clamp(tm - torch.maximum(prev_step, 2.0 * m_cell), min=0.0)
    hi = tm + 0.5 * m_cell
    d_end = torch.zeros((m,), dtype=rays_o.dtype, device=dev)
    for _ in range(n_newton):
        d_end, g = packed_trilinear_tap(pg.mid_rows, pg.aabb,
                                        om + dm * tm[:, None],
                                        want_grad=True)
        slope = torch.sum(g * dm, -1)
        slope = torch.where(
            slope.abs() < 0.1,
            torch.where(slope < 0, torch.full_like(slope, -0.1),
                        torch.full_like(slope, 0.1)), slope)
        tm = _clip(tm - d_end / slope, lo, hi)
    hit_m = done & (d_end < 2.0 * hit_eps_m) & (tm <= txm)

    # full-res polish: the scheme of sphere_trace_packed
    b_lo, b_hi = tm - 2.0 * m_cell, tm + 2.0 * m_cell
    t_p = tm
    for _ in range(max(n_polish - 1, 0)):
        dv, g = block_tap(pg, om + dm * t_p[:, None], want_grad=True)
        t_p = _newton_step(t_p, dv, g, dm, b_lo, b_hi)
    dv, g = block_tap(pg, om + dm * t_p[:, None], want_grad=True)
    t_ref = _newton_step(t_p, dv, g, dm, b_lo, b_hi)

    inters_m = om + dm * torch.where(hit_m, t_ref,
                                     torch.zeros_like(t_ref))[:, None]
    normals_m = _flip_to_face(_unit(g), dm)
    depth_m = torch.where(hit_m, t_ref, torch.full_like(t_ref, MISS_DEPTH))
    return CompactSecondary(src=src, slot_mask=slot_mask, dest=dest,
                            inters=inters_m, normals=normals_m,
                            view_out=-dm, hit_m=hit_m, depth_m=depth_m,
                            cand=cand, a1_need=need)
