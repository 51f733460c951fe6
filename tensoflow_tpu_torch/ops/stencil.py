"""Fused VM-field stencil MLP head: plain PyTorch version + Hopper kernels.

Counterpart of tensoflow_tpu/ops/pallas_stencil.py.  Per row it takes 3
plane patches (4x4 texels, [N, 16C]) and 3 line patches (4 texels,
[N, 4C]) per mip branch, the fraction/sigma lanes ``fr`` [N, 64] and the
centre-point PE, and computes the 7-point FD stencil's shifted bilinear
taps (hat weights over the patch slots, factorised separable form), the
per-plane plane*line products plus the stencil-point PEs (trig addition,
see tenso_sdf._pe_rot_table) as one X row, ``z = X.W0 + b0``,
softplus(beta=100) and layer 1: the full head at the centre point, the
sdf column only at the 6 offset points.

  * ``stencil_head_plain`` — plain PyTorch on the same inputs; autograd
    through it is the backward's oracle.  The CPU path and the tests use
    it.
  * ``StencilHead`` — autograd.Function whose forward launches
    csrc/stencil_head_fwd.cu (saving the tap variants V) and whose
    backward launches csrc/stencil_head_bwd.cu.  CUDA tensors only.
    bf16 patches take the wgmma kernels, which read their weights in the
    tensor cores' shared-memory operand layout (``tile_matrix``,
    ``pack_weights_bf16``); anything else the float32 kernels
    (register-blocked FMAs over weights streamed through shared memory,
    zero padded by ``pack_weights_f32``).
  * ``GeneralStencilHead`` — the same on csrc/stencil_head_general.cu,
    for the widths the fast kernels are not built for (``head_route``:
    3C+E >= 144, H > 256, O > 144, and in bf16 C % 4 != 0 or E > 32),
    any width up to 3C+E <= 2048, H <= 4096, O <= 4096.
  * ``stencil_head`` / ``point_head`` — the public wrappers: the plain
    version for CPU tensors, the kernels for CUDA tensors (no fallback).

bf16 rounding points follow the TPU kernel: the [N, C]-wide madds run in
the patch dtype, the [N, 1] weight products are f32 and cast once, V is
stored in the compute dtype, and h is cast to it before layer 1.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..fields.mlp import softplus100
from . import cuda_build
from .tensor_field import FRAC_STRIDE as FS, MAT_MODE, VEC_MODE

_PVAR_SIGN = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))
_LVAR_SIGN = (0, 1, -1)
_STENCIL = ((None, 0), (0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))

# launches of each kernel wrapper (read by chip_smoke.py): the fast
# kernels', and beside them the general-width kernels'
LAUNCHES = {'stencil_head_fwd': 0, 'stencil_head_bwd': 0}
GENERAL_LAUNCHES = {'stencil_head_general_fwd': 0,
                    'stencil_head_general_bwd': 0}


def reset_launches():
    for d in (LAUNCHES, GENERAL_LAUNCHES):
        for k in d:
            d[k] = 0


def _stencil_mapping():
    """mapping[s][i] = (plane_variant, line_variant) for stencil point s."""
    out = []
    for d, sign in _STENCIL:
        row = []
        for i in range(3):
            a, b = MAT_MODE[i]
            c = VEC_MODE[i]
            pi, li = 0, 0
            if d == a:
                pi = 1 if sign > 0 else 2
            elif d == b:
                pi = 3 if sign > 0 else 4
            elif d == c:
                li = 1 if sign > 0 else 2
            row.append((pi, li))
        out.append(tuple(row))
    return tuple(out)


MAPPING7 = _stencil_mapping()
MAPPING1 = (((0, 0), (0, 0), (0, 0)),)


def vw(S: int, C: int) -> int:
    """Saved-variant row width: (n_pv + n_lv) * 3 planes * C."""
    return ((5 + 3) if S > 1 else 2) * 3 * C


# Widths the bf16 kernels are built for (csrc/stencil_sm90.cuh): hidden
# width, X row width (its last column is all ones, so 3C+E < XP), layer-1
# width, X rows per tile.
HP, XP, OP, MR = 256, 144, 144, 128


def tile_matrix(mat):
    """[A, B] (both multiples of 8) -> flat tensor in the operand layout of
    the bf16 kernels: 8x8 blocks of 64 contiguous elements, block (a/8, b/8)
    at ((a/8) * B/8 + b/8) * 64, element (a, b) at + (a%8)*8 + b%8."""
    a, b = mat.shape
    if a % 8 or b % 8:
        raise ValueError(f'tile_matrix: {a}x{b} is not a multiple of 8x8')
    return mat.reshape(a // 8, 8, b // 8, 8).permute(0, 2, 1, 3).reshape(-1)


def untile_matrix(flat, a, b):
    """Inverse of tile_matrix."""
    return flat.reshape(a // 8, b // 8, 8, 8).permute(0, 2, 1, 3).reshape(a, b)


def pack_weights_bf16(w0, b0, w1):
    """The bf16 kernels' weight operands from W0 [3C+E, H], b0 [H] and
    W1 [H, O]: (W0 zero padded to [XP, HP] and tiled, b0 [HP] f32,
    W1^T zero padded to [OP, HP] and tiled, column 0 of W1 [HP] f32 rounded
    to bf16).  Zero pads change nothing: a pad column of z meets a zero row
    of W1, a pad column of X a zero row of W0."""
    k0, h = w0.shape
    o = w1.shape[1]
    if k0 >= XP or h > HP or o > OP:
        raise ValueError(f'stencil head (bf16 kernels): 3C+E={k0} must be '
                         f'< {XP}, H={h} <= {HP}, O={o} <= {OP}')
    bf = torch.bfloat16
    w0p = w0.new_zeros((XP, HP), dtype=bf)
    w0p[:k0, :h] = w0.to(bf)
    w1p = w1.new_zeros((OP, HP), dtype=bf)
    w1p[:o, :h] = w1.t().to(bf)
    b0p = b0.new_zeros((HP,), dtype=torch.float32)
    b0p[:h] = b0.float()
    return (tile_matrix(w0p).contiguous(), b0p,
            tile_matrix(w1p).contiguous(), w1p[0].float().contiguous())


def tile_rows(S: int) -> int:
    """Rows of the head's input per tile of the bf16 kernels: 16 rows x
    (7 stencil points + 1 pad group) or 128 single points = MR X rows."""
    return 16 if S > 1 else MR


def workspace_bytes_bf16(S: int, n_sm: int, n: int) -> int:
    """Bytes of the bf16 backward's workspace, as csrc/stencil_head_bwd.cu
    lays it out: per tile X [MR, XP], dz [MR, HP], the centre h
    [tile_rows, HP] and the rounded centre cotangent [tile_rows, OP] in
    bf16, then one f32 partial per block of dw1row [HP], dW0^T [HP, XP]
    and dW1 [HP, OP]; each piece padded to 256 bytes."""
    tn = tile_rows(S)
    tiles = -(-n // tn)
    blocks = min(tiles, n_sm)
    blocks_dw1 = min(-(-tiles * tn // MR), n_sm)
    pieces = [tiles * MR * XP * 2, tiles * MR * HP * 2, tiles * tn * HP * 2,
              tiles * tn * OP * 2, blocks * HP * 4, blocks * HP * XP * 4,
              blocks_dw1 * HP * OP * 4]
    return sum(-(-p // 256) * 256 for p in pieces)


# Widths the float32 kernels are built for (csrc/stencil_f32.cuh): hidden
# width, X row width (3C+E < F32_XP: the backward's workspace X carries a
# ones column last, whose dW0 row is db0), layer-1 width; rows of the
# head's input per tile and X rows per tile (16 rows x 7 stencil points;
# S=1 uses the first 16); threads and row pitch of the transposed X / dz /
# dX tiles in shared memory; weight rows per ring chunk and ring slots.
F32_HP, F32_XP, F32_OP = 256, 144, 144
F32_TR, F32_MT, F32_MS = 16, 112, 116
F32_FKC, F32_FSTAGE = 24, 2          # forward ring: rows a chunk, slots
F32_BKC, F32_BSTAGE = 32, 2          # backward ring
F32_AKC, F32_ASTAGE = 32, 2          # weight-gradient ring
F32_AKMAX = 1024                     # rows a weight-gradient split at most
F32_THREADS = {'fwd': 448, 'bwd': 448, 'atb': 288}
# blocks per SM the kernels are built for (__launch_bounds__); the card's
# own count comes from stencil_head_{fwd,bwd}_f32_info
F32_BLOCKS_PER_SM = {'fwd': 2, 'bwd': 1, 'atb': 2}
SMEM_PER_SM = 233472         # bytes of shared memory an H100 SM holds
SMEM_PER_BLOCK = 232448      # the most one block may ask for
SMEM_RESERVED = 1024         # the runtime's own share of each block


def pack_weights_f32(w0, b0, w1):
    """The float32 kernels' weight operands from W0 [3C+E, H], b0 [H] and
    W1 [H, O]: (W0 zero padded to [F32_XP, F32_HP], b0 [F32_HP], W1 zero
    padded to [F32_HP, F32_OP], column 0 of W1 [F32_HP]), all float32.
    Zero pads change nothing: a pad column of z meets a zero row of W1 and
    a zero w1row entry, a pad column of X a zero row of W0."""
    k0, h = w0.shape
    o = w1.shape[1]
    if k0 >= F32_XP or h > F32_HP or o > F32_OP:
        raise ValueError(f'stencil head (float32 kernels): 3C+E={k0} must be '
                         f'< {F32_XP}, H={h} <= {F32_HP}, O={o} <= {F32_OP}')
    f = torch.float32
    w0p = w0.new_zeros((F32_XP, F32_HP), dtype=f)
    w0p[:k0, :h] = w0.to(f)
    w1p = w1.new_zeros((F32_HP, F32_OP), dtype=f)
    w1p[:h, :o] = w1.to(f)
    b0p = b0.new_zeros((F32_HP,), dtype=f)
    b0p[:h] = b0.to(f)
    return w0p, b0p, w1p, w1p[:, 0].contiguous()


def f32_tiles(n: int) -> int:
    """Row tiles of the float32 kernels over n rows (the last one ragged)."""
    return -(-n // F32_TR)


def f32_grid(kernel: str, n_sm: int, n: int,
             per_sm: int | None = None) -> int:
    """Persistent blocks of a float32 row kernel ('fwd' or 'bwd'): one per
    tile, at most per_sm (default: what the kernel is built for) a SM."""
    per_sm = F32_BLOCKS_PER_SM[kernel] if per_sm is None else per_sm
    return min(f32_tiles(n), per_sm * n_sm)


def f32_splits(n_sm: int, k: int):
    """(splits, rows per split) of a float32 weight-gradient product over
    k rows: about 256 rows or more a split, one split per SM unless that
    would put more than F32_AKMAX rows in a split (a longer float32 chain
    puts the bias gradient 1e-5 from float64), each a multiple of the
    ring's 32 rows."""
    ns = max(min(-(-k // 256), n_sm), -(-k // F32_AKMAX))
    chunk = -(-(-(-k // ns)) // F32_AKC) * F32_AKC
    return -(-k // chunk), chunk


def f32_smem_bytes(kernel: str) -> int:
    """Dynamic shared memory of a float32 kernel, as stencil_f32.cuh sizes
    it: fwd X^T [XP, MS], two W0/W1 chunks of [24, OP], the centre h^T
    [HP, TR]; bwd X^T / dX^T [XP, MS], one half's dz^T [128, MS], two
    chunks of [32, XP], the centre cotangent^T [OP, TR], dh [TR, HP] and
    each thread's 16 dw1row sums; atb two A and B chunks
    of [32, XP] and [32, 128]."""
    bring = F32_BSTAGE * F32_BKC
    floats = {
        'fwd': F32_XP * F32_MS + F32_FSTAGE * F32_FKC * F32_OP
        + F32_HP * F32_TR,
        'bwd': (F32_XP + 128) * F32_MS + bring * F32_XP + F32_OP * F32_TR
        + F32_TR * F32_HP + 16 * F32_THREADS['bwd'],
        'atb': F32_ASTAGE * F32_AKC * (F32_XP + 128)}[kernel]
    return 4 * floats


def workspace_bytes_f32(S: int, n_sm: int, n: int,
                        per_sm: int | None = None) -> int:
    """Bytes of the float32 backward's workspace, as
    csrc/stencil_head_bwd.cu lays it out: per tile X [S*TR, XP], dz
    [S*TR, HP], the centre h [TR, HP] and cotangent [TR, OP], then one
    dw1row partial [HP] per row block and the split-K partials of dW0 and
    dW1^T [splits, XP, HP]; each piece padded to 256 bytes."""
    tiles = f32_tiles(n)
    rows = tiles * F32_TR
    blocks = f32_grid('bwd', n_sm, n, per_sm)
    part = F32_XP * F32_HP * 4
    pieces = [rows * S * F32_XP * 4, rows * S * F32_HP * 4,
              rows * F32_HP * 4, rows * F32_OP * 4, blocks * F32_HP * 4,
              f32_splits(n_sm, rows * S)[0] * part,
              f32_splits(n_sm, rows)[0] * part]
    return sum(-(-p // 256) * 256 for p in pieces)


# The general-width kernels (csrc/stencil_head_general.cu): threads of a
# row block (28 row groups x 16 column groups), hidden columns a pass,
# floats of a forward / backward ring slot, dX columns a register window;
# rows of the head's input a tile at most (by S); rows a weight-gradient
# partial sums at most; row blocks a SM the kernels are built for; the
# widths they take.
GEN_NT, GEN_HW, GEN_FSLOT, GEN_BSLOT, GEN_DXW = 448, 128, 3960, 5120, 160
GEN_STAGE = 2                        # ring slots of both row kernels
GEN_DHG = 4                          # K groups of the backward's dh at most
GEN_TRMAX = {1: 112, 7: 16}
GEN_AKMAX = 1024
GEN_BLOCKS_PER_SM = {'fwd': 2, 'bwd': 1}
GEN_KMAX, GEN_HMAX, GEN_OMAX = 2048, 4096, 4096
PEW = 32             # PE columns the bf16 backward keeps in float32


def _r4(x: int) -> int:
    return -(-x // 4) * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fast_takes(bf16: bool, C: int, E: int, H: int, O: int) -> bool:
    """Whether the fast kernels are built for these widths (bf16: the
    wgmma kernels; otherwise the float32 FMA kernels)."""
    k0 = 3 * C + E
    if bf16:
        return C % 4 == 0 and k0 < XP and E <= PEW and H <= HP and O <= OP
    return k0 < F32_XP and H <= F32_HP and O <= F32_OP


def head_route(dtype, S: int, B: int, C: int, E: int, H: int,
               O: int) -> str:
    """The kernels a stencil head of these widths launches on the card:
    'fast' (stencil_head_fwd / _bwd.cu, built for the published widths)
    or 'general' (stencil_head_general.cu, any width up to 3C+E <=
    GEN_KMAX, H <= GEN_HMAX, O <= GEN_OMAX).  Raises past those."""
    if S not in (1, 7) or B not in (1, 2):
        raise ValueError(f'stencil head: S={S}, B={B} (S in 1, 7; B in 1, 2)')
    if fast_takes(dtype == torch.bfloat16, C, E, H, O):
        return 'fast'
    k0 = 3 * C + E
    if k0 <= GEN_KMAX and H <= GEN_HMAX and O <= GEN_OMAX:
        return 'general'
    raise ValueError(f'stencil head: 3C+E={k0} must be <= {GEN_KMAX}, '
                     f'H={H} <= {GEN_HMAX}, O={O} <= {GEN_OMAX} (the '
                     'general kernels\' limits)')


def gen_dims(C: int, E: int, H: int, O: int):
    """(K, K4, H4, O4) of the general kernels: X columns 3C+E, the
    workspace's X row width (a ones column at K, whose dW0 row is db0),
    hidden and layer-1 widths rounded up to 4 (the padded weights'
    widths)."""
    k = 3 * C + E
    return k, _r4(k + 1), _r4(H), _r4(O)


def gen_plan(S: int, C: int, E: int, H: int, O: int, tr: int) -> dict:
    """What the widths decide in the general kernels at tr rows a tile, as
    stencil_head_general.cu make_plan computes it: X rows m = S tr, the
    backward's X^T pitch ms and the forward's msf, tr rounded to 4; the
    forward's layer-1 split (g1 K groups of 4x8 units over owp = 8 cgp
    columns a pass, n1pass passes); the backward's dh split (gd groups)
    and dX windows (nwin)."""
    k, k4, h4, o4 = gen_dims(C, E, H, O)
    m = S * tr
    ms, trp = _r4(m) + 4, _r4(tr)
    rg1 = trp // 4
    cg1 = _cdiv(o4, 8)
    cgmax = min(GEN_NT // rg1, GEN_FSLOT // 32)
    n1pass = _cdiv(cg1, cgmax)
    cgp = _cdiv(cg1, n1pass)
    owp = 8 * cgp
    g1 = min(GEN_NT // (rg1 * cgp), GEN_FSLOT // (4 * owp))
    gd = min(GEN_NT // (trp // 4 * 16), ms // trp, GEN_DHG)
    return dict(K=k, K4=k4, H4=h4, O4=o4, TR=tr, M=m, MS=ms, MSF=_r4(m),
                TRP=trp,
                npass=_cdiv(h4, GEN_HW), rg1=rg1, cgp=cgp, owp=owp,
                n1pass=n1pass, g1=g1, kq1=GEN_FSLOT // (owp * g1), gd=gd,
                kqd=GEN_BSLOT // (GEN_HW * gd), nwin=_cdiv(k4, GEN_DXW),
                r0f=max(k4 * _r4(m), (g1 - 1) * trp * owp))


def gen_smem_bytes(kind: str, S: int, C: int, E: int, H: int, O: int,
                   tr: int) -> int:
    """Shared memory of a general kernel's block at tr rows a tile, as
    stencil_head_general.cu lays it out: fwd X^T [K4, MSF] (afterwards the
    layer-1 partials), a two-slot ring, the centre h^T [H4, TRP]; bwd X^T
    [K4, MS] (afterwards dX^T, for one dX window), one pass's dz^T
    [HW, MS], a two-slot ring, the centre cotangent^T [O4, TRP], one
    pass's dh [TRP, HW] and each warp's dw1row terms [NW, HW]."""
    p = gen_plan(S, C, E, H, O, tr)
    if kind == 'fwd':
        floats = p['r0f'] + GEN_STAGE * GEN_FSLOT + p['H4'] * p['TRP']
    else:
        floats = (p['K4'] * p['MS'] + GEN_HW * p['MS']
                  + GEN_STAGE * GEN_BSLOT + p['O4'] * p['TRP']
                  + p['TRP'] * GEN_HW + GEN_NT // 32 * GEN_HW)
    return 4 * floats


def gen_tile_rows(kind: str, S: int, C: int, E: int, H: int, O: int) -> int:
    """Rows of the head's input a general kernel's tile takes: the most
    (up to GEN_TRMAX[S]) whose block fits one SM's shared memory."""
    tr = GEN_TRMAX[S]
    while tr > 1 and gen_smem_bytes(kind, S, C, E, H, O, tr) > SMEM_PER_BLOCK:
        tr -= 1
    return tr


def gen_blocks_per_sm(kind: str, smem: int) -> int:
    """Row blocks of a general kernel a SM holds: what it is built for
    (GEN_BLOCKS_PER_SM, its registers' bound) unless shared memory holds
    fewer (1 KB of it reserved a block)."""
    return max(1, min(GEN_BLOCKS_PER_SM[kind],
                      SMEM_PER_SM // (smem + 1024)))


def gen_grid(kind: str, n_sm: int, S: int, C: int, E: int, H: int, O: int,
             n: int) -> int:
    """Persistent blocks of a general row kernel ('fwd' or 'bwd') over n
    rows: one per tile, at most gen_blocks_per_sm a SM."""
    tr = gen_tile_rows(kind, S, C, E, H, O)
    per_sm = gen_blocks_per_sm(kind, gen_smem_bytes(kind, S, C, E, H, O, tr))
    return min(_cdiv(n, tr), per_sm * n_sm)


def gen_splits(k: int):
    """(splits, rows a split) of a general weight-gradient product over k
    rows: at most GEN_AKMAX rows a split, a multiple of 32."""
    n0 = -(-k // GEN_AKMAX)
    chunk = -(-(-(-k // n0)) // 32) * 32
    return -(-k // chunk), chunk


def gen_workspace_bytes(S: int, C: int, E: int, H: int, O: int, n: int,
                        tr: int, grid: int) -> int:
    """Bytes of the general backward's workspace at grid row blocks, as
    stencil_head_general.cu lays it out: X [tiles S tr, K4], dz
    [tiles S tr, H4], the centre h [tiles tr, H4] and cotangent
    [tiles tr, O4], one dw1row partial [H4] a block, past one dX window a
    dX^T scratch [K4, MS] a block, the split partials of dW0
    [splits, K4, H4] and dW1 [splits, H4, O4]; each piece padded to 256
    bytes."""
    p = gen_plan(S, C, E, H, O, tr)
    k4, h4, o4 = p['K4'], p['H4'], p['O4']
    tiles = -(-n // tr)
    r0, r1 = tiles * S * tr, tiles * tr
    pieces = [r0 * k4, r0 * h4, r1 * h4, r1 * o4, grid * h4,
              grid * k4 * p['MS'] if p['nwin'] > 1 else 0,
              gen_splits(r0)[0] * k4 * h4, gen_splits(r1)[0] * h4 * o4]
    return sum(-(-4 * p // 256) * 256 for p in pieces)


def pack_weights_general(w0, b0, w1, cd):
    """The general kernels' weight operands from W0 [3C+E, H], b0 [H] and
    W1 [H, O], W0 and W1 rounded to the compute dtype cd: W0 [K4, H4], W0^T
    [H4, K4], b0 [H4], W1 [H4, O4], W1^T [O4, H4] and column 0 of W1 [H4],
    float32, zero padded (a pad column of z meets a zero row of W1 and a
    zero w1row entry, a pad column of X a zero row of W0)."""
    k0, h = w0.shape
    o = w1.shape[1]
    _, k4, h4, o4 = gen_dims(0, k0, h, o)
    f = torch.float32
    w0p = w0.new_zeros((k4, h4), dtype=f)
    w0p[:k0, :h] = w0.to(cd).to(f)
    w1p = w1.new_zeros((h4, o4), dtype=f)
    w1p[:h, :o] = w1.to(cd).to(f)
    b0p = b0.new_zeros((h4,), dtype=f)
    b0p[:h] = b0.to(f)
    return (w0p, w0p.t().contiguous(), b0p, w1p, w1p.t().contiguous(),
            w1p[:, 0].contiguous())


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _hat_terms(frac, sigma, sign):
    """[(k, weight [N,1])] for a clamped-bilinear lookup shifted by
    sign*sigma texels; only statically-possible taps for a static sigma."""
    if isinstance(sigma, (int, float)):
        s = float(sigma) * sign
        r = frac + s if s != 0.0 else frac
        ks = [k for k in (-1, 0, 1, 2) if s - 1.0 < k < s + 2.0]
    elif sign == 0:
        r, ks = frac, [0, 1]
    else:
        r, ks = frac + sign * sigma, [-1, 0, 1, 2]
    return [(k, torch.clamp(1.0 - torch.abs(r - k), min=0.0)) for k in ks]


def _acc(acc, t):
    return t if acc is None else acc + t


def _variants(P, L, fr, S, B, C, sigmas):
    """Blended stencil tap variants (PV 3x5 / LV 3x3 lists of [N, C] in the
    patch dtype), in the TPU kernel's factorised order."""
    bd = P[0].dtype
    n_pv = 5 if S > 1 else 1
    n_lv = 3 if S > 1 else 1
    PV = [[None] * n_pv for _ in range(3)]
    LV = [[None] * n_lv for _ in range(3)]
    for b in range(B):
        def f(j):
            return fr[:, b * FS + j:b * FS + j + 1]
        wgt = f(9)
        for i in range(3):
            pref = P[b * 3 + i]

            def slot(ku, kv):
                q = (ku + 1) * 4 + kv + 1
                return pref[:, q * C:(q + 1) * C]
            fu, fv = f(2 * i), f(2 * i + 1)
            if sigmas[b] is not None:
                su, sv, _ = sigmas[b][i]
            else:
                su, sv = f(10 + 2 * i), f(11 + 2 * i)
            wv0 = [(kv, (wgt * w).to(bd)) for kv, w in _hat_terms(fv, sv, 0)]
            wu0 = [(ku, (wgt * w).to(bd)) for ku, w in _hat_terms(fu, su, 0)]
            rv = {}
            for ku in ((0, 1) if n_pv == 1 else (-1, 0, 1, 2)):
                acc = None
                for kv, wv in wv0:
                    acc = _acc(acc, wv * slot(ku, kv))
                rv[ku] = acc
            for pv in range(min(n_pv, 3)):           # centre, u+, u-
                acc = None
                for ku, wu in _hat_terms(fu, su, _PVAR_SIGN[pv][0]):
                    acc = _acc(acc, wu.to(bd) * rv[ku])
                PV[i][pv] = _acc(PV[i][pv], acc)
            if n_pv > 1:
                ru = {}
                for kv in (-1, 0, 1, 2):
                    acc = None
                    for ku, wu in wu0:
                        acc = _acc(acc, wu * slot(ku, kv))
                    ru[kv] = acc
                for pv in (3, 4):                    # v+, v-
                    acc = None
                    for kv, wv in _hat_terms(fv, sv, _PVAR_SIGN[pv][1]):
                        acc = _acc(acc, wv.to(bd) * ru[kv])
                    PV[i][pv] = _acc(PV[i][pv], acc)
            lslots = [L[b * 3 + i][:, s * C:(s + 1) * C] for s in range(4)]
            fx = f(6 + i)
            sx = sigmas[b][i][2] if sigmas[b] is not None else f(16 + i)
            wgt_b = wgt.to(bd)
            for lv in range(n_lv):
                tap = None
                for k, w in _hat_terms(fx, sx, _LVAR_SIGN[lv]):
                    tap = _acc(tap, w.to(bd) * lslots[k + 1])
                LV[i][lv] = _acc(LV[i][lv], wgt_b * tap)
    return PV, LV


def _pe_offsets(pe, rot, S):
    """The S stencil-point PEs from the centre PE via the [S,4,E] table:
    pe_s = pe*A0 + roll(pe,-3)*A1 + roll(pe,+3)*A2 + A3."""
    if S == 1:
        return [pe]
    pe_m3 = torch.roll(pe, -3, dims=1)
    pe_p3 = torch.roll(pe, 3, dims=1)
    return [pe] + [pe * rot[s, 0] + pe_m3 * rot[s, 1] + pe_p3 * rot[s, 2]
                   + rot[s, 3] for s in range(1, S)]


def _compute_dtype(pp):
    """bf16 patches compute in bf16, float64 ones in float64 (the plain
    version's oracle mode), anything else in float32."""
    if pp[0].dtype in (torch.bfloat16, torch.float64):
        return pp[0].dtype
    return torch.float32


def stencil_head_plain(pp, lp, fr, sigmas, pe_c, rot, w0_parts, b0, w1, b1,
                       S: int = 7):
    """Plain PyTorch stencil head.  pp/lp: B*3 patch tensors (b-major) in
    float32 or bfloat16 (float64 computes the same function in float64,
    the oracle a float32 kernel is held to on the card);
    fr [N, 64]; sigmas: per-branch static (su, sv, sx) triples or None
    (dynamic: read from the fr lanes); pe_c [N, E]; rot [S, 4, E];
    w0_parts = (w0a, w0b, w0c, w0pe) row splits of W0 [3C+E, H]; b0 [H];
    w1 [H, O]; b1 [O].  Returns (out_c [N, O], sdf_off [S-1, N] or None)
    with the biases applied."""
    cd = _compute_dtype(pp)
    acc = torch.float64 if cd == torch.float64 else torch.float32
    B = len(sigmas)
    C = pp[0].shape[-1] // 16
    n = fr.shape[0]
    P = [p.to(cd) for p in pp]
    L = [l.to(cd) for l in lp]
    PV, LV = _variants(P, L, fr.to(acc), S, B, C, sigmas)
    pes = _pe_offsets(pe_c.to(cd).to(acc), rot.to(acc), S)
    mapping = MAPPING7 if S == 7 else MAPPING1
    X = torch.cat([torch.cat([(PV[i][mapping[s][i][0]]
                               * LV[i][mapping[s][i][1]]).to(cd)
                              for i in range(3)] + [pes[s].to(cd)], dim=1)
                   for s in range(S)], dim=0)                 # [S*N, 3C+E]
    w0 = torch.cat(list(w0_parts), dim=0).to(cd)
    z = X.to(acc) @ w0.to(acc) + b0.to(acc)
    h = softplus100(z).to(cd)
    out_c = h[:n].to(acc) @ w1.to(cd).to(acc) + b1
    if S == 1:
        return out_c, None
    hh = h[n:].to(acc).reshape(S - 1, n, -1)
    out_off = torch.sum(hh * w1[:, 0].to(cd).to(acc), dim=-1) + b1[0]
    return out_c, out_off


# ---------------------------------------------------------------------------
# Hopper kernels
# ---------------------------------------------------------------------------

_FWD_ARGS = [ctypes.c_int] * 10 + [ctypes.c_void_p] * 13
_BWD_ARGS = [ctypes.c_int] * 10 + [ctypes.c_void_p] * 20


def _lib(name, argtypes):
    lib = cuda_build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        if name == 'stencil_head_bwd':
            lib.stencil_head_bwd_workspace.argtypes = [ctypes.c_int] * 10
            lib.stencil_head_bwd_workspace.restype = ctypes.c_longlong
    return lib


def _ptr_array(ts):
    arr = (ctypes.c_void_p * 6)(*([t.data_ptr() for t in ts]
                                  + [0] * (6 - len(ts))))
    return arr


def _dtype_code(cd):
    return 1 if cd == torch.bfloat16 else 0


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _n_sm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def check_current_device(t, what):
    """The ctypes launchers run on the CUDA runtime's current device (and
    the kernels' per-process occupancy caches belong to it): a tensor on
    another card must not be launched on, a rank sets its own card current
    first (parallel/sharding.py)."""
    if t.device.index is not None \
            and t.device.index != torch.cuda.current_device():
        raise ValueError(f'{what}: tensors on {t.device} but the current '
                         f'device is cuda:{torch.cuda.current_device()} '
                         '(torch.cuda.set_device first)')


def _check_cuda(ts, what):
    for t in ts:
        if t.device.type != 'cuda':
            raise ValueError(f'{what}: all tensors must be on the card')
        if not t.is_contiguous():
            raise ValueError(f'{what}: tensors must be contiguous')
    check_current_device(ts[0], what)


def _check_shapes(S, B, C, n, E, H, O, pp, lp, fr, rot, w0_parts, b0):
    """The kernels index every input by these sizes: refuse a mismatch."""
    want = ([(p, (n, 16 * C)) for p in pp] + [(l, (n, 4 * C)) for l in lp]
            + [(fr, (n, 2 * FS)), (rot, (S, 4, E)), (b0, (H,))])
    bad = [tuple(t.shape) for t, s in want if tuple(t.shape) != s]
    rows = [w.shape for w in w0_parts]
    if (bad or len(pp) != 3 * B or len(lp) != 3 * B
            or sum(r[0] for r in rows) != 3 * C + E
            or any(r[1:] != (H,) for r in rows)):
        raise ValueError(f'stencil head: inconsistent shapes {bad or rows}')


def _fr_with_static_sigmas(fr, sigmas):
    """f32 fr with static per-branch sigmas written into their lanes (the
    kernels always read the lanes)."""
    fr = fr.float().contiguous()
    if all(s is None for s in sigmas):
        return fr
    fr = fr.clone()
    for b, sg in enumerate(sigmas):
        if sg is None:
            continue
        for i in range(3):
            su, sv, sx = sg[i]
            fr[:, b * FS + 10 + 2 * i] = su
            fr[:, b * FS + 11 + 2 * i] = sv
            fr[:, b * FS + 16 + i] = sx
    return fr


def _kernel_inputs(static, fr, pe, rot, b0, w1, rest):
    """What both kernel routes launch on: the shapes checked, patches, PE
    and W0 in the compute dtype, fr with the static sigmas written in,
    float32 rot, and the outputs (out_c, out_off, the saved variants V or
    None).  Returns (pp, lp, fr32, pe_cd, rot32, w0, out_c, out_off, v)."""
    S, B, C, cd, sigmas, save_v = static
    pp, lp = rest[:3 * B], rest[3 * B:6 * B]
    w0_parts = rest[6 * B:]
    n, E = pe.shape
    H, O = w1.shape
    dev = fr.device
    _check_shapes(S, B, C, n, E, H, O, pp, lp, fr, rot, w0_parts, b0)
    out_c = torch.empty((n, O), dtype=torch.float32, device=dev)
    out_off = torch.empty((max(S - 1, 1), n), dtype=torch.float32,
                          device=dev)
    v = (torch.empty((n, vw(S, C)), dtype=cd, device=dev) if save_v
         else None)
    return ([p.to(cd).contiguous() for p in pp],
            [l.to(cd).contiguous() for l in lp],
            _fr_with_static_sigmas(fr, sigmas), pe.to(cd).contiguous(),
            rot.float().contiguous(),
            torch.cat([w.to(cd) for w in w0_parts], dim=0), out_c, out_off, v)


def _cotangents(S, g_c, g_off, n, O, dev):
    """The output cotangents as the kernels read them: float32, zeros for
    an output that got none."""
    f32 = torch.float32
    g_c = (torch.zeros((n, O), dtype=f32, device=dev)
           if g_c is None else g_c.float().contiguous())
    if S > 1 and g_off is not None:
        g_off = g_off.float().contiguous()
    else:
        g_off = torch.zeros((max(S - 1, 1), n), dtype=f32, device=dev)
    return g_c, g_off


def _grads_out(S, meta, dpe, db0, dw0, dw1, dw1row, dP, dL):
    """backward's return: dw1row added into dW1's column 0 (S = 7), dW0
    split back into its row parts, each gradient in its input's dtype."""
    pe_dtype, b0_dtype, w1_dtype, parts = meta
    if S > 1:
        dw1[:, 0] += dw1row
    dw0_parts, off = [], 0
    for rows, dt in parts:
        dw0_parts.append(dw0[off:off + rows].to(dt))
        off += rows
    # fr (stop-gradient coords) and rot (static offsets) get no grads
    return (None, None, dpe.to(pe_dtype), None, db0.to(b0_dtype),
            dw1.to(w1_dtype), *dP, *dL, *dw0_parts)


def _grad_meta(pe, b0, w1, w0_parts):
    return (pe.dtype, b0.dtype, w1.dtype,
            [(w.shape[0], w.dtype) for w in w0_parts])


class StencilHead(torch.autograd.Function):
    """Kernel-backed stencil head (no biases): forward = stencil_head_fwd,
    backward = stencil_head_bwd.  Inputs as for stencil_head_plain."""

    @staticmethod
    def forward(ctx, static, fr, pe, rot, b0, w1, *rest):
        S, B, C, cd, sigmas, save_v = static
        n, E = pe.shape
        H, O = w1.shape
        dev = fr.device
        pp, lp, fr32, pe_cd, rot32, w0, out_c, out_off, v = _kernel_inputs(
            static, fr, pe, rot, b0, w1, rest)
        if cd == torch.bfloat16:
            xw_k = XP
            w0_op, b0f, w1_op, w1row = pack_weights_bf16(w0, b0, w1)
        else:
            xw_k = F32_XP
            w0_op, b0f, w1_op, w1row = pack_weights_f32(w0, b0, w1)
        _check_cuda(pp + lp + [fr32, pe_cd, rot32, w0_op, b0f, w1_op, w1row],
                    'stencil_head_fwd')
        lib = _lib('stencil_head_fwd', _FWD_ARGS)
        pa, la = _ptr_array(pp), _ptr_array(lp)
        err = lib.stencil_head_fwd(
            _dtype_code(cd), S, B, _n_sm(dev), n, C, E, H, O, xw_k,
            ctypes.addressof(pa), ctypes.addressof(la), fr32.data_ptr(),
            pe_cd.data_ptr(), rot32.data_ptr(), w0_op.data_ptr(),
            b0f.data_ptr(), w1_op.data_ptr(), w1row.data_ptr(),
            out_c.data_ptr(), out_off.data_ptr(),
            v.data_ptr() if v is not None else None, _stream(dev))
        cuda_build.check(err, 'stencil_head_fwd')
        LAUNCHES['stencil_head_fwd'] += 1
        if save_v:
            ctx.save_for_backward(fr32, v, pe_cd, rot32, w0_op, b0f, w1_op,
                                  w1row)
        ctx.static = static
        ctx.meta = (xw_k, H, O, _grad_meta(pe, b0, w1, rest[6 * B:]))
        return out_c, (out_off if S > 1 else None)

    @staticmethod
    def backward(ctx, g_c, g_off):
        S, B, C, cd, sigmas, save_v = ctx.static
        if not save_v:
            raise RuntimeError('StencilHead: forward ran without saving V')
        fr32, v, pe_cd, rot32, w0_op, b0f, w1_op, w1row = ctx.saved_tensors
        xw_k, H, O, meta = ctx.meta
        n, E = pe_cd.shape
        dev = fr32.device
        bf = cd == torch.bfloat16
        g_c, g_off = _cotangents(S, g_c, g_off, n, O, dev)
        w0t = None
        if not bf:
            w0t = w0_op.t().contiguous()            # [F32_HP, F32_XP]
            w1_op = w1_op.t().contiguous()          # W1^T [F32_OP, F32_HP]
        dP = [torch.empty((n, 16 * C), dtype=cd, device=dev)
              for _ in range(3 * B)]
        dL = [torch.empty((n, 4 * C), dtype=cd, device=dev)
              for _ in range(3 * B)]
        dpe = torch.empty((n, E), dtype=torch.float32, device=dev)
        lib = _lib('stencil_head_bwd', _BWD_ARGS)
        shape = (_dtype_code(cd), S, B, _n_sm(dev), n, C, E, H, O, xw_k)
        ws_bytes = lib.stencil_head_bwd_workspace(*shape)
        if ws_bytes <= 0:
            raise ValueError(f'stencil_head_bwd: unsupported shape {shape}')
        workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
        # bf16: dW0 comes transposed and padded, db0 as its last column;
        # float32: dW0 padded, db0 as its last row, and dW1 transposed
        f32 = torch.float32
        dw0 = torch.empty((HP, XP) if bf else (F32_XP, F32_HP), dtype=f32,
                          device=dev)
        db0 = torch.empty((HP if bf else F32_HP,), dtype=f32, device=dev)
        dw1 = torch.empty((HP, OP) if bf else (F32_OP, F32_HP), dtype=f32,
                          device=dev)
        dw1row = torch.empty((HP if bf else F32_HP,), dtype=f32, device=dev)
        _check_cuda([g_c, g_off, w1_op] + ([w0t] if w0t is not None else []),
                    'stencil_head_bwd')
        pa, la = _ptr_array(dP), _ptr_array(dL)
        err = lib.stencil_head_bwd(
            *shape, fr32.data_ptr(), v.data_ptr(), pe_cd.data_ptr(),
            rot32.data_ptr(), w0_op.data_ptr(),
            w0t.data_ptr() if w0t is not None else None, b0f.data_ptr(),
            w1_op.data_ptr(), w1row.data_ptr(), g_c.data_ptr(),
            g_off.data_ptr(), ctypes.addressof(pa), ctypes.addressof(la),
            dpe.data_ptr(), workspace.data_ptr(), dw0.data_ptr(),
            db0.data_ptr(), dw1.data_ptr(), dw1row.data_ptr(), _stream(dev))
        cuda_build.check(err, 'stencil_head_bwd')
        LAUNCHES['stencil_head_bwd'] += 1
        if bf:
            db0 = dw0[:H, XP - 1]
            dw0 = dw0[:H].t()
            dw1, dw1row = dw1[:H, :O].contiguous(), dw1row[:H]
        else:
            db0 = dw0[F32_XP - 1, :H]
            dw0 = dw0[:, :H]
            dw1, dw1row = dw1[:O, :H].t().contiguous(), dw1row[:H]
        return _grads_out(S, meta, dpe, db0, dw0, dw1, dw1row, dP, dL)


_GEN_FWD_ARGS = [ctypes.c_int] * 10 + [ctypes.c_void_p] * 13
_GEN_BWD_ARGS = ([ctypes.c_int] * 10 + [ctypes.c_void_p] * 15
                 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4)


def _gen_lib():
    lib = cuda_build.load('stencil_head_general')
    if lib.stencil_gen_fwd_launch.argtypes is None:
        for name, args in (('stencil_gen_fwd_launch', _GEN_FWD_ARGS),
                           ('stencil_gen_bwd_launch', _GEN_BWD_ARGS)):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        lib.stencil_gen_smem.argtypes = [ctypes.c_int] * 7
        lib.stencil_gen_smem.restype = ctypes.c_longlong
        lib.stencil_gen_bwd_workspace.argtypes = [ctypes.c_int] * 8
        lib.stencil_gen_bwd_workspace.restype = ctypes.c_longlong
        lib.stencil_gen_info.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.stencil_gen_info.restype = ctypes.c_int
    return lib


class GeneralStencilHead(torch.autograd.Function):
    """The stencil head on the general-width kernels (no biases): forward
    = stencil_gen_fwd, backward = stencil_gen_bwd_rows + the weight-
    gradient products.  Inputs as for StencilHead."""

    @staticmethod
    def forward(ctx, static, fr, pe, rot, b0, w1, *rest):
        S, B, C, cd, sigmas, save_v = static
        n, E = pe.shape
        H, O = w1.shape
        dev = fr.device
        pp, lp, fr32, pe_cd, rot32, w0, out_c, out_off, v = _kernel_inputs(
            static, fr, pe, rot, b0, w1, rest)
        w0p, w0t, b0p, w1p, w1t, w1row = pack_weights_general(w0, b0, w1, cd)
        _check_cuda(pp + lp + [fr32, pe_cd, rot32, w0p, b0p, w1p, w1row],
                    'stencil_head_general_fwd')
        tr = gen_tile_rows('fwd', S, C, E, H, O)
        grid = gen_grid('fwd', _n_sm(dev), S, C, E, H, O, n)
        lib = _gen_lib()
        pa, la = _ptr_array(pp), _ptr_array(lp)
        err = lib.stencil_gen_fwd_launch(
            _dtype_code(cd), S, B, n, C, E, H, O, tr, grid,
            ctypes.addressof(pa),
            ctypes.addressof(la), fr32.data_ptr(), pe_cd.data_ptr(),
            rot32.data_ptr(), w0p.data_ptr(), b0p.data_ptr(), w1p.data_ptr(),
            w1row.data_ptr(), out_c.data_ptr(), out_off.data_ptr(),
            v.data_ptr() if v is not None else None, _stream(dev))
        cuda_build.check(err, 'stencil_head_general_fwd')
        GENERAL_LAUNCHES['stencil_head_general_fwd'] += 1
        if save_v:
            ctx.save_for_backward(fr32, v, pe_cd, rot32, w0p, w0t, b0p, w1t,
                                  w1row)
        ctx.static = static
        ctx.meta = (H, O, _grad_meta(pe, b0, w1, rest[6 * B:]))
        return out_c, (out_off if S > 1 else None)

    @staticmethod
    def backward(ctx, g_c, g_off):
        S, B, C, cd, sigmas, save_v = ctx.static
        if not save_v:
            raise RuntimeError('GeneralStencilHead: forward ran without '
                               'saving V')
        fr32, v, pe_cd, rot32, w0p, w0t, b0p, w1t, w1row = ctx.saved_tensors
        H, O, meta = ctx.meta
        n, E = pe_cd.shape
        dev = fr32.device
        f32 = torch.float32
        g_c, g_off = _cotangents(S, g_c, g_off, n, O, dev)
        K, k4, h4, o4 = gen_dims(C, E, H, O)
        tr = gen_tile_rows('bwd', S, C, E, H, O)
        grid = gen_grid('bwd', _n_sm(dev), S, C, E, H, O, n)
        dP = [torch.empty((n, 16 * C), dtype=cd, device=dev)
              for _ in range(3 * B)]
        dL = [torch.empty((n, 4 * C), dtype=cd, device=dev)
              for _ in range(3 * B)]
        dpe = torch.empty((n, E), dtype=f32, device=dev)
        ws_bytes = gen_workspace_bytes(S, C, E, H, O, n, tr, grid)
        workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
        dw0 = torch.empty((k4, h4), dtype=f32, device=dev)
        dw1 = torch.empty((h4, o4), dtype=f32, device=dev)
        dw1row = torch.empty((h4,), dtype=f32, device=dev)
        _check_cuda([g_c, g_off], 'stencil_head_general_bwd')
        lib = _gen_lib()
        pa, la = _ptr_array(dP), _ptr_array(dL)
        err = lib.stencil_gen_bwd_launch(
            _dtype_code(cd), S, B, n, C, E, H, O, tr, grid, fr32.data_ptr(),
            v.data_ptr(), pe_cd.data_ptr(), rot32.data_ptr(),
            w0p.data_ptr(), w0t.data_ptr(), b0p.data_ptr(), w1t.data_ptr(),
            w1row.data_ptr(), g_c.data_ptr(), g_off.data_ptr(),
            ctypes.addressof(pa), ctypes.addressof(la), dpe.data_ptr(),
            workspace.data_ptr(), ws_bytes, dw0.data_ptr(), dw1.data_ptr(),
            dw1row.data_ptr(), _stream(dev))
        cuda_build.check(err, 'stencil_head_general_bwd')
        GENERAL_LAUNCHES['stencil_head_general_bwd'] += 1
        db0 = dw0[K, :H]
        dw0, dw1, dw1row = dw0[:K, :H], dw1[:H, :O], dw1row[:H]
        if cd == torch.bfloat16:
            # the plain version's weight gradients pass through W0.to(bf16),
            # W1.to(bf16) and W1[:, 0].to(bf16): each is rounded there
            dw0, dw1, dw1row = (t.to(cd).to(f32) for t in (dw0, dw1, dw1row))
        return _grads_out(S, meta, dpe, db0, dw0, dw1.contiguous(), dw1row,
                          dP, dL)


def _head(S, pp, lp, fr, sigmas, pe, rot, w0_parts, b0, w1, b1):
    if fr.device.type == 'cpu':
        return stencil_head_plain(pp, lp, fr, sigmas, pe, rot, w0_parts, b0,
                                  w1, b1, S=S)
    if fr.device.type != 'cuda':
        raise ValueError(f'stencil head: unsupported device {fr.device}')
    cd = _compute_dtype(pp)
    B = len(sigmas)
    C = pp[0].shape[-1] // 16
    tensors = [fr, pe, rot, b0, w1, *pp, *lp, *w0_parts]
    save_v = torch.is_grad_enabled() and any(t.requires_grad
                                             for t in tensors)
    static = (S, B, C, cd, tuple(sigmas), save_v)
    fn = (StencilHead if head_route(cd, S, B, C, pe.shape[-1], *w1.shape)
          == 'fast' else GeneralStencilHead)
    out_c, out_off = fn.apply(static, fr, pe, rot, b0, w1, *pp, *lp,
                              *w0_parts)
    out_c = out_c + b1[None, :]
    return out_c, (out_off + b1[0] if out_off is not None else None)


def stencil_head(pp, lp, fr, sigmas, pe_c, pe_rot, w0_parts: Sequence, b0,
                 w1, b1):
    """7-point stencil MLP head -> (out_centre [N, O], sdf_off [6, N]).
    CPU tensors: the plain version; CUDA tensors: the Hopper kernels."""
    return _head(7, pp, lp, fr, sigmas, pe_c, pe_rot, w0_parts, b0, w1, b1)


def point_head(pp, lp, fr, sigmas, pe, w0_parts: Sequence, b0, w1, b1):
    """Single-point MLP head (centre taps only): -> [N, O]."""
    rot = torch.zeros((1, 4, pe.shape[-1]), dtype=torch.float32,
                      device=pe.device)
    return _head(1, pp, lp, fr, sigmas, pe, rot, w0_parts, b0, w1, b1)[0]
