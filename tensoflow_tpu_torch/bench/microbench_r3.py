"""Microbenches of the step's gather and scatter building blocks
(counterpart of scripts/microbench_r3.py).

    python -m tensoflow_tpu_torch.bench.microbench_r3            # the card
    python -m tensoflow_tpu_torch.bench.microbench_r3 --device cpu --small

  1. the gathers of the Pallas probes (ops/tile_gather.py, the four
     hand-written kernels: the row gather reads the L2-resident table in
     512-byte chunks a warp over every SM, the lane gather stages one row
     a block in shared memory): row gather in one tile at three widths,
     the gridded row gather (512 tiles x [256, 1280]), the lane gather at
     two widths, the bfloat16 row gather.  Each is checked against its
     plain version (exact equality: a gather copies bits) and timed.
  2. scatter-add variants in plain PyTorch (``index_add_``): [131072, 576]
     updates into [49923, 576], bf16 / f32 targets, random, ray-coherent
     and pre-sorted indices.
  3. occupancy-predicate gathers in plain PyTorch: 901,120 lookups from
     128^3 entries held as bool / uint8 / bf16 / f32, and the packed-row +
     one-hot variant.

Times are CUDA-event times on the card (host-clock times with
``--device cpu``, where the plain versions run).  ``--small`` cuts every
size for a quick run.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import tile_gather as tg


def timeit(fn, device, iters=20, windows=3) -> float:
    """Best-of-windows mean ms per call."""
    fn()
    best = float('inf')
    for _ in range(windows):
        if device.type == 'cuda':
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                fn()
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) / iters * 1e3
        best = min(best, ms)
    return best


def gather_cases(small: bool = False):
    """(name, wrapper, plain, table shape, dtype, idx shape, idx range) for
    every shape the probes run."""
    tn = 256
    tiles = 4 if small else 512
    cases = []
    for lanes in (128, 512, 1280):
        cases.append((f'row_gather_tile lanes={lanes}', tg.row_gather_tile,
                      tg.row_gather_plain, (tn, lanes), torch.float32,
                      (tn, 1), tn))
    cases.append((f'row_gather_grid {tiles}x[256,1280]', tg.row_gather_grid,
                  tg.row_gather_plain, (tn, 1280), torch.float32,
                  (tiles * tn, 1), tn))
    for lanes in (128, 512):
        cases.append((f'lane_gather_tile lanes={lanes}', tg.lane_gather_tile,
                      tg.lane_gather_plain, (tn, lanes), torch.float32,
                      (tn, lanes), lanes))
    cases.append(('row_gather_tile_bf16 lanes=1280', tg.row_gather_tile_bf16,
                  tg.row_gather_plain, (tn, 1280), torch.bfloat16, (tn, 1),
                  tn))
    return cases


def ragged_gather_cases():
    """Cases in the same form at shapes the probes do not run: 16-byte
    rows, rows that are not a multiple of 512 bytes (and, for the lane
    gather, not of 16), row counts that are a multiple of no block's rows,
    tables of more rows (up to 1,000) than 227 KB of shared memory holds
    at 512 bytes a row (454), and all-repeated indices (index range 1:
    every row is row 0)."""
    f32, bf16 = torch.float32, torch.bfloat16
    row, grid, lane, row16 = (tg.row_gather_tile, tg.row_gather_grid,
                              tg.lane_gather_tile, tg.row_gather_tile_bf16)
    rp, lp = tg.row_gather_plain, tg.lane_gather_plain
    return [
        ('row_gather_tile 16B rows', row, rp, (256, 4), f32, (257, 1), 256),
        ('row_gather_tile [1000,100]', row, rp, (1000, 100), f32, (777, 1),
         1000),
        ('row_gather_tile repeated', row, rp, (256, 1280), f32, (256, 1), 1),
        ('row_gather_grid [600,1288]', grid, rp, (600, 1288), f32,
         (4099, 1), 600),
        ('row_gather_tile_bf16 [517,40]', row16, rp, (517, 40), bf16,
         (333, 1), 517),
        ('row_gather_tile_bf16 16B rows', row16, rp, (100, 8), bf16,
         (61, 1), 100),
        ('lane_gather_tile 16B rows', lane, lp, (256, 4), f32, (256, 4), 4),
        ('lane_gather_tile [257,100]', lane, lp, (257, 100), f32,
         (257, 100), 100),
        ('lane_gather_tile [33,37]', lane, lp, (33, 37), f32, (33, 37), 37),
        ('lane_gather_tile [600,1100]', lane, lp, (600, 1100), f32,
         (600, 1100), 1100),
        ('lane_gather_tile repeated', lane, lp, (256, 512), f32, (256, 512),
         1),
    ]


def make_case(case, rng, device):
    _, _, _, tshape, dtype, ishape, hi = case
    table = torch.as_tensor(rng.randn(*tshape).astype(np.float32)).to(
        device=device, dtype=dtype)
    idx = torch.as_tensor(rng.randint(0, hi, ishape).astype(np.int32)).to(
        device)
    return table, idx


def section_gathers(device, rng, small, out):
    print('== gathers of the Pallas probes ==', flush=True)
    for case in gather_cases(small):
        name, fn, plain = case[:3]
        table, idx = make_case(case, rng, device)
        got = fn(table, idx)
        ok = torch.equal(got, plain(table, idx))
        del got
        ms = timeit(lambda: fn(table, idx), device,
                    iters=5 if 'grid' in name else 20)
        print(f'  {name}: ok={ok} {ms:.4f} ms', flush=True)
        if not ok:
            raise AssertionError(f'{name}: differs from its plain version')
        out[name] = ms


def section_scatter(device, rng, small, out):
    n, r, c = (4096, 499, 64) if small else (131072, 49923, 576)
    print(f'== scatter-add [{n},{c}] -> [{r},{c}] ==', flush=True)
    upd = torch.as_tensor(rng.randn(n, c).astype(np.float32)).to(device)
    idx = torch.as_tensor(rng.randint(0, r, (n,))).to(device)
    # ray-coherent pattern: consecutive samples hit nearby rows
    coh = np.clip(np.repeat(rng.randint(0, r, (n // 64,)), 64)
                  + rng.randint(-2, 3, (n,)), 0, r - 1)
    idx_coh = torch.as_tensor(coh).to(device)

    def scat(tgt_dtype, ix, sort=False):
        def f():
            u, i = upd.to(tgt_dtype), ix
            if sort:
                i, order = torch.sort(i)
                u = u[order]
            return torch.zeros((r, c), dtype=tgt_dtype,
                               device=device).index_add_(0, i, u)
        return f

    for name, f in [
            ('bf16<-bf16 rand', scat(torch.bfloat16, idx)),
            ('f32<-f32  rand', scat(torch.float32, idx)),
            ('f32<-f32  coherent', scat(torch.float32, idx_coh)),
            ('f32 pre-sorted rand', scat(torch.float32, idx, True))]:
        ms = timeit(f, device, iters=5)
        print(f'  {name}: {ms:.3f} ms', flush=True)
        out['scatter ' + name] = ms


def section_pred_gather(device, rng, small, out):
    m, g = (8192, 65536) if small else (901120, 2097152)
    print(f'== occ pred gather: {m} lookups from {g} ==', flush=True)
    occ_bits = rng.rand(g) > 0.7
    gidx_np = rng.randint(0, g, (m,))
    gidx = torch.as_tensor(gidx_np).to(device)
    bits = torch.as_tensor(occ_bits).to(device)
    for name, tab in [('bool', bits), ('u8  ', bits.to(torch.uint8)),
                      ('bf16', bits.to(torch.bfloat16)),
                      ('f32 ', bits.to(torch.float32))]:
        ms = timeit(lambda: torch.index_select(
            tab, 0, torch.clamp(gidx, 0, g - 1)), device, iters=5)
        print(f'  {name}[{g}]: {ms:.3f} ms', flush=True)
        out['pred ' + name.strip()] = ms
    # packed rows [g/128, 128] f32: gather the row, reduce with a one-hot
    rows = bits.reshape(g // 128, 128).float()
    ridx = torch.as_tensor(gidx_np // 128).to(device)
    lidx = torch.as_tensor(gidx_np % 128).to(device)
    lanes = torch.arange(128, device=device)

    def g_rows():
        got = torch.index_select(rows, 0, ridx)
        return torch.sum(got * (lidx[:, None] == lanes[None, :]), dim=1)

    ms = timeit(g_rows, device, iters=5)
    print(f'  rows[{g // 128},128]+onehot: {ms:.3f} ms', flush=True)
    out['pred rows+onehot'] = ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None,
                    help="'cpu' runs the plain versions; default: the card")
    ap.add_argument('--small', action='store_true',
                    help='cut every size (a quick run)')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    where = (torch.cuda.get_device_name(device) if device.type == 'cuda'
             else 'cpu (plain versions, host clock)')
    print(f'microbench_r3 on {where}', flush=True)
    out = {}
    section_gathers(device, rng, args.small, out)
    section_scatter(device, rng, args.small, out)
    section_pred_gather(device, rng, args.small, out)
    return out


if __name__ == '__main__':
    main()
