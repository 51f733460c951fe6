"""Two trees' general-width stencil kernels timed in turns on one card.

    python -m tensoflow_tpu_torch.bench.stencil_ab --trees build/parent .
        [--turns 2]

Each tree is the root of a copy of the repository (for a parent commit,
unpack `git archive <commit>` into a directory that .gitignore lists, e.g.
build/parent).  The trees run in turns, A B B A for two turns, each run in
a process of its own with that root first on sys.path, so that each builds
and times its own csrc/stencil_head_general.cu (ops/cuda_build.py builds
under the root's build/kernels/).  A run times, at NeuS's head widths
(C=36, E=39, H=256, O=257), float32, S=7, dynamic sigma lanes for B=2:
forward and backward at N=131,072 for B=1 and B=2 (device time of the
general kernels from torch.profiler over 3 calls, the backward also kernel
by kernel), and the forward alone at N=512 and N=4,096 (B=2, no gradient:
a render and a relight chunk; 20 calls).  It calls only the public
ops/stencil.stencil_head, so any tree with the general route can be timed.
Needs one CUDA card with nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

WIDTHS = (36, 39, 256, 257)        # C, E, H, O
N_MAIN, SMALL_N = 131072, (512, 4096)


def _inputs(n, B, seed):
    """Stencil-head inputs at WIDTHS made on the card from a seed."""
    import torch
    from tensoflow_tpu_torch.ops.tensor_field import FRAC_STRIDE as FS
    C, E, H, O = WIDTHS
    g = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device='cuda') * scale
    fr = torch.zeros((n, 2 * FS), device='cuda')
    sig = []
    for b in range(B):
        o = b * FS
        fr[:, o:o + 9] = torch.rand((n, 9), generator=g, device='cuda')
        fr[:, o + 9] = 1.0 / B
        if B > 1:
            fr[:, o + 10:o + 19] = 0.5 + 0.5 * torch.rand(
                (n, 9), generator=g, device='cuda')
            sig.append(None)
        else:
            sig.append(((1.0, 1.0, 1.0),) * 3)
    leaves = ([rnd(n, 16 * C, scale=0.3) for _ in range(3 * B)]
              + [rnd(n, 4 * C, scale=0.3) for _ in range(3 * B)]
              + [rnd(k, H, scale=(3 * C + E) ** -0.5) for k in (C, C, C, E)]
              + [rnd(n, E, scale=0.5), rnd(H, scale=0.1),
                 rnd(H, O, scale=H ** -0.5), rnd(O, scale=0.1)])
    for t in leaves:
        t.requires_grad_(True)
    return leaves, fr, tuple(sig), rnd(7, 4, E, scale=0.5), rnd(n, O), \
        rnd(6, n)


def _device_ms(fn, calls):
    """{kernel: device ms a call} of the general kernels over `calls`
    profiled calls of fn (after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if 'stencil_gen' in e.key:
            k = e.key.split('(')[0].replace('void ', '').split('<')[0]
            ms[k] = ms.get(k, 0.0) + e.device_time_total / 1e3 / calls
    return ms


def worker():
    """One run: the times of the tree first on sys.path, as one JSON line."""
    import torch
    from tensoflow_tpu_torch.ops import stencil as st
    out = {}
    for B in (1, 2):
        leaves, fr, sig, rot, g_c, g_off = _inputs(N_MAIN, B, seed=5)
        nb = 3 * B
        pp, lp, w0p = leaves[:nb], leaves[nb:2 * nb], leaves[2 * nb:2 * nb + 4]
        pe, b0, w1, b1 = leaves[2 * nb + 4:]
        if st.head_route(torch.float32, 7, B, *WIDTHS) != 'general':
            raise AssertionError(f'{WIDTHS}: not the general route')

        def step():
            o = st.stencil_head(pp, lp, fr, sig, pe, rot, w0p, b0, w1, b1)
            torch.autograd.grad(o, leaves, (g_c, g_off))
        ms = _device_ms(step, 3)
        out[f'B={B}'] = dict(fwd=ms.pop('stencil_gen_fwd'),
                             bwd=sum(ms.values()), bwd_kernels=ms)
        del leaves, pp, lp, w0p, pe, b0, w1, b1
    for n in SMALL_N:
        leaves, fr, sig, rot, _, _ = _inputs(n, 2, seed=21)
        pp, lp, w0p = leaves[:6], leaves[6:12], leaves[12:16]
        pe, b0, w1, b1 = leaves[16:]

        def fwd():
            with torch.no_grad():
                st.stencil_head(pp, lp, fr, sig, pe, rot, w0p, b0, w1, b1)
        out[f'fwd N={n}'] = _device_ms(fwd, 20)['stencil_gen_fwd']
    print('[ab] ' + json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--trees', nargs=2, required=True,
                    help='roots of the two trees, A (parent) then B')
    ap.add_argument('--turns', type=int, default=2)
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.worker))
        worker()
        return 0
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    roots = [os.path.abspath(t) for t in args.trees]
    runs = {r: [] for r in roots}
    for turn in range(args.turns):
        for r in (roots if turn % 2 == 0 else roots[::-1]):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--trees',
                 *roots, '--worker', r], cwd=r, capture_output=True,
                text=True, timeout=1200)
            lines = [ln for ln in res.stdout.splitlines()
                     if ln.startswith('[ab] ')]
            if res.returncode != 0 or not lines:
                raise RuntimeError(f'{r}: exit {res.returncode}\n'
                                   f'{res.stdout[-3000:]}{res.stderr[-3000:]}')
            t = json.loads(lines[-1][5:])
            runs[r].append(t)
            print(f'[ab] turn {turn} {r} on {card}: {json.dumps(t)}',
                  flush=True)
    for r in roots:
        keys = [k for k in runs[r][0]]
        best = {}
        for k in keys:
            v = runs[r][0][k]
            best[k] = (min(x[k]['fwd'] for x in runs[r]),
                       min(x[k]['bwd'] for x in runs[r])) \
                if isinstance(v, dict) else min(x[k] for x in runs[r])
        print(f'[ab] best of {args.turns} turns, {r} on {card}: '
              + json.dumps(best), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
