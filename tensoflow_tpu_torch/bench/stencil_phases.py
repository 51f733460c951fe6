"""Where the stencil-head kernels spend their time, by leaving phases out.

    python -m tensoflow_tpu_torch.bench.stencil_phases [--rows 131072]
        [--dtype bfloat16|float32] [--branches 1|2] [--route fast|general]

Builds the route's kernels once as they are and once per -DSH_SKIP_*
switch (taps: the hat-weight taps / product rule and routing; softplus:
the activation; workspace: the backward's stores of X, dz, h and g_c;
for float32 and the general kernels also z: the z = X.W0 product,
layer1: the forward's layer 1 and the backward's dh = g.W1^T, dx: the
backward's dX = dz.W0^T), runs forward and backward and prints each
kernel's device time from torch.profiler, and each launch of the
backward on its own (the row kernel, each weight-gradient product, each
column sum).  --route fast: csrc/stencil_head_{fwd,bwd}.cu at the stage-1
shapes (C=36, E=21, H=256, O=129, S=7); --route general:
csrc/stencil_head_general.cu at NeuS's head widths (C=36, E=39, H=256,
O=257, S=7).  B mip branches, dynamic sigma lanes for B=2.  A build with
a phase left out computes wrong results: only its time is read, and the
difference to the full build is that phase's share.  Needs one CUDA card
with nvcc.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

S = 7
# (C, E, H, O) and sources of each route
ROUTES = {'fast': ((36, 21, 256, 129),
                   ('stencil_head_fwd', 'stencil_head_bwd')),
          'general': ((36, 39, 256, 257), ('stencil_head_general',))}
_PRODUCTS = (('-DSH_SKIP_TAPS',), ('-DSH_SKIP_SOFTPLUS',),
             ('-DSH_SKIP_WORKSPACE',), ('-DSH_SKIP_Z',),
             ('-DSH_SKIP_LAYER1',), ('-DSH_SKIP_DX',),
             ('-DSH_SKIP_Z', '-DSH_SKIP_LAYER1', '-DSH_SKIP_DX'))
VARIANTS = {
    'bfloat16': ((), ('-DSH_SKIP_TAPS',), ('-DSH_SKIP_SOFTPLUS',),
                 ('-DSH_SKIP_WORKSPACE',),
                 ('-DSH_SKIP_TAPS', '-DSH_SKIP_SOFTPLUS',
                  '-DSH_SKIP_WORKSPACE')),
    'float32': ((), ('-DSH_SKIP_TAPS',), ('-DSH_SKIP_SOFTPLUS',),
                ('-DSH_SKIP_WORKSPACE',), ('-DSH_SKIP_Z',),
                ('-DSH_SKIP_LAYER1',), ('-DSH_SKIP_DX',),
                ('-DSH_SKIP_Z', '-DSH_SKIP_LAYER1', '-DSH_SKIP_DX')),
    # the general kernels, either type: the same switches as float32
    'general': ((),) + _PRODUCTS,
}


def _inputs(n, dtype, branches, widths, seed=5):
    from ..ops.tensor_field import FRAC_STRIDE as FS
    C, E, H, O = widths
    g = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device='cuda') * scale
    fr = torch.zeros((n, 2 * FS), device='cuda')
    sig = []
    for b in range(branches):
        o = b * FS
        fr[:, o:o + 9] = torch.rand((n, 9), generator=g, device='cuda')
        fr[:, o + 9] = 1.0 / branches
        if branches > 1:
            fr[:, o + 10:o + 19] = 0.5 + 0.5 * torch.rand(
                (n, 9), generator=g, device='cuda')
            sig.append(None)
        else:
            sig.append(((1.0, 1.0, 1.0),) * 3)
    leaves = ([rnd(n, 16 * C, scale=0.3).to(dtype)
               for _ in range(3 * branches)]
              + [rnd(n, 4 * C, scale=0.3).to(dtype)
                 for _ in range(3 * branches)]
              + [rnd(k, H, scale=(3 * C + E) ** -0.5) for k in (C, C, C, E)]
              + [rnd(n, E, scale=0.5), rnd(H, scale=0.1),
                 rnd(H, O, scale=H ** -0.5), rnd(O, scale=0.1)])
    for t in leaves:
        t.requires_grad_(True)
    return (leaves, fr, tuple(sig), rnd(S, 4, E, scale=0.5), rnd(n, O),
            rnd(S - 1, n))


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile
    from ..ops import cuda_build, stencil
    ap = argparse.ArgumentParser()
    ap.add_argument('--rows', type=int, default=2048 * 64)
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    default='bfloat16')
    ap.add_argument('--branches', type=int, choices=(1, 2), default=1)
    ap.add_argument('--route', choices=tuple(ROUTES), default='fast')
    ap.add_argument('--repeat', type=int, default=1,
                    help='time every build this many times, in turns')
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    nb = 3 * args.branches
    widths, sources = ROUTES[args.route]
    if stencil.head_route(dtype, S, args.branches, *widths) != args.route:
        raise ValueError(f'{widths} {args.dtype}: not the {args.route} '
                         'route')
    leaves, fr, sig, rot, g_c, g_off = _inputs(args.rows, dtype,
                                               args.branches, widths)
    pp, lp, w0p = leaves[:nb], leaves[nb:2 * nb], leaves[2 * nb:2 * nb + 4]
    pe, b0, w1, b1 = leaves[2 * nb + 4:]
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    variants = VARIANTS['general' if args.route == 'general'
                        else args.dtype]
    # every build at once: one nvcc per source and set of switches
    cuda_build.build(sources, variants)
    for defines in list(variants) * args.repeat:
        cuda_build.DEFINES = defines
        try:
            def step():
                out = stencil.stencil_head(pp, lp, fr, sig, pe, rot, w0p, b0,
                                           w1, b1)
                torch.autograd.grad(out, leaves, (g_c, g_off))
            step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
        finally:
            cuda_build.DEFINES = ()
        ms = {}
        for e in prof.key_averages():
            if 'stencil' in e.key:
                k = _short(e.key)
                ms[k] = ms.get(k, 0.0) + e.device_time_total / 3e3
        print(f'[phases] {args.route} {args.dtype} B={args.branches} '
              f'{" ".join(defines) or "full"} N={args.rows} on {card}: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in sorted(ms.items())),
              flush=True)
        if args.route == 'general' or not defines:
            print(f'[phases] {args.route} {args.dtype} B={args.branches} '
                  f'{" ".join(defines) or "full"} N={args.rows}: each launch '
                  'of a call, in order: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in
                              _launch_ms(prof, 3)), flush=True)


def _short(key):
    return key.split('(')[0].replace('void ', '')


def _launch_ms(prof, calls):
    """(kernel, ms) of each stencil kernel launch of one call, in launch
    order, averaged over the profiled calls."""
    seq = [(_short(e.name), e.time_range.elapsed_us() / 1e3)
           for e in sorted(prof.events(), key=lambda e: e.time_range.start)
           if e.device_type == torch.autograd.DeviceType.CUDA
           and 'stencil' in e.name]
    per = len(seq) // calls
    return [(seq[i][0], sum(seq[i + c * per][1] for c in range(calls))
             / calls) for i in range(per)]


if __name__ == '__main__':
    main()
