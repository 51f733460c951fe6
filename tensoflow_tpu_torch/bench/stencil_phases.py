"""Where the bf16 stencil-head kernels spend their time, by leaving phases out.

    python -m tensoflow_tpu_torch.bench.stencil_phases [--rows 131072]

Builds csrc/stencil_head_{fwd,bwd}.cu once as they are and once per
-DSH_SKIP_* switch (taps: the hat-weight taps / product rule and routing;
softplus: the activation on the accumulator fragment; workspace: the
backward's stores of X, dz, h and g_c), runs forward and backward at the
stage-1 shapes (C=36, E=21, H=256, O=129, S=7, B=1) and prints each
kernel's device time from torch.profiler.  A build with a phase left out
computes wrong results: only its time is read, and the difference to the
full build is that phase's share.  Needs one CUDA card with nvcc.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

C, E, H, O, S = 36, 21, 256, 129, 7
VARIANTS = ((), ('-DSH_SKIP_TAPS',), ('-DSH_SKIP_SOFTPLUS',),
            ('-DSH_SKIP_WORKSPACE',),
            ('-DSH_SKIP_TAPS', '-DSH_SKIP_SOFTPLUS', '-DSH_SKIP_WORKSPACE'))


def _inputs(n, seed=5):
    from ..ops.tensor_field import FRAC_STRIDE as FS
    g = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device='cuda') * scale
    fr = torch.zeros((n, 2 * FS), device='cuda')
    fr[:, :9] = torch.rand((n, 9), generator=g, device='cuda')
    fr[:, 9] = 1.0
    leaves = ([rnd(n, 16 * C, scale=0.3).bfloat16() for _ in range(3)]
              + [rnd(n, 4 * C, scale=0.3).bfloat16() for _ in range(3)]
              + [rnd(k, H, scale=(3 * C + E) ** -0.5) for k in (C, C, C, E)]
              + [rnd(n, E, scale=0.5), rnd(H, scale=0.1),
                 rnd(H, O, scale=H ** -0.5), rnd(O, scale=0.1)])
    for t in leaves:
        t.requires_grad_(True)
    return leaves, fr, rnd(S, 4, E, scale=0.5), rnd(n, O), rnd(S - 1, n)


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile
    from ..ops import cuda_build, stencil
    ap = argparse.ArgumentParser()
    ap.add_argument('--rows', type=int, default=2048 * 64)
    args = ap.parse_args(argv)
    leaves, fr, rot, g_c, g_off = _inputs(args.rows)
    pp, lp, w0p = leaves[:3], leaves[3:6], leaves[6:10]
    pe, b0, w1, b1 = leaves[10:]
    sig = (((1.0, 1.0, 1.0),) * 3,)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for defines in VARIANTS:
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
                k = e.key.split('(')[0].replace('void ', '')
                ms[k] = ms.get(k, 0.0) + e.device_time_total / 3e3
        print(f'[phases] {" ".join(defines) or "full"} N={args.rows} on '
              f'{card}: ' + ', '.join(f'{k} {v:.3f} ms'
                                      for k, v in sorted(ms.items())),
              flush=True)


if __name__ == '__main__':
    main()
