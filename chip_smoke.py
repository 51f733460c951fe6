"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure exits nonzero; no phase's failure is caught):
  1. build   — compile the hand-written kernels from tensoflow_tpu_torch/csrc
               (one nvcc per source, started together) and print the seconds.
  2. kernels — hold the stencil-head fwd and bwd kernels to their plain
               PyTorch version on the card at the slice's shapes
               (N = 2048 rays x 64 samples = 131,072 rows, C=36, E=21,
               H=256, O=129), in bf16 (against the plain version in bf16)
               and f32 (against the plain version in f64), with B=2
               dynamic sigma lanes and with S=1 at N=16,384, and at a
               ragged N=1,003 (a partial last row tile); then time
               kernel and plain version beside the byte/op bound.
  3. slice   — first a small float32 configuration trained for 2 steps on
               the card and on the CPU (plain versions) from the same
               parameters, batches and noise, loss terms compared; then
               ShapeTrainer at the widths of configs/shape/syn/
               compressor_occ.yaml (database toy/sphere_128_12, bf16
               gathers): one occupancy update + 5 training steps with the
               launch counts reset just before; asserts finite loss terms
               and one fwd + one bwd kernel launch per step; then 10 more
               steps for the step time and one profiled step (device time
               by kernel, launches, host operators, idle share).
Then it prints the card's name and power limit, one JSON line listing
every hand-written kernel, and as the last line
{"ok": true, "device": {...}}.  Without CUDA, or outside the repo, it
exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM datasheet HBM3 rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
N_MAIN, C, E, H, O = 2048 * 64, 36, 21, 256, 129
# Tolerance on max |kernel - plain| / max |plain| per output or gradient,
# (fwd, bwd).  bfloat16 kernels are held to the plain version in
# bfloat16: both round at the same points (ops/stencil.py), but an h or dz
# whose float32 value sits next to a bf16 rounding boundary can round the
# other way after a differently ordered f32 sum, a one-ulp (2^-8) step
# that the products and sums downstream carry.  float32 kernels are held
# to the plain version computed in float64 on the same inputs: what is
# left is float32 rounding (~1e-6).  The plain version in float32 is
# printed beside it.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 5e-2)}
TPU_KERNELS = {
    'stencil_head_fwd': 'tensoflow_tpu/ops/pallas_stencil.py:274',
    'stencil_head_bwd': 'tensoflow_tpu/ops/pallas_stencil.py:368',
}


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against the plain version
# ---------------------------------------------------------------------------

def head_inputs(n, S, B, cd, seed):
    """Slice-shaped stencil-head inputs made on the card from a seed."""
    from tensoflow_tpu_torch.ops.tensor_field import FRAC_STRIDE as FS
    g = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    fr = torch.zeros((n, 2 * FS), device=dev)
    sigmas = []
    for b in range(B):
        o = b * FS
        fr[:, o:o + 9] = torch.rand((n, 9), generator=g, device=dev)
        fr[:, o + 9] = (torch.rand((n,), generator=g, device=dev)
                        if B > 1 else 1.0)
        if B > 1:          # dynamic mips: per-row sigma lanes
            fr[:, o + 10:o + 19] = 0.5 + 0.5 * torch.rand(
                (n, 9), generator=g, device=dev)
            sigmas.append(None)
        else:              # 128^3 grid, level 0: one texel per stencil step
            sigmas.append(((1.0, 1.0, 1.0),) * 3)
    d = {
        'pp': [rnd(n, 16 * C, scale=0.3).to(cd) for _ in range(3 * B)],
        'lp': [rnd(n, 4 * C, scale=0.3).to(cd) for _ in range(3 * B)],
        'fr': fr, 'sigmas': tuple(sigmas),
        'pe': rnd(n, E, scale=0.5),
        'rot': rnd(S, 4, E, scale=0.5),
        'w0p': [rnd(k, H, scale=(3 * C + E) ** -0.5) for k in (C, C, C, E)],
        'b0': rnd(H, scale=0.1), 'w1': rnd(H, O, scale=H ** -0.5),
        'b1': rnd(O, scale=0.1),
        'g_c': rnd(n, O), 'g_off': rnd(max(S - 1, 1), n),
    }
    return d


def run_head(d, S, kernel: bool):
    """Forward + backward of one head on d; returns (outs, grads)."""
    from tensoflow_tpu_torch.ops import stencil as st
    leaves = {k: [t.detach().clone().requires_grad_(True) for t in d[k]]
              for k in ('pp', 'lp', 'w0p')}
    one = {k: d[k].detach().clone().requires_grad_(True)
           for k in ('pe', 'b0', 'w1', 'b1')}
    args = (leaves['pp'], leaves['lp'], d['fr'], d['sigmas'], one['pe'])
    rest = (leaves['w0p'], one['b0'], one['w1'], one['b1'])
    if kernel:
        if S == 7:
            oc, oo = st.stencil_head(*args, d['rot'], *rest)
        else:
            oc, oo = st.point_head(*args, *rest), None
    else:
        oc, oo = st.stencil_head_plain(*args, d['rot'], *rest, S=S)
    loss = torch.sum(oc * d['g_c'])
    if oo is not None:
        loss = loss + torch.sum(oo * d['g_off'])
    inputs = leaves['pp'] + leaves['lp'] + leaves['w0p'] + [
        one['pe'], one['b0'], one['w1'], one['b1']]
    grads = torch.autograd.grad(loss, inputs)
    outs = [oc] + ([oo] if oo is not None else [])
    return [o.detach() for o in outs], list(grads)


def rel_err(a_list, b_list):
    """(max abs err, max abs err / max |ref|) over paired tensors."""
    worst_abs, worst_rel = 0.0, 0.0
    for a, b in zip(a_list, b_list):
        a, b = a.float(), b.float()
        e = float((a - b).abs().max())
        scale = float(b.abs().max()) + 1e-12
        worst_abs = max(worst_abs, e)
        worst_rel = max(worst_rel, e / scale)
    return worst_abs, worst_rel


def _as_f64(d):
    """The same inputs, cast up, for the float64 plain version."""
    out = dict(d)
    for k in ('pp', 'lp', 'w0p'):
        out[k] = [t.double() for t in d[k]]
    for k in ('pe', 'b0', 'w1', 'b1', 'rot', 'fr', 'g_c', 'g_off'):
        out[k] = d[k].double()
    return out


def check_case(name, n, S, B, cd, seed):
    """Kernel fwd + bwd vs the plain version on one set of inputs; raises
    beyond TOL.  Returns (max abs err fwd, bwd)."""
    d = head_inputs(n, S, B, cd, seed)
    ko, kg = run_head(d, S, kernel=True)
    po, pg = run_head(d if cd == torch.bfloat16 else _as_f64(d), S,
                      kernel=False)
    torch.cuda.synchronize()
    fa, fr_ = rel_err(ko, po)
    ba, br = rel_err(kg, pg)
    tol = TOL[cd]
    names = ([f'pp{k}' for k in range(3 * B)] + [f'lp{k}' for k in range(3 * B)]
             + ['w0a', 'w0b', 'w0c', 'w0pe', 'pe', 'b0', 'w1', 'b1'])
    detail = ', '.join(f'{nm} {rel_err([a], [b])[1]:.1e}'
                       for nm, a, b in zip(names, kg, pg))
    oracle = 'plain bf16' if cd == torch.bfloat16 else 'plain f64'
    print(f'[kernels] {name} vs {oracle}: per-grad rel err: {detail}',
          flush=True)
    extra = ''
    if cd == torch.float32:
        po32, pg32 = run_head(d, S, kernel=False)
        extra = (f'  (plain f32 vs f64: fwd {rel_err(po32, po)[1]:.2e}, '
                 f'bwd {rel_err(pg32, pg)[1]:.2e})')
        del po32, pg32
    print(f'[kernels] {name} vs {oracle}: fwd max_abs_err={fa:.3e} '
          f'rel={fr_:.3e}  bwd max_abs_err={ba:.3e} rel={br:.3e}  '
          f'(tol rel fwd {tol[0]:g}, bwd {tol[1]:g}){extra}', flush=True)
    if not (fr_ <= tol[0] and br <= tol[1]):
        raise AssertionError(f'{name}: kernel disagrees with the plain '
                             f'version (fwd {fr_:.3e}, bwd {br:.3e}, '
                             f'tol {tol})')
    return fa, ba


def head_bytes_ops(n, S, B, cd):
    """Least bytes moved and operations for one fwd / bwd call."""
    from tensoflow_tpu_torch.ops.stencil import vw
    es = 2 if cd == torch.bfloat16 else 4
    K = 3 * C + E
    weights = (K * H + H * O) * es + H * 4
    v_bytes = n * vw(S, C) * es
    fwd_in = 3 * B * n * 20 * C * es + n * 64 * 4 + n * E * es + weights
    fwd_out = n * O * 4 + (S - 1) * n * 4 + v_bytes
    fwd_ops = 2 * S * n * K * H + 2 * n * H * O + 2 * (S - 1) * n * H
    bwd_in = n * 64 * 4 + v_bytes + n * E * es + weights + n * O * 4 \
        + (S - 1) * n * 4
    bwd_out = 3 * B * n * 20 * C * es + n * E * 4 + (K * H + H * O + H) * 4
    bwd_ops = 3 * 2 * S * n * K * H + 2 * 2 * n * H * O \
        + 2 * 2 * (S - 1) * n * H
    return (fwd_in + fwd_out, fwd_ops), (bwd_in + bwd_out, bwd_ops)


def bound_ms(nbytes, ops, cd):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[cd] * 1e3
    return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')


def _device_ms(prof, name_parts, calls):
    """Summed device time (ms) per call of the kernels whose name holds
    one of name_parts, from a torch.profiler run of `calls` calls."""
    total_us = 0.0
    for e in prof.key_averages():
        if any(p in e.key for p in name_parts):
            total_us += float(getattr(e, 'device_time_total', 0.0)
                              or getattr(e, 'cuda_time_total', 0.0))
    return total_us / 1e3 / calls


def time_head(n, S, B, cd, seed):
    """ms per call, fwd and bwd, at the main shape: the plain version and
    the kernel wrappers by CUDA events, in turns plain, kernel, kernel,
    plain (best of the two turns), and the kernels' own device time by
    torch.profiler (None where the profiler shows no device time)."""
    from tensoflow_tpu_torch.ops import stencil as st
    d = head_inputs(n, S, B, cd, seed)
    out = {}
    for kernel in (False, True, True, False):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in d['pp'] + d['lp'] + d['w0p']]
        pp, lp, w0p = leaves[:3], leaves[3:6], leaves[6:]
        pe, b0, w1, b1 = [d[k].detach().clone().requires_grad_(True)
                          for k in ('pe', 'b0', 'w1', 'b1')]
        head = st.stencil_head if kernel else st.stencil_head_plain

        def fwd():
            return head(pp, lp, d['fr'], d['sigmas'], pe, d['rot'], w0p, b0,
                        w1, b1)
        f_ms = cuda_ms(fwd, iters=5)
        oc, oo = fwd()
        ins = leaves + [pe, b0, w1, b1]

        def bwd():
            torch.autograd.grad((oc, oo), ins, (d['g_c'], d['g_off']),
                                retain_graph=True)
        b_ms = cuda_ms(bwd, iters=5)
        key = 'kernel' if kernel else 'plain'
        prev = out.get(key)
        out[key] = (f_ms, b_ms) if prev is None else (
            min(prev[0], f_ms), min(prev[1], b_ms))
        if kernel:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    o = fwd()
                    torch.autograd.grad(o, ins, (d['g_c'], d['g_off']))
                torch.cuda.synchronize()
            dev = (_device_ms(prof, ['stencil_fwd_kernel'], 3),
                   _device_ms(prof, ['stencil_bwd_'], 3))
            out['device'] = tuple(x if x > 0 else None for x in dev)
        del oc, oo
    return out


def phase_kernels(card):
    errs = {}
    for cd in (torch.bfloat16, torch.float32):
        tag = 'bf16' if cd == torch.bfloat16 else 'f32'
        errs[tag] = check_case(f'S=7 B=1 static {tag} N={N_MAIN}', N_MAIN,
                               7, 1, cd, seed=1)
        check_case(f'S=7 B=2 dynamic {tag} N=16384', 16384, 7, 2, cd,
                   seed=2)
        check_case(f'S=1 B=1 static {tag} N=16384', 16384, 1, 1, cd,
                   seed=4)
        check_case(f'S=7 B=1 static {tag} N=1003 (ragged last tile)', 1003,
                   7, 1, cd, seed=6)
    cd = torch.bfloat16
    t = time_head(N_MAIN, 7, 1, cd, seed=5)
    (fb, fo), (bb, bo) = head_bytes_ops(N_MAIN, 7, 1, cd)
    fbound, fby = bound_ms(fb, fo, cd)
    bbound, bby = bound_ms(bb, bo, cd)
    dev = t['device']
    # a kernel's ms is its device time; the wrapper's (kernel + argument
    # prep) where the profiler shows none
    k_ms = [dev[i] if dev[i] is not None else t['kernel'][i]
            for i in range(2)]
    print(f'[kernels] timing at N={N_MAIN} bf16 on {card}: '
          f'fwd kernel {k_ms[0]:.3f} ms (wrapper {t["kernel"][0]:.3f}), '
          f'plain {t["plain"][0]:.3f} ms, bound {fbound:.4f} ms ({fby}: '
          f'{fb / 1e9:.3f} GB, {fo / 1e9:.1f} GFLOP); bwd kernel '
          f'{k_ms[1]:.3f} ms (wrapper {t["kernel"][1]:.3f}), plain '
          f'{t["plain"][1]:.3f} ms, bound {bbound:.4f} ms ({bby}: '
          f'{bb / 1e9:.3f} GB, {bo / 1e9:.1f} GFLOP); device times from '
          f'the profiler: {dev}', flush=True)
    return {
        'stencil_head_fwd': dict(max_abs_err=errs['bf16'][0], ms=k_ms[0],
                                 plain_ms=t['plain'][0], bound_ms=fbound,
                                 bound_by=fby),
        'stencil_head_bwd': dict(max_abs_err=errs['bf16'][1], ms=k_ms[1],
                                 plain_ms=t['plain'][1], bound_ms=bbound,
                                 bound_by=bby),
    }


# ---------------------------------------------------------------------------
# phase 3: the stage-1 training slice
# ---------------------------------------------------------------------------

SMALL_OVERRIDES = [
    'database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
    'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=4096',
    'occ_grid_reso=16', 'train_ray_num=64', 'occ_max_samples=48',
    'occ_loss_max_pn=64', 'upsample_list=null',
    'compact_samples_per_ray=16', 'gather_dtype=float32']


def _load_cfg(overrides):
    from tensoflow_tpu_torch import config as config_mod
    root = os.path.dirname(os.path.abspath(__file__))
    return config_mod.load_config(
        os.path.join(root, 'configs/shape/syn/compressor_occ.yaml'),
        overrides=overrides)


def _check_finite(logs):
    for rec in logs:
        bad = {k: v for k, v in rec.items() if not (v == v and abs(v) < 1e30)}
        if bad:
            raise AssertionError(f'non-finite loss terms at step '
                                 f'{rec["step"]}: {bad}')


def check_slice_small(steps=2):
    """The training step on the card (kernels) against the same step on
    the CPU (plain versions) at a small float32 configuration: same
    initial parameters (both trainers seed the same CPU generator), same
    batches, same noise (drawn on the CPU and copied).  Loss terms agree
    to rtol 1e-4 at the first step (float32 summation order through the
    1/eps^2 hessian) and 1e-3 at the second (Adam's first update is
    sign(g) * lr, so tiny grads may step either way)."""
    from tensoflow_tpu_torch.models import shape_renderer as sr
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer

    class CpuDraws(ShapeTrainer):
        def __init__(self, cfg, device):
            super().__init__(cfg, device=device)
            self.cpu_gen = torch.Generator().manual_seed(cfg['random_seed'])

        def step_noise(self, step):
            noise = sr.draw_noise(self.cpu_gen, self.rcfg,
                                  self.cfg['train_ray_num'], 'cpu')
            return {k: v.to(self.device) for k, v in noise.items()}

        def occ_jitter(self, step):
            r = self.occ_cfg.resolution
            return torch.rand((r ** 3, 3), generator=self.cpu_gen).to(
                self.device)

    cfg = _load_cfg(SMALL_OVERRIDES)
    logs = {dev: CpuDraws(cfg, dev).train(n_steps=steps, log_every=1)
            for dev in ('cuda', 'cpu')}
    _check_finite(logs['cuda'])
    worst = 0.0
    for i, (g, c) in enumerate(zip(logs['cuda'], logs['cpu'])):
        rtol = 1e-4 if i == 0 else 1e-3
        for k, v in c.items():
            err = abs(g[k] - v)
            if err > rtol * abs(v) + 1e-6:
                raise AssertionError(f'small slice step {i}: {k} on the '
                                     f'card {g[k]!r} vs CPU {v!r}')
            if abs(v) > 1e-6:
                worst = max(worst, err / abs(v))
    print(f'[slice] small float32 config: {steps} steps on the card match '
          f'the CPU plain path (worst loss-term rel err {worst:.2e}); '
          f'losses card {[round(r["loss"], 6) for r in logs["cuda"]]} cpu '
          f'{[round(r["loss"], 6) for r in logs["cpu"]]}', flush=True)


def profile_step(trainer, card, step_ms, top=12):
    """One more training step under torch.profiler: device time by
    kernel, kernel launches, the host's busiest operators, and the
    device's idle share of an unprofiled step (step_ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer.train(n_steps=1, log_every=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = [], []
    for e in prof.key_averages():
        if str(getattr(e, 'device_type', '')).endswith('CUDA'):
            # kernels only: an operator's entry repeats its kernels' time
            dev_us = float(getattr(e, 'self_device_time_total', 0.0)
                           or getattr(e, 'self_cuda_time_total', 0.0))
            if dev_us > 0:
                rows.append((dev_us, e.count, e.key))
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f'[slice] profiled step on {card}: wall {wall_ms:.1f} ms '
          f'(unprofiled {step_ms:.1f} ms), device kernels {busy_ms:.1f} ms '
          f'in {sum(r[1] for r in rows)} launches, idle share of the '
          f'unprofiled step {max(0.0, 1 - busy_ms / step_ms):.2f}',
          flush=True)
    for dev_us, count, key in rows[:top]:
        print(f'[slice]   device {dev_us / 1e3:8.3f} ms  x{count:<4d} '
              f'{key[:80]}')
    for cpu_us, count, key in host[:top // 2]:
        print(f'[slice]   host   {cpu_us / 1e3:8.3f} ms  x{count:<4d} '
              f'{key[:80]}')


def phase_slice(card, steps=5, timed_steps=10):
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    check_slice_small()
    cfg = _load_cfg(['database_name=toy/sphere_128_12',
                     'gather_dtype=bfloat16'])
    t0 = time.perf_counter()
    trainer = ShapeTrainer(cfg)            # device=None: the card
    trainer.init_dataset()
    torch.cuda.synchronize()
    print(f'[slice] set-up {time.perf_counter() - t0:.1f} s', flush=True)
    # the main path: step 0 runs the occupancy update, then the first
    # step; the rest are timed on their own
    st.reset_launches()
    t0 = time.perf_counter()
    logs = trainer.train(n_steps=1, log_every=1)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    logs += trainer.train(n_steps=steps - 1, log_every=1)
    torch.cuda.synchronize()
    rest = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    _check_finite(logs)
    print('[slice] loss per step: '
          + ', '.join(f'{r["loss"]:.6f}' for r in logs), flush=True)
    print('[slice] last step terms: ' + json.dumps(
        {k: round(v, 6) for k, v in logs[-1].items()}), flush=True)
    for k in ('stencil_head_fwd', 'stencil_head_bwd'):
        if launches[k] != steps:
            raise AssertionError(f'{k} launched {launches[k]} times in '
                                 f'{steps} steps')
    rays = cfg['train_ray_num']
    print(f'[slice] {steps} steps on {card}: first step (with occ update) '
          f'{first * 1e3:.1f} ms, then {rest / (steps - 1) * 1e3:.1f} '
          f'ms/step; launches {launches}', flush=True)
    # a steadier step time: 10 more steps, logged once (the launch counts
    # above are those of the main path alone)
    t0 = time.perf_counter()
    trainer.train(n_steps=timed_steps, log_every=timed_steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
    print(f'[slice] {timed_steps} more steps on {card}: {step_ms:.1f} '
          f'ms/step = {rays / (step_ms / 1e3):.0f} rays/s', flush=True)
    profile_step(trainer, card, step_ms)
    return launches


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tensoflow_tpu_torch.ops import cuda_build
    card = card_line()
    t0 = time.perf_counter()
    cuda_build.build(list(TPU_KERNELS))
    print(f'[build] kernels built in {time.perf_counter() - t0:.1f} s',
          flush=True)
    for name in TPU_KERNELS:
        log = os.path.join(cuda_build.BUILD_DIR, name + '.log')
        if not os.path.exists(log):      # built by an earlier run
            continue
        with open(log, errors='replace') as f:
            for line in f:
                if 'registers' in line or 'spill' in line:
                    print(f'[build] {name}: {line.strip()}')
    kinds = phase_kernels(card)
    launches = phase_slice(card)
    print(card)
    print(json.dumps({'kernels': [
        {'name': k, 'route': 'cuda',
         'source': f'tensoflow_tpu_torch/csrc/{k}.cu',
         'replaces': TPU_KERNELS[k], 'launches': launches[k],
         'library_ms': None, **kinds[k]} for k in TPU_KERNELS]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
