"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure exits nonzero; no phase's failure is caught; the
training phases (3, 5, 3b, 3c, 3d, in this order), the relight phase 3e,
the variants phase 3f, the sharded phase 3g, the convergence phase 3h and
the general-width phase 3i run before the kernel phases (2, then 2b), and
their profiled steps last, because running the profiler slows every later
launch of the process):
  1. build   — compile the hand-written kernels from tensoflow_tpu_torch/csrc
               (one nvcc per source, started together) and print the seconds.
  2. kernels — hold the stencil-head fwd and bwd kernels to their plain
               PyTorch version on the card at the slice's shapes
               (N = 2048 rays x 64 samples = 131,072 rows, C=36, E=21,
               H=256, O=129), in bf16 (against the plain version in bf16)
               and f32 (against the plain version in f64), with B=2
               dynamic sigma lanes (the shape after the first upsample) at
               N=131,072 and with S=1 at N=16,384, at a
               ragged N=1,003 (a partial last row tile) and at N=520
               for both heads (fewer row tiles than SMs: the persistent
               grids run short); two float32 backward launches on the
               same inputs must give bit-identical weight gradients; then
               time kernel and plain version, B=1 and B=2, in bf16 and in
               f32, beside the byte/op bound; for each float32 kernel its
               share of the bound, blocks per SM, registers and spills;
               cuBLAS float32 at the three large products' shapes as a
               yardstick; and point_head (S=1, bf16) at the occupancy
               update's chunk of 131,072 points.
  2b. general kernels — csrc/stencil_head_general.cu, the route of the
               widths the fast kernels are not built for (ops/stencil.py
               head_route), fwd and bwd against the plain version at
               GEN_CASES: NeuS's widths (C=36, E=39, H=256, O=257), a wider
               head (C=48, H=512) and a bf16 head with C % 4 != 0 (C=18,
               E=21), S in {1, 7}, B in {1, 2}, N = 131,072, 1,003 and
               512 (a render chunk's); two bit-identical backward runs in
               each dtype; what the card gives each general kernel
               (blocks per SM, registers, spills, shared memory); times
               at N = 131,072, B=1 and B=2, float32, beside the plain
               version and the bound, and the forward's at N = 512 and
               4,096 (a render and a relight chunk).
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
  3b. schedule — ShapeTrainer at the compressor_occ widths over the
               published schedule cut to single digits (upsample_list
               [2, 4], radiance head and Gaussian loss from step 4): 128^3
               -> 256^3 -> 512^3 grids, one -> three mip levels, p16 -> p4
               atlas; per-step loss, one fwd + one bwd launch a step with
               B=2 from the first upsample; 10 timed 512^3 steps, peak
               memory; the B=2 kernels on a 512^3 step's own inputs;
               render_image of the held-out toy view at downsample_ratio
               (PSNR, SSIM, forward-only kernel) and validate(); the mesh at
               256^3 with the SDF on the card, written under build/.
  3c. hierarchical — check_slice_small's twin on the hierarchical sampler
               (alpha mask, live-field occ loss, background; card vs CPU);
               then ShapeTrainer at configs/shape/syn/compressor.yaml as
               published (float32 gathers, 64 + 64 samples in 4 rounds,
               the alpha mask, no sample-variance clip) over its schedule
               cut to six steps (alpha mask after step 2, upsample_list
               [2, 4], occ loss, radiance head and Gaussian loss from step
               3): 128^3 -> 256^3 -> 512^3; per-step loss, launches, mip
               branches and live-sample share, the alpha-mask build time
               and occupied share; the 512^3 step time as the median of 5
               windows of 4 steps (min, max beside it) and peak memory;
               the f32 B=2 kernels on a 512^3 step's own inputs;
               render_image of the held-out view (PSNR, SSIM).  Then the
               background sub-phase: 5 steps at the widths of
               configs/shape/custom/shoe.yaml (predict_BG, the sample
               variance clipped) with the background net moved by the
               first step.
  3d. datasets — toy/blobs_128_12 written under build/smoke_datasets/ by
               the port's own writers (imwrite_png, colmap_model, write_ply
               and a ZIP / HALF EXR writer here) in every layout: tensoSDF
               (with a test split: _normal.png, _diffColor.exr), nerf,
               tensoIR, orb, syn, custom/<obj>/raw, raw_64 (resize),
               custom/<obj>/96 and real/<obj>/96 (crops), a JPEG capture
               (custom/<obj>/raw_64 with a JPEG cache), and read back
               through parse_database_name, equal to what was written;
               a tensoSDF layout of 50 views of 800x800 RGBA loaded (host
               s/view), the C++ PNG defilter against its numpy version on
               one view, a 1600x1200 JPEG read and written, the ray
               batch's host bytes at the published 100 views;
               compressor.yaml trained 4 steps from the
               tensoSDF layout (the ray batch and the first step's loss
               terms equal to the same trainer's through ToyDatabase), one
               fwd + one bwd launch a step; shoe.yaml from the JPEG
               capture's raw_64: the rays of its published nerfDataType
               (true) that meet the aabb counted, then 4 steps with
               nerfDataType false (the w2c ray function); stage
               2 (mat compressor.yaml widths) 4 steps from the tensoSDF
               layout on phase 5's checkpoint; python -m
               tensoflow_tpu_torch.eval_geo on the test split and
               eval_orb_shape between that checkpoint's mesh and the
               analytic blobs mesh.
  3e. relight — on phase 5's material model (saved where the CLI looks
               for it) and phase 3d's orb/ layout: a 64x128 sky written as
               a ZIP / HALF .exr and as a Radiance .hdr, read back; python
               -m tensoflow_tpu_torch.relight_orb once per env file (the
               test views relit, shaded pixels counted, the two renders
               within 8 / 255); on syn/ (GlossySynthetic, w2c poses) the
               CLI's rays that hit the surface counted (none: a quirk of
               the reference); eval_mat --extract_mats --relight (no
               blender: the bundle is left); eval_orb_relight on the relit
               views with the toy views as "gt" (only shows that the path
               runs); one 4096-ray chunk of relight_view with fixed rolls
               on the card against the CPU plain path (colours, light rays
               classified differently); an 800x800 view (a toy view's K
               scaled) at phase 5's widths: s/view, ms a chunk, one stencil
               forward a chunk; the stencil forward on its middle chunk's
               own inputs against its plain version, timed beside the
               bound.  Its profiled chunk runs with the others at the end.
  3f. variants — the options no published config sets.  Stage 2 at the
               widths of configs/mat/syn/compressor.yaml on phase 5's
               checkpoint with phase 5's cuts, once for each of
               flow_type pwlinear, flow_type realnvp, shade_mixed_all +
               use_nis_all (as tests/test_train_material.py sets it, then
               with use_nis_diffuse so that flow_all gets a loss) and
               disable_tensorial + disable_reflected: each variant's
               small step on the card against the CPU (check_stage2_small),
               then 12 steps across the NIS phases (finite terms, the
               flows a NIS-loss step moves, the median ms/step of each
               phase beside phase 5's pwquad), one validated view for
               realnvp and both shade_mixed_all runs (_nis pass, one
               stencil forward a chunk), the stencil launches of that path
               counted; predict_materials through mat_pack against the raw
               planes.  Stage 1's human light: the small card-vs-CPU
               comparison with it on, then configs/shape/custom/shoe.yaml
               with the human light turned on in its renderer config on
               phase 3d's JPEG capture,
               5 steps (one fwd + one bwd launch a step, the light's MLP
               moved by the first step, the share of shaded samples it
               lights).  The split stencil route: sdf_with_grad_hessian
               with stencil_impl 'xla' against the kernels on a 512^3
               hierarchical step's own inputs (phase 3c's trainer):
               agreement and both times.  Profiled last: a human-light
               step and a shade_mixed_all step.
  3g. sharded — the multi-device path (parallel/sharding.py), in
               subprocesses of this script (no process group lives in the
               main process): two gloo ranks on the one card run
               configs/shape/syn/compressor.yaml's hierarchical step at
               512^3 from step 0 (1,024 rays, 512 a rank; the grid at its
               N_voxel_final, occ loss, radiance head and Gaussian loss on)
               and configs/mat/syn/compressor.yaml's stage-2 step (2,048
               rays, both flows sampling and training) on phase 5's
               checkpoint; each is held to the single-device step of the
               same params, batch and draws run in this process at the CPU
               tests' tolerance (rtol 2e-4 / atol 2e-5), the ranks' params
               must be equal bit for bit, one fwd + one bwd stencil launch
               a rank and stage-1 step, and the kernels are held to their
               plain version on rank 0's shard.  Beside them: python -m
               tensoflow_tpu_torch.run_training --multihost (NCCL, one
               rank) on configs/shape/toy/sphere.yaml for 2 steps, and
               python -m tensoflow_tpu_torch.parallel.dryrun with 2 gloo
               ranks on the card.  Then one NCCL rank: both steps' ms/step
               sharded beside unsharded in one process, the gradient
               buffer's bytes and its all-reduce time.
  3h. convergence — the evidence scripts (tensoflow_tpu_torch/scripts/):
               the float32 stencil kernels at their widths (C=16 at N=49,152,
               B=1 and B=2; C=12 at N=24,576; H=128, O=65) against the
               plain version in float64 at TOL; then each script's run
               function at toy step counts with the launch counts reset
               just before: convergence_run 40 steps (upsamples at 10 / 20,
               two marks, Chamfer at 64^3), convergence_mat and ab_material
               20 stage-1 + 20 stage-2 steps (NIS sampling from step 5);
               each artifact must carry every key of the JAX artifact in
               data/convergence/, finite values only and this card's name.
  3i. general — the widths past the fast kernels through the user's entry
               points: 2 steps card vs CPU at NeuS's head widths on a small
               hierarchical config, and on the small occupancy-grid config
               without compaction (compact_samples_per_ray 0);
               compressor.yaml with sdf_multires 6 and app_dim 256 over
               phase 3c's cut schedule (six steps, 128^3 -> 512^3, the
               general kernels' launches counted from zero), 5 timed
               512^3 steps beside phase 3c's, the kernels on a step's own
               inputs, a rendered view, the mesh at 128^3; stage 2 on a
               checkpoint at these widths (2 steps card vs CPU, a render, a
               relight_view chunk); compressor_occ.yaml without compaction
               at these widths, 2 + 4 timed steps at 128^3.  Its 512^3
               step is profiled at the end with the others (device time,
               the general kernels' share, idle share).
  4. probes  — the four tile-gather kernels (ops/tile_gather.py) against
               their plain versions and torch.index_select / torch.gather
               at every shape of the gather probes and at the ragged
               shapes of microbench_r3.ragged_gather_cases (exact
               equality); at the probe shapes timed beside the byte bound,
               the library call and the launch floor (a one-element fill_
               in the same profiled window); then the microbench entry
               point tensoflow_tpu_torch.bench.microbench_r3 in-process,
               with the launch counts reset just before.
  5. stage 2 — small: one stage-2 step of a small float32 configuration
               on the card against the same step on the CPU (same
               parameters, grid, batch and noise), loss terms compared;
               and sphere_trace_budget on 1.77 M rays against the
               two-lobe analytic grid at 256^3, beside the unbudgeted
               trace.  Full width: a ShapeTrainer at the compressor_occ
               widths on toy/blobs_128_12 trains in rounds of 8 steps
               until a probe trace of its SDF keeps surface hits, and
               saves a checkpoint under build/; MaterialTrainer at the
               widths of
               configs/mat/syn/compressor.yaml (512 + 256 analytic and
               64 + 32 flow samples, 512^3 field grids, 256^3 bake, 2048
               rays, bf16 estimator) runs init_dataset and 12 steps across
               its three phases (no NIS, NIS loss, NIS sampling).  Then
               its evaluation: render_image of the held-out view (the
               toy split's, split_manul false) in chunks of 512 (s/view,
               rays/s, PSNR of both variants, hit share, one stencil
               forward a chunk) and validate(); the stencil forward on
               the render's own N = 512 inputs (the first chunk and a
               padded last one) against its plain version, timed beside
               a chunk; env_light_image at 256x512;
               predict_vertex_materials on the checkpoint's mesh at
               128^3.  A 16x16 render of the small configuration on the
               card against the CPU (both variants, hit pixels).  The
               lights sub-phase: configs/mat/syn/lego.yaml ('direction')
               and configs/mat/custom/shoe.yaml ('sphere_direction' +
               human lights) at their widths on the same checkpoint, 12
               steps across the NIS phases, the light MLPs moved by the
               first step, one validated view.  Last, one profiled step
               and one profiled render chunk.  The cuts are the database
               and the NIS schedule, both printed.
Then it prints the card's name and power limit, one JSON line listing
every hand-written kernel (the general-width stencil kernels with their
float32 B=2 figures at NeuS's widths and their launches in phase 3i; the
stencil kernels with their float32 B=2
figures, the shape of 80 % of a published run, and their launches in
phase 3c, the other instantiations and the launches of phase 3b, of
phase 5's render, of phase 3d's from-disk training, of phase 3e's
800x800 relit view, of phase 3f's human-light steps and stage-2
variants, of phase 3g's two ranks' sharded stage-1 steps and of phase
3h's evidence runs beside them),
and as the last line
{"ok": true, "device": {...}}.  Without CUDA, or outside the repo, it
exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
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
# the gather probes: wrapper -> (source, probe it replaces, the case of
# microbench_r3.gather_cases whose numbers go into the kernels line)
GATHER_KERNELS = {
    'row_gather_tile': ('scripts/microbench_r3.py:68',
                        'row_gather_tile lanes=1280'),
    'row_gather_grid': ('scripts/microbench_r3.py:98',
                        'row_gather_grid 512x[256,1280]'),
    'lane_gather_tile': ('scripts/microbench_r3.py:126',
                         'lane_gather_tile lanes=512'),
    'row_gather_tile_bf16': ('scripts/microbench_r3.py:155',
                             'row_gather_tile_bf16 lanes=1280'),
}
SOURCES = ('stencil_head_fwd', 'stencil_head_bwd', 'stencil_head_general',
           'tile_gather')


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(lines):
    """Each kernel's registers, shared memory and spills from nvcc's
    -Xptxas -v output, under the kernel's mangled entry name."""
    kernel = None
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and ('registers' in line or 'spill' in line):
            yield f'{kernel}: {line.split(":", 1)[-1].strip()}'


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

def head_inputs(n, S, B, cd, seed, widths=(C, H, O), e=E):
    """Slice-shaped stencil-head inputs made on the card from a seed, at
    ``widths`` (C, H, O) and PE width ``e``: the published ones by
    default."""
    from tensoflow_tpu_torch.ops.tensor_field import FRAC_STRIDE as FS
    C, H, O = widths
    E = e
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
        if not bool(torch.isfinite(a).all()):
            return float('inf'), float('inf')     # max() would drop a NaN
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


def check_case(name, n, S, B, cd, seed, widths=(C, E, H, O)):
    """Kernel fwd + bwd vs the plain version on random inputs made from a
    seed, at ``widths`` (C, E, H, O); raises beyond TOL.  Returns (max abs
    err fwd, bwd)."""
    c, e, h, o = widths
    return check_inputs(name, head_inputs(n, S, B, cd, seed, (c, h, o), e),
                        S, cd)


def check_inputs(name, d, S, cd):
    """Kernel fwd + bwd vs the plain version on the inputs d (as
    head_inputs makes them); raises beyond TOL.  Returns (max abs err fwd,
    bwd)."""
    B = len(d['sigmas'])
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


def head_bytes_ops(n, S, B, cd, widths=(C, E, H, O)):
    """Least bytes moved and operations for one fwd / bwd call at
    ``widths`` (C, E, H, O)."""
    from tensoflow_tpu_torch.ops.stencil import vw
    C, E, H, O = widths
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


# the device kernels of a fwd / bwd call by route (profiler name parts)
KERNEL_NAMES = {'fast': (['stencil_fwd_'], ['stencil_bwd_']),
                'general': (['stencil_gen_fwd'],
                            ['stencil_gen_bwd_rows', 'stencil_gen_atb',
                             'stencil_gen_colsum'])}


def time_head(n, S, B, cd, seed, widths=(C, E, H, O)):
    """ms per call, fwd and bwd, at the main shape: the plain version and
    the kernel wrappers by CUDA events, in turns plain, kernel, kernel,
    plain (best of the two turns), and the kernels' own device time by
    torch.profiler (None where the profiler shows no device time)."""
    from tensoflow_tpu_torch.ops import stencil as st
    c, e, h, o = widths
    d = head_inputs(n, S, B, cd, seed, (c, h, o), e)
    names = KERNEL_NAMES[st.head_route(cd, S, B, c, e, h, o)]
    out = {}
    for kernel in (False, True, True, False):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in d['pp'] + d['lp'] + d['w0p']]
        pp, lp = leaves[:3 * B], leaves[3 * B:6 * B]
        w0p = leaves[6 * B:]
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
            dev = (_device_ms(prof, names[0], 3),
                   _device_ms(prof, names[1], 3))
            out['device'] = tuple(x if x > 0 else None for x in dev)
        del oc, oo
    return out


def time_point_head(card, n=131072):
    """point_head (S=1, bf16, no gradient) at the occupancy update's chunk
    size (shape_renderer.compute_sdf_chunked), beside its byte bound."""
    from torch.profiler import ProfilerActivity, profile
    from tensoflow_tpu_torch.ops import stencil as st
    cd = torch.bfloat16
    d = head_inputs(n, 1, 1, cd, seed=9)

    def call():
        with torch.no_grad():
            return st.point_head(d['pp'], d['lp'], d['fr'], d['sigmas'],
                                 d['pe'], d['w0p'], d['b0'], d['w1'], d['b1'])
    wrapper_ms = cuda_ms(call, iters=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    dev_ms = _device_ms(prof, ['stencil_fwd_'], 3)
    (fb, fo), _ = head_bytes_ops(n, 1, 1, cd)
    fb -= n * st.vw(1, C) * 2          # no V is saved without a gradient
    bound, by = bound_ms(fb, fo, cd)
    print(f'[kernels] point_head S=1 bf16 N={n} (the occupancy update\'s '
          f'chunk) on {card}: kernel {dev_ms:.3f} ms (wrapper '
          f'{wrapper_ms:.3f}), bound {bound:.4f} ms ({by}: {fb / 1e9:.3f} GB, '
          f'{fo / 1e9:.1f} GFLOP)', flush=True)


def time_row(card, B, cd, errs):
    """Kernel, plain version and bound of both heads at N_MAIN, S=7; the
    kernels line's numbers for one (type, B)."""
    tag = 'bf16' if cd == torch.bfloat16 else 'f32'
    t = time_head(N_MAIN, 7, B, cd, seed=5)
    (fb, fo), (bb, bo) = head_bytes_ops(N_MAIN, 7, B, cd)
    fbound, fby = bound_ms(fb, fo, cd)
    bbound, bby = bound_ms(bb, bo, cd)
    dev = t['device']
    # a kernel's ms is its device time; the wrapper's (kernel + argument
    # prep) where the profiler shows none
    k_ms = [dev[i] if dev[i] is not None else t['kernel'][i]
            for i in range(2)]
    print(f'[kernels] timing B={B} at N={N_MAIN} {tag} on {card}: '
          f'fwd kernel {k_ms[0]:.3f} ms (wrapper {t["kernel"][0]:.3f}), '
          f'plain {t["plain"][0]:.3f} ms, bound {fbound:.4f} ms ({fby}: '
          f'{fb / 1e9:.3f} GB, {fo / 1e9:.1f} GFLOP); bwd kernel '
          f'{k_ms[1]:.3f} ms (wrapper {t["kernel"][1]:.3f}), plain '
          f'{t["plain"][1]:.3f} ms, bound {bbound:.4f} ms ({bby}: '
          f'{bb / 1e9:.3f} GB, {bo / 1e9:.1f} GFLOP); device times from '
          f'the profiler: {dev}', flush=True)
    return {
        'stencil_head_fwd': dict(max_abs_err=errs[0], ms=k_ms[0],
                                 plain_ms=t['plain'][0], bound_ms=fbound,
                                 bound_by=fby),
        'stencil_head_bwd': dict(max_abs_err=errs[1], ms=k_ms[1],
                                 plain_ms=t['plain'][1], bound_ms=bbound,
                                 bound_by=bby)}


F32_KERNELS = (('fwd', 7, 2), ('fwd', 7, 1), ('fwd', 1, 1), ('fwd', 1, 2),
               ('bwd', 7, 2), ('bwd', 7, 1), ('bwd', 1, 1), ('bwd', 1, 2),
               ('atb', 0, 0))


def f32_kernel_info():
    """Blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and local (spill) bytes a thread and shared memory a block
    of each float32 kernel, from the libraries' own entry points."""
    import ctypes
    from tensoflow_tpu_torch.ops import stencil as st
    fwd = st._lib('stencil_head_fwd', st._FWD_ARGS)
    bwd = st._lib('stencil_head_bwd', st._BWD_ARGS)
    out = {}
    for kern, S, B in F32_KERNELS:
        buf = (ctypes.c_int * 4)()
        if kern == 'fwd':
            err = fwd.stencil_head_fwd_f32_info(S, B, buf)
            name = f'stencil_fwd_f32<{S},{B}>'
        elif kern == 'bwd':
            err = bwd.stencil_head_bwd_f32_info(0, S, B, buf)
            name = f'stencil_bwd_rows_f32<{S},{B}>'
        else:
            err = bwd.stencil_head_bwd_f32_info(1, 0, 0, buf)
            name = 'stencil_bwd_atb_f32'
        if err != 0:
            raise RuntimeError(f'{name}: info CUDA error {err}')
        out[name] = dict(blocks_per_sm=buf[0], registers=buf[1],
                         spill_bytes=buf[2], smem_bytes=buf[3])
    return out


def check_bwd_deterministic(n, S, B, seed, widths=(C, E, H, O),
                            cd=torch.float32):
    """Two backward launches on the same inputs give bit-identical
    weight gradients (dW0, db0, dW1 with dw1row in its column 0): no
    atomics, every sum over rows in a fixed order."""
    c, e, h, o = widths
    d = head_inputs(n, S, B, cd, seed, (c, h, o), e)
    grads = [run_head(d, S, kernel=True)[1] for _ in range(2)]
    names = ('w0a', 'w0b', 'w0c', 'w0pe', 'pe', 'b0', 'w1')   # after pp, lp
    same = {nm: bool(torch.equal(grads[0][6 * B + k], grads[1][6 * B + k]))
            for k, nm in enumerate(names) if nm != 'pe'}
    print(f'[kernels] {cd} S={S} B={B} N={n} widths {widths}: two backward '
          f'launches give bit-identical weight gradients: {same}', flush=True)
    if not all(same.values()):
        raise AssertionError(f'backward is not deterministic: {same}')


def cublas_yardstick(card, n=N_MAIN):
    """cuBLAS float32 (TF32 off) torch.matmul at the float32 kernels' three
    large products: z = X.W0 [7N,144].[144,256], dX = dz.W0^T
    [7N,256].[256,144] and dW0 = X^T.dz [144,7N].[7N,256].  What the
    card's SGEMM reaches on these shapes; a yardstick, not the port."""
    from tensoflow_tpu_torch.ops import stencil as st
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m = 7 * n
        x = torch.randn(m, st.F32_XP, device='cuda')
        w = torch.randn(st.F32_XP, st.F32_HP, device='cuda')
        dz = torch.randn(m, st.F32_HP, device='cuda')
        ms = [cuda_ms(lambda: x @ w), cuda_ms(lambda: dz @ w.t()),
              cuda_ms(lambda: x.t() @ dz)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    flops = 2 * m * st.F32_XP * st.F32_HP
    rates = [flops / (t * 1e-3) / 1e12 for t in ms]
    print(f'[kernels] cuBLAS float32 yardstick (allow_tf32 False) on {card}, '
          f'{flops / 1e9:.1f} GFLOP each: X.W0 [{m},144].[144,256] '
          f'{ms[0]:.3f} ms ({rates[0]:.1f} TFLOP/s), dz.W0^T '
          f'[{m},256].[256,144] {ms[1]:.3f} ms ({rates[1]:.1f}), X^T.dz '
          f'[144,{m}].[{m},256] {ms[2]:.3f} ms ({rates[2]:.1f})', flush=True)
    del x, w, dz
    return ms


def phase_kernels(card):
    errs = {}
    for cd in (torch.bfloat16, torch.float32):
        tag = 'bf16' if cd == torch.bfloat16 else 'f32'
        errs[tag] = check_case(f'S=7 B=1 static {tag} N={N_MAIN}', N_MAIN,
                               7, 1, cd, seed=1)
        errs[tag + ' B=2'] = check_case(
            f'S=7 B=2 dynamic {tag} N={N_MAIN} (after the first upsample)',
            N_MAIN, 7, 2, cd, seed=2)
        check_case(f'S=1 B=1 static {tag} N=16384', 16384, 1, 1, cd,
                   seed=4)
        check_case(f'S=7 B=1 static {tag} N=1003 (ragged last tile)', 1003,
                   7, 1, cd, seed=6)
        check_case(f'S=7 B=1 static {tag} N=520 (fewer tiles than SMs)', 520,
                   7, 1, cd, seed=7)
        check_case(f'S=1 B=1 static {tag} N=520 (point_head, fewer tiles '
                   'than SMs)', 520, 1, 1, cd, seed=8)
    check_bwd_deterministic(N_MAIN, 7, 2, seed=12)
    info = f32_kernel_info()
    rows = {}
    for cd in (torch.bfloat16, torch.float32):
        tag = 'bf16' if cd == torch.bfloat16 else 'f32'
        for B in (1, 2):
            rows[tag, B] = time_row(card, B, cd, errs[tag if B == 1
                                                     else tag + ' B=2'])
    for B in (2, 1):
        report_f32(card, B, rows['f32', B], info)
    cublas_yardstick(card)
    time_point_head(card)
    return rows


# the general-width kernels (csrc/stencil_head_general.cu) on the card:
# NeuS's widths, a wider head, and a bf16 head the wgmma kernels refuse
# for its C % 4 != 0; (S, B, N, widths (C, E, H, O)), both dtypes unless
# the widths are BF18's (the float32 fast kernels take those)
GEN_NEUS, GEN_WIDE, GEN_BF18 = ((36, 39, 256, 257), (48, 39, 512, 257),
                                (18, 21, 256, 129))
GEN_CASES = ((7, 1, N_MAIN, GEN_NEUS), (7, 2, N_MAIN, GEN_NEUS),
             (1, 2, 1003, GEN_NEUS), (7, 2, 1003, GEN_NEUS),
             (7, 2, 512, GEN_NEUS),
             (1, 1, N_MAIN, GEN_WIDE), (7, 1, 1003, GEN_WIDE),
             (7, 1, N_MAIN, GEN_BF18), (1, 2, 1003, GEN_BF18))
GEN_SOURCE = 'tensoflow_tpu_torch/csrc/stencil_head_general.cu'
# the forward's chunk sizes off the training step: a stage-2 render chunk
# of 512 rays (one surface point a ray), a relight chunk of 4,096
GEN_SMALL_N = (512, 4096)


def gen_kernel_info(widths, kind, S=7, B=2, tr=None, dtype=0):
    """Blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and local (spill) bytes a thread and shared memory a block
    of a general kernel at ``widths`` (C, E, H, O): kind 'fwd', 'bwd'
    (the row kernel, at tr rows a tile: the route's own by default),
    'atb_dw0' or 'atb_dw1' (the weight-gradient product at dW0's or
    dW1's output shape), from the library's own entry point."""
    import ctypes
    from tensoflow_tpu_torch.ops import stencil as st
    if tr is None:
        tr = st.gen_tile_rows('fwd' if kind == 'fwd' else 'bwd', S, *widths)
    code = {'fwd': 0, 'bwd': 1, 'atb_dw0': 2, 'atb_dw1': 3}[kind]
    buf = (ctypes.c_int * 4)()
    err = st._gen_lib().stencil_gen_info(code, dtype, S, B, *widths, tr, buf)
    if err != 0:
        raise RuntimeError(f'stencil_gen_info {kind} {widths}: CUDA error '
                           f'{err}')
    return dict(blocks_per_sm=buf[0], registers=buf[1], spill_bytes=buf[2],
                smem_bytes=buf[3])


def time_gen_fwd_small(card, n, seed=21):
    """The general forward (float32, NeuS widths, B=2, no gradient, as a
    render or relight chunk calls it) at n rows: its device time from the
    profiler (20 calls) and the wrapper's by CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    from tensoflow_tpu_torch.ops import stencil as st
    c, e, h, o = GEN_NEUS
    d = head_inputs(n, 7, 2, torch.float32, seed, (c, h, o), e)

    def call():
        with torch.no_grad():
            return st.stencil_head(d['pp'], d['lp'], d['fr'], d['sigmas'],
                                   d['pe'], d['rot'], d['w0p'], d['b0'],
                                   d['w1'], d['b1'])
    wrapper_ms = cuda_ms(call, iters=20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    dev_ms = _device_ms(prof, KERNEL_NAMES['general'][0], 20)
    (fb, fo), _ = head_bytes_ops(n, 7, 2, torch.float32, widths=GEN_NEUS)
    fb -= n * st.vw(7, c) * 4          # no V is saved without a gradient
    bound, by = bound_ms(fb, fo, torch.float32)
    print(f'[kernels] general fwd B=2 N={n} f32 (C, E, H, O) = {GEN_NEUS} '
          f'on {card}: kernel {dev_ms:.4f} ms (wrapper {wrapper_ms:.4f}), '
          f'bound {bound:.4f} ms ({by}: {fb / 1e9:.4f} GB, '
          f'{fo / 1e9:.2f} GFLOP), grid '
          f'{st.gen_grid("fwd", st._n_sm(torch.device("cuda")), 7, *GEN_NEUS, n)}'
          ' blocks', flush=True)
    return dict(ms=dev_ms, wrapper_ms=wrapper_ms, bound_ms=bound,
                bound_by=by)


def phase_general_kernels(card):
    """The general kernels, fwd + bwd, against the plain version at
    GEN_CASES (float32 against float64 at TOL, bf16 against bf16), two
    bit-identical backward runs in each dtype, and their times at
    N_MAIN, B=1 and B=2, at the NeuS widths in float32 (the compressor
    configs' gather dtype) beside the plain version and the bound.
    Returns the kernels line's figures by B."""
    from tensoflow_tpu_torch.ops import stencil as st
    t0 = time.perf_counter()
    errs = {}
    for cd in (torch.float32, torch.bfloat16):
        tag = 'bf16' if cd == torch.bfloat16 else 'f32'
        for S, B, n, w in GEN_CASES:
            if w == GEN_BF18 and cd == torch.float32:
                continue
            if st.head_route(cd, S, B, *w) != 'general':
                raise AssertionError(f'{w} {cd}: not the general route')
            errs[tag, S, B, n, w] = check_case(
                f'general S={S} B={B} {tag} N={n} (C, E, H, O) = {w}', n, S,
                B, cd, seed=S + 3 * B + n % 97, widths=w)
        check_bwd_deterministic(N_MAIN, 7, 2, 12, widths=GEN_NEUS, cd=cd)
    info = {k: gen_kernel_info(GEN_NEUS, k)
            for k in ('fwd', 'bwd', 'atb_dw0', 'atb_dw1')}
    for k, v in info.items():
        print(f'[kernels] general {k} f32 S=7 B=2 (C, E, H, O) = {GEN_NEUS} '
              f'on {card}: {v["blocks_per_sm"]} blocks/SM, '
              f'{v["registers"]} registers, {v["spill_bytes"]} spill bytes, '
              f'{v["smem_bytes"]} B smem', flush=True)
    for kind in ('fwd', 'bwd'):
        tr = st.gen_tile_rows(kind, 7, *GEN_NEUS)
        want = st.gen_blocks_per_sm(kind, st.gen_smem_bytes(kind, 7,
                                                            *GEN_NEUS, tr))
        if info[kind]['blocks_per_sm'] < want:
            raise AssertionError(f'general {kind}: the card holds '
                                 f'{info[kind]["blocks_per_sm"]} blocks a '
                                 f'SM, the grid counts on {want}')
    occupancy = {'stencil_head_general_fwd': {'stencil_gen_fwd': info['fwd']},
                 'stencil_head_general_bwd': {
                     'stencil_gen_bwd_rows': info['bwd'],
                     'stencil_gen_atb dW0': info['atb_dw0'],
                     'stencil_gen_atb dW1': info['atb_dw1']}}
    rows = {}
    for B in (1, 2):
        t = time_head(N_MAIN, 7, B, torch.float32, seed=5, widths=GEN_NEUS)
        (fb, fo), (bb, bo) = head_bytes_ops(N_MAIN, 7, B, torch.float32,
                                            widths=GEN_NEUS)
        err = errs.get(('f32', 7, B, N_MAIN, GEN_NEUS))
        row = {}
        for i, (k, nb, no) in enumerate((('stencil_head_general_fwd', fb, fo),
                                         ('stencil_head_general_bwd', bb,
                                          bo))):
            bound, by = bound_ms(nb, no, torch.float32)
            ms = t['device'][i] if t['device'][i] is not None \
                else t['kernel'][i]
            row[k] = dict(max_abs_err=err[i], ms=ms, plain_ms=t['plain'][i],
                          bound_ms=bound, bound_by=by,
                          occupancy=occupancy[k])
            print(f'[kernels] general B={B} N={N_MAIN} f32 (C, E, H, O) = '
                  f'{GEN_NEUS} {k} on {card}: {ms:.3f} ms (wrapper '
                  f'{t["kernel"][i]:.3f}), plain {t["plain"][i]:.3f} ms, '
                  f'bound {bound:.4f} ms ({by}: {nb / 1e9:.3f} GB, '
                  f'{no / 1e9:.1f} GFLOP), share of bound '
                  f'{bound / ms:.3f}', flush=True)
        rows[B] = row
    rows['small'] = {n: time_gen_fwd_small(card, n) for n in GEN_SMALL_N}
    print(f'[kernels] general kernels phase in {time.perf_counter() - t0:.1f}'
          ' s', flush=True)
    return rows


def report_f32(card, B, row, info):
    """The float32 kernels of one B at N_MAIN: ms, bound, share of the
    bound, and what the card gives each kernel (blocks per SM, registers
    and spills a thread, shared memory a block)."""
    def what(name):
        k = info[name]
        return (f'{name}: {k["blocks_per_sm"]} blocks/SM, '
                f'{k["registers"]} registers, {k["spill_bytes"]} spill '
                f'bytes, {k["smem_bytes"]} B smem')
    for key, kerns in (('stencil_head_fwd', [f'stencil_fwd_f32<7,{B}>']),
                       ('stencil_head_bwd', [f'stencil_bwd_rows_f32<7,{B}>',
                                             'stencil_bwd_atb_f32'])):
        r = row[key]
        row[key] = dict(r, **{'occupancy': {k: info[k] for k in kerns}})
        print(f'[kernels] f32 B={B} N={N_MAIN} {key} on {card}: '
              f'{r["ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms '
              f'({r["bound_by"]}), share of bound '
              f'{r["bound_ms"] / r["ms"]:.3f}; '
              + '; '.join(what(k) for k in kerns), flush=True)


# ---------------------------------------------------------------------------
# phase 3: the stage-1 training slice
# ---------------------------------------------------------------------------

SMALL_OVERRIDES = [
    'database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
    'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=4096',
    'occ_grid_reso=16', 'train_ray_num=64', 'occ_max_samples=48',
    'occ_loss_max_pn=64', 'upsample_list=null',
    'compact_samples_per_ray=16', 'gather_dtype=float32']


def _load_cfg(overrides, yaml='configs/shape/syn/compressor_occ.yaml'):
    from tensoflow_tpu_torch import config as config_mod
    root = os.path.dirname(os.path.abspath(__file__))
    return config_mod.load_config(os.path.join(root, yaml),
                                  overrides=overrides)


def _check_finite(logs):
    for rec in logs:
        bad = {k: v for k, v in rec.items() if not (v == v and abs(v) < 1e30)}
        if bad:
            raise AssertionError(f'non-finite loss terms at step '
                                 f'{rec["step"]}: {bad}')


def card_vs_cpu(cfg, what, steps=2, configure=None):
    """The training step on the card (kernels) against the same step on
    the CPU (plain versions) at a small float32 configuration: same
    initial parameters (both trainers seed the same CPU generator), same
    batches, same noise (drawn on the CPU and copied).  Loss terms agree
    to rtol 1e-4 at the first step (float32 summation order through the
    1/eps^2 hessian) and 1e-3 at the second (Adam's first update is
    sign(g) * lr, so tiny grads may step either way).  Returns the
    trainers by device, their logs and the worst relative error."""
    from tensoflow_tpu_torch.models import shape_renderer as sr
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer

    class CpuDraws(ShapeTrainer):
        def __init__(self, cfg, device):
            super().__init__(cfg, device=device, configure=configure)
            self.cpu_gen = torch.Generator().manual_seed(cfg['random_seed'])

        def step_noise(self, step):
            noise = sr.draw_noise(self.cpu_gen, self.rcfg,
                                  self.cfg['train_ray_num'], 'cpu')
            return {k: v.to(self.device) for k, v in noise.items()}

        def occ_jitter(self, step):
            r = self.occ_cfg.resolution
            return torch.rand((r ** 3, 3), generator=self.cpu_gen).to(
                self.device)

    runs = {dev: CpuDraws(cfg, dev) for dev in ('cuda', 'cpu')}
    logs = {dev: t.train(n_steps=steps, log_every=1)
            for dev, t in runs.items()}
    _check_finite(logs['cuda'])
    worst = 0.0
    for i, (g, c) in enumerate(zip(logs['cuda'], logs['cpu'])):
        rtol = 1e-4 if i == 0 else 1e-3
        for k, v in c.items():
            err = abs(g[k] - v)
            if err > rtol * abs(v) + 1e-6:
                raise AssertionError(f'{what} step {i}: {k} on the card '
                                     f'{g[k]!r} vs CPU {v!r}')
            if abs(v) > 1e-6:
                worst = max(worst, err / abs(v))
    return runs, logs, worst


def _losses(logs):
    return (f'losses card {[round(r["loss"], 6) for r in logs["cuda"]]} '
            f'cpu {[round(r["loss"], 6) for r in logs["cpu"]]}')


def check_slice_small(steps=2):
    """card_vs_cpu at a small float32 occupancy-grid configuration."""
    _, logs, worst = card_vs_cpu(_load_cfg(SMALL_OVERRIDES), 'small slice',
                                 steps)
    print(f'[slice] small float32 config: {steps} steps on the card match '
          f'the CPU plain path (worst loss-term rel err {worst:.2e}); '
          f'{_losses(logs)}', flush=True)


def profile_step(trainer, card, step_ms, top=12, tag='slice', run=None,
                 what='step'):
    """One more training step (or ``run()``) under torch.profiler: device
    time by kernel, kernel launches, the host's busiest operators, and the
    device's idle share of an unprofiled step (step_ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        if run is None:
            trainer.train(n_steps=1, log_every=1)
        else:
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = [], []
    for e in prof.key_averages():
        if getattr(e, 'is_user_annotation', False):
            # a range on the device timeline (Optimizer.step#Adam.step)
            # spans kernels that are counted on their own
            continue
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
    print(f'[{tag}] profiled {what} on {card}: wall {wall_ms:.1f} ms '
          f'(unprofiled {step_ms:.1f} ms), device kernels {busy_ms:.1f} ms '
          f'in {sum(r[1] for r in rows)} launches, idle share of the '
          f'unprofiled {what} {max(0.0, 1 - busy_ms / step_ms):.2f}',
          flush=True)
    for dev_us, count, key in rows[:top]:
        print(f'[{tag}]   device {dev_us / 1e3:8.3f} ms  x{count:<4d} '
              f'{key[:80]}')
    for dev_us, count, key in rows[top:]:
        if 'stencil_' in key:      # the hand-written kernels, wherever
            print(f'[{tag}]   device {dev_us / 1e3:8.3f} ms  x{count:<4d} '
                  f'{key[:80]}')
    for cpu_us, count, key in host[:top // 2]:
        print(f'[{tag}]   host   {cpu_us / 1e3:8.3f} ms  x{count:<4d} '
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
    return launches, trainer, step_ms


# ---------------------------------------------------------------------------
# phase 3b: stage 1 over its published schedule (upsamplings, eval, mesh)
# ---------------------------------------------------------------------------

# compressor_occ upsamples at steps 20,000 and 40,000 and turns the
# radiance head and the Gaussian loss on after step 20,000; cut to single
# digits so that a few steps cross both upsamplings with both live.  The
# toy scene keeps one view out (split_manul=false) for the render.
SCHEDULE_CUTS = ['database_name=toy/sphere_128_12', 'gather_dtype=bfloat16',
                 'upsample_list=[2,4]', 'radiance_field_step=3',
                 'gaussianLoss_step=3', 'split_manul=false']


class HeadSpy:
    """Records the mip-branch count B of every stencil-head kernel call
    and, when ``capture_next`` is set (or at the call of index
    ``capture_at``), a copy of that call's inputs; it wraps
    StencilHead.apply and launches nothing itself."""

    def __init__(self, capture_at=None, fn='StencilHead'):
        from tensoflow_tpu_torch.ops import stencil as st
        self.fn = getattr(st, fn)     # or GeneralStencilHead
        self.bs, self.dtypes = [], []
        self.capture_next, self.captured = False, None
        self.capture_at = capture_at

    def __enter__(self):
        orig = self.fn.apply

        def apply(static, *args):
            if self.capture_next or self.capture_at == len(self.bs):
                self.captured = (static, [t.detach().clone() for t in args])
                self.capture_next = False
            self.bs.append(static[1])
            self.dtypes.append(static[3])
            return orig(static, *args)
        self.fn.apply = apply
        return self

    def __exit__(self, *exc):
        del self.fn.apply                    # the inherited classmethod


def _captured_inputs(captured, b1, seed=11):
    """check_inputs' dict from a captured StencilHead call (with the
    layer-1 bias it adds outside) and random cotangents."""
    (S, B, C_, cd, sigmas, _), args = captured
    fr, pe, rot, b0, w1 = args[:5]
    rest = args[5:]
    n, o = fr.shape[0], w1.shape[1]
    g = torch.Generator(device='cuda').manual_seed(seed)
    return {'pp': rest[:3 * B], 'lp': rest[3 * B:6 * B],
            'w0p': rest[6 * B:], 'fr': fr, 'sigmas': sigmas, 'pe': pe,
            'rot': rot, 'b0': b0, 'w1': w1, 'b1': b1.detach().clone(),
            'g_c': torch.randn((n, o), generator=g, device='cuda'),
            'g_off': torch.randn((S - 1, n), generator=g, device='cuda')}


def phase_schedule(card, timed_steps=10):
    """ShapeTrainer at the compressor_occ widths through both upsamplings
    (128^3 -> 256^3 -> 512^3, one -> three mip levels, p16 -> p4 atlas):
    per-step loss and kernel launches, the 512^3 step time and memory, the
    B=2 kernels on a 512^3 step's own inputs, one test view rendered and
    scored, and the mesh of the trained field at 256^3."""
    from tensoflow_tpu_torch import extract_mesh
    from tensoflow_tpu_torch.ops import mesh as mesh_mod
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.ops import tensor_field as tfield
    from tensoflow_tpu_torch.train import metrics_vis
    from tensoflow_tpu_torch.train.trainer import EVAL_KEYS, ShapeTrainer
    import numpy as np
    cfg = _load_cfg(SCHEDULE_CUTS)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30   # earlier phases' state
    trainer = ShapeTrainer(cfg)                # device=None: the card
    trainer.init_dataset()
    rays = cfg['train_ray_num']
    print(f'[schedule] cuts: {SCHEDULE_CUTS} (published: upsample_list '
          '[20000, 40000], radiance_field_step and gaussianLoss_step 20000, '
          'database tensoSDF/compressor, split_manul true)', flush=True)

    def grid_line():
        sdf = trainer.rcfg.sdf
        with torch.no_grad():
            fmt = tfield.pack_vm_patches(trainer.params['sdf']['field'],
                                         sdf.n_levels).meta.plane_fmt
        return (f'grid {sdf.grid_size}, n_levels {sdf.n_levels}, atlas '
                f'{fmt}, march_stride {trainer.rcfg.march_stride}, '
                f'compact budget {trainer.rcfg.compact_samples_per_ray}')
    print(f'[schedule] start: {grid_line()}', flush=True)
    logs = []
    st.reset_launches()
    with HeadSpy() as spy:
        # the main path: the five steps that cross both upsamplings and the
        # first 512^3 step, whose stencil inputs are kept
        for step in range(6):
            spy.capture_next = step == 5
            logs += trainer.train(n_steps=1, log_every=1)
            if step in cfg['upsample_list']:
                print(f'[schedule] after step {step} (upsample): '
                      f'{grid_line()}; Adam rebased at step '
                      f'{trainer.opt.reset_step}', flush=True)
        torch.cuda.synchronize()
        launches = dict(st.LAUNCHES)
        if spy.bs != [1, 1, 1, 2, 2, 2]:
            raise AssertionError(f'stencil branch counts per step {spy.bs}')
    _check_finite(logs)
    print('[schedule] loss per step: ' + ', '.join(
        f'{r["loss"]:.6f}' for r in logs), flush=True)
    print('[schedule] step 6 terms: ' + json.dumps(
        {k: round(v, 6) for k, v in logs[-1].items()}), flush=True)
    for k in ('stencil_head_fwd', 'stencil_head_bwd'):
        if launches[k] != len(logs):
            raise AssertionError(f'{k} launched {launches[k]} times in '
                                 f'{len(logs)} steps')
    print(f'[schedule] launches over the {len(logs)} steps {launches}; '
          f'mip branches per step {spy.bs}', flush=True)

    t0 = time.perf_counter()
    timed = trainer.train(n_steps=timed_steps, log_every=timed_steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
    _check_finite(timed)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[schedule] {timed_steps} steps at 512^3 on {card}: '
          f'{step_ms:.1f} ms/step = {rays / (step_ms / 1e3):.0f} rays/s; peak '
          f'device memory {peak:.2f} GiB in all, {peak - base:.2f} GiB above '
          f'what earlier phases hold; loss {timed[-1]["loss"]:.6f}',
          flush=True)

    d = _captured_inputs(spy.captured, trainer.params['sdf']['mlp'][1]['b'])
    spy.captured = None
    n = d['fr'].shape[0]
    check_inputs(f'S=7 B=2 dynamic bf16 N={n} (a 512^3 step\'s own inputs)',
                 d, 7, torch.bfloat16)
    del d

    # one held-out view at the validation size, rendered in chunks of 1536
    # rays (the last one padded), scored; then validate() itself
    (vid,) = trainer.test_ids
    db = trainer.database
    ds = cfg['downsample_ratio']
    gt = db.get_image(vid).astype(np.float32) / 255.0
    h, w = int(gt.shape[0] * ds), int(gt.shape[1] * ds)
    gt = metrics_vis.resize_linear(gt, h, w)
    K = np.diag([ds, ds, 1.0]).astype(np.float32) @ db.get_K(vid)
    st.reset_launches()
    t0 = time.perf_counter()
    out = trainer.render_image(db.get_pose(vid), K, h, w, chunk=1536)
    render_s = time.perf_counter() - t0
    render_launches = dict(st.LAUNCHES)
    bad = [k for k in EVAL_KEYS if not np.isfinite(out[k]).all()]
    if bad or set(out) != set(EVAL_KEYS):
        raise AssertionError(f'render_image: non-finite or missing {bad}')
    # per chunk: the samples' head, then the surface normal's
    chunks = -(-h * w // 1536)
    if render_launches != {'stencil_head_fwd': 2 * chunks,
                           'stencil_head_bwd': 0}:
        raise AssertionError(f'render_image launches {render_launches}')
    res = metrics_vis.eval_and_dump(gt, out, cfg['name'], trainer.start_step,
                                    vid, vis_dir=os.path.join(_root(),
                                                              'build'))
    val_psnr = trainer.validate()
    print(f'[schedule] render_image of view {vid} at {h}x{w} '
          f'(downsample_ratio {ds}) in {render_s:.2f} s on {card}: PSNR '
          f'{res["psnr"]:.3f} dB, SSIM {res["ssim"]:.4f}; all {len(out)} '
          f'images finite; kernel launches {render_launches} (forward only); '
          f'validate() PSNR {val_psnr:.3f} dB', flush=True)

    # the mesh: SDF on the card at the blend_ratio mip level, marching
    # tetrahedra on the host
    res_mesh = 256
    t0 = time.perf_counter()
    query = extract_mesh.sdf_query(trainer.params, trainer.rcfg,
                                   torch.device('cuda'),
                                   float(cfg['blend_ratio']))
    verts, tris = mesh_mod.extract_geometry(
        np.array([-1.0, -1, -1]), np.array([1.0, 1, 1]), res_mesh, 0.0,
        query)
    ply = os.path.join(_root(), 'build', 'smoke_schedule.ply')
    mesh_mod.write_ply(ply, verts, tris)
    rv, rt = mesh_mod.read_ply(ply)
    if len(tris) == 0 or len(rv) != len(verts) or len(rt) != len(tris) \
            or not np.isfinite(verts).all():
        raise AssertionError(f'mesh: {len(verts)} verts, {len(tris)} tris')
    print(f'[schedule] extract_geometry at {res_mesh}^3 in '
          f'{time.perf_counter() - t0:.1f} s: {len(verts)} vertices, '
          f'{len(tris)} triangles, written to build/smoke_schedule.ply',
          flush=True)
    return launches, trainer, step_ms


# ---------------------------------------------------------------------------
# phase 3c: stage 1 on the hierarchical sampler, as published
# ---------------------------------------------------------------------------

HIER_YAML = 'configs/shape/syn/compressor.yaml'
# compressor.yaml builds the alpha mask at step 20,000, upsamples at
# 20,000 and 40,000 and turns the occ loss on at 10,000 and the radiance
# head and the Gaussian loss after 20,000; cut to single digits so that
# six steps cross all of them.  Everything else is the config's own:
# float32 gathers, 64 + 64 samples in 4 rounds, no sample-variance clip.
HIER_CUTS = ['database_name=toy/sphere_128_12', 'split_manul=false',
             'upsample_list=[2,4]', 'update_AlphaMask_lst=[2]',
             'occ_loss_step=3', 'radiance_field_step=3',
             'gaussianLoss_step=3']
# the background sub-phase: shoe.yaml's widths and losses, the same
# database cut; the sample-variance clip at the config default (on), so
# that the sampler carries deviation's gradient on the card
BG_YAML = 'configs/shape/custom/shoe.yaml'
BG_CUTS = ['database_name=toy/sphere_128_12', 'split_manul=false',
           'clip_sample_variance=true']
HIER_SMALL = ['database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
              'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=4096',
              'train_ray_num=64', 'n_samples=16', 'n_importance=16',
              'occ_loss_max_pn=64', 'upsample_list=null',
              'update_AlphaMask_lst=[0]', 'occ_loss_step=0',
              'n_bg_samples=16', 'init_radius=0.5']


def check_hier_small(steps=2):
    """card_vs_cpu on the hierarchical sampler with the alpha mask (built
    after step 0), the live-field occ loss and the NeRF++ background, at
    shoe.yaml's settings cut to a small float32 size."""
    runs, logs, worst = card_vs_cpu(_load_cfg(HIER_SMALL, BG_YAML),
                                    'small hierarchical', steps)
    masks = [runs[d].alpha_mask.volume.cpu() for d in ('cuda', 'cpu')]
    print(f'[hier] small float32 config (hierarchical sampler, alpha mask, '
          f'background): {steps} steps on the card match the CPU plain '
          f'path (worst loss-term rel err {worst:.2e}); alpha masks differ '
          f'in {int((masks[0] != masks[1]).sum())} of {masks[0].numel()} '
          f'voxels; {_losses(logs)}', flush=True)


def phase_hierarchical(card, windows=5, per_window=4):
    """ShapeTrainer at configs/shape/syn/compressor.yaml as published
    (float32 gathers, the hierarchical sampler with 64 + 64 samples a ray,
    the alpha mask, the live-field occ loss) over its schedule cut to six
    steps: 128^3 -> 256^3 -> 512^3; per-step loss, launches, mip branches
    and live-sample share; the alpha-mask build; the 512^3 step time as
    the median of 5 windows of 4 steps (min, max) and the peak memory; the
    float32 kernels on a 512^3 step's own inputs; one test view rendered
    and scored.  Then the background sub-phase."""
    from tensoflow_tpu_torch.models import shape_renderer as sr
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.ops import tensor_field as tfield
    from tensoflow_tpu_torch.train import metrics_vis
    from tensoflow_tpu_torch.train.trainer import EVAL_KEYS, ShapeTrainer
    import numpy as np
    check_hier_small()
    cfg = _load_cfg(HIER_CUTS, HIER_YAML)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    trainer = ShapeTrainer(cfg)                # device=None: the card
    trainer.init_dataset()
    rays, sn = cfg['train_ray_num'], sr.n_dense_samples(trainer.rcfg)
    print(f'[hier] cuts: {HIER_CUTS} (published: database tensoSDF/'
          'compressor, split_manul true, upsample_list [20000, 40000], '
          'update_AlphaMask_lst [20000], occ_loss_step 10000, '
          'radiance_field_step and gaussianLoss_step 20000); as published: '
          f'gather_dtype {cfg["gather_dtype"]}, {rays} rays x '
          f'({cfg["n_samples"]} + {cfg["n_importance"]}) samples in '
          f'{cfg["up_sample_steps"]} rounds, clip_sample_variance '
          f'{cfg["clip_sample_variance"]}, mul_length {cfg["mul_length"]}, '
          f'alphaMask_thres {cfg["alphaMask_thres"]}', flush=True)
    if trainer.rcfg.use_occ_grid or trainer.rcfg.sdf.gather_dtype != \
            'float32':
        raise AssertionError('compressor.yaml: expected the hierarchical '
                             'sampler and float32 gathers')

    def grid_line():
        sdf = trainer.rcfg.sdf
        with torch.no_grad():
            fmt = tfield.pack_vm_patches(trainer.params['sdf']['field'],
                                         sdf.n_levels).meta.plane_fmt
        return f'grid {sdf.grid_size}, n_levels {sdf.n_levels}, atlas {fmt}'
    print(f'[hier] start: {grid_line()}', flush=True)

    mask_s = []
    build = trainer.maybe_update_alpha_mask

    def timed_build(step):
        before = trainer.alpha_mask
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build(step)
        torch.cuda.synchronize()
        if trainer.alpha_mask is not before:
            mask_s.append(time.perf_counter() - t0)
            vol = trainer.alpha_mask.volume
            print(f'[hier] alpha mask after step {step}: '
                  f'{tuple(vol.shape)} built in {mask_s[-1]:.2f} s on '
                  f'{card}, occupied share {float(vol.mean()):.4f}',
                  flush=True)
    trainer.maybe_update_alpha_mask = timed_build
    logs = []
    st.reset_launches()
    with HeadSpy() as spy:
        # the main path: six steps across the mask and both upsamplings;
        # the first 512^3 step's stencil inputs are kept
        for step in range(6):
            spy.capture_next = step == 5
            logs += trainer.train(n_steps=1, log_every=1)
            if step in cfg['upsample_list']:
                print(f'[hier] after step {step} (upsample): '
                      f'{grid_line()}', flush=True)
        torch.cuda.synchronize()
        launches = dict(st.LAUNCHES)
    if spy.bs != [1, 1, 1, 2, 2, 2] or set(spy.dtypes) != {torch.float32}:
        raise AssertionError(f'stencil calls per step: branches {spy.bs}, '
                             f'types {spy.dtypes}')
    if not mask_s:
        raise AssertionError('the alpha mask was not built')
    _check_finite(logs)
    for k in ('stencil_head_fwd', 'stencil_head_bwd'):
        if launches[k] != len(logs):
            raise AssertionError(f'{k} launched {launches[k]} times in '
                                 f'{len(logs)} steps')
    print('[hier] loss per step: ' + ', '.join(
        f'{r["loss"]:.6f}' for r in logs), flush=True)
    print('[hier] live samples per step (share of the '
          f'{sn} a ray): ' + ', '.join(
              f'{r["sample_num"] / sn:.4f}' for r in logs), flush=True)
    print('[hier] step 6 terms: ' + json.dumps(
        {k: round(v, 6) for k, v in logs[-1].items()}), flush=True)
    print(f'[hier] launches over the {len(logs)} steps {launches} (float32 '
          f'kernels, one fwd + one bwd a step); mip branches per step '
          f'{spy.bs}; stencil rows a step {rays * sn}', flush=True)

    # the step time: the median of `windows` windows of `per_window` steps
    # (min and max beside it), each ending in a synchronize
    window_ms = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = trainer.train(n_steps=per_window, log_every=per_window)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) / per_window * 1e3)
        _check_finite(timed)
    step_ms = sorted(window_ms)[len(window_ms) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[hier] {windows} windows of {per_window} steps at 512^3 on '
          f'{card}: median {step_ms:.1f} ms/step (min {min(window_ms):.1f}, '
          f'max {max(window_ms):.1f}; windows ' + ', '.join(
              f'{t:.1f}' for t in window_ms) + f') = '
          f'{rays / (step_ms / 1e3):.0f} rays/s; live-sample '
          f'share {timed[-1]["sample_num"] / sn:.4f}; peak device memory '
          f'{peak:.2f} GiB in all, {peak - base:.2f} GiB above what earlier '
          f'phases hold; loss {timed[-1]["loss"]:.6f}', flush=True)

    d = _captured_inputs(spy.captured, trainer.params['sdf']['mlp'][1]['b'])
    spy.captured = None
    n = d['fr'].shape[0]
    errs = check_inputs(f'S=7 B=2 dynamic f32 N={n} (a 512^3 step\'s own '
                        'inputs)', d, 7, torch.float32)
    del d

    (vid,) = trainer.test_ids
    db = trainer.database
    ds = cfg['downsample_ratio']
    gt = db.get_image(vid).astype(np.float32) / 255.0
    h, w = int(gt.shape[0] * ds), int(gt.shape[1] * ds)
    gt = metrics_vis.resize_linear(gt, h, w)
    K = np.diag([ds, ds, 1.0]).astype(np.float32) @ db.get_K(vid)
    st.reset_launches()
    t0 = time.perf_counter()
    out = trainer.render_image(db.get_pose(vid), K, h, w, chunk=1024)
    render_s = time.perf_counter() - t0
    render_launches = dict(st.LAUNCHES)
    bad = [k for k in EVAL_KEYS if not np.isfinite(out[k]).all()]
    if bad or set(out) != set(EVAL_KEYS):
        raise AssertionError(f'render_image: non-finite or missing {bad}')
    chunks = -(-h * w // 1024)
    if render_launches != {'stencil_head_fwd': 2 * chunks,
                           'stencil_head_bwd': 0}:
        raise AssertionError(f'render_image launches {render_launches}')
    res = metrics_vis.eval_and_dump(gt, out, cfg['name'], trainer.start_step,
                                    vid, vis_dir=os.path.join(_root(),
                                                              'build'))
    print(f'[hier] render_image of view {vid} at {h}x{w} (downsample_ratio '
          f'{ds}, no alpha mask, as the JAX package renders) in '
          f'{render_s:.2f} s on {card}: PSNR {res["psnr"]:.3f} dB, SSIM '
          f'{res["ssim"]:.4f}; all {len(out)} images finite; kernel launches '
          f'{render_launches} (forward only)', flush=True)
    phase_background(card)
    return launches, trainer, step_ms, errs


def phase_background(card, steps=5):
    """ShapeTrainer at the widths and losses of configs/shape/custom/
    shoe.yaml (the NeRF++ background, a black background, Hessian and
    Sparse losses) on the toy database: 5 steps at 128^3."""
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer, named_leaves
    cfg = _load_cfg(BG_CUTS, BG_YAML)
    trainer = ShapeTrainer(cfg)
    trainer.init_dataset()
    if not trainer.rcfg.predict_BG or trainer.rcfg.isBGWhite:
        raise AssertionError('shoe.yaml: expected predict_BG, no white '
                             'background')
    bg0 = [t.detach().clone() for _, t in named_leaves(trainer.params['bg'])]
    logs = trainer.train(n_steps=1, log_every=1)
    moved = sum(not torch.equal(t.detach(), b) for (_, t), b in
                zip(named_leaves(trainer.params['bg']), bg0))
    if moved != len(bg0):
        raise AssertionError(f'the first step moved {moved} of {len(bg0)} '
                             'background leaves')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs += trainer.train(n_steps=steps - 1, log_every=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    _check_finite(logs)
    print(f'[bg] cuts: {BG_CUTS} (published: database custom/shoe/raw_1600, '
          'split_manul true, clip_sample_variance false); widths: grid '
          f'{trainer.rcfg.sdf.grid_size}, {cfg["train_ray_num"]} rays x '
          f'{cfg["n_samples"]} + {cfg["n_importance"]} samples, '
          f'{trainer.rcfg.n_bg_samples} background samples', flush=True)
    print(f'[bg] {steps} steps on {card}: loss per step '
          + ', '.join(f'{r["loss"]:.6f}' for r in logs)
          + f' (all finite); the first step moved all {len(bg0)} background '
          f'leaves; {step_ms:.1f} ms/step over steps 2-{steps} = '
          f'{cfg["train_ray_num"] / (step_ms / 1e3):.0f} rays/s (steps by '
          f'path {trainer.graph_stats})', flush=True)


# ---------------------------------------------------------------------------
# phase 3d: every dataset layout, written from the toy scenes and read back
# ---------------------------------------------------------------------------

DATASET_TOY = 'toy/blobs_128_12'
TEST_IDS = (0, 6)                   # the toy views written as test splits
RESIZE_LEN, CROP_SIZE = 64, 96      # custom/<obj>/raw_64, <obj>/96
LOAD_TOY, LOAD_VIEWS = 'toy/sphere_800_50', 50
# the published tensoSDF scenes: 100 training views of 800x800 RGBA
PUBLISHED_VIEWS, PUBLISHED_SIZE = 100, 800


def gl_c2w_to_w2c(c2w):
    """A c2w pose in the blender (OpenGL) convention as a COLMAP w2c [3, 4]
    (x right, y down, z forward)."""
    cv = np.asarray(c2w, np.float64) @ np.diag([1.0, -1.0, -1.0, 1.0])
    return np.linalg.inv(cv)[:3]


def write_exr_zip_half(path, planes):
    """A scanline OpenEXR file of {name: [h, w]} in HALF with ZIP
    compression (16 lines a block), channels in EXR's alphabetical order."""
    import struct
    import zlib
    from tensoflow_tpu_torch.data.image_io import EXR_MAGIC
    names = sorted(planes)
    h, w = planes[names[0]].shape

    def attr(name, kind, body):
        return (name.encode() + b'\0' + kind.encode() + b'\0'
                + struct.pack('<i', len(body)) + body)
    box = struct.pack('<iiii', 0, 0, w - 1, h - 1)
    head = (struct.pack('<ii', EXR_MAGIC, 2)
            + attr('channels', 'chlist', b''.join(
                n.encode() + b'\0' + struct.pack('<iB3xii', 1, 0, 1, 1)
                for n in names) + b'\0')
            + attr('compression', 'compression', b'\3')
            + attr('dataWindow', 'box2i', box)
            + attr('displayWindow', 'box2i', box)
            + attr('lineOrder', 'lineOrder', b'\0')
            + attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
            + attr('screenWindowCenter', 'v2f', struct.pack('<ff', 0, 0))
            + attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
            + b'\0')
    blocks = []
    for y0 in range(0, h, 16):
        raw = np.frombuffer(b''.join(
            planes[n][y].astype('<f2').tobytes()
            for y in range(y0, min(y0 + 16, h)) for n in names), np.uint8)
        t = np.concatenate([raw[0::2], raw[1::2]]).astype(np.int64)
        t[1:] = (t[1:] - t[:-1].copy() + 128) & 255
        data = zlib.compress(t.astype(np.uint8).tobytes())
        if len(data) >= len(raw):
            data = raw.tobytes()
        blocks.append(struct.pack('<ii', y0, len(data)) + data)
    offsets = np.cumsum([len(head) + 8 * len(blocks)]
                        + [len(b) for b in blocks[:-1]])
    with open(path, 'wb') as f:
        f.write(head + offsets.astype('<u8').tobytes() + b''.join(blocks))


def _rgba(db, i):
    return np.concatenate([db.get_image(i), (db.get_mask(i) * 255).astype(
        np.uint8)[..., None]], -1)


def _normal_png(db, i):
    n = db.get_normal(i)
    return np.round(np.concatenate([(n * 0.5 + 0.5) * 255,
                                    db.get_mask(i)[..., None] * 255],
                                   -1)).astype(np.uint8)


def write_blender_layout(db, root, test_ids=(), extras=True):
    """The views of a toy database in the blender layout of tensoSDF/ and
    nerf/: transforms_{train,val,test}.json (the translations doubled: the
    adapters halve them), RGBA pngs with the mask as alpha; views 0..n-2
    train, n-1 val; ``test_ids`` also as the test split with _normal.png
    and a ZIP / HALF _diffColor.exr (albedo, mask as A)."""
    from tensoflow_tpu_torch.data.image_io import imwrite_png
    ids = list(db.get_img_ids())
    cax = 2 * np.arctan(0.5 * db.W / float(db.K[0, 0]))
    for split, sids in (('train', ids[:-1]), ('val', ids[-1:]),
                        ('test', list(test_ids))):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in sids:
            fp = f'./{split}/r_{i}'
            imwrite_png(os.path.join(root, fp + '.png'), _rgba(db, i))
            pose = np.array(db.get_pose(i), np.float64)
            pose[:, 3:] *= 2.0
            frames.append({'file_path': fp,
                           'transform_matrix': pose.tolist()})
            if split == 'test' and extras:
                imwrite_png(os.path.join(root, fp + '_normal.png'),
                            _normal_png(db, i))
                planes = dict(zip('RGB', np.moveaxis(db.get_albedo(i), -1,
                                                     0)))
                planes['A'] = db.get_mask(i)
                write_exr_zip_half(os.path.join(root, fp + '_diffColor.exr'),
                                   planes)
        with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
            json.dump({'camera_angle_x': cax, 'frames': frames}, f)


def write_tensoir_layout(db, root, test_ids=()):
    """TensoIR: <split>_NNN/ with metadata.json and rgba_sunset_000.png;
    the test views also normal.png and albedo.png."""
    from tensoflow_tpu_torch.data.image_io import imwrite_png
    ids = list(db.get_img_ids())
    cax = 2 * np.arctan(0.5 * db.W / float(db.K[0, 0]))
    for split, sids in (('train', ids[:-1]), ('val', ids[-1:]),
                        ('test', list(test_ids))):
        for k, i in enumerate(sids):
            d = os.path.join(root, f'{split}_{k:03d}')
            os.makedirs(d, exist_ok=True)
            pose = np.array(db.get_pose(i), np.float64)
            pose[:, 3:] *= 2.0
            with open(os.path.join(d, 'metadata.json'), 'w') as f:
                json.dump({'cam_transform_mat': ','.join(
                    repr(float(v)) for v in pose.reshape(-1)),
                    'imh': db.H, 'imw': db.W, 'cam_angle_x': cax}, f)
            imwrite_png(os.path.join(d, 'rgba_sunset_000.png'), _rgba(db, i))
            if split == 'test':
                imwrite_png(os.path.join(d, 'normal.png'), _normal_png(db, i))
                alb = np.round(db.get_albedo(i) * 255).astype(np.uint8)
                imwrite_png(os.path.join(d, 'albedo.png'), np.concatenate(
                    [alb, (db.get_mask(i) * 255).astype(np.uint8)[..., None]],
                    -1))


def write_orb_layout(db, root, test_ids=()):
    """ORB: blender_format_LDR/transforms_{train,test}.json + RGBA pngs."""
    from tensoflow_tpu_torch.data.image_io import imwrite_png
    d = os.path.join(root, 'blender_format_LDR')
    cax = 2 * np.arctan(0.5 * db.W / float(db.K[0, 0]))
    for split, sids in (('train', list(db.get_img_ids())),
                        ('test', list(test_ids))):
        os.makedirs(os.path.join(d, split), exist_ok=True)
        frames = []
        for i in sids:
            fp = f'{split}/{i:04d}'
            imwrite_png(os.path.join(d, fp + '.png'), _rgba(db, i))
            frames.append({'file_path': fp, 'transform_matrix':
                           np.asarray(db.get_pose(i), np.float64).tolist()})
        with open(os.path.join(d, f'transforms_{split}.json'), 'w') as f:
            json.dump({'camera_angle_x': cax, 'frames': frames}, f)


SYN_DEPTH = 2.0       # metres stored for the object; the background 15
PC_RADIUS = 0.5       # of the object point cloud of the COLMAP layouts


def write_glossy_syn_layout(db, root):
    """GlossySynthetic: <k>.png, 16-bit <k>-depth.png (the background at
    its far value), <k>-camera.pkl = (w2c [3, 4], K)."""
    import pickle
    from tensoflow_tpu_torch.data.image_io import imwrite_png
    os.makedirs(root, exist_ok=True)
    for k, i in enumerate(db.get_img_ids()):
        imwrite_png(os.path.join(root, f'{k}.png'), db.get_image(i))
        depth = np.where(db.get_mask(i) > 0.5,
                         round(SYN_DEPTH / 15 * 65535), 65535)
        imwrite_png(os.path.join(root, f'{k}-depth.png'),
                    depth.astype(np.uint16))
        with open(os.path.join(root, f'{k}-camera.pkl'), 'wb') as f:
            pickle.dump((gl_c2w_to_w2c(db.get_pose(i)),
                         np.asarray(db.get_K(i), np.float64)), f)


def write_colmap_layout(db, root, masks=True, ext='.png'):
    """A COLMAP capture of the toy views: images/*<ext> (PNG, or JPEG at
    cv2's default quality), masks/*.png, a binary sparse model (one
    PINHOLE camera) and object_point_cloud.ply of the six axis points at
    PC_RADIUS, which the adapters normalize to the unit sphere: the poses'
    translations grow by 1 / PC_RADIUS."""
    from tensoflow_tpu_torch.data import colmap_model as cm
    from tensoflow_tpu_torch.data.image_io import imwrite_jpeg, imwrite_png
    from tensoflow_tpu_torch.ops.mesh import write_ply
    for sub in ('images', 'masks') if masks else ('images',):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    K = np.asarray(db.get_K(0), np.float64)
    cams = {1: cm.Camera(1, 'PINHOLE', db.W, db.H,
                         np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))}
    images = {}
    for k, i in enumerate(db.get_img_ids()):
        w2c = gl_c2w_to_w2c(db.get_pose(i))
        name = f'view{k:03d}{ext}'
        images[k + 1] = cm.Image(k + 1, cm.rotmat2qvec(w2c[:, :3]),
                                 w2c[:, 3], 1, name, np.zeros((0, 2)),
                                 np.zeros(0, np.int64))
        write = imwrite_png if ext == '.png' else imwrite_jpeg
        write(os.path.join(root, 'images', name), db.get_image(i))
        if masks:
            imwrite_png(os.path.join(root, 'masks', name),
                        (db.get_mask(i) * 255).astype(np.uint8))
    cm.write_model(cams, images, {}, os.path.join(root, 'colmap', 'sparse',
                                                  '0'))
    write_ply(os.path.join(root, 'object_point_cloud.ply'),
              PC_RADIUS * np.concatenate([np.eye(3), -np.eye(3)]).astype(
                  np.float32),
              np.zeros((0, 3), np.int32))


def write_layouts(db, root):
    """Every layout of the toy scene under root/<layout>/; returns the
    (database name, dataset dir) of each."""
    obj = db.database_name.split('/')[1].split('_')[0]
    write_blender_layout(db, os.path.join(root, 'tensoSDF', obj), TEST_IDS)
    write_blender_layout(db, os.path.join(root, 'nerf', obj), extras=False)
    write_tensoir_layout(db, os.path.join(root, 'tensoIR', obj), TEST_IDS)
    write_orb_layout(db, os.path.join(root, 'orb', obj), TEST_IDS)
    write_glossy_syn_layout(db, os.path.join(root, 'syn', obj))
    write_colmap_layout(db, os.path.join(root, 'custom', obj))
    write_colmap_layout(db, os.path.join(root, 'custom_jpeg', obj),
                        masks=False, ext='.jpg')
    write_colmap_layout(db, os.path.join(root, 'real', obj), masks=False)
    dirs = {'custom_jpeg': 'custom_jpeg'}
    return {kind: (name.format(obj=obj),
                   os.path.join(root, dirs.get(kind, name.split('/')[0])))
            for kind, name in (
                ('tensoSDF', 'tensoSDF/{obj}'), ('nerf', 'nerf/{obj}'),
                ('tensoIR', 'tensoIR/{obj}'), ('orb', 'orb/{obj}'),
                ('syn', 'syn/{obj}'), ('custom', 'custom/{obj}/raw'),
                ('custom_resize', f'custom/{{obj}}/raw_{RESIZE_LEN}'),
                ('custom_jpeg', f'custom/{{obj}}/raw_{RESIZE_LEN}'),
                ('custom_crop', f'custom/{{obj}}/{CROP_SIZE}'),
                ('real', f'real/{{obj}}/{CROP_SIZE}'))}


def _same(what, got, want, exact=True):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f'{what}: shape {got.shape} vs {want.shape}')
    if exact and not np.array_equal(got, want):
        raise AssertionError(f'{what}: differs in {(got != want).sum()} of '
                             f'{got.size} values')
    if not exact and not np.allclose(got, want, rtol=1e-6, atol=1e-6):
        raise AssertionError(f'{what}: max |diff| '
                             f'{np.abs(got - want.astype(got.dtype)).max()}')


def _expected_normal(png):
    mask = png[..., 3:].astype(np.float32) / 255.0
    nrm = (png[..., :3] / 255.0 - 0.5) * 2.0
    return nrm * mask + (1 - mask) * np.array([0, 0, 1.0])


def check_layouts(db, layouts):
    """Each layout read back through parse_database_name: images, masks,
    normals, albedo and depth equal to what was written, poses and K to
    1e-6.  Returns the number of views compared per layout."""
    from tensoflow_tpu_torch.data import database as db_mod
    from tensoflow_tpu_torch.data.colmap_db import project_points
    from tensoflow_tpu_torch.data.image_ops import resize_area
    ids = list(db.get_img_ids())
    counts, jpeg_err = {}, 0.0
    for kind, (name, ddir) in layouts.items():
        split_ids = {False: ids, True: list(TEST_IDS)}
        tests = (False, True) if kind in ('tensoSDF', 'tensoIR', 'orb') \
            else (False,)
        n = 0
        for is_test in tests:
            rd = db_mod.parse_database_name(name, ddir, isTest=is_test,
                                            isWhiteBG=True)
            src = split_ids[is_test]
            if len(rd.get_img_ids()) != len(src):
                raise AssertionError(f'{name}: {len(rd.get_img_ids())} '
                                     f'views, {len(src)} written')
            for rid, i in zip(rd.get_img_ids(), src):
                what = f'{name} view {rid}' + (' (test)' if is_test else '')
                img, mask = db.get_image(i), db.get_mask(i)
                w2c = gl_c2w_to_w2c(db.get_pose(i))
                if kind in ('tensoSDF', 'nerf', 'tensoIR', 'orb'):
                    _same(what + ' image', rd.get_image(rid), img)
                    _same(what + ' mask', rd.get_mask(rid), mask)
                    _same(what + ' pose', rd.get_pose(rid)[:3],
                          np.asarray(db.get_pose(i))[:3], exact=False)
                    _same(what + ' K', rd.get_K(rid), db.get_K(i),
                          exact=False)
                    if is_test and kind != 'orb':
                        _same(what + ' normal', rd.get_normal(rid),
                              _expected_normal(_normal_png(db, i)))
                    if is_test and kind == 'tensoIR':
                        alb = np.round(db.get_albedo(i) * 255).astype(
                            np.uint8)
                        _same(what + ' albedo', rd.get_albedo(rid),
                              alb / 255.0 * (_rgba(db, i)[..., 3:] / 255.0))
                    if is_test and kind == 'tensoSDF':
                        h16 = lambda a: a.astype(np.float16).astype(  # noqa
                            np.float32)
                        _same(what + ' diffColor', rd.get_albedo(rid),
                              h16(db.get_albedo(i)) * h16(mask)[..., None])
                elif kind == 'syn':
                    _same(what + ' image', rd.get_image(rid),
                          img * (mask > 0.5)[..., None])
                    _same(what + ' mask', rd.get_mask(rid), mask > 0.5)
                    _same(what + ' pose', rd.get_pose(rid), w2c, exact=False)
                    _same(what + ' K', rd.get_K(rid), db.get_K(i),
                          exact=False)
                elif kind == 'custom':
                    _same(what + ' image', rd.get_image(rid), img)
                    _same(what + ' mask', rd.get_mask(rid), mask > 0.5)
                    w2c[:, 3] /= PC_RADIUS
                    _same(what + ' pose', rd.get_pose(rid), w2c, exact=False)
                    _same(what + ' K', rd.get_K(rid), db.get_K(i),
                          exact=False)
                elif kind == 'custom_jpeg':
                    # JPEG captures, resized into a JPEG cache (quality
                    # 95 twice): within a few levels of the toy's view
                    want = resize_area(img, (RESIZE_LEN, RESIZE_LEN))
                    got = rd.get_image(rid)
                    err = np.abs(got.astype(np.int64) - want).mean()
                    jpeg_err = max(jpeg_err, err)
                    if got.shape != want.shape or err > 6:
                        raise AssertionError(f'{what}: mean |JPEG - toy| '
                                             f'{err:.3f} levels')
                    w2c[:, 3] /= PC_RADIUS
                    _same(what + ' pose', rd.get_pose(rid), w2c, exact=False)
                elif kind == 'custom_resize':
                    s = RESIZE_LEN / db.W
                    _same(what + ' image', rd.get_image(rid), resize_area(
                        img[..., ::-1], (RESIZE_LEN, RESIZE_LEN))[..., ::-1])
                    _same(what + ' K', rd.get_K(rid), np.diag(
                        [s, s, 1.0]) @ db.get_K(i), exact=False)
                else:                            # the object-centred crops
                    got = rd.get_image(rid)
                    if got.shape != (CROP_SIZE, CROP_SIZE, 3):
                        raise AssertionError(f'{what}: crop {got.shape}')
                    uv, depth = project_points(rd.ref_points,
                                               rd.get_pose(rid),
                                               rd.get_K(rid))
                    if (depth <= 0).any() or uv.min() < -2 \
                            or uv.max() > CROP_SIZE + 2:
                        raise AssertionError(f'{what}: the object does not '
                                             'project inside the crop')
                n += 1
        counts[f'{name} ({kind})'] = n
    print(f'[datasets] the JPEG capture\'s resized views: mean |JPEG - '
          f'toy view| at most {jpeg_err:.3f} levels (cv2\'s quality 95, '
          'twice)', flush=True)
    return counts


def published_load(card, root):
    """A tensoSDF layout at the published size (800x800 RGBA, 50 views,
    written here) loaded through parse_database_name: host seconds a view;
    the C++ defilter against its numpy plain version on one view (bytes
    and times); the ray batch's host bytes a ray, scaled to the published
    100 training views."""
    import zlib
    from tensoflow_tpu_torch.data import database as db_mod
    from tensoflow_tpu_torch.data import image_io, rays as rays_mod
    from tensoflow_tpu_torch.data.toy import ToyDatabase
    t0 = time.perf_counter()
    toy = ToyDatabase(LOAD_TOY)
    render_s = time.perf_counter() - t0
    ddir = os.path.join(root, 'published')
    t0 = time.perf_counter()
    write_blender_layout(toy, os.path.join(ddir, 'sphere'), extras=False)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rd = db_mod.parse_database_name('tensoSDF/sphere', ddir, isWhiteBG=True)
    load_s = time.perf_counter() - t0
    n = len(rd.get_img_ids())
    if n != LOAD_VIEWS:
        raise AssertionError(f'{n} views loaded, {LOAD_VIEWS} written')
    for i in (0, n - 1):
        _same(f'published view {i}', rd.get_image(i), toy.get_image(i))
    print(f'[datasets] published-size load: {n} views of {toy.W}x{toy.H} '
          f'RGBA (tensoSDF layout, written by the phase in {write_s:.1f} s '
          f'after {render_s:.1f} s of rendering) read by parse_database_name '
          f'in {load_s:.2f} s = {load_s / n * 1e3:.1f} ms/view (host time '
          f'on the card\'s machine; {card})', flush=True)

    path = os.path.join(ddir, 'sphere', 'train', 'r_0.png')
    with open(path, 'rb') as f:
        data = f.read()
    idat = b''.join(b for k, b in image_io._png_chunks(data, path)
                    if k == b'IDAT')
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    h, stride = toy.H, toy.W * 4
    kinds = np.bincount(raw.reshape(h, stride + 1)[:, 0], minlength=5)
    t0 = time.perf_counter()
    fast = image_io.unfilter(raw, h, stride, 4)
    cpp_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = image_io.unfilter_plain(raw, h, stride, 4)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(fast, plain):
        raise AssertionError('the C++ defilter differs from the plain '
                             'version')
    print(f'[datasets] PNG defilter of one {toy.W}x{toy.H} RGBA view (row '
          f'filters None/Sub/Up/Average/Paeth: {kinds.tolist()}): C++ '
          f'{cpp_ms:.2f} ms, numpy plain version {plain_ms:.1f} ms, bytes '
          f'identical (host times; {card})', flush=True)

    # a JPEG capture's frame at custom/*/raw_1600's size: 1600x1200
    big = np.repeat(np.repeat(toy.get_image(0), 2, 0), 2, 1)[:1200]
    jpg = os.path.join(ddir, 'frame.jpg')
    t0 = time.perf_counter()
    image_io.imwrite_jpeg(jpg, big)
    jw_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = image_io.imread(jpg)
    jr_ms = (time.perf_counter() - t0) * 1e3
    err = np.abs(back.astype(np.int64) - big).mean()
    if back.shape != big.shape or err > 3:
        raise AssertionError(f'JPEG round trip: {back.shape}, mean |diff| '
                             f'{err:.3f}')
    print(f'[datasets] JPEG at {big.shape[1]}x{big.shape[0]} (4:2:0, '
          f'quality 95): read {jr_ms:.1f} ms, write {jw_ms:.1f} ms, mean '
          f'|round trip - source| {err:.3f} levels (host times; {card})',
          flush=True)

    info = rays_mod.build_imgs_info(rd, [0, 1], apply_mask=True)
    batch, rn, _, _ = rays_mod.construct_ray_batch_nerf(info, True)
    per_ray = sum(v.nbytes for v in batch.values()) / rn
    total = per_ray * PUBLISHED_VIEWS * PUBLISHED_SIZE ** 2
    print(f'[datasets] ray batch on the host: {per_ray:.0f} bytes a ray '
          f'({", ".join(sorted(batch))}); at {PUBLISHED_VIEWS} views of '
          f'{PUBLISHED_SIZE}x{PUBLISHED_SIZE}, before the aabb filter: '
          f'{total / 2 ** 30:.2f} GiB', flush=True)
    shutil.rmtree(ddir)
    return load_s / n


def _train_timed(trainer, steps=4):
    """``steps`` logged steps; returns (logs, mean ms of steps 2..steps)."""
    logs = trainer.train(n_steps=1, log_every=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs += trainer.train(n_steps=steps - 1, log_every=1)
    torch.cuda.synchronize()
    return logs, (time.perf_counter() - t0) / (steps - 1) * 1e3


def _cli(args, cwd):
    """``python -m <args>`` run from ``cwd`` with the repository on the
    path; its standard output, stripped.  Raises with its errors."""
    res = subprocess.run([sys.executable, '-m', *args], cwd=cwd,
                         env=dict(os.environ, PYTHONPATH=_root()),
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f'python -m {args[0]} exit {res.returncode}:\n'
                             + res.stderr[-3000:])
    return res.stdout.strip()


def phase_datasets(card, geo):
    """Every layout of the toy scene written with the port's own writers
    and read back; the published-size load; stage 1 from disk
    (compressor.yaml on the tensoSDF layout against the same trainer fed
    through ToyDatabase; shoe.yaml on custom/<obj>/raw_64), stage 2 from
    disk on the phase-5 checkpoint
    ``geo``; the eval_geo and eval_orb_shape CLIs.  Returns the stencil
    launches of the from-disk training runs."""
    from tensoflow_tpu_torch import extract_mesh
    from tensoflow_tpu_torch.data.toy import ToyDatabase, blob_sdf
    from tensoflow_tpu_torch.ops import mesh
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    root = os.path.join(_root(), 'build', 'smoke_datasets')
    shutil.rmtree(root, ignore_errors=True)
    t_phase = t0 = time.perf_counter()
    toy = ToyDatabase(DATASET_TOY)
    layouts = write_layouts(toy, root)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = check_layouts(toy, layouts)
    print(f'[datasets] {DATASET_TOY} written in every layout in '
          f'{write_s:.1f} s and read back in {time.perf_counter() - t0:.1f} '
          f's through parse_database_name, equal to what was written '
          f'(images, masks, normals, diffColor, depth exactly; poses and K '
          f'to 1e-6; resize against image_ops, crops by reprojection): '
          f'views compared {counts}', flush=True)
    published_load(card, root)

    # stage 1 from disk against the same trainer fed through ToyDatabase
    name, ddir = layouts['tensoSDF']
    disk_cuts = ['split_manul=false', f'database_name={name}',
                 f'dataset_dir={ddir}']
    ref = ShapeTrainer(_load_cfg(['split_manul=false',
                                  f'database_name={DATASET_TOY}'],
                                 HIER_YAML))
    ref.init_dataset()
    ref_log = ref.train(n_steps=1, log_every=1)
    ref_batch = ref.batcher.batch
    del ref
    cfg = _load_cfg(disk_cuts, HIER_YAML)
    trainer = ShapeTrainer(cfg)
    t0 = time.perf_counter()
    trainer.init_dataset()
    init_s = time.perf_counter() - t0
    for k, v in ref_batch.items():
        _same(f'ray batch {k} (tensoSDF layout vs ToyDatabase)',
              trainer.batcher.batch[k], v)
    st.reset_launches()
    logs, shape_ms = _train_timed(trainer)
    _check_finite(logs)
    if logs[0] != ref_log[0]:
        raise AssertionError(f'first step from disk {logs[0]} vs through '
                             f'ToyDatabase {ref_log[0]}')
    shape_launches = dict(st.LAUNCHES)
    if shape_launches != {'stencil_head_fwd': 4, 'stencil_head_bwd': 4}:
        raise AssertionError(f'{HIER_YAML} from disk: launches '
                             f'{shape_launches} in 4 steps')
    print(f'[datasets] {HIER_YAML} from {name} (as published: '
          f'{cfg["gather_dtype"]} gathers, nerfDataType '
          f'{cfg["nerfDataType"]}; cut: split_manul false): init_dataset '
          f'{init_s:.2f} s, {trainer.batcher.n} rays after the aabb filter '
          f'(the same batch as through ToyDatabase); loss per step '
          + ', '.join(f'{r["loss"]:.6f}' for r in logs)
          + '; step 1 terms equal to the ToyDatabase-fed trainer\'s; '
          f'launches {shape_launches}; {shape_ms:.1f} ms/step over steps '
          f'2-4 on {card} (steps by path {trainer.graph_stats})',
          flush=True)
    del trainer

    # shoe.yaml publishes nerfDataType true, but CustomDatabase gives w2c
    # COLMAP poses (both packages): the nerf ray function then starts every
    # ray at a w2c translation, and the rays that meet the aabb are
    # counted; the 4 steps take the w2c ray function (the cut)
    name, ddir = layouts['custom_jpeg']
    over = ['split_manul=false', f'database_name={name}',
            f'dataset_dir={ddir}']
    published = ShapeTrainer(_load_cfg(over, BG_YAML))
    published.init_dataset()
    n_pub, nerf_type = published.batcher.n, published.cfg['nerfDataType']
    del published
    cfg = _load_cfg(over + ['nerfDataType=false'], BG_YAML)
    trainer = ShapeTrainer(cfg)
    trainer.init_dataset()
    logs, bg_ms = _train_timed(trainer)
    _check_finite(logs)
    if dict(st.LAUNCHES) != {'stencil_head_fwd': 8, 'stencil_head_bwd': 8}:
        raise AssertionError(f'{BG_YAML} from disk: launches '
                             f'{dict(st.LAUNCHES)} after 4 + 4 steps')
    n_rays = len(trainer.train_ids) * RESIZE_LEN ** 2
    print(f'[datasets] {BG_YAML} from {name} (a JPEG capture, JPEG '
          f'cache): with its published '
          f'nerfDataType {nerf_type}, {n_pub} of {n_rays} rays meet the '
          f'aabb; cut nerfDataType false (the w2c ray function on the COLMAP '
          f'poses): {trainer.batcher.n} of {n_rays} rays, predict_BG '
          f'{cfg["predict_BG"]}; loss per step '
          + ', '.join(f'{r["loss"]:.6f}' for r in logs)
          + f'; {bg_ms:.1f} ms/step over steps 2-4 on {card} (steps by '
          f'path {trainer.graph_stats})', flush=True)
    del trainer

    name, ddir = layouts['tensoSDF']
    mcfg = _mat_cfg({'database_name': name, 'dataset_dir': ddir,
                     'split_manul': False, 'shader_cfg': dict(NIS_CUT)})
    mat = MaterialTrainer(mcfg, geo)
    mat.init_dataset()
    logs, mat_ms = _train_timed(mat)
    _check_finite(logs)
    launches = dict(st.LAUNCHES)
    print(f'[datasets] {MAT_YAML} from {name} on the phase-5 checkpoint: '
          f'{mat.tbn} surface hits kept; loss per step '
          + ', '.join(f'{r["loss"]:.6f}' for r in logs)
          + f' (no NIS); {mat_ms:.1f} ms/step over steps 2-4 on {card}; '
          f'stencil launches of the three from-disk runs {launches}',
          flush=True)
    del mat
    torch.cuda.empty_cache()

    # the evaluation CLIs, as a user runs them, on the phase-5 checkpoint
    occ = os.path.join(_root(), 'configs/shape/syn/compressor_occ.yaml')
    name, ddir = layouts['tensoSDF']
    out = _cli(['tensoflow_tpu_torch.eval_geo', '--cfg', occ, '--ckpt', geo,
                '--save_dir', os.path.join(root, 'nvs'),
                'gather_dtype=bfloat16', f'database_name={name}',
                f'dataset_dir={ddir}'], root).splitlines()
    line = out[-1]
    vals = [float(v) for v in line.split()[-5::2]]
    if 'NormalMAE' not in line or not np.isfinite(vals).all():
        raise AssertionError(f'eval_geo: {out}')
    print(f'[datasets] python -m tensoflow_tpu_torch.eval_geo on the '
          f'{len(TEST_IDS)}-view test split of {name}: ' + ' | '.join(out),
          flush=True)
    pred = os.path.join(root, 'pred.ply')
    _, verts, _ = extract_mesh.main([
        '--cfg', occ, '--ckpt', geo, '--resolution', '128', '--output',
        pred, 'gather_dtype=bfloat16', f'database_name={DATASET_TOY}'])
    lin = np.linspace(-1, 1, 128)
    gverts, gtris = mesh.marching_tets(blob_sdf(np.stack(np.meshgrid(
        lin, lin, lin, indexing='ij'), -1)))
    mesh.write_ply(os.path.join(root, 'gt.ply'), gverts / 127 * 2 - 1, gtris)
    out = _cli(['tensoflow_tpu_torch.eval_orb_shape', '--mesh', pred,
                '--gt_mesh', os.path.join(root, 'gt.ply')], root)
    cd = float(out.split()[-1])
    if not np.isfinite(cd):
        raise AssertionError(f'eval_orb_shape: {out}')
    print(f'[datasets] python -m tensoflow_tpu_torch.eval_orb_shape between '
          f'the phase-5 checkpoint\'s mesh at 128^3 ({len(verts)} vertices) '
          f'and the analytic blobs mesh ({len(gverts)} vertices): {out}; '
          f'phase {time.perf_counter() - t_phase:.1f} s', flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 3e: relighting and its evaluation
# ---------------------------------------------------------------------------

RELIGHT_VIEW = 800          # the published views' size
RELIGHT_CHUNK = 4096        # relight_orb's chunk of primary rays
RELIGHT_ENV_HW = (64, 128)


def write_hdr(path, rgb):
    """float [H, W, 3] as a Radiance RGBE file, flat scanlines, -Y H +X W:
    each pixel m * 256 / 2^e of its largest channel's exponent e."""
    h, w, _ = rgb.shape
    top = rgb.max(-1)
    mant, ex = np.frexp(top)
    scale = np.where(top > 1e-32, mant * 256.0 / np.maximum(top, 1e-32), 0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.floor(rgb * scale[..., None]).clip(0, 255)
    rgbe[..., 3] = np.where(top > 1e-32, ex + 128, 0)
    with open(path, 'wb') as f:
        f.write(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n'
                + f'-Y {h} +X {w}\n'.encode() + rgbe.tobytes())
    e = rgbe[..., 3:].astype(np.int32)
    return (rgbe[..., :3] * np.where(e > 0, np.ldexp(np.float32(1), e - 136),
                                     0)).astype(np.float32)


def relight_env():
    """A 64x128 latlong sky: a blue-white gradient, a warm sun and a dim
    ground, linear values up to 1.9 (relight_orb divides images brighter
    than 2 by 255)."""
    h, w = RELIGHT_ENV_HW
    th = (np.arange(h) + 0.5) / h * np.pi
    ph = (np.arange(w) + 0.5) / w * 2 * np.pi
    th, ph = np.meshgrid(th, ph, indexing='ij')
    up = np.cos(th)[..., None]
    sky = np.where(up > 0, 0.3 + 0.5 * up * np.array([0.6, 0.8, 1.0]),
                   0.08 * np.array([1.0, 0.9, 0.8]))
    sun = np.exp(-((th - 0.8) ** 2 + (ph - 2.0) ** 2) / 0.02)[..., None]
    return (sky + 1.2 * sun * np.array([1.0, 0.85, 0.6])).astype(np.float32)


def _cpu_trainer(trainer):
    """The trainer's parameters, stage-1 field and baked grid on the CPU:
    what relight_view reads, for its plain PyTorch path."""
    from types import SimpleNamespace
    from tensoflow_tpu_torch.ops import sdf_trace
    from tensoflow_tpu_torch.train.checkpoints import tree_map
    g = trainer.grid
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t   # noqa: E731
    grid = sdf_trace.PackedSDFGrid(
        cpu(g.mid_rows), cpu(g.blocks), cpu(g.coarse_rows), cpu(g.aabb),
        g.reso, cpu(g.vis_rows), g.vis_pad)
    return SimpleNamespace(params=tree_map(cpu, trainer.params),
                           geo_params=tree_map(cpu, trainer.geo_params),
                           grid=grid, rcfg=trainer.rcfg,
                           device=torch.device('cpu'), gen=None)


def phase_relight(card, trainer, geo):
    """Relighting as a user runs it, on the phase-5 material model and the
    phase-3d layouts: the env maps (.exr, .hdr) read back; relight_orb
    once per env file, eval_mat --extract_mats --relight (the Blender
    bundle), eval_orb_relight on the relit views; one relight chunk on the
    card against the CPU plain path; an 800x800 view at the widths of
    phase 5 (s/view, ms a chunk, launches), the stencil forward on a relight
    chunk's own inputs against its plain version.  Returns (the stencil
    launches of the 800x800 view, a callable that runs one relight chunk
    for the profiler, its unprofiled ms)."""
    from tensoflow_tpu_torch import relight_orb
    from tensoflow_tpu_torch.data import database as db_mod
    from tensoflow_tpu_torch.data import rays as rays_mod
    from tensoflow_tpu_torch.data.image_io import (imread, imwrite_png,
                                                   read_env_map)
    from tensoflow_tpu_torch.eval.relight import relight_direct
    from tensoflow_tpu_torch.models import material_renderer as mr
    from tensoflow_tpu_torch.ops import stencil as st
    t_phase = time.perf_counter()
    layouts = os.path.join(_root(), 'build', 'smoke_datasets')
    run = os.path.join(layouts, 'relight')
    shutil.rmtree(run, ignore_errors=True)
    os.makedirs(run)

    env = relight_env()
    write_exr_zip_half(os.path.join(run, 'sky.exr'),
                       {c: env[..., i] for i, c in enumerate('RGB')})
    want_hdr = write_hdr(os.path.join(run, 'sky.hdr'), env)
    _same('sky.exr read back', read_env_map(os.path.join(run, 'sky.exr')),
          env.astype(np.float16).astype(np.float32))
    _same('sky.hdr read back', read_env_map(os.path.join(run, 'sky.hdr')),
          want_hdr)
    name = trainer.cfg['name']
    trainer.save(os.path.join(run, 'data', 'model', name, 'model.pkl'))
    orb = ['database_name=orb/blobs',
           f'dataset_dir={os.path.join(layouts, "orb")}',
           f'geo_model_path={geo}', 'split_manul=false']
    lines = []
    for env_file in ('sky.exr', 'sky.hdr'):
        t0 = time.perf_counter()
        out = _cli(['tensoflow_tpu_torch.relight_orb', '--cfg',
                    os.path.join(_root(), MAT_YAML), '--hdr', env_file,
                    '--out', f'relit_{env_file[4:]}', *orb], run)
        lines.append(f'{env_file}: {out.splitlines()} in '
                     f'{time.perf_counter() - t0:.1f} s')
    db = db_mod.parse_database_name('orb/blobs', os.path.join(layouts, 'orb'),
                                    isTest=True)
    ids = db.get_img_ids()[:relight_orb.N_VIEWS]
    shares = []
    for vid in ids:
        a, b = (imread(os.path.join(run, f'relit_{e}', f'relit_{vid}.png'))
                for e in ('exr', 'hdr'))
        lit = (a < 255).any(-1)
        if a.shape != db.get_image(vid).shape[:2] + (3,) or not lit.any() \
                or np.abs(a.astype(int) - b).max() > 8:
            raise AssertionError(f'relit view {vid}: shape {a.shape}, '
                                 f'{int(lit.sum())} shaded pixels, .exr vs '
                                 f'.hdr up to {np.abs(a.astype(int) - b).max()}')
        shares.append(float(lit.mean()))
    print(f'[relight] python -m tensoflow_tpu_torch.relight_orb --cfg '
          f'{MAT_YAML} on orb/blobs (phase 3d), the phase-5 checkpoint: '
          + '; '.join(lines) + f'; {2 * len(ids)} relit PNGs, shaded share '
          f'{np.round(shares, 4).tolist()}, .exr and .hdr renders within 8 '
          '/ 255 (the .hdr is 8-bit RGBE, the .exr half)', flush=True)

    # relight_orb builds nerf (c2w) rays for every layout; GlossySynthetic
    # returns w2c poses, so on syn/ no ray hits the object (both packages)
    syn = db_mod.parse_database_name('syn/blobs', os.path.join(layouts, 'syn'),
                                     isTest=True)
    met, n_rays = 0, 0
    for vid in syn.get_img_ids()[:relight_orb.N_VIEWS]:
        h, w = syn.get_image(vid).shape[:2]
        batch = rays_mod.construct_ray_batch_nerf({
            'imgs': np.zeros((1, h, w, 3), np.float32),
            'Ks': syn.get_K(vid)[None], 'poses': syn.get_pose(vid)[None]})[0]
        for ri in range(0, h * w, RELIGHT_CHUNK):
            o, d = (torch.as_tensor(batch[k][ri:ri + RELIGHT_CHUNK],
                                    device=trainer.device)
                    for k in ('rays_o', 'dirs'))
            met += int(mr.trace_surface(trainer.geo_params, trainer.rcfg,
                                        trainer.grid, o, d)[3].sum())
        n_rays += h * w
    print(f'[relight] on syn/blobs (GlossySynthetic, w2c poses) '
          f'relight_orb\'s nerf rays of its 8 views: {met} of {n_rays} hit '
          'the surface (the reference builds the same rays: ROADMAP.md '
          'quirks)', flush=True)

    out = _cli(['tensoflow_tpu_torch.eval_mat', '--cfg',
                os.path.join(_root(), MAT_YAML), '--extract_mats',
                '--relight', '--hdr', 'sky.hdr',
                f'mesh={os.path.join(layouts, "pred.ply")}', *orb], run)
    bundle = json.load(open(os.path.join(run, 'data', 'relight', name,
                                         'relight_cfg.json')))
    if 'blender not found' not in out or bundle['hdr'] != 'sky.hdr':
        raise AssertionError(f'eval_mat --relight: {out}')
    n_mat = len(np.load(os.path.join(run, bundle['albedo'])))
    print(f'[relight] python -m tensoflow_tpu_torch.eval_mat --extract_mats '
          f'--relight --hdr sky.hdr: {out.splitlines()}; bundle '
          f'{sorted(bundle)}, {n_mat} vertex materials', flush=True)

    for d in ('gt', 'mask'):
        os.makedirs(os.path.join(run, d), exist_ok=True)
    for vid in ids:
        imwrite_png(os.path.join(run, 'gt', f'relit_{vid}.png'),
                    db.get_image(vid)[..., :3])
        imwrite_png(os.path.join(run, 'mask', f'relit_{vid}.png'),
                    (np.asarray(db.get_mask(vid)) > 0.5).astype(np.uint8)
                    * 255)
    out = _cli(['tensoflow_tpu_torch.eval_orb_relight', '--pred_dir',
                'relit_hdr', '--gt_dir', 'gt', '--mask_dir', 'mask'], run)
    last = out.splitlines()[-1]
    if not last.startswith('relight: SI-PSNR') or not np.isfinite(
            float(last.split()[2])):
        raise AssertionError(f'eval_orb_relight: {out}')
    print(f'[relight] python -m tensoflow_tpu_torch.eval_orb_relight on the '
          f'.hdr relit views against the toy views\' own images as "gt" '
          f'(this only shows that the path runs: the toy images were not '
          f'lit by this sky): {out.splitlines()}', flush=True)

    # one chunk of relight_view on the card against the CPU plain path,
    # the same fixed rolls: the middle 4096 rays of the first test view
    vid = ids[0]
    pose, K = db.get_pose(vid), np.asarray(db.get_K(vid), np.float32)
    h, w = db.get_image(vid).shape[:2]
    rows = min(h, RELIGHT_CHUNK // w)
    band = (h // 2 - rows // 2, h // 2 - rows // 2 + rows)
    rolls = [torch.rand(((band[1] - band[0]) * w, 1, 1),
                        generator=torch.Generator().manual_seed(5))]
    env_cube = relight_orb.load_env_cube(os.path.join(run, 'sky.hdr'),
                                         trainer.device)
    t0 = time.perf_counter()
    gpu = relight_orb.relight_view(trainer, env_cube, pose, K, h, w,
                                   rolls=rolls, rows=band, secondary=True)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = relight_orb.relight_view(_cpu_trainer(trainer), env_cube.cpu(),
                                   pose, K, h, w, rolls=rolls, rows=band,
                                   secondary=True)
    cpu_s = time.perf_counter() - t0
    both = gpu['hit'] & ref['hit']
    flips = int((gpu['secondary_hits'] != ref['secondary_hits']).sum())
    n_sec = gpu['secondary_hits'].size
    err = float(np.abs(gpu['rgb'][both] - ref['rgb'][both]).max())
    print(f'[relight] one relight_view chunk ({len(rolls[0])} rays, rows '
          f'{band}, fixed rolls) card vs CPU plain path: primary hits '
          f'{int(gpu["hit"].sum())} / {int(ref["hit"].sum())}, differing '
          f'{int((gpu["hit"] != ref["hit"]).sum())}; light rays classified '
          f'differently {flips} of {n_sec}; max |colour diff| on shared '
          f'hits {err:.3e}; card {gpu_s:.2f} s, CPU {cpu_s:.1f} s',
          flush=True)
    if int(both.sum()) == 0 or not np.isfinite(err) or \
            flips > 1e-3 * n_sec or err > 2e-2:
        raise AssertionError('relight chunk: card and CPU disagree')

    # an 800x800 view at the widths of phase 5: a toy view's K scaled
    scale = RELIGHT_VIEW / w
    K800 = np.array([[K[0, 0] * scale, 0, K[0, 2] * scale],
                     [0, K[1, 1] * scale, K[1, 2] * scale], [0, 0, 1]],
                    np.float32)
    chunks = -(-RELIGHT_VIEW * RELIGHT_VIEW // RELIGHT_CHUNK)
    spy = HeadSpy(capture_at=chunks // 2)
    st.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with spy:
        view = relight_orb.relight_view(trainer, env_cube, pose, K800,
                                        RELIGHT_VIEW, RELIGHT_VIEW)
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    if launches != {'stencil_head_fwd': chunks, 'stencil_head_bwd': 0} or \
            not np.isfinite(view['rgb']).all():
        raise AssertionError(f'800x800 relight: launches {launches} for '
                             f'{chunks} chunks')
    chunk_ms = view_s / chunks * 1e3
    print(f'[relight] an {RELIGHT_VIEW}x{RELIGHT_VIEW} view relit (view '
          f'{vid}\'s K scaled by {scale:g}; phase 5\'s widths, '
          f'{relight_orb.CHUNK}-ray chunks, 128 light rays a hit) on {card}: '
          f'{view_s:.3f} s/view, {chunk_ms:.1f} ms a chunk over {chunks} '
          f'chunks, {RELIGHT_VIEW ** 2 * 128 / view_s:.0f} light rays/s; hit '
          f'share {float(view["hit"].mean()):.4f}; stencil launches '
          f'{launches}', flush=True)

    b1 = trainer.geo_params['sdf']['mlp'][1]['b']
    mid = _captured_inputs(spy.captured, b1)
    n = mid['fr'].shape[0]
    hits = int(view['hit'].reshape(-1)[chunks // 2 * RELIGHT_CHUNK:
                                       (chunks // 2 + 1) * RELIGHT_CHUNK].sum())
    # the path runs the forward only: it is held to the plain version in
    # float64 on these inputs
    keys = ('pp', 'lp', 'fr', 'sigmas', 'pe', 'rot', 'w0p', 'b0', 'w1', 'b1')
    args = tuple(mid[k] for k in keys)
    with torch.no_grad():
        f64 = _as_f64(mid)
        fa, fr_ = rel_err(st.stencil_head(*args),
                          st.stencil_head_plain(*(f64[k] for k in keys),
                                                S=7))
    print(f'[relight] stencil forward at N={n} (the 800x800 view\'s middle '
          f'chunk, {hits} hits) vs plain f64: max_abs_err={fa:.3e} '
          f'rel={fr_:.3e} (tol rel {TOL[torch.float32][0]:g})', flush=True)
    if not fr_ <= TOL[torch.float32][0]:
        raise AssertionError(f'relight chunk: stencil forward rel err {fr_}')
    with torch.no_grad():
        k_ms = cuda_ms(lambda: st.stencil_head(*args), iters=50, warmup=5)
        p_ms = cuda_ms(lambda: st.stencil_head_plain(*args, S=7), iters=20,
                       warmup=3)
    (fb, fo), _ = head_bytes_ops(n, 7, 1, torch.float32)
    b_ms, by = bound_ms(fb, fo, torch.float32)
    print(f'[relight] stencil forward at N={n} (a relight chunk\'s own '
          f'inputs, float32, B=1): kernel {k_ms:.4f} ms/call (CUDA events, '
          f'50 calls), plain {p_ms:.4f}, bound {b_ms:.5f} ({by}); a relight '
          f'chunk {chunk_ms:.1f} ms; phase {time.perf_counter() - t_phase:.1f}'
          f' s', flush=True)

    info = {'imgs': np.zeros((1, RELIGHT_VIEW, RELIGHT_VIEW, 3), np.float32),
            'Ks': K800[None], 'poses': np.asarray(pose, np.float32)[None]}
    batch = rays_mod.construct_ray_batch_nerf(info)[0]
    at = chunks // 2 * RELIGHT_CHUNK
    o, d = (torch.as_tensor(batch[k][at:at + RELIGHT_CHUNK],
                            device=trainer.device) for k in ('rays_o', 'dirs'))
    aabb = mr.aabb_tensor(trainer.rcfg, trainer.device)
    roll = torch.rand((o.shape[0], 1, 1), generator=trainer.gen,
                      device=trainer.device)

    def chunk():
        inters, normals, _, _ = mr.trace_surface(
            trainer.geo_params, trainer.rcfg, trainer.grid, o, d)
        relight_direct(trainer.params, trainer.rcfg.shader, trainer.grid,
                       mr.unit_size(trainer.rcfg), aabb, inters, normals,
                       env_cube, -d, roll=roll)
    return launches, chunk, chunk_ms


# ---------------------------------------------------------------------------
# phase 3f: the field and shader options no published config sets
# ---------------------------------------------------------------------------

# the stage-2 options of the paper's ablations, each at the widths of
# configs/mat/syn/compressor.yaml on phase 5's checkpoint with phase 5's
# cuts; (c) as tests/test_train_material.py sets it (the combined flow
# alone: phase() gates its NIS loss on use_nis_diffuse / use_nis_specular,
# so it never trains), then with use_nis_diffuse on (the loss trains
# flow_all while the diffuse slot holds flow_diffuse's copy)
MAT_VARIANTS = (
    ('pwlinear', {'flow_type': 'pwlinear'}),
    ('realnvp', {'flow_type': 'realnvp'}),
    ('all', {'shade_fn': 'shade_mixed_all', 'use_nis_all': True,
             'use_nis_diffuse': False, 'use_nis_specular': False}),
    ('all+diffuse', {'shade_fn': 'shade_mixed_all', 'use_nis_all': True,
                     'use_nis_diffuse': True, 'use_nis_specular': False}),
    ('disable', {'disable_tensorial': True, 'disable_reflected': True}),
)
# the flows a NIS-loss step moves (and the ones it must leave alone)
MOVED_BY_NIS = {'pwlinear': ('flow_diffuse', 'flow_specular'),
                'realnvp': ('flow_diffuse', 'flow_specular'),
                'all': (), 'all+diffuse': ('flow_all',),
                'disable': ('flow_diffuse', 'flow_specular')}
VALIDATED = ('realnvp', 'all', 'all+diffuse')


def _phase_name(ph):
    return ('NIS sampling' if ph.nis_sample_diffuse else
            'NIS loss' if ph.nis_loss_diffuse or ph.nis_loss_specular else
            'no NIS')


def _flow_blocks(trainer):
    from tensoflow_tpu_torch.train.trainer import named_leaves
    return {k: [t.detach().clone()
                for _, t in named_leaves(trainer.params[k]['blocks'])]
            for k in trainer.params if k.startswith('flow')}


def run_mat_variant(card, geo, name, over, steps=12):
    """MaterialTrainer with ``over`` on the phase-5 checkpoint: init_dataset,
    ``steps`` steps across the NIS phases (finite terms; the flows a
    NIS-loss step moves; the median ms/step of each phase without its first
    step), and for VALIDATED variants one validated view (its _nis pass
    included).  Returns the trainer, its per-phase medians and the render's
    chunk count."""
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    cfg = _mat_cfg({'database_name': 'toy/blobs_128_12', 'split_manul': False,
                    'shader_cfg': {**NIS_CUT, **over}})
    trainer = MaterialTrainer(cfg, geo)
    trainer.init_dataset()
    loss_step = NIS_CUT['nis_loss_iter']
    logs, ms, names, moved = [], {}, {}, None
    for step in range(steps):
        before = _flow_blocks(trainer) if step == loss_step else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs += trainer.train(n_steps=1, log_every=1)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if before is not None:
            after = _flow_blocks(trainer)
            moved = sorted(k for k in before if not all(
                torch.equal(a, b) for a, b in zip(before[k], after[k])))
        pn = _phase_name(trainer.phase(step))
        names.setdefault(pn, step)
        if names[pn] != step:             # a phase's first step warms up
            ms.setdefault(pn, []).append(dt)
    _check_finite(logs)
    want = sorted(MOVED_BY_NIS[name])
    if moved != want:
        raise AssertionError(f'{name}: the NIS-loss step {loss_step} moved '
                             f'the flows {moved}, expected {want}')
    if 'NIS sampling' not in names:
        raise AssertionError(f'{name}: no NIS-sampling step ({names})')
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    chunks, val = 0, None
    if name in VALIDATED:
        (vid,) = trainer.test_ids
        h, w = trainer.database.get_image(vid).shape[:2]
        chunks = -(-h * w // 512)
        t0 = time.perf_counter()
        val = trainer.validate(max_views=1)
        val_s = time.perf_counter() - t0
        if not np.isfinite(val):
            raise AssertionError(f'{name}: validate() {val}')
        val = f'validate(max_views=1) {val:.3f} dB (_nis pass) in ' \
              f'{val_s:.2f} s, {chunks} chunks'
    print(f'[variants] {name} {over}: {trainer.tbn} hits, loss per step '
          + ', '.join(f'{r["loss"]:.5f}' for r in logs)
          + f' (finite); NIS loss terms '
          f'{[round(r.get("loss_nis", 0.0), 7) for r in logs]}; the '
          f'NIS-loss step {loss_step} moved {moved}; median ms/step by '
          f'phase (first step of each left out) '
          + json.dumps({k: round(v, 1) for k, v in med.items()})
          + (f'; {val}' if val else '') + f'; on {card}', flush=True)
    return trainer, med, chunks


def check_packed_materials(trainer):
    """predict_materials with packed=mat_pack(...) against the raw-plane
    route on the card, at the trainer's hits: the same level-0 bilinear
    taps in another order, to 1e-5 of each output's largest value."""
    from tensoflow_tpu_torch.fields import mc_shading
    from tensoflow_tpu_torch.models import material_renderer as mr
    scfg = trainer.rcfg.shader
    pts = torch.as_tensor(trainer.batcher.batch['inters'][:65536],
                          device='cuda')
    aabb = mr.aabb_tensor(trainer.rcfg, 'cuda')
    with torch.no_grad():
        raw = mc_shading.predict_materials(trainer.params, scfg, pts, aabb)
        packed = mc_shading.mat_pack(trainer.params, scfg)
        pk = mc_shading.predict_materials(trainer.params, scfg, pts, aabb,
                                          packed=packed)
    errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
            for a, b in zip(pk, raw)]
    if max(errs) > 1e-5:
        raise AssertionError(f'packed materials vs raw planes: {errs}')
    print(f'[variants] predict_materials with packed=mat_pack(...) on '
          f'{pts.shape[0]} hits on the card vs the raw planes: max rel diff '
          f'(metallic, roughness, albedo) '
          f'{[f"{e:.2e}" for e in errs]} (tol 1e-5); atlas '
          f'{tuple(packed.buffer.shape)}', flush=True)


def phase_human_light(card, steps=5):
    """Stage 1's human light: check_slice_small's comparison with the light
    on; then configs/shape/custom/shoe.yaml with the light turned on in
    the renderer config (ShapeTrainer(configure=with_human_light)) on
    phase 3d's JPEG capture (nerfDataType false, as 3d trains it)
    at 128^3: ``steps`` steps, one fwd + one bwd stencil launch a step,
    the human_light MLP moved by the first step, and the share of the
    first step's shaded samples whose blend weight is non-zero (read by a
    wrapper that syncs, so the timed steps run without it).  Returns the
    trainer, its ms/step and the launches of the steps."""
    from tensoflow_tpu_torch.fields import shading as shading_mod
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.train.trainer import (ShapeTrainer, named_leaves,
                                                   with_human_light)
    share = []
    orig = shading_mod.predict_human_light

    def spy(*args):
        light, weight = orig(*args)
        share.append(float((weight > 0).float().mean()))
        return light, weight
    shading_mod.predict_human_light = spy
    _, logs, worst = card_vs_cpu(_load_cfg(SMALL_OVERRIDES),
                                 'small slice + human light',
                                 configure=with_human_light)
    small_share = max(share)
    print(f'[human_light] small float32 config with the light on: 2 steps '
          f'on the card match the CPU plain path (worst loss-term rel err '
          f'{worst:.2e}); light weight non-zero on up to {small_share:.4f} '
          f'of the shaded samples; {_losses(logs)}', flush=True)
    obj = DATASET_TOY.split('/')[1].split('_')[0]
    name = f'custom/{obj}/raw_{RESIZE_LEN}'
    ddir = os.path.join(_root(), 'build', 'smoke_datasets', 'custom_jpeg')
    cfg = _load_cfg(['split_manul=false', f'database_name={name}',
                     f'dataset_dir={ddir}', 'nerfDataType=false'],
                    BG_YAML)
    trainer = ShapeTrainer(cfg, configure=with_human_light)
    trainer.init_dataset()
    if not trainer.rcfg.shading.human_light:
        raise AssertionError('the human light is not on')
    hl0 = [t.detach().clone()
           for _, t in named_leaves(trainer.params['shading']['human_light'])]
    share.clear()
    st.reset_launches()
    logs = trainer.train(n_steps=1, log_every=1)
    moved = sum(not torch.equal(t.detach(), b) for (_, t), b in zip(
        named_leaves(trainer.params['shading']['human_light']), hl0))
    shading_mod.predict_human_light = orig
    if moved != len(hl0):
        raise AssertionError(f'the first step moved {moved} of {len(hl0)} '
                             'human_light leaves')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs += trainer.train(n_steps=steps - 1, log_every=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    launches = dict(st.LAUNCHES)
    _check_finite(logs)
    if launches != {'stencil_head_fwd': steps, 'stencil_head_bwd': steps}:
        raise AssertionError(f'human light: launches {launches} in {steps} '
                             'steps')
    if not max(share) > 0:
        raise AssertionError('the human light weight is zero on every '
                             'shaded sample')
    print(f'[human_light] {BG_YAML} + human_light on {name} (phase 3d\'s '
          f'JPEG capture; cuts split_manul false, nerfDataType false): grid '
          f'{trainer.rcfg.sdf.grid_size}, {cfg["train_ray_num"]} rays x '
          f'({cfg["n_samples"]} + {cfg["n_importance"]}) samples, '
          f'{trainer.batcher.n} rays in the aabb; loss per step '
          + ', '.join(f'{r["loss"]:.6f}' for r in logs)
          + f' (finite); the first step moved all {len(hl0)} human_light '
          f'leaves; light weight non-zero on {max(share):.4f} of the first '
          f'step\'s shaded samples; launches {launches}; {step_ms:.1f} '
          f'ms/step over steps 2-{steps} on {card} (steps by path '
          f'{trainer.graph_stats})', flush=True)
    return trainer, step_ms, launches


SPLIT_GRAD_TOL = 1e-2


def check_split_route(card, hier):
    """sdf_with_grad_hessian on a 512^3 hierarchical step's own inputs
    (phase 3c's trainer: float32, B=2) with stencil_impl 'xla' (the split
    route: deduplicated taps of the 2x2 atlas, unfused head; plain torch,
    no kernel) and with the default (the stencil kernels).  Forward
    outputs and the parameter gradients of a random projection (the FD
    gradient's cotangent scaled by eps, so that its 1/eps does not swamp
    the others) as max relative differences; sdf / app held to 2 x TOL
    (two float32 routes, each within TOL of the exact), the FD gradient to
    that bound carried through 1/eps, the parameter gradients to
    SPLIT_GRAD_TOL of each leaf's largest value, the tolerance at which
    tests/test_torch_tenso_sdf.py holds the kernel route to the JAX
    package's 'xla' route (a line texel sums thousands of contributions
    of both signs: the FD gradient's +-offset taps cancel).  The split
    route runs twice: the difference of its two runs (atomic index_add_
    order) is printed beside.  Both routes timed with CUDA events.  The
    step spied on runs eagerly: a replay of the trainer's graph runs no
    Python."""
    from tensoflow_tpu_torch.fields import tenso_sdf
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.train.trainer import named_leaves
    got = {}
    orig = tenso_sdf.sdf_with_grad_hessian

    def spy(params, cfg, xyz, aabb, level=None, **kw):
        if not got:
            got.update(xyz=xyz.detach().clone(), aabb=aabb,
                       level=None if level is None else level.detach().clone())
        return orig(params, cfg, xyz, aabb, level, **kw)
    tenso_sdf.sdf_with_grad_hessian = spy
    hier.graph_engages = lambda: False
    try:
        hier.train(n_steps=1, log_every=1)
    finally:
        del hier.graph_engages
        tenso_sdf.sdf_with_grad_hessian = orig
    xyz, aabb, level = got['xyz'], got['aabb'], got['level']
    cfg_k = hier.rcfg.sdf
    cfg_x = cfg_k._replace(stencil_impl='xla')
    params = hier.params['sdf']
    names, leaves = zip(*named_leaves(params))
    n = xyz.shape[0]
    g = torch.Generator(device='cuda').manual_seed(5)
    cot = [torch.randn((n,), generator=g, device='cuda'),
           torch.randn((n, cfg_k.app_dim), generator=g, device='cuda'),
           torch.randn((n, 3), generator=g, device='cuda')]
    eps = tenso_sdf.units(cfg_k, aabb)

    def run(cfg, grads=True):
        out = tenso_sdf.sdf_with_grad_hessian(params, cfg, xyz, aabb, level)
        if not grads:
            return out
        loss = (torch.sum(out[0] * cot[0]) + torch.sum(out[1] * cot[1])
                + torch.sum(out[2] * cot[2] * eps))
        return [o.detach() for o in out], torch.autograd.grad(loss, leaves)

    st.reset_launches()
    xo, xg = run(cfg_x)
    torch.cuda.synchronize()
    x_launches = dict(st.LAUNCHES)
    _, xg2 = run(cfg_x)
    ko, kg = run(cfg_k)
    torch.cuda.synchronize()
    k_launches = dict(st.LAUNCHES)
    if x_launches != {'stencil_head_fwd': 0, 'stencil_head_bwd': 0} or \
            k_launches != {'stencil_head_fwd': 1, 'stencil_head_bwd': 1}:
        raise AssertionError(f'launches: xla {x_launches}, then the kernel '
                             f'route {k_launches}')

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    tol = 2 * TOL[torch.float32][0]
    outs = dict(zip(('sdf', 'app', 'grad', 'hessian'),
                    (rel(a, b) for a, b in zip(xo, ko))))
    grad_tol = tol * float(ko[0].abs().max() / eps.min()
                           / ko[2].abs().max())
    gerr = {'.'.join(map(str, k)): rel(a, b)
            for k, a, b in zip(names, xg, kg)}
    noise = {'.'.join(map(str, k)): rel(a, b)
             for k, a, b in zip(names, xg2, xg)}
    bad = [f'{k} {v:.2e}' for k, v in outs.items()
           if k in ('sdf', 'app') and v > tol]
    bad += [f'grad {outs["grad"]:.2e} > {grad_tol:.2e}'] \
        if outs['grad'] > grad_tol else []
    bad += [f'd{k} {v:.2e}' for k, v in gerr.items() if v > SPLIT_GRAD_TOL]
    with torch.no_grad():
        fx = cuda_ms(lambda: run(cfg_x, False), iters=5, warmup=1)
        fk = cuda_ms(lambda: run(cfg_k, False), iters=5, warmup=1)
    bx = cuda_ms(lambda: run(cfg_x), iters=3, warmup=1)
    bk = cuda_ms(lambda: run(cfg_k), iters=3, warmup=1)
    print(f'[split] sdf_with_grad_hessian on a 512^3 hierarchical step\'s '
          f'own inputs (N={n}, grid {cfg_k.grid_size}, {cfg_k.n_levels} '
          f'mip levels, float32): stencil_impl \'xla\' (split route, no '
          f'kernel: launches {x_launches}) vs the default (the stencil '
          f'kernels: {k_launches}); max rel diff '
          + json.dumps({k: f'{v:.2e}' for k, v in outs.items()})
          + f' (sdf/app tol {tol:.0e}, grad tol {grad_tol:.2e}, hessian '
          f'reported only); parameter gradients, largest '
          f'{max(gerr.values()):.2e} (tol {SPLIT_GRAD_TOL:.0e}) '
          + json.dumps({k: f'{v:.1e}' for k, v in gerr.items()})
          + '; two runs of the split route apart by '
          + json.dumps({k: f'{v:.1e}' for k, v in noise.items()}),
          flush=True)
    print(f'[split] times on {card} (CUDA events; a different algorithm, '
          f'not a library call): forward xla {fx:.2f} ms vs kernel route '
          f'{fk:.2f} ms ({fx / fk:.1f}x); forward + backward xla {bx:.2f} ms '
          f'vs {bk:.2f} ms ({bx / bk:.1f}x)', flush=True)
    if bad:
        raise AssertionError('split route vs kernel route: ' + '; '.join(bad))


def phase_variants(card, geo, hier, pwquad_ms):
    """Phase 3f: the options no published config sets (the paper's
    ablations and a custom capture's photographer light).  Stage 2: each
    MAT_VARIANTS entry's small step on the card against the CPU, then its
    run at the compressor widths (run_mat_variant) with the stencil
    launches counted from the first trainer to the last validation, beside
    phase 5's pwquad figures; predict_materials through mat_pack.  Stage
    1: the human light (phase_human_light).  The split stencil route
    (check_split_route).  Returns the launches of both paths and the
    trainers + ms/step that are profiled last."""
    from tensoflow_tpu_torch.ops import stencil as st
    t_phase = time.perf_counter()
    for name, over in MAT_VARIANTS:
        check_stage2_small(name, over)
    st.reset_launches()
    kept, chunks = {}, 0
    for name, over in MAT_VARIANTS:
        trainer, med, ch = run_mat_variant(card, geo, name, over)
        kept[name] = med
        chunks += ch
        if name == 'all+diffuse':
            mat_trainer, mat_ms = trainer, med['NIS sampling']
        else:
            del trainer
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mat_launches = dict(st.LAUNCHES)
    filter_chunks = mat_launches['stencil_head_fwd'] - chunks
    if mat_launches['stencil_head_bwd'] != 0 or \
            filter_chunks != len(MAT_VARIANTS) * 3:
        raise AssertionError(f'stage-2 variants: launches {mat_launches} for '
                             f'{chunks} render chunks + 3 hit-filtering '
                             f'chunks a trainer')
    print(f'[variants] stage-2 ms/step by phase on {card}: pwquad (phase 5) '
          + json.dumps({k: round(v, 1) for k, v in pwquad_ms.items()})
          + '; ' + '; '.join(f'{k} ' + json.dumps(
              {p: round(v, 1) for p, v in m.items()}) for k, m in kept.items())
          + f'; stencil launches of the variants\' path {mat_launches} '
          f'({len(MAT_VARIANTS)} x 3 hit-filtering chunks + {chunks} render '
          'chunks, forward only)', flush=True)
    check_packed_materials(mat_trainer)
    light_trainer, light_ms, light_launches = phase_human_light(card)
    check_split_route(card, hier)
    print(f'[variants] phase {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return {'mat_trainer': mat_trainer, 'mat_ms': mat_ms,
            'mat_launches': mat_launches, 'light_trainer': light_trainer,
            'light_ms': light_ms, 'light_launches': light_launches}


# ---------------------------------------------------------------------------
# phase 3g: sharded (parallel/sharding.py on torch.distributed)
# ---------------------------------------------------------------------------

SHARD_RANKS = 2
# compressor.yaml's hierarchical step at 512^3 from step 0: phase 3c's
# database cut, the grid at its N_voxel_final from the start (no
# upsampling), and the occ loss, radiance head and Gaussian loss (published
# from steps 10,000 / 20,000) on at step 0
SHARD_CUTS = ['database_name=toy/sphere_128_12', 'split_manul=false',
              'N_voxel_init=134217729', 'upsample_list=null',
              'occ_loss_step=0', 'radiance_field_step=-1',
              'gaussianLoss_step=-1']
# phase 5's database and checkpoint, the NIS schedule cut so that the first
# step samples and trains both flows
SHARD_NIS = {'nis_loss_iter': 0, 'nis_start_iter': 1,
             'nis_update_interval': 1}
SHARD_TOL = (2e-4, 2e-5)   # rtol, atol: tests/test_torch_sharding.py's
# run_training --multihost on a toy config (tests/test_torch_sharding.py's)
SHARD_CLI = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
             'app_dim=8', 'N_voxel_init=512', 'N_voxel_final=512',
             'train_ray_num=16', 'n_samples=8', 'n_importance=8',
             'upsample_list=null', 'init_radius=0.5', 'sdf_multires=0',
             'split_manul=false', 'save_interval=2', 'val_interval=1000',
             'train_log_step=1', 'name=smoke_multihost']


def shard_trainer(kind, geo, mesh=None):
    """A fresh trainer of phase 3g ('shape': compressor.yaml at 512^3,
    'mat': mat compressor.yaml on phase 5's checkpoint) with its dataset;
    mesh None: the single-device one."""
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    if kind == 'shape':
        t = ShapeTrainer(_load_cfg(SHARD_CUTS, HIER_YAML), mesh=mesh)
    else:
        t = MaterialTrainer(_mat_cfg({'database_name': DATASET_TOY,
                                      'split_manul': False,
                                      'shader_cfg': dict(SHARD_NIS)}), geo,
                            mesh=mesh)
    t.init_dataset()
    return t


def shard_step(t):
    """One training step; returns its log and the stencil launches."""
    from tensoflow_tpu_torch.ops import stencil as st
    torch.cuda.synchronize()
    st.reset_launches()
    logs = t.train(n_steps=1, log_every=1)
    torch.cuda.synchronize()
    _check_finite(logs)
    return logs[0], dict(st.LAUNCHES)


def rank_spread(params):
    """The largest |difference| of any parameter from rank 0's (each leaf
    broadcast from rank 0) and the number of leaves."""
    import torch.distributed as dist
    from tensoflow_tpu_torch.train.trainer import named_leaves
    worst, leaves = 0.0, named_leaves(params)
    with torch.no_grad():
        for _, t in leaves:
            ref = t.detach().clone()
            dist.broadcast(ref, 0)
            worst = max(worst, float((ref - t).abs().max()))
    return worst, len(leaves)


def shard_rank(rank, ranks, port, out, geo, backend):
    """One rank of the two-rank check: both stages' sharded steps, the
    ranks' parameter spread, and on rank 0 the stencil kernels against
    their plain version on this shard's own inputs."""
    from tensoflow_tpu_torch.parallel import sharding
    mesh = sharding.init_multihost(f'localhost:{port}', ranks, rank,
                                   backend=backend)
    res = {'device': str(mesh.device)}
    for kind in ('shape', 'mat'):
        t = shard_trainer(kind, geo, mesh)
        with HeadSpy() as spy:
            spy.capture_next = kind == 'shape' and rank == 0
            log, launches = shard_step(t)
        spread, n_leaves = rank_spread(t.params)
        res[kind] = {'log': log, 'launches': launches, 'spread': spread,
                     'leaves': n_leaves}
        if spy.captured is not None:
            d = _captured_inputs(spy.captured, t.params['sdf']['mlp'][1]['b'])
            spy.captured = None
            n, S = d['fr'].shape[0], 7
            res['kernel_case'] = f'S={S} B={len(d["sigmas"])} f32 N={n}'
            res['kernel_errs'] = check_inputs(
                res['kernel_case'] + ' (rank 0\'s shard of a sharded 512^3 '
                'step)', d, S, torch.float32)
            del d
        del t
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(out, f'rank{rank}.pt'))
    sharding.shutdown(mesh)


def nccl_timing(port, out, geo, steps=4, reps=2, iters=20):
    """One NCCL rank on the card: each stage's ms/step sharded (the
    collectives and the host reads of the compaction counts included)
    beside the unsharded step of the same process, in alternating windows;
    the gradient buffer's bytes and its all-reduce time (CUDA events)."""
    import torch.distributed as dist
    from tensoflow_tpu_torch.parallel import sharding
    mesh = sharding.init_multihost(f'localhost:{port}', 1, 0)
    res = {'backend': dist.get_backend()}
    for kind in ('shape', 'mat'):
        runs = {'single': shard_trainer(kind, geo),
                'nccl': shard_trainer(kind, geo, mesh)}
        for t in runs.values():
            log, _ = shard_step(t)                         # warm-up
        ms = {k: [] for k in runs}
        for _ in range(reps):
            for k, t in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _check_finite(t.train(n_steps=steps, log_every=steps))
                torch.cuda.synchronize()
                ms[k].append((time.perf_counter() - t0) / steps * 1e3)
        params = runs['nccl'].opt.params
        # the loss terms and their sum ride at the buffer's end
        n_terms = sum(k.startswith('loss') for k in log)
        nbytes = sharding.grad_buffer_bytes(params, n_terms)
        flat = torch.zeros(nbytes // 4, device='cuda')
        ar_ms = cuda_ms(lambda: dist.all_reduce(flat), iters=iters,
                        warmup=3)
        res[kind] = {'ms': ms, 'bytes': nbytes, 'all_reduce_ms': ar_ms,
                     'leaves': len(params)}
        del runs, flat
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(out, 'nccl.pt'))
    sharding.shutdown(mesh)


def _start(argv, out, name, env=None, cwd=None):
    from tensoflow_tpu_torch.parallel import dryrun
    return dryrun.start(argv, os.path.join(out, name + '.log'), env, cwd)


def _finish(procs, timeout=600):
    """Wait for (name, process, log file) triples (dryrun.finish); raise
    with the tail of the output of the first one that failed by itself
    (not killed after another failed)."""
    from tensoflow_tpu_torch.parallel import dryrun
    res = dryrun.finish([(p, log) for _, p, log in procs], timeout)
    bad = sorted(((rc == -signal.SIGKILL, name, rc, out)
                  for (name, _, _), (rc, out) in zip(procs, res) if rc),
                 key=lambda b: b[0])
    if bad:
        _, name, rc, out = bad[0]
        raise AssertionError(f'{name} exited with {rc}:\n{out[-6000:]}')


def _read(path):
    with open(path, errors='replace') as f:
        return f.read()


def phase_sharded(card, geo):
    """Phase 3g: the multi-device path on the one card, in subprocesses
    (no process group lives in this process).  Two gloo ranks run
    compressor.yaml's hierarchical step at 512^3 (1,024 rays, 512 a rank)
    and mat compressor.yaml's stage-2 step (2,048 rays) on phase 5's
    checkpoint, each held to the single-device step of the same params,
    batch and draws run here, at the CPU tests' tolerance; the ranks'
    params must be equal bit for bit; one fwd + one bwd stencil launch a
    rank and step, and the kernels against their plain version on rank
    0's shard.  Meanwhile run_training --multihost (NCCL, one rank) trains
    a toy config 2 steps and parallel.dryrun runs 2 gloo ranks.  Then one
    NCCL rank times both sharded steps beside the unsharded ones, the
    gradient buffer and its all-reduce.  Returns the stencil launches of
    the two ranks' stage-1 steps."""
    from tensoflow_tpu_torch.parallel import dryrun
    t_phase = time.perf_counter()
    root = _root()
    out = os.path.join(root, 'build', 'sharded')
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, 'cli'))
    me = os.path.abspath(__file__)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    port = dryrun.free_port()
    procs = [(f'rank {r}',) + _start(
        [sys.executable, me, '--shard-rank', str(r), '--ranks',
         str(SHARD_RANKS), '--port', str(port), '--out', out, '--geo', geo,
         '--backend', 'gloo'], out, f'rank{r}', env)
        for r in range(SHARD_RANKS)]
    procs.append(('dryrun',) + _start(
        [sys.executable, '-m', 'tensoflow_tpu_torch.parallel.dryrun',
         '--ranks', '2', '--backend', 'gloo'], out, 'dryrun', env, root))
    procs.append(('run_training',) + _start(
        [sys.executable, '-m', 'tensoflow_tpu_torch.run_training', '--cfg',
         os.path.join(root, 'configs/shape/toy/sphere.yaml'), '--steps', '2',
         '--multihost', f'localhost:{dryrun.free_port()}',
         '--num-processes', '1', '--process-id', '0', *SHARD_CLI], out,
        'run_training', env, os.path.join(out, 'cli')))
    single = {}
    try:
        for kind in ('shape', 'mat'):
            t = shard_trainer(kind, geo)
            single[kind] = shard_step(t)
            del t
            torch.cuda.empty_cache()
    finally:
        _finish(procs)
    ranks = [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
             for r in range(SHARD_RANKS)]
    rtol, atol = SHARD_TOL
    sharded_launches = {k: 0 for k in TPU_KERNELS}
    for kind, what in (('shape', 'compressor.yaml hierarchical step at '
                                 '512^3, float32'),
                       ('mat', 'mat compressor.yaml stage-2 step (both '
                               'flows sampling and training)')):
        ref, ref_launches = single[kind]
        worst = 0.0
        for r, res in enumerate(ranks):
            log = res[kind]['log']
            if sorted(log) != sorted(ref):
                raise AssertionError(f'{kind}: rank {r} logs {sorted(log)}')
            for k, v in ref.items():
                err = abs(log[k] - v)
                if err > atol + rtol * abs(v):
                    raise AssertionError(
                        f'{kind} {k}: rank {r} {log[k]!r} vs single-device '
                        f'{v!r} (rtol {rtol}, atol {atol})')
                worst = max(worst, err / max(abs(v), 1e-12))
            if res[kind]['spread'] != 0.0:
                raise AssertionError(f'{kind}: rank {r} params differ from '
                                     f'rank 0 by {res[kind]["spread"]}')
        launches = [res[kind]['launches'] for res in ranks]
        if kind == 'shape':
            for r, ln in enumerate(launches):
                if ln != {'stencil_head_fwd': 1, 'stencil_head_bwd': 1}:
                    raise AssertionError(f'rank {r}: launches {ln} in one '
                                         'sharded step')
                for k in sharded_launches:
                    sharded_launches[k] += ln[k]
        print(f'[sharded] {what}: {SHARD_RANKS} gloo ranks on one card '
              f'({", ".join(res["device"] for res in ranks)}) match the '
              f'single-device step (loss {ref["loss"]:.6f}; worst loss-term '
              f'rel err {worst:.2e}, tol rtol {rtol} / atol {atol}); params '
              f'equal on both ranks bit for bit ({ranks[0][kind]["leaves"]} '
              f'leaves, max |diff| {max(r[kind]["spread"] for r in ranks)}); '
              f'stencil launches per rank {launches} (single-device step '
              f'{ref_launches}); on {card}', flush=True)
    print(f'[sharded] kernels on rank 0\'s shard ({ranks[0]["kernel_case"]}):'
          f' fwd / bwd max abs err vs plain f64 '
          f'{ranks[0]["kernel_errs"][0]:.3e} / '
          f'{ranks[0]["kernel_errs"][1]:.3e} (within TOL); rank 0 printed:',
          flush=True)
    for ln in _read(os.path.join(out, 'rank0.log')).splitlines():
        if ln.startswith('[kernels]'):
            print(f'[sharded]   {ln}', flush=True)
    dry = _read(os.path.join(out, 'dryrun.log'))
    cli = _read(os.path.join(out, 'run_training.log'))
    for want, text in (('dryrun(2 ranks): stage-1 loss=', dry),
                       ('dryrun(2 ranks): stage-2 loss=', dry),
                       ('[mesh] 1 devices', cli),
                       ('training done at step 2 (rank 0)', cli)):
        if want not in text:
            raise AssertionError(f'{want!r} not in:\n{text[-4000:]}')
    print('[sharded] python -m tensoflow_tpu_torch.parallel.dryrun --ranks 2 '
          '--backend gloo on the card: ' + ' | '.join(
              ln for ln in dry.splitlines() if ln.startswith('dryrun(')),
          flush=True)
    print('[sharded] run_training --multihost (NCCL, --num-processes 1) on '
          'configs/shape/toy/sphere.yaml, 2 steps: ' + ' | '.join(
              ln for ln in cli.splitlines()
              if ln.startswith(('[mesh]', 'training done'))
              or ln.startswith('step=') or ' loss=' in ln), flush=True)
    port = dryrun.free_port()
    _finish([('nccl timing',) + _start(
        [sys.executable, me, '--nccl-timing', '--port', str(port), '--out',
         out, '--geo', geo], out, 'nccl', env)])
    res = torch.load(os.path.join(out, 'nccl.pt'), weights_only=False)
    for kind, what in (('shape', '512^3 hierarchical'), ('mat', 'stage-2')):
        r = res[kind]
        ms = {k: sorted(v)[len(v) // 2] for k, v in r['ms'].items()}
        print(f'[sharded] one {res["backend"]} rank, {what} step: '
              f'{ms["nccl"]:.1f} ms/step sharded vs {ms["single"]:.1f} '
              f'unsharded in the same process (windows '
              f'{json.dumps({k: [round(x, 1) for x in v] for k, v in r["ms"].items()})}); '
              f'gradient buffer {r["bytes"]} bytes ({r["leaves"]} leaves + '
              f'the loss terms) all-reduced in {r["all_reduce_ms"]:.3f} ms; '
              f'on {card}', flush=True)
    print(f'[sharded] phase {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return sharded_launches


# ---------------------------------------------------------------------------
# phase 3h: the evidence scripts at toy step counts
# ---------------------------------------------------------------------------

# (C, H, O, N, mip branches) of the scripts' stencil heads: convergence_run's
# field (sdf_n_comp 16, sdf_dim 128, app_dim 64; 512 rays x 96 samples; two
# branches after its first upsample) and the material scripts' stage 1
# (sdf_n_comp 12; 512 rays x (24 + 24) samples)
CONV_HEADS = ((16, 128, 65, 512 * 96, (1, 2)), (12, 128, 65, 512 * 48, (1,)))
# convergence_run cut to 40 steps: upsamples at 10 / 20, the occ-grid
# warmup, occ loss, radiance field and anneal moved inside the run
CONV_RUN = dict(total=40, marks=(20, 40), upsample_list=(10, 20),
                chamfer_res=64,
                extra={'occ_warmup_steps': 8, 'occ_loss_step': 12,
                       'radiance_field_step': 15, 'anneal_end': 20})
# the material scripts cut to 20 + 20 steps, the flows sampling from step 5
CONV_MAT = dict(steps=20, shape_steps=20, mat_extra={'shader_cfg': {
    'nis_start_iter': 5, 'nis_loss_iter': 3, 'nis_update_interval': 5}})


def phase_convergence(card):
    """The float32 stencil kernels at the evidence scripts' widths against
    their plain version (float64) at TOL; then the three scripts' own run
    functions at toy step counts (convergence_run 40 steps across both
    upsamples with a Chamfer at 64^3; convergence_mat and ab_material 20
    stage-1 + 20 stage-2 steps, NIS sampling from step 5, no extra seed),
    with the launch counts reset just before: every artifact must carry
    every key of the JAX artifact in data/convergence/, finite values only
    and this card's name.  Returns the launches of the runs and the
    kernels' worst (fwd, bwd) error."""
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.scripts import (ab_material, convergence_mat,
                                             convergence_run, record)
    t_phase = time.perf_counter()
    errs = (0.0, 0.0)
    for c, h, o, n, branches in CONV_HEADS:
        for b in branches:
            e = check_inputs(
                f'f32 S=7 B={b} N={n} C={c} H={h} O={o}',
                head_inputs(n, 7, b, torch.float32, seed=23, widths=(c, h, o)),
                7, torch.float32)
            errs = (max(errs[0], e[0]), max(errs[1], e[1]))
    out = os.path.join(_root(), 'build', 'smoke_convergence')
    st.reset_launches()
    runs = {
        'blobs_convergence': convergence_run.run(
            os.path.join(out, 'blobs_convergence.json'), **CONV_RUN),
        'toy_material_convergence': convergence_mat.run(
            os.path.join(out, 'toy_material_convergence.json'), **CONV_MAT),
        'toy_material_ab': ab_material.run(
            os.path.join(out, 'toy_material_ab.json'), seeds=(), **CONV_MAT),
    }
    launches = dict(st.LAUNCHES)
    for name, got in runs.items():
        with open(os.path.join(_root(), 'data', 'convergence',
                               name + '.json')) as f:
            ref = json.load(f)
        missing = record.missing_keys(ref, got)
        bad = record.nonfinite(got)
        if missing or bad or got['card'] != card:
            raise AssertionError(f'{name}: keys missing {missing}, values '
                                 f'not finite {bad}, card {got["card"]!r}')
        print(f'[convergence] {name}: every key of the JAX artifact, all '
              f'values finite; wall clock by phase {got["phase_wall_s"]}',
              flush=True)
    if not all(launches.values()):
        raise AssertionError(f'the evidence runs launched {launches}')
    blobs = runs['blobs_convergence']['chamfer']
    mat = runs['toy_material_convergence']
    arms = runs['toy_material_ab']['arms']
    print(f'[convergence] convergence_run 40 steps: grids '
          f'{[m["grid"][0] for m in blobs]}, val PSNR '
          f'{[round(m["val_psnr"], 2) for m in blobs]}, Chamfer '
          f'{[round(m["chamfer"], 4) for m in blobs]}; convergence_mat '
          f'stage-1 PSNR {mat["stage1_psnr"]}, stage-2 PSNR '
          f'{[round(r["psnr"], 2) for r in mat["trajectory"]]}; A/B val '
          f'PSNR {[round(a["val_psnr"], 2) for a in arms.values()]}; '
          f'stencil launches {launches}; phase '
          f'{time.perf_counter() - t_phase:.1f} s on {card}', flush=True)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 3i: widths past the fast kernels, and the dense occupancy route
# ---------------------------------------------------------------------------

# NeuS's published SDF network (confs/womask.conf, sdf_network: multires 6,
# d_hidden 256, d_out 257) on compressor.yaml's C = 36 and H = 256: E = 3 +
# 6 * 6 = 39 PE columns (3C+E = 147) and O = 1 + 256 head columns, past
# the fast kernels' 3C+E < 144 and O <= 144: the general kernels' path
NEUS_WIDTHS = ['sdf_multires=6', 'app_dim=256']
NEUS_SMALL = HIER_SMALL + ['sdf_n_comp=36', 'sdf_dim=256'] + NEUS_WIDTHS
# the occupancy-grid sampler without compaction: every one of its
# occ_max_samples (192) a ray through the field, dense compositing
OCC_DENSE = ['compact_samples_per_ray=0']
OCC_DENSE_CUTS = ['database_name=toy/sphere_128_12', 'split_manul=false']


def _launches():
    from tensoflow_tpu_torch.ops import stencil as st
    return {**st.LAUNCHES, **st.GENERAL_LAUNCHES}


def _paths(trainer, before):
    """The trainer's steps by path (replayed, eager) and its captures
    since ``before``, a copy of its graph_stats."""
    return {k: n - before[k] for k, n in trainer.graph_stats.items()}


def _expect_route(launches, route, fwd, bwd, what):
    """launches (fast and general) of a path: fwd / bwd on ``route``
    ('' for the fast kernels, 'general_'), none on the other."""
    want = {k: 0 for k in launches}
    want[f'stencil_head_{route}fwd'] = fwd
    want[f'stencil_head_{route}bwd'] = bwd
    if launches != want:
        raise AssertionError(f'{what}: launches {launches}, expected {want}')


def phase_general(card, hier_ms, timed_steps=5, occ_steps=4):
    """The widths the fast kernels refuse, through the user's entry
    points.  (a) card_vs_cpu at NeuS_SMALL (hierarchical sampler, the
    full NeuS head widths) and at the small dense occupancy-grid config;
    (b) compressor.yaml with NEUS_WIDTHS over phase 3c's schedule cut to
    six steps (128^3 -> 512^3), launches counted from zero, two more
    (the graph is captured at the second), then ``timed_steps`` replayed
    steps at 512^3 (B=2) beside phase 3c's published widths, the general
    kernels on a 512^3 step's own inputs, a rendered view and the mesh at
    128^3 (its SDF query, sdf_only, takes the field's plain head: no
    stencil); (c) stage 2 on a checkpoint at these widths
    (card vs CPU, a render and a relight_view chunk); (d)
    compressor_occ.yaml without compaction at NEUS_WIDTHS: an occupancy
    update, then ``occ_steps`` timed steps at 128^3.  Returns the
    general kernels' launches on (b)'s main path, its errors, its 512^3
    step ms and its trainer (profiled last, by main)."""
    import numpy as np
    from tensoflow_tpu_torch import extract_mesh, relight_orb
    from tensoflow_tpu_torch.models import shape_renderer as sr
    from tensoflow_tpu_torch.ops import mesh as mesh_mod
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.train import metrics_vis
    from tensoflow_tpu_torch.train.trainer import EVAL_KEYS, ShapeTrainer
    t_phase = time.perf_counter()
    # (a) card vs CPU
    st.reset_launches()
    _, logs, worst = card_vs_cpu(_load_cfg(NEUS_SMALL, HIER_YAML),
                                 'NeuS widths (hierarchical)')
    _expect_route(_launches(), 'general_', 2, 2, 'NeuS widths small')
    print(f'[general] NeuS head widths (C=36, E=39, H=256, O=257) on a small '
          f'hierarchical config: 2 steps on the card (general kernels) match '
          f'the CPU plain path (worst loss-term rel err {worst:.2e}); '
          f'{_losses(logs)}', flush=True)
    st.reset_launches()
    runs, logs, worst = card_vs_cpu(_load_cfg(SMALL_OVERRIDES + OCC_DENSE),
                                    'dense occupancy route')
    _expect_route(_launches(), '', 2, 2, 'dense occupancy small')
    sn = sr.n_route_samples(runs['cuda'].rcfg)
    print(f'[general] occupancy grid without compaction (small config, '
          f'{sn} samples a ray through the field): 2 steps on the card match '
          f'the CPU (worst loss-term rel err {worst:.2e}); {_losses(logs)}',
          flush=True)
    del runs

    # (b) the NeuS widths at 512^3 through the published schedule's cuts
    cfg = _load_cfg(HIER_CUTS + NEUS_WIDTHS, HIER_YAML)
    trainer = ShapeTrainer(cfg)
    trainer.init_dataset()
    sdf = trainer.rcfg.sdf
    widths = (sdf.n_comp, 3 + 6 * sdf.sdf_multires, sdf.sdf_dim,
              1 + sdf.app_dim)
    if widths != (36, 39, 256, 257) or st.head_route(
            torch.float32, 7, 2, *widths) != 'general':
        raise AssertionError(f'NeuS widths: {widths}')
    logs = []
    st.reset_launches()
    with HeadSpy(fn='GeneralStencilHead') as spy:
        for step in range(6):
            spy.capture_next = step == 5
            logs += trainer.train(n_steps=1, log_every=1)
        torch.cuda.synchronize()
        launches = _launches()
    _expect_route(launches, 'general_', 6, 6, 'NeuS widths schedule')
    if spy.bs != [1, 1, 1, 2, 2, 2]:
        raise AssertionError(f'mip branches per step {spy.bs}')
    _check_finite(logs)
    print(f'[general] compressor.yaml + {NEUS_WIDTHS} (C, E, H, O = '
          f'{widths}; cuts {HIER_CUTS}): loss per step ' + ', '.join(
              f'{r["loss"]:.6f}' for r in logs) + f'; launches {launches}; '
          f'mip branches per step {spy.bs}', flush=True)
    # step 5 was the first at the 512^3 key: step 6 is its second eager
    # step, step 7 its capture, so that the timed steps are replays
    trainer.train(n_steps=2, log_every=2)
    before = dict(trainer.graph_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = trainer.train(n_steps=timed_steps, log_every=timed_steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
    _check_finite(timed)
    paths = _paths(trainer, before)
    if paths['replayed'] != timed_steps:
        raise AssertionError(f'NeuS widths: timed steps by path {paths}')
    rays = cfg['train_ray_num']
    print(f'[general] {timed_steps} steps at 512^3 (B=2) at the NeuS widths '
          f'on {card}, all graph replays (steps 8-{7 + timed_steps}; '
          f'captured at step 7): {step_ms:.1f} ms/step = '
          f'{rays / (step_ms / 1e3):.0f} rays/s, beside {hier_ms:.1f} '
          f'ms/step at the published widths (phase 3c, fast kernels); loss '
          f'{timed[-1]["loss"]:.6f}', flush=True)
    d = _captured_inputs(spy.captured, trainer.params['sdf']['mlp'][1]['b'])
    spy.captured = None
    n = d['fr'].shape[0]
    errs = check_inputs(f'general S=7 B=2 dynamic f32 N={n} (a 512^3 step\'s '
                        'own inputs at the NeuS widths)', d, 7, torch.float32)
    del d
    (vid,) = trainer.test_ids
    db = trainer.database
    ds = cfg['downsample_ratio']
    gt = db.get_image(vid).astype(np.float32) / 255.0
    h, w = int(gt.shape[0] * ds), int(gt.shape[1] * ds)
    gt = metrics_vis.resize_linear(gt, h, w)
    K = np.diag([ds, ds, 1.0]).astype(np.float32) @ db.get_K(vid)
    st.reset_launches()
    t0 = time.perf_counter()
    out = trainer.render_image(db.get_pose(vid), K, h, w, chunk=1024)
    render_s = time.perf_counter() - t0
    _expect_route(_launches(), 'general_', 2 * -(-h * w // 1024), 0,
                  'NeuS widths render_image')
    bad = [k for k in EVAL_KEYS if not np.isfinite(out[k]).all()]
    if bad or set(out) != set(EVAL_KEYS):
        raise AssertionError(f'render_image: non-finite or missing {bad}')
    res = metrics_vis.eval_and_dump(gt, out, cfg['name'], trainer.start_step,
                                    vid, vis_dir=os.path.join(_root(),
                                                              'build'))
    st.reset_launches()
    t0 = time.perf_counter()
    query = extract_mesh.sdf_query(trainer.params, trainer.rcfg,
                                   torch.device('cuda'),
                                   float(cfg['blend_ratio']))
    verts, tris = mesh_mod.extract_geometry(
        np.array([-1.0, -1, -1]), np.array([1.0, 1, 1]), 128, 0.0, query)
    mesh_s = time.perf_counter() - t0
    mesh_launches = _launches()
    # the SDF query is sdf_only: the field's plain head, no stencil
    if not np.isfinite(verts).all() or len(tris) and len(verts) == 0:
        raise AssertionError(f'mesh: {len(verts)} verts, {len(tris)} tris')
    print(f'[general] render_image of view {vid} at {h}x{w} in '
          f'{render_s:.2f} s: PSNR {res["psnr"]:.3f} dB, all {len(out)} '
          f'images finite (general forward, 2 a chunk); mesh at 128^3 in '
          f'{mesh_s:.1f} s: {len(verts)} vertices, {len(tris)} triangles '
          f'(sdf_only: the field\'s plain head, stencil launches '
          f'{mesh_launches})', flush=True)
    del out
    torch.cuda.empty_cache()

    # (c) stage 2 on a checkpoint at these widths
    st.reset_launches()
    card_t, ref_t = check_stage2_small('NeuS widths', geo_over=NEUS_WIDTHS)
    s2 = _launches()          # the training step traces the baked grid
    if s2['stencil_head_fwd'] or s2['stencil_head_bwd']:
        raise AssertionError(f'stage 2 at the NeuS widths: launches {s2}')
    check_render_small(card_t, ref_t, kernel='stencil_head_general_fwd')
    env = os.path.join(_root(), 'build', 'smoke_general_sky.hdr')
    write_hdr(env, relight_env())
    db, vid = ref_t.database, ref_t.train_ids[0]
    K = np.diag([0.5, 0.5, 1.0]).astype(np.float32) @ db.get_K(vid)
    rolls = [torch.rand((256, 1, 1), generator=torch.Generator().manual_seed(3))]
    st.reset_launches()
    gpu = relight_orb.relight_view(card_t, relight_orb.load_env_cube(
        env, 'cuda'), db.get_pose(vid), K, 16, 16, rolls=rolls)
    rl = _launches()
    _expect_route(rl, 'general_', 1, 0, 'relight_view chunk')
    ref = relight_orb.relight_view(ref_t, relight_orb.load_env_cube(
        env, 'cpu'), db.get_pose(vid), K, 16, 16, rolls=rolls)
    both = gpu['hit'] & ref['hit']
    if not np.isfinite(gpu['rgb']).all() or both.sum() < 8:
        raise AssertionError(f'relight_view: {int(both.sum())} shared hits')
    print(f'[general] stage 2 on a checkpoint at the NeuS widths: launches '
          f'{s2} over the small card steps (they trace the baked grid), one '
          f'general forward in the render; a 16x16 relight_view chunk on the '
          f'card ({rl}) vs the CPU: hits {int(gpu["hit"].sum())} / '
          f'{int(ref["hit"].sum())}, max |colour diff| on shared hits '
          f'{float(np.abs(gpu["rgb"][both] - ref["rgb"][both]).max()):.3e}',
          flush=True)
    del card_t, ref_t

    # (d) the dense occupancy-grid route at the NeuS widths, 128^3
    occ = ShapeTrainer(_load_cfg(OCC_DENSE_CUTS + OCC_DENSE + NEUS_WIDTHS))
    occ.init_dataset()
    sn = sr.n_route_samples(occ.rcfg)
    st.reset_launches()
    warm = occ.train(n_steps=2, log_every=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = occ.train(n_steps=occ_steps, log_every=occ_steps)
    torch.cuda.synchronize()
    occ_ms = (time.perf_counter() - t0) / occ_steps * 1e3
    _check_finite(warm + timed)
    _expect_route(_launches(), 'general_', 2 + occ_steps, 2 + occ_steps,
                  'dense occupancy route')
    print(f'[general] compressor_occ.yaml + {OCC_DENSE + NEUS_WIDTHS} (cuts '
          f'{OCC_DENSE_CUTS}): {occ.cfg["train_ray_num"]} rays x {sn} '
          f'samples, grid {occ.rcfg.sdf.grid_size}: {occ_steps} timed steps '
          f'{occ_ms:.1f} ms/step on {card}; live-sample share '
          f'{timed[-1]["sample_num"] / sn:.4f}; loss {timed[-1]["loss"]:.6f}',
          flush=True)
    del occ
    torch.cuda.empty_cache()
    print(f'[general] phase in {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return ({k: launches[k] for k in st.GENERAL_LAUNCHES}, errs, step_ms,
            trainer)


def sub_main(argv):
    """The subprocess entries of phase 3g."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('--shard-rank', type=int)
    p.add_argument('--nccl-timing', action='store_true')
    p.add_argument('--ranks', type=int, default=SHARD_RANKS)
    p.add_argument('--port', type=int)
    p.add_argument('--out')
    p.add_argument('--geo')
    p.add_argument('--backend', default=None)
    a = p.parse_args(argv)
    sys.path.insert(0, _root())
    if a.nccl_timing:
        nccl_timing(a.port, a.out, a.geo)
    else:
        shard_rank(a.shard_rank, a.ranks, a.port, a.out, a.geo, a.backend)
    return 0


# ---------------------------------------------------------------------------
# phase 4: the tile-gather probes
# ---------------------------------------------------------------------------

def phase_probes(card):
    """Each gather kernel against its plain version and the one-call
    library version at every probe shape and at the ragged shapes (exact
    equality: a gather copies bits); at the probe shapes its device time,
    the plain and library versions' times, the byte bound (table + indices
    read once, output written once) and the launch floor (the device time
    of a one-element fill_, read in the same profiled window); then the
    microbench entry point, whose launches are the ones counted."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from tensoflow_tpu_torch.bench import microbench_r3
    from tensoflow_tpu_torch.ops import tile_gather as tg
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    rows = {}
    probes = microbench_r3.gather_cases()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    one = torch.zeros(1, device=dev)
    for i, case in enumerate(probes + microbench_r3.ragged_gather_cases()):
        name, fn, plain = case[:3]
        table, idx = microbench_r3.make_case(case, rng, dev)
        lane = name.startswith('lane_gather')
        idx64 = idx.long() if lane else idx.reshape(-1).long()

        def library():
            return (torch.gather(table, 1, idx64) if lane
                    else torch.index_select(table, 0, idx64))
        got = fn(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, plain(table, idx)):
            raise AssertionError(f'{name}: kernel differs from its plain '
                                 'version')
        if not torch.equal(got, library()):
            raise AssertionError(f'{name}: plain version differs from the '
                                 'library call')
        geometry = (tg.lane_gather_geometry(*table.shape) if lane else
                    tg.row_gather_geometry(idx.shape[0], table.shape[1]
                                           * table.element_size(), n_sm))
        if i >= len(probes):
            print(f'[probes] {name}: exact (geometry {geometry})',
                  flush=True)
            del got, table, idx, idx64
            continue
        nbytes = (table.numel() * table.element_size() + idx.numel() * 4
                  + got.numel() * got.element_size())
        del got
        iters = 5 if 'grid' in name else 20
        t = {}
        for which, f in (('plain', lambda: plain(table, idx)),
                         ('kernel', lambda: fn(table, idx)),
                         ('library', library),
                         ('kernel', lambda: fn(table, idx)),
                         ('plain', lambda: plain(table, idx))):
            ms = cuda_ms(f, iters=iters)
            t[which] = min(t.get(which, ms), ms)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(table, idx)
                one.fill_(1.0)
            torch.cuda.synchronize()
        dev_ms = _device_ms(prof, ['row_gather_kernel', 'lane_gather_kernel'],
                            iters)
        floor = _device_ms(prof, ['FillFunctor'], iters)
        k_ms = dev_ms if dev_ms > 0 else t['kernel']
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f'[probes] {name}: exact; kernel {k_ms:.5f} ms (wrapper '
              f'{t["kernel"]:.4f}), launch floor {floor:.5f} ms, bound '
              f'{bound:.5f} ms ({nbytes / 1e6:.2f} MB), plain '
              f'{t["plain"]:.4f} ms, library {t["library"]:.4f} ms; '
              f'geometry {geometry} on {card}', flush=True)
        rows[name] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=t['plain'],
                          bound_ms=bound, bound_by='bytes',
                          library_ms=t['library'], floor_ms=floor)
        del table, idx, idx64
    # the entry point a user would call; its launches are the counted ones
    tg.reset_launches()
    microbench_r3.main([])
    launches = dict(tg.LAUNCHES)
    print(f'[probes] microbench_r3 launches {launches}', flush=True)
    return ({k: rows[case] for k, (_, case) in GATHER_KERNELS.items()},
            launches)


# ---------------------------------------------------------------------------
# phase 5: the stage-2 (material / NIS) slice
# ---------------------------------------------------------------------------

MAT_YAML = 'configs/mat/syn/compressor.yaml'
SMALL_SHADER = {
    'diffuse_sample_num': 32, 'specular_sample_num': 16,
    'nis_diffuse_sample_num': 8, 'nis_specular_sample_num': 8,
    'nis_start_iter': 1, 'nis_loss_iter': 0, 'nis_update_interval': 5,
    'grid_size': (32, 32, 32), 'light_reso': 16, 'mat_n_comp': 4,
    'estimator_dtype': 'f32'}
# the NIS schedule of the full-width run, cut to single digits so that 12
# steps cross the three phases (published: 500 / 1000 / 1000)
NIS_CUT = {'nis_loss_iter': 4, 'nis_start_iter': 8, 'nis_update_interval': 4}
LOBE_CENTERS = ((-0.3, 0.0, 0.0), (0.3, 0.0, 0.0))
LOBE_RADIUS = 0.45


def _root():
    return os.path.dirname(os.path.abspath(__file__))


def _mat_cfg(extra):
    from tensoflow_tpu_torch import config as config_mod
    return config_mod.load_config(os.path.join(_root(), MAT_YAML),
                                  extra=extra)


def check_stage2_small(variant=None, over=None, geo_over=()):
    """One stage-2 training step in its last phase (NIS loss + sampling
    from frozen flow copies) on the card against the same step on the CPU
    at a small float32 configuration: same initial parameters (both
    trainers seed the same CPU generator), the same baked grid and hit
    batch (made on the CPU and copied) and the same noise (drawn on the
    CPU and copied).  Loss terms and psnr agree to rtol 1e-4 at the first
    step (float32 sums of Monte-Carlo samples in another order) and 2e-2
    at the second: Adam's first update is sign(g) * lr, so tiny gradients
    may step either way, and the estimator's few samples with a small pdf
    carry that into the colours.  ``over``: the shader options of a
    variant (phase 3f); ``geo_over``: stage-1 options of the geometry
    (phase 3i's widths); the render check runs for the published options
    only.  Returns the card and CPU trainers."""
    from tensoflow_tpu_torch.data import rays as rays_mod
    from tensoflow_tpu_torch.fields import mc_shading
    from tensoflow_tpu_torch.ops.sdf_trace import PackedSDFGrid
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

    class CpuDraws(MaterialTrainer):
        def step_noise(self, step, phase):
            noise = mc_shading.draw_shade_noise(
                self.cpu_gen, self.rcfg.shader, self.cfg['train_ray_num'],
                phase, 'cpu')
            return {k: v.to(self.device) for k, v in noise.items()}

    geo = os.path.join(_root(), 'build', 'smoke_geo_small'
                       + ('_widths' if geo_over else '') + '.pt')
    ShapeTrainer(_load_cfg(SMALL_OVERRIDES + ['init_radius=0.5']
                           + list(geo_over)), device='cpu').save(geo)
    cfg = _mat_cfg({'database_name': 'toy/sphere_32_4', 'train_ray_num': 64,
                    'bake_resolution': 32,
                    'shader_cfg': {**SMALL_SHADER, **(over or {})}})
    ref = CpuDraws(cfg, geo, device='cpu')
    ref.init_dataset()
    card = CpuDraws(cfg, geo, device='cuda')
    g = ref.grid
    card.grid = PackedSDFGrid(
        g.mid_rows.cuda(), g.blocks.cuda(), g.coarse_rows.cuda(),
        g.aabb.cuda(), g.reso, g.vis_rows.cuda(), g.vis_pad)
    logs, hits = {}, dict(ref.batcher.batch)
    for name, tr in (('cuda', card), ('cpu', ref)):
        tr.cpu_gen = torch.Generator().manual_seed(cfg['random_seed'])
        tr.batcher = rays_mod.RayBatcher(dict(hits), cfg['train_ray_num'],
                                         cfg['random_seed'])
        logs[name] = tr.train(n_steps=2, log_every=1)
    _check_finite(logs['cuda'])
    scfg = card.rcfg.shader
    assert card.phase(1).nis_sample_diffuse and \
        card.phase(1).nis_loss_diffuse == scfg.use_nis_diffuse
    worst, bad = 0.0, []
    for i, (gl, cl) in enumerate(zip(logs['cuda'], logs['cpu'])):
        rtol = 1e-4 if i == 0 else 2e-2
        for k, v in cl.items():
            err = abs(gl[k] - v)
            if k.startswith('secondary_'):
                tol = 5e-3              # a rate: a few rays of thousands
            elif k == 'variance':
                # a diagnostic, not a loss term: the variance of f / pdf
                # over all samples, carried by the few samples whose pdf
                # is small
                tol = 10 * rtol * abs(v)
            else:
                tol = rtol * abs(v) + 1e-6
                if abs(v) > 1e-6:
                    worst = max(worst, err / abs(v))
            if err > tol:
                bad.append(f'step {i} {k}: card {gl[k]!r} vs CPU {v!r}')
    tag = '[stage2]' if variant is None else f'[variants] {variant}:'
    if bad:
        raise AssertionError(f'{tag} small stage-2 step: ' + '; '.join(bad)
                             + f'; card {logs["cuda"]}; cpu {logs["cpu"]}')
    print(f'{tag} small float32 config ({ref.tbn} hits kept): 2 steps '
          f'on the card match the CPU (worst term rel err {worst:.2e}, tol '
          f'1e-4 then 2e-2); card {json.dumps({k: round(v, 6) for k, v in logs["cuda"][-1].items()})}',
          flush=True)
    if variant is None:
        check_render_small(card, ref)
    return card, ref


# render_image, card against CPU: pixels whose primary hit may differ (a
# depth at a threshold of the sphere trace), and on the pixels both sides
# hit, the largest and the mean |card - CPU| of rgb_pr and rgb_pr_nis: one
# secondary ray of a pixel's 48 + 24 that the budgeted trace classifies
# the other way moves its colour by up to ~1/48 of a light's value
RENDER_HIT_ALLOWANCE = 3
RENDER_TOL = {'max': 5e-2, 'mean': 1e-3}


def check_render_small(card, ref, kernel='stencil_head_fwd'):
    """render_image of a 16x16 view (the 32x32 toy view through a K scaled
    by 1/2) on the card (the stencil forward kernel in the primary trace's
    normal) and on the CPU (its plain version), with the same parameters
    and frozen flow copies (the card trainer's, copied); both variants
    compared on the pixels both sides hit.  Evaluation draws nothing."""
    import numpy as np
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.train.checkpoints import tree_map
    ref.set_params(tree_map(lambda t: t.detach().cpu().clone(), card.params))
    ref.flow_copies = tree_map(lambda t: t.cpu().clone(), card.flow_copies)
    db, vid = ref.database, ref.train_ids[0]
    K = np.diag([0.5, 0.5, 1.0]).astype(np.float32) @ db.get_K(vid)
    st.reset_launches()
    out = card.render_image(db.get_pose(vid), K, 16, 16)
    torch.cuda.synchronize()
    launches = {**st.LAUNCHES, **st.GENERAL_LAUNCHES}
    want = ref.render_image(db.get_pose(vid), K, 16, 16)
    hc, hr = out['hit_mask'][..., 0] > 0.5, want['hit_mask'][..., 0] > 0.5
    both = hc & hr
    errs = {}
    for k in ('rgb_pr', 'rgb_pr_nis'):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f'render on the card: non-finite {k}')
        e = np.abs(out[k] - want[k])[both]
        errs[k] = (float(e.max()), float(e.mean()))
    diff = int((hc != hr).sum())
    print(f'[stage2] render_image 16x16 card vs CPU: {int(both.sum())} '
          f'pixels hit on both sides, {diff} differ in hit (allowed '
          f'{RENDER_HIT_ALLOWANCE}); max / mean |card - CPU| '
          + ', '.join(f'{k} {a:.2e} / {m:.2e}' for k, (a, m) in errs.items())
          + f' (tol {RENDER_TOL["max"]:g} / {RENDER_TOL["mean"]:g}); '
          f'stencil launches on the card {launches}', flush=True)
    if diff > RENDER_HIT_ALLOWANCE or both.sum() < 8 or any(
            a > RENDER_TOL['max'] or m > RENDER_TOL['mean']
            for a, m in errs.values()):
        raise AssertionError(f'render_image: card disagrees with the CPU: '
                             f'{diff} hit pixels differ, errors {errs}')
    if launches[kernel] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f'render_image: launches {launches}')


def check_budget_trace(card, pn=2048, sn=864):
    """sphere_trace_budget at the full-width ray count (pn x sn = 1.77 M
    rays) on the two-lobe analytic grid at 256^3 (a union of two spheres:
    self-occluding, with a concave crease), launched as get_lights
    launches its rays, beside the unbudgeted sphere_trace_packed."""
    from tensoflow_tpu_torch.ops import sdf_trace as st
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    res, unit = 256, 2.0 / 511.0
    centers = torch.tensor(LOBE_CENTERS, device=dev)

    def sdf(p):
        return (torch.linalg.norm(p[..., None, :] - centers, dim=-1)
                - LOBE_RADIUS).min(-1).values
    xs = torch.linspace(-1, 1, res, device=dev)
    vals = sdf(torch.stack(torch.meshgrid(xs, xs, xs, indexing='ij'), -1))
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3], device=dev)
    t0 = time.perf_counter()
    pg = st.bake_vis_cache(st.pack_sdf_grid(st.SDFGrid(vals, aabb)),
                           apex_pad=2.0 * unit)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    # surface points with analytic normals on both lobes, outside the
    # other lobe; hemisphere directions about the normal
    n = torch.randn((4 * pn, 3), generator=g, device=dev)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    lobe = centers[torch.randint(0, 2, (4 * pn,), generator=g, device=dev)]
    pts = lobe + n * LOBE_RADIUS
    keep = torch.nonzero(sdf(pts) > -1e-3)[:pn, 0]
    pts, n = pts[keep], n[keep]
    d = torch.randn((pn, sn, 3), generator=g, device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = torch.where(torch.sum(d * n[:, None], -1, keepdim=True) < 0, -d, d)
    m_cell = 2.0 / (res // 2 - 1)
    nrm = n[:, None, :].expand(pn, sn, 3).reshape(-1, 3)
    d = d.reshape(-1, 3)
    o = pts[:, None, :].expand(pn, sn, 3).reshape(-1, 3) \
        + 2.0 * unit * d + 1.5 * m_cell * nrm
    h0 = torch.sum(d * nrm, -1)
    n_rays = o.shape[0]
    from tensoflow_tpu_torch.train import trainer_mat as tm
    budget_frac = 0.375

    def budget():
        return st.sphere_trace_budget(
            pg, o, d, st.budget_slots(n_rays, budget_frac), h0=h0,
            a1_budget=0.625)
    res_b = budget()
    first_rate = float(res_b.cand.float().mean())
    if first_rate * tm.SEC_BUDGET_MARGIN > budget_frac:
        # re-bucket as MaterialTrainer._adapt_secondary_budget does
        budget_frac = next((b for b in tm.SEC_BUDGET_BUCKETS
                            if b >= first_rate * tm.SEC_BUDGET_MARGIN),
                           tm.SEC_BUDGET_BUCKETS[-1])
        res_b = budget()
    m = st.budget_slots(n_rays, budget_frac)
    full_hit = st.sphere_trace_packed(pg, o, d)[3]
    torch.cuda.synchronize()
    b_ms = cuda_ms(budget, iters=3, warmup=1)
    f_ms = cuda_ms(lambda: st.sphere_trace_packed(pg, o, d), iters=3,
                   warmup=1)
    live = res_b.hit_m & res_b.slot_mask
    hit = torch.zeros_like(full_hit)
    hit[res_b.src[live]] = True
    agree = float((hit == full_hit).float().mean())
    dropped = int((res_b.cand & (res_b.dest >= m)).sum())
    stats = dict(rays=n_rays, budget=budget_frac,
                 cand_rate=float(res_b.cand.float().mean()),
                 hit_rate=float(live.float().sum()) / n_rays,
                 a1_rate=float(res_b.a1_need.float().mean()),
                 full_hit_rate=float(full_hit.float().mean()),
                 hit_agreement=agree, dropped_candidates=dropped)
    print(f'[stage2] budgeted trace on the two-lobe grid at 256^3 on {card}: '
          f'{json.dumps({k: round(v, 5) for k, v in stats.items()})}; '
          f'budgeted {b_ms:.1f} ms, unbudgeted {f_ms:.1f} ms, cache bake '
          f'{bake_s:.1f} s', flush=True)
    if not (agree > 0.98 and 0.0 < stats['hit_rate'] < stats['cand_rate']
            and (dropped == 0 or budget_frac == tm.SEC_BUDGET_BUCKETS[-1])):
        raise AssertionError(f'budgeted trace disagrees with the unbudgeted '
                             f'one: {stats}')


def _probe_kept_share(shape, mat_cfg, n=65536):
    """Share of the stage-1 trainer's first n training rays that hit the
    surface of its current SDF, baked at 128^3 (a quick probe of what
    MaterialTrainer.init_dataset will keep)."""
    from tensoflow_tpu_torch.models import material_renderer as mr
    from tensoflow_tpu_torch.ops import sdf_trace
    from tensoflow_tpu_torch.train.trainer_mat import build_material_config
    sdf = shape.rcfg.sdf
    rcfg = build_material_config(mat_cfg, {
        'grid_size': list(sdf.grid_size), 'n_levels': sdf.n_levels,
        'sdf_n_comp': sdf.n_comp, 'sdf_dim': sdf.sdf_dim,
        'app_dim': sdf.app_dim, 'sdf_multires': sdf.sdf_multires,
        'aabb': [list(a) for a in shape.rcfg.aabb]})
    geo = {'sdf': shape.params['sdf'], 'deviation': shape.params['deviation']}
    dev = shape.device
    with torch.no_grad():
        dense = sdf_trace.bake_sdf_grid(mr.sdf_fun_of(geo, rcfg, dev),
                                        rcfg.aabb, 128, device=dev)
        o = torch.as_tensor(shape.batcher.batch['rays_o'][:n], device=dev)
        d = torch.as_tensor(shape.batcher.batch['dirs'][:n], device=dev)
        hit = mr.trace_surface(geo, rcfg, sdf_trace.pack_sdf_grid(dense),
                               o, d)[3]
    return float(hit.float().mean())


def phase_stage2(card, steps=12):
    from tensoflow_tpu_torch.ops import stencil as st
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    check_stage2_small()
    check_budget_trace(card)

    # stage 1 at the compressor_occ widths on the self-occluding toy
    # scene, trained in rounds of 8 steps until a probe trace of its baked
    # SDF keeps enough surface hits (the untrained field has no surface
    # inside the aabb); then the checkpoint
    geo = os.path.join(_root(), 'build', 'smoke_geo.pt')
    cfg = _mat_cfg({'database_name': 'toy/blobs_128_12',
                    'split_manul': False, 'shader_cfg': dict(NIS_CUT)})
    rays = cfg['train_ray_num']
    t0 = time.perf_counter()
    shape = ShapeTrainer(_load_cfg(['database_name=toy/blobs_128_12',
                                    'gather_dtype=bfloat16']))
    shape.init_dataset()
    geo_steps, share = 0, 0.0
    while share * shape.batcher.n < 4 * rays:
        if geo_steps >= 64:
            raise AssertionError(f'no traceable surface after {geo_steps} '
                                 f'stage-1 steps (kept share {share:.4f})')
        _check_finite(shape.train(n_steps=8, log_every=8))
        geo_steps += 8
        share = _probe_kept_share(shape, cfg)
        print(f'[stage2] stage 1 after {geo_steps} steps: a probe trace '
              f'keeps {share:.4f} of 65,536 training rays', flush=True)
    shape.save(geo)
    del shape
    torch.cuda.empty_cache()
    print(f'[stage2] cuts: database toy/blobs_128_12 with a stage-1 '
          f'checkpoint of {geo_steps} steps (the published scene and its '
          f'checkpoint are not in the repository); NIS schedule {NIS_CUT} '
          f'(published 500 / 1000 / 1000); split_manul false (the toy '
          f'split holds out one of its 12 views); stage-1 part '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    st.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = MaterialTrainer(cfg, geo)          # device=None: the card
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.init_dataset()
    torch.cuda.synchronize()
    scfg = trainer.rcfg.shader
    print(f'[stage2] widths: {rays} rays, {scfg.diffuse_sample_num} + '
          f'{scfg.specular_sample_num} analytic and '
          f'{scfg.nis_diffuse_sample_num} + {scfg.nis_specular_sample_num} '
          f'flow samples, field grids {scfg.grid_size}, mat_n_comp '
          f'{scfg.mat_n_comp}, light_reso {scfg.light_reso}, bake '
          f'{trainer.rcfg.bake_resolution}^3, estimator '
          f'{scfg.estimator_dtype}; bake {bake_s:.1f} s, hit filtering '
          f'{time.perf_counter() - t0:.1f} s, kept {trainer.tbn} hits = '
          f'{trainer.kept_share:.3f} of the training rays', flush=True)
    if trainer.tbn < rays:
        raise AssertionError(f'only {trainer.tbn} surface hits for batches '
                             f'of {rays}')
    logs, ms, names = [], {}, {}
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs += trainer.train(n_steps=1, log_every=1)
        torch.cuda.synchronize()
        ph = trainer.phase(step)
        name = ('NIS sampling' if ph.nis_sample_diffuse else
                'NIS loss' if ph.nis_loss_diffuse else 'no NIS')
        names.setdefault(name, step)
        if names[name] != step:       # a phase's first step warms up
            ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
    _check_finite(logs)
    if list(names) != ['no NIS', 'NIS loss', 'NIS sampling']:
        raise AssertionError(f'phases crossed: {list(names)}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[stage2] every loss term of the {steps} steps is finite; loss '
          'per step: ' + ', '.join(f'{r["loss"]:.6f}' for r in logs),
          flush=True)
    print('[stage2] last step terms: ' + json.dumps(
        {k: round(v, 6) for k, v in logs[-1].items()}), flush=True)
    for name, v in ms.items():
        mean = sum(v) / len(v)
        dn = scfg.diffuse_sample_num + (
            scfg.nis_diffuse_sample_num if name == 'NIS sampling' else 0)
        sn = (scfg.nis_specular_sample_num if name == 'NIS sampling'
              else scfg.specular_sample_num)
        print(f'[stage2] phase "{name}" (from step {names[name]}): '
              f'{mean:.1f} ms/step over {len(v)} steps = '
              f'{rays / (mean / 1e3):.0f} rays/s, {rays * (dn + sn)} '
              f'secondary rays a step, on {card}', flush=True)
    print(f'[stage2] trace rates at the last step: candidates '
          f'{logs[-1]["secondary_cand_rate"]:.4f}, hits '
          f'{logs[-1]["secondary_hit_rate"]:.4f}, a1 '
          f'{logs[-1]["secondary_a1_rate"]:.4f}; peak device memory '
          f'{peak:.2f} GiB; stencil launches on this path '
          f'{dict(st.LAUNCHES)}', flush=True)
    last = ms['NIS sampling']
    render_launches, chunk_ms = stage2_eval(trainer, card)
    phase_lights(card, geo)
    medians = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    return trainer, sum(last) / len(last), render_launches, chunk_ms, medians


def stage2_eval(trainer, card, chunk=512):
    """What a published material run does at its validations and in
    eval_mat: render_image of the held-out view (both variants, s/view,
    rays/s, PSNR, hit share, stencil launches: one forward a chunk, the
    normal of the primary hits) and validate(); the stencil forward kernel
    on the render's own inputs at N = 512 (its first chunk, and the padded
    last chunk of a 24x24 view) against its plain version, and its time
    beside a chunk's; env_light_image at 256x512; predict_vertex_materials
    on the mesh of the stage-1 checkpoint extracted at 128^3."""
    import numpy as np
    from tensoflow_tpu_torch.eval import metrics
    from tensoflow_tpu_torch.fields import mc_shading
    from tensoflow_tpu_torch.models import material_renderer as mr
    from tensoflow_tpu_torch.ops import mesh as mesh_mod
    from tensoflow_tpu_torch.ops import stencil as st
    (vid,) = trainer.test_ids
    db = trainer.database
    gt = db.get_image(vid).astype(np.float32) / 255.0
    h, w = gt.shape[:2]
    pose, K = db.get_pose(vid), np.asarray(db.get_K(vid), np.float32)
    chunks = -(-h * w // chunk)
    spy = HeadSpy(capture_at=chunks // 2)      # the view's middle rows
    st.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with spy:
        out = trainer.render_image(pose, K, h, w, chunk=chunk)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    bad = [k for k, v in out.items() if not np.isfinite(v).all()]
    if bad or 'rgb_pr_nis' not in out:
        raise AssertionError(f'render_image: non-finite {bad} or no _nis '
                             f'variant ({sorted(out)})')
    if launches != {'stencil_head_fwd': chunks, 'stencil_head_bwd': 0}:
        raise AssertionError(f'render_image launches {launches} for '
                             f'{chunks} chunks')
    psnr = metrics.psnr(gt, out['rgb_pr'])
    psnr_nis = metrics.psnr(gt, out['rgb_pr_nis'] + (1.0 - out['hit_mask']))
    t0 = time.perf_counter()
    val = trainer.validate(max_views=1)
    val_s = time.perf_counter() - t0
    if not (np.isfinite(val) and abs(val - psnr_nis) < 1e-2):
        raise AssertionError(f'validate() {val} vs the render\'s '
                             f'rgb_pr_nis PSNR {psnr_nis}')
    rays_s = h * w / render_s
    print(f'[stage2] render_image of held-out view {vid} at {h}x{w} in '
          f'chunks of {chunk} on {card}: {render_s:.3f} s/view = '
          f'{rays_s:.0f} rays/s ({render_s / chunks * 1e3:.1f} ms a chunk; '
          f'an 800x800 view: {800 * 800 / rays_s:.0f} s), hit share '
          f'{float(out["hit_mask"].mean()):.4f}; PSNR analytic {psnr:.3f} '
          f'dB, _nis {psnr_nis:.3f} dB; every image finite; stencil '
          f'launches {launches}; validate(max_views=1) {val:.3f} dB in '
          f'{val_s:.3f} s', flush=True)

    # the stencil forward kernel on the render's own N = 512 rows (a
    # missed ray's row sits at its camera centre): the middle chunk of the
    # view, and the padded last chunk of a 24x24 view whose principal
    # point puts the object in its last rows
    b1 = trainer.geo_params['sdf']['mlp'][1]['b']
    mid = _captured_inputs(spy.captured, b1)
    hits = int(out['hit_mask'].reshape(-1)[
        chunks // 2 * chunk:(chunks // 2 + 1) * chunk].sum())
    check_inputs(f'S=7 B=1 f32 N={chunk} (the render\'s middle chunk, '
                 f'{hits} hits)', mid, 7, torch.float32)
    tail_spy = HeadSpy(capture_at=1)
    K24 = np.array([[K[0, 0] * 24 / w, 0, 12.0], [0, K[1, 1] * 24 / h, 22.5],
                    [0, 0, 1]], np.float32)
    with tail_spy:
        small = trainer.render_image(pose, K24, 24, 24, chunk=chunk)
    tail_hits = int(small['hit_mask'].reshape(-1)[chunk:].sum())
    if tail_hits == 0 or not all(np.isfinite(v).all()
                                 for v in small.values()):
        raise AssertionError(f'render_image 24x24: {tail_hits} hits in its '
                             'last chunk, or non-finite images')
    check_inputs(f'S=7 B=1 f32 N={chunk} (a padded last chunk: '
                 f'{24 * 24 - chunk} rays, {tail_hits} hits, + '
                 f'{2 * chunk - 24 * 24} copies)',
                 _captured_inputs(tail_spy.captured, b1), 7, torch.float32)
    args = (mid['pp'], mid['lp'], mid['fr'], mid['sigmas'], mid['pe'],
            mid['rot'], mid['w0p'], mid['b0'], mid['w1'], mid['b1'])
    with torch.no_grad():
        k_ms = cuda_ms(lambda: st.stencil_head(*args), iters=50, warmup=5)
        p_ms = cuda_ms(lambda: st.stencil_head_plain(*args, S=7), iters=20,
                       warmup=3)
    (fb, fo), _ = head_bytes_ops(chunk, 7, 1, torch.float32)
    b_ms, by = bound_ms(fb, fo, torch.float32)
    print(f'[stage2] stencil forward at N={chunk} (the render\'s own '
          f'inputs, float32, B=1): kernel {k_ms:.4f} ms/call (CUDA events, '
          f'50 calls), plain {p_ms:.4f}, bound {b_ms:.5f} ({by}); a render '
          f'chunk {render_s / chunks * 1e3:.1f} ms', flush=True)

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env = mc_shading.env_light_image(trainer.params, trainer.rcfg.shader,
                                         256, 512)
        torch.cuda.synchronize()
    env_ms = (time.perf_counter() - t0) * 1e3
    if tuple(env.shape) != (256, 512, 3) or not bool(
            torch.isfinite(env).all()):
        raise AssertionError(f'env_light_image: {tuple(env.shape)}')
    light = trainer.rcfg.shader.outer_light_version
    print(f'[stage2] env_light_image 256x512 ({light}) in {env_ms:.1f} ms: '
          f'finite, values '
          f'{float(env.min()):.4f}..{float(env.max()):.4f}', flush=True)

    dev = trainer.device
    sdf_fun = mr.sdf_fun_of(trainer.geo_params, trainer.rcfg, dev)

    @torch.no_grad()
    def query(pts):
        return torch.cat([
            sdf_fun(torch.as_tensor(pts[i:i + 262144], dtype=torch.float32,
                                    device=dev))[:, 0].cpu()
            for i in range(0, len(pts), 262144)]).numpy()
    verts, _ = mesh_mod.extract_geometry(np.array([-1.0] * 3),
                                         np.array([1.0] * 3), 128, 0.0, query)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mats = mr.predict_vertex_materials(trainer.params, trainer.rcfg,
                                       verts.astype(np.float32))
    mat_ms = (time.perf_counter() - t0) * 1e3
    if len(verts) == 0 or any(
            v.shape[0] != len(verts) or not np.isfinite(v).all()
            for v in mats.values()):
        raise AssertionError(f'predict_vertex_materials on {len(verts)} '
                             'vertices')
    print(f'[stage2] predict_vertex_materials on the 128^3 mesh of the '
          f'stage-1 checkpoint: {len(verts)} vertices in {mat_ms:.1f} ms '
          f'(chunks of 8192), albedo mean '
          f'{mats["albedo"].mean(0).round(4).tolist()}', flush=True)
    return launches, render_s / chunks * 1e3


def profile_render(trainer, card, chunk_ms, chunk=512):
    """profile_step over one render chunk of the held-out view (its middle
    chunk of ``chunk`` rays, both eval passes)."""
    import numpy as np
    from tensoflow_tpu_torch.data import rays as rays_mod
    (vid,) = trainer.test_ids
    db = trainer.database
    h, w = db.get_image(vid).shape[:2]
    info = {'imgs': np.zeros((1, h, w, 3), np.float32),
            'Ks': np.asarray(db.get_K(vid), np.float32)[None],
            'poses': np.asarray(db.get_pose(vid), np.float32)[None]}
    make = (rays_mod.construct_ray_batch_nerf if trainer.cfg['nerfDataType']
            else rays_mod.construct_ray_batch_w2c)
    batch = make(info)[0]
    at = (h * w // chunk // 2) * chunk
    o, d = (torch.as_tensor(batch[k][at:at + chunk], device='cuda')
            for k in ('rays_o', 'dirs'))
    profile_step(trainer, card, chunk_ms, tag='render',
                 run=lambda: trainer.render_chunk(o, d, True),
                 what=f'render chunk ({chunk} rays, both eval passes)')


# the two other light setups of the published material configs, at their
# own widths on the same toy checkpoint
LIGHT_YAMLS = (('configs/mat/syn/lego.yaml', ('outer_light',)),
               ('configs/mat/custom/shoe.yaml',
                ('outer_light', 'human_light')))


def phase_lights(card, geo, steps=12):
    """MaterialTrainer at configs/mat/syn/lego.yaml ('direction') and
    configs/mat/custom/shoe.yaml ('sphere_direction' + human lights): the
    database cut to toy/blobs_128_12 (nerfDataType, one held-out view),
    the NIS schedule to NIS_CUT; ``steps`` steps across the three phases,
    every loss term finite, the light MLPs' leaves moved by the first
    step, then one validated view."""
    import numpy as np
    from tensoflow_tpu_torch import config as config_mod
    from tensoflow_tpu_torch.fields import mc_shading
    from tensoflow_tpu_torch.train.trainer import named_leaves
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    for yaml, lights in LIGHT_YAMLS:
        cfg = config_mod.load_config(os.path.join(_root(), yaml))
        cfg['shader_cfg'] = {**cfg['shader_cfg'], **NIS_CUT}
        cfg.update({'database_name': 'toy/blobs_128_12',
                    'split_manul': False, 'nerfDataType': True})
        trainer = MaterialTrainer(cfg, geo)
        trainer.init_dataset()
        scfg = trainer.rcfg.shader
        before = {n: [t.detach().clone()
                      for _, t in named_leaves(trainer.params[n])]
                  for n in lights}
        t0 = time.perf_counter()
        logs = trainer.train(n_steps=1, log_every=1)
        still = [f'{n}{p}' for n in lights
                 for (p, t), t0_ in zip(named_leaves(trainer.params[n]),
                                        before[n])
                 if torch.equal(t.detach(), t0_)]
        if still:
            raise AssertionError(f'{yaml}: leaves not moved by the first '
                                 f'step: {still}')
        names = []
        for step in range(steps):
            if step:
                logs += trainer.train(n_steps=1, log_every=1)
            ph = trainer.phase(step)      # the copies of this step on
            names.append('NIS sampling' if ph.nis_sample_diffuse else
                         'NIS loss' if ph.nis_loss_diffuse else 'no NIS')
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        _check_finite(logs)
        if sorted(set(names)) != ['NIS loss', 'NIS sampling', 'no NIS']:
            raise AssertionError(f'{yaml}: phases {names}')
        t0 = time.perf_counter()
        val = trainer.validate(max_views=1)
        val_s = time.perf_counter() - t0
        with torch.no_grad():
            env = mc_shading.env_light_image(trainer.params, scfg, 256, 512)
        if not (np.isfinite(val) and bool(torch.isfinite(env).all())):
            raise AssertionError(f'{yaml}: validate() {val}, env_light_image '
                                 f'finite {bool(torch.isfinite(env).all())}')
        print(f'[lights] {yaml}: outer light {scfg.outer_light_version!r}, '
              f'human_lights {scfg.human_lights}, {scfg.diffuse_sample_num} '
              f'+ {scfg.specular_sample_num} samples, {trainer.tbn} hits, '
              f'step batch {trainer.step_keys()}; {steps} steps across the '
              f'three NIS phases in {step_s:.2f} s (cuts: database '
              f'toy/blobs_128_12 with nerfDataType, split_manul false, NIS '
              f'{NIS_CUT}), every loss term finite, all '
              f'{sum(len(v) for v in before.values())} leaves of {lights} '
              f'moved by the first step; losses '
              f'{[round(r["loss"], 5) for r in logs]}; validate(max_views=1) '
              f'{val:.3f} dB in {val_s:.2f} s; env_light_image 256x512 '
              f'finite, {float(env.min()):.4f}..{float(env.max()):.4f}; on '
              f'{card}', flush=True)
        del trainer
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        return sub_main(sys.argv[1:])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tensoflow_tpu_torch.ops import cuda_build
    card = card_line()
    t_script = t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    print(f'[build] kernels built in {time.perf_counter() - t0:.1f} s',
          flush=True)
    for name in SOURCES:
        log = os.path.join(cuda_build.BUILD_DIR, name + '.log')
        if not os.path.exists(log):      # built by an earlier run
            continue
        with open(log, errors='replace') as f:
            for line in ptxas_report(f):
                print(f'[build] {name}: {line}')
    # the training phases come first and their profiled steps last: once a
    # torch.profiler session has run in a process, every later kernel
    # launch of that process costs the host several microseconds more
    # (measured: the same stage-2 steps took 77 / 130 / 123 ms before and
    # 112 / 168 / 168 ms after a session), which would inflate the step
    # times of these host-bound steps
    _, shape_trainer, shape_ms = phase_slice(card)
    mat_trainer, mat_ms, render_launches, chunk_ms, mat_phase_ms = \
        phase_stage2(card)
    launches, sched_trainer, sched_ms = phase_schedule(card)
    hier_launches, hier_trainer, hier_ms, hier_errs = phase_hierarchical(card)
    geo = os.path.join(_root(), 'build', 'smoke_geo.pt')
    disk_launches = phase_datasets(card, geo)
    relight_launches, relight_chunk, relight_ms = phase_relight(
        card, mat_trainer, geo)
    var = phase_variants(card, geo, hier_trainer, mat_phase_ms)
    sharded_launches = phase_sharded(card, geo)
    conv_launches, conv_errs = phase_convergence(card)
    gen_launches, gen_errs, gen_step_ms, gen_trainer = phase_general(
        card, hier_ms)
    kinds = phase_kernels(card)
    gen_rows = phase_general_kernels(card)
    gather_kinds, gather_launches = phase_probes(card)
    profile_step(shape_trainer, card, shape_ms)
    profile_step(mat_trainer, card, mat_ms, tag='stage2')
    profile_render(mat_trainer, card, chunk_ms)
    with torch.no_grad():
        profile_step(mat_trainer, card, relight_ms, tag='relight',
                     run=relight_chunk,
                     what=f'relight chunk ({RELIGHT_CHUNK} rays)')
    profile_step(sched_trainer, card, sched_ms, tag='schedule')
    profile_step(hier_trainer, card, hier_ms, tag='hier')
    profile_step(var['light_trainer'], card, var['light_ms'],
                 tag='human_light')
    profile_step(var['mat_trainer'], card, var['mat_ms'],
                 tag='stage2_all')
    # the NeuS-width 512^3 step of phase 3i: its device time, the general
    # kernels' share of it, and the idle share
    profile_step(gen_trainer, card, gen_step_ms, tag='general_step')
    for k, n in gather_launches.items():
        if n <= 0:
            raise AssertionError(f'{k} was not launched by microbench_r3')
    print(f'[smoke] every phase passed in {time.perf_counter() - t_script:.1f}'
          ' s (build included)', flush=True)
    print(card)
    # the stencil rows: the float32 B=2 figures of this slice's main path
    # (every published stage-1 config after its first upsample), its
    # launches, and beside them the other instantiations and the launches
    # of the occupancy-grid schedule (bf16)
    stencil = []
    for k in TPU_KERNELS:
        row = dict(kinds['f32', 2][k])
        row['max_abs_err'] = max(row['max_abs_err'],
                                 hier_errs[k == 'stencil_head_bwd'],
                                 conv_errs[k == 'stencil_head_bwd'])
        stencil.append({
            'name': k, 'route': 'cuda',
            'source': f'tensoflow_tpu_torch/csrc/{k}.cu',
            'replaces': TPU_KERNELS[k], 'launches': hier_launches[k],
            'library_ms': None, **row, 'dtype': 'float32', 'B': 2,
            'launches_by_path': {'hierarchical_f32': hier_launches[k],
                                 'occ_schedule_bf16': launches[k],
                                 'stage2_render_f32': render_launches[k],
                                 'from_disk': disk_launches[k],
                                 'stage2_relight_f32': relight_launches[k],
                                 'human_light_f32':
                                     var['light_launches'][k],
                                 'stage2_variants':
                                     var['mat_launches'][k],
                                 'sharded_f32': sharded_launches[k],
                                 'convergence': conv_launches[k]},
            'other_rows': {f'{t} B={b}': kinds[t, b][k]
                           for t, b in kinds if (t, b) != ('f32', 2)}})
    # the general kernels: the float32 B=2 figures at the NeuS widths,
    # their launches on phase 3i's NeuS-width schedule (its main path)
    for k in ('stencil_head_general_fwd', 'stencil_head_general_bwd'):
        row = dict(gen_rows[2][k])
        row['max_abs_err'] = max(row['max_abs_err'],
                                 gen_errs[k.endswith('bwd')])
        stencil.append({
            'name': k, 'route': 'cuda', 'source': GEN_SOURCE,
            'replaces': TPU_KERNELS[k.replace('general_', '')],
            'launches': gen_launches[k], 'library_ms': None, **row,
            'dtype': 'float32', 'B': 2, 'widths_CEHO': list(GEN_NEUS),
            'step_ms_512': gen_step_ms,
            'other_rows': {'f32 B=1': gen_rows[1][k], **(
                {f'f32 B=2 N={n}': r for n, r in gen_rows['small'].items()}
                if k.endswith('fwd') else {})}})
    print(json.dumps({'kernels': stencil + [
        {'name': k, 'route': 'cuda',
         'source': 'tensoflow_tpu_torch/csrc/tile_gather.cu',
         'replaces': GATHER_KERNELS[k][0], 'launches': gather_launches[k],
         **gather_kinds[k]} for k in GATHER_KERNELS]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
