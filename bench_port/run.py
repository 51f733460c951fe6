"""Run one cell of BENCHMARK.json once on the card this process sees.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from process start to the first timed step): the
cell's configuration builds the system under test from the seed and
brings it to the measured state (see the configuration's system.py),
warms up on the cell's own shapes, and runs the compared steps on that
warmed path, keeping what the reference needs.  The window is one call of the
program's own entry for a step count fixed from the warm-up's step time,
ending in a synchronise.  With ``--trace 1`` a few more steps run under
the profiler after the window, and the per-layer metrics are read from
them (bench_port/metrics/<name>.py).  After the window the program's state
is freed and the configuration's check.py compares what the timed path
produced with the plain reference; every number compared is printed with
its limit on the last lines of standard error and under ``checks`` in the
result, which is the last line of standard output.
"""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()

# one host thread for the libraries' pools: the step is host-bound, and
# pools spinning beside it on a shared host spread the runs
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[_var] = '1'

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port.harness import peaks, profile, timing  # noqa: E402
from bench_port.harness import spec as spec_mod  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cache_dirs(root):
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    build = os.path.join(root, 'build')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(build, 'torch_ext')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    from tensoflow_tpu_torch.ops import cuda_build
    cuda_build.BUILD_DIR = os.path.join(build, 'kernels')


def card_line():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi unavailable'


def run_cell(name, seed, seconds, trace, device='cuda', overrides=(),
             traffic_over=None):
    """One run of cell ``name``; returns the result dict (the contract's
    keys, ``checks`` last).  ``overrides`` (config dotlist) and
    ``traffic_over`` shrink a run for the CPU tests."""
    import torch
    spec = spec_mod.load_spec()
    cell = spec_mod.workload(spec, name)
    traffic = {**spec_mod.load_traffic(cell['traffic']),
               **(traffic_over or {})}
    cdir = spec_mod.config_dir(spec, cell['config'])
    load = spec_mod.load_module
    system_mod = load(os.path.join(cdir, 'system.py'),
                      f'bench_system_{cell["config"]}')
    check_mod = load(os.path.join(cdir, 'check.py'),
                     f'bench_check_{cell["config"]}')
    counts = load(os.path.join(cdir, 'counts.py'),
                  f'bench_counts_{cell["config"]}')
    cuda = torch.device(device).type == 'cuda'

    # -- set-up ------------------------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_setup0 = time.perf_counter()
    sut = system_mod.System(traffic, seed, device=device,
                            overrides=overrides)
    warm_s = prepare(sut, traffic, device)
    n = max(traffic['min_window_steps'], int(round(seconds / warm_s)))
    split = {'process start to set-up': t_setup0 - T_START, **sut.times}
    log(f'[bench] {name}: set-up split (s) ' + json.dumps(
        {k: round(v, 3) for k, v in split.items()}))
    log(f'[bench] {name}: warm-up {warm_s * 1e3:.3f} ms/step '
        f'-> {n} steps in the window')

    # -- the window --------------------------------------------------------
    sut.reset_launches()
    stamps = timing.Stamps(device)
    sut.step_starts = stamps
    timing.sync(device)
    t_win = time.perf_counter()
    setup_s = t_win - T_START
    sut.run_steps(n, keep_aux=True)
    stamps.mark()
    timing.sync(device)
    wall = time.perf_counter() - t_win
    sut.step_starts = None
    step_times = stamps.durations()
    launches = sut.launches()
    route = sut.route(launches, n)
    log(f'[bench] head route in the window: {route} ({launches})')
    terms = [torch.stack([v.float().reshape(()) for v in a.values()])
             for a in sut.aux]
    finite = torch.stack([torch.isfinite(t).all() for t in terms])
    failed = int((~finite).sum())
    sut.aux = []
    step_s = wall / n
    e2e = {'train_rays_per_s': (sut.rays * n / wall, 'rays/s'),
           'step_ms_p95': (timing.percentile(step_times, 95) * 1e3, 'ms'),
           'setup_s': (setup_s, 's')}
    log(f'[bench] window {wall:.3f} s, {n} steps, {step_s * 1e3:.3f} ms/step '
        f'mean, p50 {timing.percentile(step_times, 50) * 1e3:.3f} ms, '
        f'p95 {e2e["step_ms_p95"][0]:.3f} ms, max '
        f'{max(step_times) * 1e3:.3f} ms; failed steps {failed}')
    slow = sorted(range(n), key=step_times.__getitem__)[-3:]
    log('[bench] slowest window steps (index: ms) ' + ', '.join(
        f'{i}: {step_times[i] * 1e3:.3f}' for i in reversed(slow)))

    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': torch.cuda.get_device_name() if cuda else 'cpu',
                   'count': 1}
    metrics, breakdown = {}, None
    if trace:
        undo = sut.ranges()
        prof, pwall = profile.profile_run(
            lambda: sut.run_steps(traffic['trace_profiled_steps']),
            lambda: timing.sync(device))
        undo()
        tr = profile.Trace(prof, pwall, traffic['trace_profiled_steps'])
        del prof
        ctx = SimpleNamespace(trace=tr, step_s=step_s, cfg=sut.cfg,
                              counts=counts, peaks=peaks, system=sut)
        for m in spec_mod.cell_metrics(spec, name, 'per_layer'):
            reader = load(spec_mod.metric_file(m['name']),
                          f'bench_metric_{m["name"]}')
            v = reader.read(ctx)
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
        breakdown = tr.breakdown()
        device_info['busy_s'] = tr.busy_s
        device_info['window_s'] = tr.wall_s
        log(f'[bench] profiled {tr.n_steps} steps: {tr.wall_s:.3f} s wall, '
            f'device busy {tr.busy_s:.3f} s, '
            f'{tr.launches_per_step():.1f} launches/step')
    else:
        for m in spec_mod.cell_metrics(spec, name, 'end_to_end'):
            v, unit = e2e[m['name']]
            metrics[m['name']] = {'value': float(v), 'unit': unit}
    device_info['memory_peak_bytes'] = (
        int(torch.cuda.max_memory_allocated()) if cuda else 0)

    # -- correctness -------------------------------------------------------
    inputs = sut.reference_inputs()
    sut.release()
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks, notes = check_mod.checks(inputs, device)
    log(f'[bench] reference and comparison {time.perf_counter() - t0:.1f} s;'
        f' {json.dumps(notes)}')
    want_route = traffic.get('route')
    ok_route = want_route is None or route == want_route
    if not ok_route:
        log(f'[bench] the head left the {want_route} route: {route}')
    correct = (ok_route and failed == 0
               and all(_within(v, lim) for _, v, lim in checks))
    shown = {k: {'value': v, 'limit': lim} for k, v, lim in checks}
    result = {'correct': bool(correct), 'attempted': n, 'failed': failed,
              'metrics': metrics, 'device': device_info}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = shown
    for k, v, lim in checks:
        log(f'check {k} {v!r} limit {lim!r}')
    # last, once everything the run loads is loaded: the reference and
    # the comparison too
    found = spec_mod.forbidden_modules(list(sys.modules))
    if found:
        raise SystemExit(f'[bench] modules that may not be loaded: {found}')
    return result


def prepare(sut, traffic, device):
    """Set-up up to the window: build and bring the system to the
    measured state, warm up on the cell's own shapes, then run the
    compared steps on that warmed path.  Returns the warm-up's seconds a
    step, which fixes the window's step count."""
    sut.setup()
    timing.sync(device)
    t0 = time.perf_counter()
    sut.run_steps(traffic['warmup_steps'])
    timing.sync(device)
    warm = time.perf_counter() - t0
    sut.times['warm-up'] = warm
    sut.capture()
    return warm / traffic['warmup_steps']


def _within(v, lim):
    return isinstance(v, (int, float)) and not math.isnan(v) and v <= lim


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    spec = spec_mod.load_spec(ROOT)
    cell = spec_mod.workload(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        log(f'[bench] {args.workload} needs {cell["chips"]} CUDA device(s); '
            f'this process sees {torch.cuda.device_count()}')
        return 2
    try:
        cache_dirs(ROOT)
    except ImportError as e:
        log(f'[bench] the program is not in this checkout: {e}')
        return 3
    log(f'[bench] card: {card_line()}')
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
