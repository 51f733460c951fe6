"""The readings the limits of ``mat_compressor``'s comparison are set from
(configs/mat_compressor/limits.json; PERF.md gives them):

* the program against the reference on each seed (the lower readings);
* the control on the first ``--control`` seeds: the reference computed in
  TF32 put in the program's place, against the reference in float32
  (matrix products in TF32, the step below float32);
* two faults on the same seeds, planted in the reference and put in the
  program's place: the specular flow copy ignored (the GGX samples kept
  where it samples), and half of each batch's points (the means taken
  over the first half).

Run on the card at the cell's own size, one process for all seeds:

    python3 bench_port/tests/readings_mat.py --seeds 11 12 13 --control 2

Each seed prints one JSON line.  ``--overrides`` shrinks the configuration
(the CPU test does so).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port.harness.spec import load_module as _load  # noqa: E402

CELL = 'mat_nis_sample'
FAULTS = ('specular_copy', 'half_batch')


def seed_readings(seed, control, device='cuda', overrides=(),
                  traffic_over=None):
    import torch
    run = _load(os.path.join(BENCH, 'run.py'), 'bench_run')
    spec = run.spec_mod.load_spec(ROOT)
    w = run.spec_mod.workload(spec, CELL)
    traffic = {**run.spec_mod.load_traffic(w['traffic'], ROOT),
               **(traffic_over or {})}
    cdir = run.spec_mod.config_dir(spec, w['config'], ROOT)
    system = _load(os.path.join(cdir, 'system.py'), 'bench_system_mat')
    check = _load(os.path.join(cdir, 'check.py'), 'bench_check_mat')
    t0 = time.perf_counter()
    sut = system.System(traffic, seed, device=device, overrides=overrides)
    run.prepare(sut, traffic, device)
    inputs = sut.reference_inputs()
    sut.release()
    del sut
    gc.collect()
    if device != 'cpu':
        torch.cuda.empty_cache()
    out = {'seed': seed, 'setup_s': time.perf_counter() - t0}
    t0 = time.perf_counter()
    ref = check.follow(inputs, device)
    out['reference_s'] = time.perf_counter() - t0
    out['program'] = {**check.stage_readings(inputs, device),
                      **check.step_readings(inputs, check.program_run(inputs),
                                            ref)}
    if control:
        out['control'] = {
            'bake': check.stage_readings(inputs, device, 'tf32')['bake'],
            **check.step_readings(inputs,
                                  check.follow(inputs, device, 'tf32'), ref)}
        for fault in FAULTS:
            out[fault] = check.step_readings(
                inputs, check.follow(inputs, device, fault=fault), ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', type=int, default=0,
                    help='read the control and the faults on this many of '
                         'the first seeds')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--overrides', nargs='*', default=())
    args = ap.parse_args(argv)
    if args.device == 'cuda':
        run = _load(os.path.join(BENCH, 'run.py'), 'bench_run')
        run.cache_dirs(ROOT)
    for i, seed in enumerate(args.seeds):
        # a shrunk configuration is not in the cell's measured state
        over = {'expect': {}} if args.overrides else None
        print(json.dumps(seed_readings(seed, i < args.control, args.device,
                                       args.overrides, over)), flush=True)


if __name__ == '__main__':
    main()
