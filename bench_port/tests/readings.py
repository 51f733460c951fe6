"""The readings the limits of ``shape_compressor``'s comparison are set
from (configs/shape_compressor/limits.json; PERF.md gives them):

* the program against the reference on each seed (the lower readings);
* the control on the first ``--control`` seeds: the reference computed in
  TF32 put in the program's place, against the reference in float32
  (matrix products and convolutions in TF32, the step below float32);
* the half-batch fault on the same seeds: the reference on the first
  half of each batch's rays, the mean taken over them, put in the
  program's place.

Run on the card at the cell's own size, one process for all seeds:

    python3 bench_port/tests/readings.py --seeds 11 12 13 --control 3

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


def seed_readings(cell, seed, control, device='cuda', overrides=(),
                  traffic_over=None):
    import torch
    run = _load(os.path.join(BENCH, 'run.py'), 'bench_run')
    spec = run.spec_mod.load_spec(ROOT)
    w = run.spec_mod.workload(spec, cell)
    traffic = {**run.spec_mod.load_traffic(w['traffic'], ROOT),
               **(traffic_over or {})}
    cdir = run.spec_mod.config_dir(spec, w['config'], ROOT)
    system = _load(os.path.join(cdir, 'system.py'), 'bench_system')
    check = _load(os.path.join(cdir, 'check.py'), 'bench_check')
    t0 = time.perf_counter()
    sut = system.System(traffic, seed, device=device, overrides=overrides)
    run.prepare(sut, traffic, device)
    inputs = sut.reference_inputs()
    sut.release()
    del sut
    gc.collect()
    if device != 'cpu':
        torch.cuda.empty_cache()
    t_setup = time.perf_counter() - t0
    out = {'seed': seed, 'setup_s': t_setup}
    t0 = time.perf_counter()
    ref = check.follow(inputs, device)
    out['reference_s'] = time.perf_counter() - t0
    prog = check.step_readings(inputs, check.program_run(inputs), ref)
    out['program'] = {**check.stage_readings(inputs, device), **prog}
    if control:
        out['control'] = {
            'mask_voxels': check.stage_readings(
                inputs, device, mode='tf32')['mask_voxels'],
            **check.step_readings(inputs,
                                  check.follow(inputs, device, mode='tf32'),
                                  ref)}
        out['half_batch'] = check.step_readings(
            inputs, check.follow(inputs, device, batch_share=0.5), ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--cell', default='shape_hier_512')
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', type=int, default=0,
                    help='read the control and the fault on this many of '
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
        print(json.dumps(seed_readings(args.cell, seed, i < args.control,
                                       args.device, args.overrides, over)),
              flush=True)


if __name__ == '__main__':
    main()
