"""Multi-rank dry run of the port (counterpart of
``__graft_entry__.dryrun_multichip`` and ``_dryrun_material``).

``dryrun(mesh)`` runs ONE sharded training step of both stages at tiny
shapes on every rank of ``mesh``: stage 1 with its full phase set
(radiance head, occ loss with ``occ_loss_max_pn = 4 n``, mask loss) on the
occupancy grid, then the stage-2 MC-shading step with both NIS flows
sampling and training, on an analytic sphere's baked SDF.  Each stage's
ray batch is drawn whole on every rank and sharded; params are
replicated; the gradients are summed in one all-reduce.  It prints the
two global losses (the JAX package's MULTICHIP record reads 1.0351 /
0.4720 from JAX's draws: a smoke value, not a target).

    python -m tensoflow_tpu_torch.parallel.dryrun --ranks 2 [--device cpu]
        [--backend gloo|nccl]

spawns the ranks as processes on this host (gloo on the CPU; on the card
NCCL unless ``--backend`` says otherwise: NCCL refuses two ranks on one
GPU, gloo does not) and waits for them.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..train.checkpoints import named_leaves, tree_map
from . import sharding


def _tiny_cfg(train_ray_num: int):
    from .. import config as config_mod
    return config_mod.load_config(extra={
        'name': 'dryrun', 'database_name': 'toy/sphere_32_4',
        'dataset_dir': 'unused', 'nerfDataType': True,
        'train_ray_num': train_ray_num, 'n_samples': 16,
        'n_importance': 16, 'up_sample_steps': 4, 'sdf_n_comp': 8,
        'sdf_dim': 64, 'app_dim': 32, 'N_voxel_init': 32 ** 3,
        'N_voxel_final': 32 ** 3, 'apply_occ_loss': False,
        'apply_mask_loss': False, 'anneal_end': 200})


def _example_batch(rn: int):
    rng = np.random.RandomState(0)
    o = np.tile(np.array([[0.0, 0.0, 2.0]], np.float32), (rn, 1))
    d = rng.randn(rn, 3).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        'rays_o': o, 'rays_d': d, 'dirs': d,
        'radiis': np.full((rn, 1), 1e-3, np.float32),
        'rays_cos': np.ones((rn, 1), np.float32),
        'rgbs': rng.rand(rn, 3).astype(np.float32),
        'masks': (rng.rand(rn, 1) > 0.5).astype(np.float32),
        'human_poses': np.tile(np.eye(3, 4, dtype=np.float32), (rn, 1, 1)),
    }


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def dryrun_stage1(mesh: sharding.Mesh) -> float:
    """One sharded stage-1 step (radiance head + occ loss + mask loss);
    returns the global loss."""
    from ..fields import light as light_mod
    from ..models import shape_renderer as sr
    from ..ops import grid as grid_mod
    from ..train import losses
    from ..train.trainer import ScheduledAdam, all_reduce_step, \
        build_shape_config
    n = mesh.size
    cfg = _tiny_cfg(8 * n)
    cfg.update({'use_occ_grid': True, 'occ_grid_reso': 16,
                'occ_max_samples': 16, 'has_radiance_field': True,
                'apply_occ_loss': True, 'occ_loss_step': -1,
                'occ_loss_max_pn': 4 * n, 'apply_mask_loss': True})
    dev = mesh.device
    rcfg = build_shape_config(cfg, (32, 32, 32), 1)
    params = sr.init_shape_renderer(torch.Generator().manual_seed(0), rcfg,
                                    dev)
    sharding.replicate_tree(mesh, params)
    for t in _leaves(params):
        t.requires_grad_(True)
    occ_state = grid_mod.init_occ_grid(grid_mod.OccGridConfig(resolution=16),
                                       dev)
    opt = ScheduledAdam(cfg, params, 0)
    batch = _to_device(sharding.shard_batch(
        mesh, _example_batch(cfg['train_ray_num'])), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = sr.draw_noise(gen, rcfg, cfg['train_ray_num'], dev)
    lo, hi = sharding.shard_range(mesh, cfg['train_ray_num'])
    noise['sample_jitter'] = noise['sample_jitter'][lo:hi]
    # step 1: the port's radiance head is on past radiance_field_step (0)
    weights = losses.schedule_weights(cfg, 1)
    mips = light_mod.build_mips(params['shading']['envlight'],
                                rcfg.shading.env)
    out = sr.train_step_outputs(params, rcfg, mips, occ_state, batch, 1,
                                noise, True, True, mesh=mesh)
    total, terms = losses.total_loss_shape(out, weights, mesh)
    total.backward()
    terms = all_reduce_step(mesh, opt.params, {**terms, 'loss': total})
    opt.step()
    return float(terms['loss'].detach())


def dryrun_stage2(mesh: sharding.Mesh) -> float:
    """One sharded stage-2 step (surface-hit batch sharded, params and the
    baked SDF replicated, both NIS flows sampling and training); returns
    the global loss."""
    from .. import config as config_mod
    from ..fields import mc_shading
    from ..models import material_renderer as mr
    from ..ops import sdf_trace
    from ..train import losses
    from ..train.trainer import ScheduledAdam, all_reduce_step
    from ..train.trainer_mat import (build_material_config,
                                     mat_param_group_label)
    rays = 8 * mesh.size
    dev = mesh.device
    cfg = config_mod.load_config(extra={
        'name': 'dryrun_mat', 'isMaterial': True, 'train_ray_num': rays,
        'shader_cfg': {
            'outer_light_version': 'envlight',
            'diffuse_sample_num': 8, 'specular_sample_num': 8,
            'nis_diffuse_sample_num': 4, 'nis_specular_sample_num': 4,
            'light_reso': 8, 'grid_size': [16, 16, 16],
            'inner_light_budget': 0.5}})
    geo_kwargs = {'grid_size': [16, 16, 16], 'sdf_n_comp': 8,
                  'sdf_dim': 64, 'app_dim': 32, 'n_levels': 1,
                  'aabb': [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]],
                  'bake_resolution': 16}
    rcfg = build_material_config(cfg, geo_kwargs)
    xs = np.linspace(-1, 1, 16, dtype=np.float32)
    xx, yy, zz = np.meshgrid(xs, xs, xs, indexing='ij')
    vals = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) - 0.5
    grid = sdf_trace.pack_sdf_grid(sdf_trace.SDFGrid(
        values=torch.as_tensor(vals, device=dev),
        aabb=torch.tensor([[-1.0] * 3, [1.0] * 3], device=dev)))
    params = mc_shading.init_mc_shading(torch.Generator().manual_seed(0),
                                        rcfg.shader, dev)
    sharding.replicate_tree(mesh, params)
    for t in _leaves(params):
        t.requires_grad_(True)
    frozen = {k: _detach(params[k]) for k in ('flow_diffuse',
                                              'flow_specular')}
    opt = ScheduledAdam(cfg, params, 0, label_fn=mat_param_group_label)
    phase = mc_shading.ShadePhase(
        nis_sample_diffuse=True, nis_sample_specular=True,
        nis_loss_diffuse=True, nis_loss_specular=True)
    rng = np.random.RandomState(1)
    d = rng.randn(rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = _to_device(sharding.shard_batch(mesh, {
        'inters': d * 0.5, 'normals': d, 'rays_d': -d,
        'rgb': rng.rand(rays, 3).astype(np.float32)}), dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    noise = mc_shading.draw_shade_noise(gen, rcfg.shader, rays, phase, dev)
    lo, hi = sharding.shard_range(mesh, rays)
    noise = {k: v[lo:hi] for k, v in noise.items()}
    out = mr.train_step_outputs(params, rcfg, grid, batch, phase, noise,
                                2000, frozen['flow_diffuse'],
                                frozen['flow_specular'], mesh=mesh)
    total, terms = losses.total_loss_material(
        out, losses.schedule_weights(cfg, 2000), mesh)
    total.backward()
    terms = all_reduce_step(mesh, opt.params, {**terms, 'loss': total})
    opt.step()
    return float(terms['loss'].detach())


def _leaves(tree):
    return [t for _, t in named_leaves(tree)]


def _detach(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def dryrun(mesh: sharding.Mesh):
    """Both stages' sharded steps; prints and returns the global losses."""
    l1 = dryrun_stage1(mesh)
    if not np.isfinite(l1):
        raise AssertionError(f'dryrun stage-1 loss {l1}')
    l2 = dryrun_stage2(mesh)
    if not np.isfinite(l2):
        raise AssertionError(f'dryrun stage-2 loss {l2}')
    if mesh.is_main:
        print(f'dryrun({mesh.size} ranks): stage-1 loss={l1:.4f} ok '
              '(radiance+occ_loss+mask phases)', flush=True)
        print(f'dryrun({mesh.size} ranks): stage-2 loss={l2:.4f} ok '
              '(NIS sample+loss phases)', flush=True)
    return l1, l2


def free_port() -> int:
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(argv, log_path: str, env=None, cwd=None):
    """Start ``argv`` with its output going to ``log_path``; returns the
    (process, log file) pair that ``finish`` takes."""
    log = open(log_path, 'w')
    return subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                            env=env, cwd=cwd), log


def finish(procs, timeout: float = 600.0):
    """Wait for the (process, log file) pairs of ``start`` and return their
    (returncode, output) pairs.  Once one has failed, or at the timeout,
    every one still running is killed (a rank left in a collective with a
    dead peer would wait out the group's timeout)."""
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > t_end or any(
                    p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    res = []
    for p, log in procs:
        with open(log.name, errors='replace') as f:
            res.append((p.returncode, f.read()))
    return res


def spawn(argv_of_rank, n: int, log_dir: str, timeout: float = 600.0,
          env=None, cwd=None):
    """Run ``n`` processes (argv_of_rank(r) each, its output in
    ``log_dir``/rank<r>.log) to their end; returns their (returncode,
    output) pairs."""
    return finish([start(argv_of_rank(r),
                         os.path.join(log_dir, f'rank{r}.log'), env, cwd)
                   for r in range(n)], timeout)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--ranks', type=int, default=2)
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' for the plain path (default: the card)")
    parser.add_argument('--backend', type=str, default=None)
    parser.add_argument('--rank', type=int, default=None,
                        help='(set by the spawner) this process\'s rank')
    parser.add_argument('--port', type=int, default=None)
    args = parser.parse_args(argv)
    if args.rank is None:
        port = free_port()
        extra = (['--device', args.device] if args.device else []) + \
            (['--backend', args.backend] if args.backend else [])
        with tempfile.TemporaryDirectory() as logs:
            res = spawn(lambda r: [sys.executable, '-m', __spec__.name,
                                   '--ranks', str(args.ranks), '--rank',
                                   str(r), '--port', str(port)] + extra,
                        args.ranks, logs, env=dict(os.environ))
        for r, (rc, out) in enumerate(res):
            sys.stdout.write(out if r == 0 or rc else '')
            if rc:
                print(f'rank {r} exited with {rc}', file=sys.stderr)
        raise SystemExit(max(rc for rc, _ in res))
    mesh = sharding.init_multihost(f'localhost:{args.port}', args.ranks,
                                   args.rank, device=args.device,
                                   backend=args.backend)
    try:
        dryrun(mesh)
    finally:
        sharding.shutdown(mesh)


if __name__ == '__main__':
    main()
