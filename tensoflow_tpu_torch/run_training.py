"""Training CLI of the port (counterpart of run_training.py).

    python -m tensoflow_tpu_torch.run_training --cfg configs/shape/syn/compressor_occ.yaml \\
        [--steps N] [--device cpu] [--mesh | --multihost HOST:PORT
        --num-processes N --process-id I] [key=value ...]

The stage is the config's ``network`` field ('shape' | 'material').  The
run trains in rounds of ``save_interval`` steps, saves
data/model/<name>/model.pkl (the port's own format) after each, validates every ``val_interval``
steps and keeps the best validation PSNR's checkpoint as model_best.pkl.
It runs on the card; ``--device cpu`` runs the plain PyTorch path.

Multi-device training shards the ray batch over one process per device
(parallel/sharding.py; params replicated, gradients all-reduced).
``--multihost HOST:PORT --num-processes N --process-id I`` joins an
explicit group (NCCL on the card, gloo with ``--device cpu``); ``--mesh``
alone takes the group from the launcher's environment (``env://``, as
torchrun sets it) and is one rank otherwise.  Rank 0 writes the snapshot,
the checkpoints and the log; every rank trains.
"""
from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg', type=str, required=True)
    parser.add_argument('--steps', type=int, default=None,
                        help='limit the number of steps (default: the '
                             "config's total_step)")
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' for the plain path (default: the card)")
    parser.add_argument('--mesh', action='store_true',
                        help='shard the ray batch over the ranks of the '
                             "launcher's process group (env://); params "
                             'replicated, gradients all-reduced')
    parser.add_argument('--multihost', type=str, default=None,
                        metavar='COORD_ADDR',
                        help="the process group's coordinator (host:port); "
                             'implies --mesh')
    parser.add_argument('--num-processes', type=int, default=None)
    parser.add_argument('--process-id', type=int, default=None)
    parser.add_argument('overrides', nargs='*',
                        help='dotlist overrides key=value')
    args = parser.parse_args(argv)

    mesh = None
    if args.mesh or args.multihost:
        from tensoflow_tpu_torch.parallel import sharding
        mesh = sharding.init_multihost(args.multihost, args.num_processes,
                                       args.process_id, device=args.device)
        print(f'[mesh] {mesh.size} devices (rank {mesh.rank} on '
              f'{mesh.device})', flush=True)
    main_rank = mesh is None or mesh.is_main

    from tensoflow_tpu_torch.config import load_config
    cfg = load_config(args.cfg, overrides=args.overrides)
    model_dir = os.path.join('data/model', cfg['name'])
    os.makedirs(model_dir, exist_ok=True)
    ckpt_path = os.path.join(model_dir, 'model.pkl')

    def log(info):
        if main_rank:
            print(' '.join(f'{k}={v:.5g}' if isinstance(v, float) else
                           f'{k}={v}' for k, v in info.items()), flush=True)

    # source snapshot for reproducibility (ref: trainer_inv.py:385-395)
    rec_dir = os.path.join(model_dir, 'recording')
    os.makedirs(rec_dir, exist_ok=True)
    try:
        if main_rank:
            shutil.copyfile(args.cfg, os.path.join(rec_dir, 'config.yaml'))
            pkg = os.path.dirname(os.path.abspath(__file__))
            dst = os.path.join(rec_dir, 'tensoflow_tpu_torch')
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            shutil.copytree(pkg, dst, ignore=shutil.ignore_patterns(
                '__pycache__', 'assets'))
    except OSError as e:
        print(f'[recording] skipped: {e}')

    device = None if mesh is not None else args.device
    if cfg.get('network', 'shape') == 'material' or cfg.get('isMaterial'):
        from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
        trainer = MaterialTrainer(cfg, cfg['geo_model_path'], device=device,
                                  mesh=mesh)
    else:
        from tensoflow_tpu_torch.train.trainer import ShapeTrainer
        trainer = ShapeTrainer(cfg, device=device, mesh=mesh)
    if os.path.exists(ckpt_path) and not cfg['scratch']:
        trainer.load(ckpt_path)
    trainer.init_dataset()

    total = args.steps if args.steps is not None else cfg['total_step']
    save_every = cfg['save_interval']
    val_every = cfg['val_interval']
    done = trainer.start_step
    while done < min(total, cfg['total_step']):
        n = min(save_every, total - done)
        trainer.train(n_steps=n, log_every=cfg['train_log_step'],
                      callback=log)
        done = trainer.start_step
        trainer.save(ckpt_path)
        if done % val_every < save_every:
            # full val split, best-checkpoint selection on the split mean
            # (ref: trainer_inv.py:217-237)
            psnr = trainer.validate()
            if main_rank:
                print(f'[val] step={done} psnr={psnr:.3f}', flush=True)
            if psnr > trainer.best_para:
                trainer.best_para = psnr
                trainer.save(os.path.join(model_dir, 'model_best.pkl'))
    print(f'training done at step {trainer.start_step}'
          + (f' (rank {mesh.rank})' if mesh is not None else ''), flush=True)
    if mesh is not None:
        sharding.shutdown(mesh)


if __name__ == '__main__':
    main()
