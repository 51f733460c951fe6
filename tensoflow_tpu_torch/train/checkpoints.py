"""Checkpoints of the port (counterpart of tensoflow_tpu/train/
checkpoints.py): one ``torch.save`` file per save holding the step, the
parameter tree, the optimizer state and the model kwargs needed to rebuild
the static configs (keys ``params``, ``kwargs``, ``step`` as the JAX
package's pickles have).  Tensors are stored on the CPU; bfloat16 and
int64 leaves keep their types.  An alpha mask is stored as the JAX
package stores it: packed bits (``pack_alpha_mask``).  The format is the port's own: a JAX
checkpoint is carried over with convert.geo_checkpoint_from_jax.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def named_leaves(tree, path=()):
    """[(path tuple, tensor)] of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, path + (i,))]
    return [(path, tree)]


def _to_host(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def save_checkpoint(path: str, payload: Dict[str, Any]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'
    torch.save(tree_map(_to_host, payload), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The saved payload, tensors on the CPU."""
    return torch.load(path, map_location='cpu', weights_only=False)


def restore_opt_state(saved, opt, zero_if=None) -> bool:
    """Shape-checked optimizer-state restore (ref: trainer_inv.py:108-113)
    into a fresh ScheduledAdam: the Adam moments and the schedule count
    are taken over when every saved moment matches its parameter's shape;
    on any mismatch the fresh state stays and False is returned.  Leaves
    whose path satisfies ``zero_if`` restart with zero moments."""
    if saved is None:
        return False
    moments = saved.get('moments', {})
    for path, p in zip(opt.paths, opt.params):
        mv = moments.get(str(path))
        if mv is None or mv[0].shape != p.shape or mv[1].shape != p.shape:
            return False
    opt.load_state(saved, zero_if)
    return True


def pack_alpha_mask(mask) -> Dict[str, Any]:
    """AlphaGridMask -> packbits payload (ref: shapeRenderer.py:343-356):
    numpy ``aabb``, ``shape`` and ``bits``, the JAX package's keys."""
    if mask is None:
        return None
    vol = mask.volume.detach().cpu().numpy() > 0.5
    return {'aabb': mask.aabb.detach().cpu().numpy().astype(np.float32),
            'shape': list(vol.shape),
            'bits': np.packbits(vol.reshape(-1))}


def unpack_alpha_mask(payload, device='cpu'):
    """pack_alpha_mask's payload (the port's or the JAX package's) -> an
    AlphaGridMask on ``device``; None stays None."""
    from ..ops import grid as grid_mod
    if payload is None:
        return None
    n = int(np.prod(payload['shape']))
    vol = np.unpackbits(np.asarray(payload['bits']))[:n].reshape(
        payload['shape'])
    return grid_mod.AlphaGridMask(
        aabb=torch.tensor(np.asarray(payload['aabb'], np.float32),
                          device=device),
        volume=torch.as_tensor(vol.astype(np.float32), device=device))
