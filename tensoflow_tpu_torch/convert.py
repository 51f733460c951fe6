"""Carry parameters, grids and checkpoints over from the JAX package.

Every function takes numpy arrays (this module imports nothing of JAX).
The JAX package keeps its stage-1 parameters as a pytree
``{'sdf': {'field', 'mlp'}, 'deviation', 'shading': {...}}`` of dicts and
lists.  The port keeps the same tree with the same names and layouts, so
the mapping is one to one: each leaf (a numpy array, e.g. from
``jax.tree.map(np.asarray, params)``) becomes a float32 tensor.  The
occupancy-grid state maps the same way, except that the JAX uint32 block
words are held in int64 with identical bits and the bfloat16 SDF bake
stays bfloat16.

The stage-2 parameter tree (``init_mc_shading``'s dict, with its
``flow_*`` entries, ``outer_light`` as an envlight cubemap ``{'base'}`` or
as a predictor ``{'layers': [{'v', 'g', 'b'}, ...]}`` ('direction',
'sphere_direction') and, with human lights, the ``human_light``
predictor) and the frozen flow copies are nested dicts and lists of
float32 arrays and map through ``params_from_jax`` as they are, and so does the NeRF++ background net
(the ``bg`` subtree of a ``predict_BG`` run).  An alpha mask, a packed
trace grid and a stage-1 checkpoint payload have their own functions
below.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == 'bfloat16':
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.astype(np.int64)).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _map(tree, device):
    if isinstance(tree, dict):
        return {k: _map(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, device) for v in tree]
    return _leaf(tree, device)


def params_from_jax(tree_of_numpy: Any, device='cpu'):
    """JAX stage-1 parameter pytree (numpy leaves) -> the port's params."""
    return _map(tree_of_numpy, device)


def occ_state_from_jax(state_of_numpy: Any, device='cpu'):
    """JAX occupancy-grid state (numpy leaves) -> the port's state."""
    return _map(state_of_numpy, device)


def alpha_mask_from_jax(payload: Any, device='cpu'):
    """The JAX package's alpha-mask payload (checkpoints.pack_alpha_mask,
    numpy leaves) -> the port's AlphaGridMask; None stays None."""
    from .train.checkpoints import unpack_alpha_mask
    return unpack_alpha_mask(payload, device)


def sdf_grid_from_jax(values, aabb, device='cpu'):
    """A dense baked SDF grid (numpy values [R,R,R], aabb [2,3])."""
    from .ops.sdf_trace import SDFGrid
    return SDFGrid(values=_leaf(np.asarray(values, np.float32), device),
                   aabb=_leaf(np.asarray(aabb, np.float32), device))


def packed_sdf_grid_from_jax(mid_rows, blocks, coarse_rows, aabb, reso: int,
                             vis_rows=None, vis_pad: float = 0.0,
                             device='cpu'):
    """The fields of a JAX PackedSDFGrid as numpy arrays -> the port's
    PackedSDFGrid: bfloat16 tables stay bfloat16, the uint32 visibility
    words become int64 with the same bits."""
    from .ops.sdf_trace import PackedSDFGrid
    return PackedSDFGrid(
        mid_rows=_leaf(mid_rows, device), blocks=_leaf(blocks, device),
        coarse_rows=_leaf(coarse_rows, device),
        aabb=_leaf(np.asarray(aabb, np.float32), device), reso=int(reso),
        vis_rows=None if vis_rows is None else _leaf(vis_rows, device),
        vis_pad=float(vis_pad))


def geo_checkpoint_from_jax(payload: Any, path=None):
    """A JAX stage-1 checkpoint payload (the unpickled dict, numpy leaves)
    -> the port's payload: ``params`` as tensors, ``kwargs`` and ``step``
    as they are.  With ``path`` it is also written as a port checkpoint
    that MaterialTrainer can open."""
    out = {'step': int(payload.get('step', 0)),
           'kwargs': dict(payload['kwargs']),
           'params': params_from_jax(payload['params'])}
    if path is not None:
        from .train import checkpoints
        checkpoints.save_checkpoint(path, out)
    return out
