"""Carry parameters and occupancy state over from the JAX package.

The JAX package keeps its stage-1 parameters as a pytree
``{'sdf': {'field', 'mlp'}, 'deviation', 'shading': {...}}`` of dicts and
lists.  The port keeps the same tree with the same names and layouts, so
the mapping is one to one: each leaf (a numpy array, e.g. from
``jax.tree.map(np.asarray, params)``) becomes a float32 tensor.  The
occupancy-grid state maps the same way, except that the JAX uint32 block
words are held in int64 with identical bits and the bfloat16 SDF bake
stays bfloat16.
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
