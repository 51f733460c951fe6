"""MLP building blocks of the port (counterpart of tensoflow_tpu/fields/mlp.py).

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``w`` is [d_in, d_out]; weight-normalised layers carry ``v``,
``g``, ``b``), so convert.params_from_jax maps them one to one.  Random
init draws from an explicit torch.Generator: it does not reproduce
jax.random's numbers, and parity tests carry the JAX params over instead.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.math import pe_dim, positional_encoding

Params = Dict[str, Any]


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return lo + (hi - lo) * u


def init_linear(gen, d_in: int, d_out: int, weight_norm: bool = False,
                device='cpu') -> Params:
    """torch.nn.Linear default init (uniform, bound 1/sqrt(d_in)), drawn
    and normed on the CPU, so that every device starts from the same
    bits."""
    bound = 1.0 / math.sqrt(d_in)
    w = _uniform(gen, (d_in, d_out), -bound, bound)
    b = _uniform(gen, (d_out,), -bound, bound).to(device)
    if weight_norm:
        return {'v': w.to(device),
                'g': torch.linalg.norm(w, dim=0).to(device), 'b': b}
    return {'w': w.to(device), 'b': b}


def apply_linear(p: Params, x):
    if 'v' in p:
        v = p['v']
        w = v * (p['g'] / torch.clamp(torch.linalg.norm(v, dim=0),
                                      min=1e-12))
        return x @ w + p['b']
    return x @ p['w'] + p['b']


def make_activation(name: str, exp_max: float = 0.0):
    if name == 'sigmoid':
        return torch.sigmoid
    if name == 'exp':
        return lambda x: torch.exp(torch.clamp(x, max=exp_max))
    if name == 'none':
        return lambda x: x
    if name == 'relu':
        return torch.relu
    if name == 'softplus':
        return torch.nn.functional.softplus
    if name == 'tanh':
        return torch.tanh
    raise NotImplementedError(name)


def softplus100(x):
    """Softplus(beta=100): (max(zs,0) + log1p(exp(-|zs|)))/100, zs = 100x.

    The exact form without F.softplus's linear switch above threshold=20
    (the JAX reference has no such switch).  torch.maximum splits the
    gradient at zs == 0, so the slope there is sigmoid(0) = 1/2 as in
    jax.nn.softplus; torch.clamp would pass all of it (slope 1)."""
    zs = 100.0 * x
    return (torch.maximum(zs, torch.zeros_like(zs))
            + torch.log1p(torch.exp(-zs.abs()))) / 100.0


def init_predictor(gen, d_in: int, d_out: int, n_layers: int = 3,
                   run_dim: Optional[int] = None, weight_norm: bool = True,
                   final_bias: Optional[float] = None,
                   device='cpu') -> Params:
    """k hidden ReLU layers + linear head (ref: other_field.py)."""
    if run_dim is None:
        run_dim = 256 if n_layers >= 4 else 128
    dims = [d_in] + [run_dim] * (n_layers - 1) + [d_out]
    layers = [init_linear(gen, dims[i], dims[i + 1], weight_norm, device)
              for i in range(len(dims) - 1)]
    if final_bias is not None:
        layers[-1]['b'] = torch.full_like(layers[-1]['b'], final_bias)
    return {'layers': layers}


def apply_predictor(p: Params, x, activation: str = 'sigmoid',
                    exp_max: float = 0.0, dot_dtype=None):
    """dot_dtype (e.g. torch.bfloat16) rounds the operands of every
    product to that type (apply_linear_mixed); the activation and the
    output stay float32."""
    act = make_activation(activation, exp_max)
    h = x
    n = len(p['layers'])
    for i, layer in enumerate(p['layers']):
        if dot_dtype is not None:
            h = apply_linear_mixed(layer, h, dot_dtype)
        else:
            h = apply_linear(layer, h)
        if i < n - 1:
            h = torch.relu(h)
    return act(h)


def apply_linear_mixed(p: Params, x, dot_dtype):
    """apply_linear with the operands rounded to ``dot_dtype`` and a
    float32 result, as the JAX package's dot with
    preferred_element_type=float32.  A ``dot_dtype`` matmul in PyTorch
    returns ``dot_dtype``, so the rounded operands are cast back and
    multiplied in float32, on the CPU and on the card alike (the card
    therefore runs the product at its float32 rate)."""
    if 'v' in p:
        v = p['v']
        w = v * (p['g'] / torch.clamp(torch.linalg.norm(v, dim=0),
                                      min=1e-12))
    else:
        w = p['w']
    return x.to(dot_dtype).float() @ w.to(dot_dtype).float() + p['b']


def init_material_feats(gen, d_in: int, run_dim: int = 256,
                        device='cpu') -> Params:
    """MaterialFeatsNetwork skip MLP (ref: fields.py:578-607)."""
    m0_dims = [d_in, run_dim, run_dim, run_dim, run_dim]
    m1_dims = [d_in + run_dim, run_dim, run_dim, run_dim, run_dim]
    m0 = [init_linear(gen, m0_dims[i], m0_dims[i + 1], True, device)
          for i in range(4)]
    m1 = [init_linear(gen, m1_dims[i], m1_dims[i + 1], True, device)
          for i in range(4)]
    return {'m0': m0, 'm1': m1}


def apply_material_feats(p: Params, x_embedded):
    h = x_embedded
    for layer in p['m0']:
        h = torch.relu(apply_linear(layer, h))
    h = torch.cat([h, x_embedded], dim=-1)
    for i, layer in enumerate(p['m1']):
        h = apply_linear(layer, h)
        if i < len(p['m1']) - 1:
            h = torch.relu(h)
    return h


def init_variance(init_val: float, device='cpu') -> Params:
    return {'variance': torch.tensor(float(init_val), device=device)}


def apply_variance(p: Params, activation: str = 'exp'):
    """Returns the scalar inv_s."""
    v = p['variance']
    if activation == 'exp':
        return torch.exp(v * 10.0)
    if activation == 'linear':
        return v * 10.0
    if activation == 'square':
        return (v * 10.0) ** 2
    raise NotImplementedError(activation)


# ---------------------------------------------------------------------------
# NeRF++ background network (ref: other_field.py:213-305)
# ---------------------------------------------------------------------------

def init_nerf_bg(gen, d_in: int = 4, d_in_view: int = 3, width: int = 256,
                 depth: int = 8, multires: int = 10, multires_view: int = 4,
                 skips: Sequence[int] = (4,), device='cpu') -> Params:
    """``depth`` ReLU layers over the PE of (x/r, 1/r), the PE input
    concatenated again after each layer in ``skips``; density, feature and
    a view-conditioned rgb head whose bias starts at log 0.5."""
    input_ch = pe_dim(d_in, multires)
    input_ch_view = pe_dim(d_in_view, multires_view)
    pts_layers = []
    for i in range(depth):
        d = (input_ch if i == 0 else
             width + input_ch if (i - 1) in skips else width)
        pts_layers.append(init_linear(gen, d, width, device=device))
    rgb = init_linear(gen, width // 2, 3, device=device)
    rgb['b'] = torch.full_like(rgb['b'], float(np.log(0.5)))
    return {
        'pts': pts_layers,
        'views0': init_linear(gen, input_ch_view + width, width // 2,
                              device=device),
        'feature': init_linear(gen, width, width, device=device),
        'alpha': init_linear(gen, width, 1, device=device),
        'rgb': rgb,
    }


def _nerf_bg_trunk(p: Params, pts4, multires: int, skips):
    x = positional_encoding(pts4, multires)
    h = x
    for i, layer in enumerate(p['pts']):
        h = torch.relu(apply_linear(layer, h))
        if i in skips:
            h = torch.cat([x, h], dim=-1)
    return h


def apply_nerf_bg(p: Params, pts4, view_dirs, multires: int = 10,
                  multires_view: int = 4, skips=(4,)):
    """pts4 [N, 4] (x/r, y/r, z/r, 1/r), view_dirs [N, 3] -> (raw density
    [N, 1], log-space rgb [N, 3])."""
    h = _nerf_bg_trunk(p, pts4, multires, skips)
    alpha = apply_linear(p['alpha'], h)
    h = torch.cat([apply_linear(p['feature'], h),
                   positional_encoding(view_dirs, multires_view)], dim=-1)
    h = torch.relu(apply_linear(p['views0'], h))
    return alpha, apply_linear(p['rgb'], h)


def apply_nerf_bg_density(p: Params, pts4, multires: int = 10, skips=(4,)):
    """The raw density [N, 1] alone."""
    return apply_linear(p['alpha'], _nerf_bg_trunk(p, pts4, multires, skips))
