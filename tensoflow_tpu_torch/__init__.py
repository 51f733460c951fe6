"""PyTorch + CUDA port of tensoflow_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (ops/, fields/, models/, train/, data/);
module names match their JAX counterparts.  Imports torch, never jax,
optax or tensoflow_tpu.

Precision is stated once, here: float32 matrix products and convolutions
run in full float32 on the card (no TF32), so float32 paths match the JAX
reference to float32 rounding.
"""
import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    device=None means 'cuda' and raises if CUDA is absent — there is no
    silent CPU fallback."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" explicitly to run '
            'the plain PyTorch path on the CPU')
    return dev


_CONSTANTS = {}


def device_constant(key, make, device, dtype=torch.float32) -> torch.Tensor:
    """The constant ``make()`` (numpy array or nested lists) as a tensor on
    ``device``, built once per (key, device, dtype) and cached.

    A host-to-device copy makes PyTorch wait until the device has run
    everything queued before it, so a step takes its constants from here
    instead of copying them anew.  The tensor is shared: never modify it."""
    k = (key, torch.device(device), dtype)
    t = _CONSTANTS.get(k)
    if t is None:
        t = torch.as_tensor(np.asarray(make()), dtype=dtype, device=device)
        _CONSTANTS[k] = t
    return t
