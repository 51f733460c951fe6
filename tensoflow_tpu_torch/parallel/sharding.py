"""Ray-sharded data parallelism over torch.distributed (counterpart of
tensoflow_tpu/parallel/sharding.py).

The JAX package shards the global ray batch over a 1-D device mesh inside
one jit: XLA computes exactly the single-device step over the global
batch and inserts the collectives.  The port runs one process per device
instead, each holding a shard:

  * rank r works on ``cuda:{local rank}`` (or the CPU when asked); params,
    Adam state and the occupancy / geometry state are replicated
    (``replicate_tree`` broadcasts rank 0's copy);
  * every rank draws the same global ray batch and the same global noise
    from the same seed, then takes its contiguous slice of the ray axis
    (``shard_batch``), so the draws equal the single-device ones;
  * every statistic that spans the batch is made global: the renderers
    take ``mesh=`` and divide local sums by global counts
    (``global_sum``), compact against the global prefix sum
    (``compact_plan``) and pick the global top-k (``global_topk``);
  * the gradients leave the step in ONE all-reduce over a single flat,
    coalesced buffer (``all_reduce_grads``), with the step's loss terms
    riding at its end.  It does the job of the JAX package's
    ``TPU_MULTICHIP_XLA_FLAGS`` combiner, which is TPU runtime
    configuration and is not carried over.

Every collective is an ``all_reduce`` or a ``broadcast`` (an all-gather is
an all-reduce of a zero buffer in which each rank fills its own rows):
gloo runs both on CUDA tensors but no all-gather there, so one code path
runs on gloo on the CPU, on gloo on the card and on NCCL.

The process group comes from ``init_multihost`` (an explicit ``tcp://``
coordinator) or from the launcher's environment (``env://``, as torchrun
sets it); without either, ``make_mesh`` is a one-rank mesh that behaves
exactly as no mesh.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..train.checkpoints import named_leaves


class Mesh:
    """This process's place in the data mesh: ``rank`` of ``size`` ranks,
    its ``device``, and whether a process group carries collectives
    (``distributed``; a one-rank mesh without a group runs every path
    exactly as without a mesh).  ``size`` plays the part of the JAX mesh's
    ``devices.size``."""

    def __init__(self, rank: int = 0, size: int = 1,
                 device: torch.device = torch.device('cpu'),
                 distributed: bool = False):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.distributed = distributed

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def active(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` makes a path take its collectives."""
    return mesh is not None and mesh.distributed


def _local_rank(rank: int) -> int:
    return int(os.environ.get('LOCAL_RANK', rank))


def _rank_device(device, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', _local_rank(rank)
                           % torch.cuda.device_count())
    if dev.type == 'cuda':
        # the ctypes kernel launchers run on the runtime's current device
        torch.cuda.set_device(dev)
    return dev


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device=None,
                   backend: Optional[str] = None,
                   timeout: Optional[float] = None) -> Mesh:
    """Join the process group at ``coordinator`` (host:port) as rank
    ``process_id`` of ``num_processes``: NCCL on the card, gloo on the
    CPU, unless ``backend`` names one; ``timeout`` (seconds) bounds every
    wait in a collective (the backend's default otherwise).  The rank's
    device is set current before anything is built.  Without a
    coordinator: the group of the launcher's environment where one is
    set, else a one-rank mesh."""
    if coordinator is None:
        return make_mesh(device, backend)
    if num_processes is None or process_id is None:
        raise ValueError('--multihost needs --num-processes and '
                         '--process-id')
    dev = _rank_device(device, process_id)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ('nccl' if dev.type == 'cuda' else 'gloo'),
            init_method=f'tcp://{coordinator}', world_size=num_processes,
            rank=process_id, **({} if timeout is None else
                                {'timeout': timedelta(seconds=timeout)}))
    return Mesh(dist.get_rank(), dist.get_world_size(), dev, True)


def make_mesh(device=None, backend: Optional[str] = None) -> Mesh:
    """The mesh of this process: the initialised process group, else the
    one the launcher's environment describes (``env://``: MASTER_ADDR,
    WORLD_SIZE, RANK), else one rank without collectives."""
    if dist.is_initialized():
        rank = dist.get_rank()
        return Mesh(rank, dist.get_world_size(), _rank_device(device, rank),
                    True)
    if 'WORLD_SIZE' in os.environ and 'MASTER_ADDR' in os.environ:
        rank = int(os.environ['RANK'])
        dev = _rank_device(device, rank)
        dist.init_process_group(
            backend or ('nccl' if dev.type == 'cuda' else 'gloo'),
            init_method='env://')
        return Mesh(rank, dist.get_world_size(), dev, True)
    return Mesh(0, 1, resolve_device(device), False)


def shutdown(mesh: Optional[Mesh]):
    if active(mesh) and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

def shard_range(mesh: Optional[Mesh], n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's rows of a global axis of n rows (n must
    divide by the mesh size, as a JAX data sharding requires)."""
    if not active(mesh):
        return 0, n
    if n % mesh.size:
        raise ValueError(f'{n} rows do not divide over {mesh.size} ranks '
                         '(pad_to_multiple)')
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_batch(mesh: Optional[Mesh], batch: Dict[str, np.ndarray]):
    """This rank's contiguous slice of the ray axis of the global host
    batch (every rank holds the same global batch)."""
    n = len(next(iter(batch.values())))
    lo, hi = shard_range(mesh, n)
    return {k: v[lo:hi] for k, v in batch.items()}


def pad_to_multiple(batch: Dict[str, np.ndarray], multiple: int):
    """Pad the ray axis so it divides the mesh size; returns (batch, n_real).

    Padded rays are real rays repeated from the start of the batch, so they
    compute fine and only slightly re-weight means."""
    n = len(next(iter(batch.values())))
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    out = {k: np.concatenate([v, v[:rem]], 0) for k, v in batch.items()}
    return out, n


# ---------------------------------------------------------------------------
# collectives (all_reduce and broadcast only)
# ---------------------------------------------------------------------------

def replicate_tree(mesh: Optional[Mesh], tree):
    """Broadcast rank 0's leaves into every rank's, in place; returns the
    tree."""
    if not active(mesh):
        return tree
    with torch.no_grad():
        for _, t in named_leaves(tree):
            if isinstance(t, torch.Tensor):
                dist.broadcast(t.data, 0)
    return tree


def rank_share(mesh: Optional[Mesh], items) -> list:
    """This rank's items: r, r + size, ... (every item without a mesh)."""
    items = list(items)
    return items[mesh.rank::mesh.size] if active(mesh) else items


def global_mean(mesh: Optional[Mesh], values) -> float:
    """The mean of every rank's ``values`` (one all-reduce of their sum
    and count); np.mean(values) without a mesh."""
    dev = mesh.device if mesh is not None else 'cpu'
    t = global_sum(mesh, torch.tensor(
        [float(np.sum(values)), float(len(values))], dtype=torch.float64,
        device=dev))
    return float(t[0] / t[1])


def barrier(mesh: Optional[Mesh]):
    if active(mesh):
        dist.barrier()


def global_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (no gradient); ``x`` itself without
    a mesh."""
    if not active(mesh):
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def mean_share(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """torch.mean(x); on an active mesh this rank's share of the mean over
    every rank's x (shards of equal size), so the shares sum to it."""
    if not active(mesh):
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * mesh.size)


def global_var(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """torch.var(x, unbiased=False) over every rank's x (no gradient)."""
    if not active(mesh):
        return torch.var(x, unbiased=False)
    x = x.detach()
    n = x.numel() * mesh.size
    mean = global_sum(mesh, torch.sum(x)) / n
    return global_sum(mesh, torch.sum((x - mean) ** 2)) / n


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[size, *x.shape]: every rank's ``x`` (an all-reduce of a zero
    buffer in which each rank fills its own row)."""
    buf = torch.zeros((mesh.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[mesh.rank] = x.detach()
    dist.all_reduce(buf)
    return buf


class CompactPlan:
    """This rank's share of a compaction of the global flat axis (ranks in
    order) into ``m`` slots: its first ``kept`` valid entries take the
    global slots [offset, offset + kept); ``slots`` = max(kept, 1) local
    slots (the host reads the counts once)."""

    def __init__(self, offset: int, kept: int, total: int):
        self.offset = offset
        self.kept = kept
        self.total = total
        self.slots = max(kept, 1)


def compact_plan(mesh: Mesh, valid_flat: torch.Tensor, m: int
                 ) -> CompactPlan:
    """The global prefix sum's verdict for this rank: an exclusive scan of
    the ranks' valid counts against the global budget ``m``."""
    counts = gather_rows(mesh, valid_flat.sum().reshape(1).long()
                         )[:, 0].tolist()
    offset = sum(counts[:mesh.rank])
    kept = max(min(counts[mesh.rank], m - offset), 0)
    return CompactPlan(offset, kept, sum(counts))


def global_topk(mesh: Mesh, score: torch.Tensor, k: int, base: int
                ) -> torch.Tensor:
    """Local indices of this rank's entries among the global top-k of
    ``score`` (this rank's entries sit at global indices base + i).  The
    global top-k lies inside the union of the ranks' local top-k, so
    exchanging k scores a rank is exact; ties go to the lower global
    index."""
    kl = min(k, score.shape[0])
    top = torch.topk(score, kl, sorted=True)
    rows = torch.full((k, 2), -2.0, dtype=torch.float64,
                      device=score.device)
    rows[:kl, 0] = top.values.double()
    rows[:kl, 1] = (top.indices + base).double()
    rows[kl:, 1] = -1.0
    allr = gather_rows(mesh, rows).reshape(-1, 2)
    # order by score descending, then global index ascending
    real = allr[:, 1] >= 0
    key_idx = torch.where(real, allr[:, 1],
                          torch.full_like(allr[:, 1], float(2 ** 52)))
    order = torch.argsort(key_idx, stable=True)
    order = order[torch.argsort(-allr[order, 0], stable=True)][:k]
    gidx = allr[order, 1].long()
    mine = (gidx >= base) & (gidx < base + score.shape[0])
    return gidx[mine] - base


def all_reduce_grads(mesh: Optional[Mesh], params: List[torch.Tensor],
                     extra: Optional[torch.Tensor] = None):
    """Sum every parameter's gradient over the ranks in ONE all-reduce of
    a flat buffer (``extra``, e.g. the step's loss terms, rides at its
    end); a leaf without a gradient contributes zeros and gets the sum.
    Returns the summed ``extra``."""
    if not active(mesh):
        return extra
    parts = [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1).float() for p in params]
    if extra is not None:
        parts.append(extra.detach().reshape(-1).float())
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    at = 0
    for p in params:
        n = p.numel()
        p.grad = flat[at:at + n].view(p.shape).to(p.dtype)
        at += n
    return flat[at:] if extra is not None else None


def grad_buffer_bytes(params: List[torch.Tensor], n_extra: int = 0) -> int:
    """Bytes of all_reduce_grads's flat float32 buffer."""
    return 4 * (sum(p.numel() for p in params) + n_extra)
