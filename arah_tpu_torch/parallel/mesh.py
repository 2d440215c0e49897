"""The data-parallel mesh. Port of `arah_tpu/parallel/mesh.py`: JAX's 1-D
`data` mesh of devices becomes a group of ranks, one device each
(`parallel/distributed.py` starts them). Ray blocks are split over the
ranks; parameters, Adam state and the frame are replicated; gradients and
losses are averaged with one all-reduce a step (`parallel/train_step.py`).
The reference's DDP (`train.py:124-133`) is the same scheme."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from arah_tpu_torch.parallel import distributed

# the leading TrainBatch fields that carry a ray-block dimension
N_PER_BLOCK_FIELDS = 16


class Mesh(NamedTuple):
    group: Any              # the process group (None: WORLD)
    rank: int
    size: int
    device: torch.device


def make_mesh(n: int | None = None) -> Mesh:
    """The mesh of every rank of the process group (`initialize` first;
    at world size 1 it may be a group of one). n: the expected size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('make_mesh needs a process group: call '
                           'parallel.distributed.initialize (or '
                           'torch.distributed.init_process_group) first')
    size = dist.get_world_size()
    if n is not None and n != size:
        raise ValueError(f'make_mesh({n}) in a group of {size} ranks: one '
                         f'device a rank, so the mesh is the whole group')
    dev = distributed.rank_device()
    if dev is None:
        dev = torch.device('cuda', torch.cuda.current_device()) \
            if dist.get_backend() == 'nccl' else torch.device('cpu')
    return Mesh(None, dist.get_rank(), size, dev)


def local_blocks(batch, rank: int, size: int, per_block_frame: bool = False):
    """Rank `rank`'s share of a global TrainBatch (or TrainDraws): the
    contiguous B / size blocks of every per-block field, and with
    per-block frames of the frame leaves and `latent_idx` too (each rank
    holds only its blocks: `make_global_batch`'s counterpart)."""
    from arah_tpu_torch.utils.tree import tree_map
    n = batch[0].shape[0]
    if n % size:
        raise ValueError(f'{n} blocks do not split over {size} ranks')
    k = n // size
    sl = slice(rank * k, (rank + 1) * k)
    if not hasattr(batch, 'frame'):          # TrainDraws
        return type(batch)(*(a[sl] for a in batch))
    per_block = {f: getattr(batch, f)[sl]
                 for f in batch._fields[:N_PER_BLOCK_FIELDS]}
    if not per_block_frame:
        return batch._replace(**per_block)
    return batch._replace(**per_block,
                          frame=tree_map(lambda a: a[sl], batch.frame),
                          latent_idx=batch.latent_idx[sl])
