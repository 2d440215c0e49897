"""Several processes, one device each, over torch.distributed. Port of
`arah_tpu/parallel/distributed.py`: JAX's multi-host runtime becomes a
process group, its global mesh the group's ranks (`parallel/mesh.py`).

`initialize` joins a group: from the CLIs' flags (`--coordinator host:port
--num-processes N --process-id r`), from torchrun's environment (`RANK`,
`WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`; the counterpart of JAX's
`COORDINATOR_ADDRESS` detection), or not at all for one process. Rank r
takes `cuda:<local rank>` unless the caller names a device; the backend
is NCCL on CUDA and gloo on the CPU unless named. Two ranks may share a
CUDA device under gloo only; a rank asked for CUDA where there is none
raises.

The control plane (the stop flag, metric rows, barriers) runs on a gloo
group of CPU tensors: the main group itself under gloo, a second group
beside an NCCL one. `launch_local` starts N local ranks of a CLI in
spawned processes, each joining one group."""
from __future__ import annotations

import datetime
import os
import socket
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

# seconds a rank waits in the rendezvous or a collective
COLLECTIVE_TIMEOUT = 600.0


class _Runtime(NamedTuple):
    device: torch.device
    cpu_group: object       # the gloo group of the control plane


_runtime: _Runtime | None = None


def pick_device(name: str | None, local_rank: int = 0) -> torch.device:
    """A rank's device: `cpu`, `cuda:k` as named, or `cuda` ->
    `cuda:<local_rank>`. CUDA must exist (no silent fall back)."""
    name = name or 'cuda'
    dev = torch.device(name)
    if dev.type != 'cuda':
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on '
                           'the CPU')
    index = local_rank if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f'cuda:{index} does not exist '
                           f'({torch.cuda.device_count()} CUDA devices); '
                           f'name a device with --device cuda:k')
    return torch.device('cuda', index)


def check_placement(backend: str, placements) -> None:
    """The backend rule over every rank's (host, device) placement: NCCL
    needs CUDA devices, one rank on each; gloo takes any placement."""
    if backend == 'gloo':
        return
    if backend != 'nccl':
        raise ValueError(f'unknown backend {backend!r}: nccl or gloo')
    seen = {}
    for rank, (host, device) in enumerate(placements):
        if not str(device).startswith('cuda'):
            raise ValueError(f'nccl needs CUDA devices; rank {rank} is on '
                             f'{device}')
        other = seen.setdefault((host, str(device)), rank)
        if other != rank:
            raise ValueError(
                f'ranks {other} and {rank} share {device} on {host}: NCCL '
                f'runs one rank per device; use --dist-backend gloo to '
                f'share a device')


def _auto_multiprocess() -> bool:
    return all(k in os.environ for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                                         'MASTER_PORT')) \
        and int(os.environ['WORLD_SIZE']) > 1


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device: str | None = None) -> torch.device:
    """Join the process group (a no-op for a single process); returns
    this rank's device. coordinator: 'host:port' of rank 0's store (with
    it, num_processes=1 makes a group of one); backend None: nccl on
    CUDA, gloo on the CPU."""
    global _runtime
    if num_processes is not None and (num_processes > 1
                                      or coordinator is not None):
        if coordinator is None or process_id is None:
            raise ValueError('--num-processes needs --coordinator and '
                             '--process-id')
        rank, world = int(process_id), int(num_processes)
        init_method = f'tcp://{coordinator}'
        local_rank = int(os.environ.get('LOCAL_RANK', rank))
    elif coordinator is None and _auto_multiprocess():
        rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
        init_method = 'env://'
        local_rank = int(os.environ.get('LOCAL_RANK', rank))
    else:
        return pick_device(device)
    dev = pick_device(device, local_rank)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    check_placement(backend, [(socket.gethostname(), dev)])
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    td = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=td)
    cpu_group = dist.group.WORLD if backend == 'gloo' else \
        dist.new_group(backend='gloo', timeout=td)
    placements = [None] * world
    dist.all_gather_object(placements, (socket.gethostname(), str(dev)),
                           group=cpu_group)
    # before the first NCCL collective, which would fail on a shared GPU
    check_placement(backend, placements)
    _runtime = _Runtime(dev, cpu_group)
    return dev


def shutdown():
    """Leave the process group (every rank calls it)."""
    global _runtime
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _runtime = None


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def rank_device() -> torch.device | None:
    """The device `initialize` gave this rank (None outside a group)."""
    return None if _runtime is None else _runtime.device


def cpu_group():
    """The gloo group of the control plane."""
    if _runtime is None:
        raise RuntimeError('not in a process group (initialize first)')
    return _runtime.cpu_group


def broadcast_one_to_all(value):
    """Rank 0's value (a number, bool or small array) on every rank."""
    a = np.asarray(value)
    if not is_multiprocess():
        return a
    t = torch.as_tensor(a.astype(np.float64)).reshape(-1).clone()
    dist.broadcast(t, src=0, group=cpu_group())
    return t.numpy().reshape(a.shape).astype(a.dtype)


def process_allgather(array) -> np.ndarray:
    """(P, *shape): every rank's array of one shape and dtype, stacked in
    rank order."""
    a = np.ascontiguousarray(array)
    if not is_multiprocess():
        return a[None]
    t = torch.from_numpy(a.copy())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=cpu_group())
    return torch.stack(out).numpy()


def sync_global_devices(name: str = '') -> None:
    """A barrier of every rank (on the control plane)."""
    if is_multiprocess():
        dist.barrier(group=cpu_group())


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def replicate_over_mesh(state, mesh):
    """Rank 0's parameters and Adam state on every rank of `mesh`, as DDP
    broadcasts them at its start (every rank must hold the same tree
    structure and the same optimizer state keys: true after restoring one
    checkpoint, or building from one seed). In place; returns state."""
    if mesh is None or mesh.size == 1:
        return state
    with torch.no_grad():
        for t in _tensors(state.params):
            dist.broadcast(t.data, src=0, group=mesh.group)
        opt = state.optimizer
        if opt is not None:
            for group in opt.adam.param_groups:
                for p in group['params']:
                    for k in sorted(opt.adam.state.get(p, {})):
                        v = opt.adam.state[p][k]
                        if torch.is_tensor(v):
                            dist.broadcast(v, src=0,
                                           group=cpu_group() if v.device.type
                                           == 'cpu' else mesh.group)
    return state


def gather_metrics(local_metrics: dict) -> dict:
    """The mean over ranks of each scalar metric (every rank gets it)."""
    keys = sorted(local_metrics)
    vals = np.asarray([float(local_metrics[k]) for k in keys], np.float64)
    if is_multiprocess():
        t = torch.from_numpy(vals.copy())
        dist.all_reduce(t, group=cpu_group())
        vals = t.numpy() / process_count()
    return {k: float(v) for k, v in zip(keys, vals)}


# ------------------------------------------------------------ launching
def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawned(rank: int, module: str, argv: list, n: int, port: int):
    import importlib
    main = importlib.import_module(module).main
    main(list(argv) + ['--coordinator', f'127.0.0.1:{port}',
                       '--num-processes', str(n), '--process-id', str(rank)])


def launch_local(module: str, argv: list, n: int) -> int:
    """Run `module.main(argv + the manual flags)` as n local ranks in
    spawned processes joined by a fresh port on 127.0.0.1. Returns the
    ranks' common exit code (0, or 2 for a timed exit); a rank that
    fails ends the others and the launch returns 1 (a rank that stops
    answering is ended by its peers' collective timeout,
    COLLECTIVE_TIMEOUT)."""
    import time
    import torch.multiprocessing as mp
    ctx = mp.get_context('spawn')
    port = free_port()
    procs = [ctx.Process(target=_spawned, args=(r, module, argv, n, port))
             for r in range(n)]
    for p in procs:
        p.start()
    codes = {}
    try:
        while len(codes) < n \
                and all(c in (0, 2) for c in codes.values()):
            for r, p in enumerate(procs):
                if r not in codes and not p.is_alive():
                    codes[r] = p.exitcode
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    if len(codes) < n or len(set(codes.values())) != 1 \
            or codes[0] not in (0, 2):
        print(f'launch_local: the ranks\' exit codes {codes} of {n} ranks',
              flush=True)
        return 1
    return codes[0]
