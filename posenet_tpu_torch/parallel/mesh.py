"""Device meshes for data parallelism, the counterpart of
`posenet_tpu.parallel.mesh`.

A `Mesh` is the tuple of devices this process drives along the 'data'
axis, plus the `torch.distributed` process group it belongs to, if any.
Two kinds exist, after PyTorch's own idiom:

- a local mesh: one process, a device list (it may repeat a device, as
  `['cuda:0', 'cuda:0']` or `['cpu'] * 8`, to shard on one device). The
  pipeline's data and spatial partitions and the data-parallel serving
  artifact run over it: one program per shard, queued from one thread.
- a world mesh: one process per device, each holding one device, joined by
  a process group (NCCL for the card, gloo for the CPU). Data-parallel
  training runs over it: each rank takes its slice of every global batch
  and the gradients are summed over the group.

No mesh shrinks to the devices it finds: asking for more than exist raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _world_env() -> bool:
    """Whether the environment describes a world (torchrun's variables)."""
    return all(k in os.environ for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'))


def local_rank() -> int:
    """This process's index among the ranks of its host: torchrun's
    LOCAL_RANK, else the rank modulo the host's card count."""
    if 'LOCAL_RANK' in os.environ:
        return int(os.environ['LOCAL_RANK'])
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(1, torch.cuda.device_count())


def local_device(device: torch.device | str) -> torch.device:
    """The device of `device`'s type that this rank drives: its card
    (`cuda:<local rank>`), or the CPU. Raises where the card is missing."""
    kind = torch.device(device).type
    if kind == 'cpu':
        return torch.device('cpu')
    i = local_rank()
    if i >= torch.cuda.device_count():
        raise ValueError(f'local rank {i} needs cuda:{i}, and this host has '
                         f'{torch.cuda.device_count()} CUDA device(s)')
    return torch.device('cuda', i)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = 'nccl',
                           timeout_s: Optional[float] = None) -> int:
    """Join a `torch.distributed` world; returns this process's rank.

    Without arguments the world comes from the environment (`env://`,
    torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK); a single
    process with nothing configured stays local and returns 0. With
    `coordinator_address` ('host:port', rank 0's store), `num_processes`
    and `process_id` the world is joined at that address. `backend`: NCCL
    for the card (the default), gloo for the CPU.

    Idempotent: a process already in a world gets its real rank back. An
    explicitly requested multi-process setup that fails raises; it is
    never swallowed into a single-process run."""
    if dist.is_initialized():
        return dist.get_rank()
    timeout = None if timeout_s is None else datetime.timedelta(seconds=timeout_s)
    explicit = coordinator_address is not None or num_processes not in (None, 1)
    if not explicit:
        if not _world_env():
            return 0
        dist.init_process_group(backend, init_method='env://', timeout=timeout)
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                f'a multi-process world needs coordinator_address, num_processes and '
                f'process_id; got {coordinator_address!r}, {num_processes!r}, '
                f'{process_id!r}')
        if not 0 <= process_id < num_processes:
            raise ValueError(f'process_id {process_id} is not a rank of '
                             f'{num_processes} processes')
        dist.init_process_group(backend, init_method=f'tcp://{coordinator_address}',
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    if dist.get_backend() == 'nccl':
        torch.cuda.set_device(local_device('cuda'))
    return dist.get_rank()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The devices this process drives along the 'data' axis, and the
    process group of a world mesh (None for a local mesh)."""

    devices: Tuple[torch.device, ...]
    group: Optional[Any] = None

    @property
    def world_size(self) -> int:
        return dist.get_world_size(self.group) if self.group is not None else 1

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def size(self) -> int:
        """Shards along 'data', over every process of the world."""
        return len(self.devices) * self.world_size


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              device_type: str = 'cuda') -> Mesh:
    """A 1-D 'data' mesh.

    In a world (after `initialize_distributed`): this rank's one device
    (`devices`, else its card under NCCL and the CPU under gloo) and the
    world's group; `num_devices`, if given, must be the world size.
    Otherwise a local mesh over `devices`, which may repeat a device, or
    over the first `num_devices` (default: all) devices of `device_type`:
    the visible cards, or the one CPU. More devices than exist raise."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_devices is not None and num_devices != world:
            raise ValueError(f'num_devices={num_devices} in a world of {world} processes: '
                             f'each process drives one device')
        if devices is None:
            devices = [local_device('cuda' if dist.get_backend() == 'nccl' else 'cpu')]
        if len(devices) != 1:
            raise ValueError(f'a process of a world drives one device, got {list(devices)}')
        return Mesh((torch.device(devices[0]),), dist.group.WORLD)
    if devices is None:
        found = torch.cuda.device_count() if device_type == 'cuda' else 1
        n = found if num_devices is None else num_devices
        if n > found or n < 1:
            raise ValueError(
                f'a mesh of {n} {device_type} device(s) asked for, and this host has '
                f'{found}; to shard over a list, pass devices=[...] (a device may '
                f'repeat, e.g. [{device_type!r}] * {n})')
        devices = ([torch.device('cuda', i) for i in range(n)] if device_type == 'cuda'
                   else [torch.device('cpu')])
    else:
        devices = [torch.device(d) for d in devices]
        if num_devices is not None:
            if num_devices > len(devices):
                raise ValueError(f'num_devices={num_devices} but the device list has '
                                 f'{len(devices)}')
            devices = devices[:num_devices]
    if not devices:
        raise ValueError('a mesh needs at least one device')
    return Mesh(tuple(devices))


def tree_map(fn: Callable, tree):
    """`fn` over the leaves (tensors, arrays, numbers) of dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def padded_size(n: int, mesh: Mesh) -> int:
    """`n` rounded up to a multiple of the mesh."""
    return -(-n // mesh.size) * mesh.size


def pad_batch(x, mesh: Mesh):
    """A batch's leading axis zero-padded to a multiple of the mesh (numpy
    array or tensor, as given)."""
    n = x.shape[0]
    pad = padded_size(n, mesh) - n
    if not pad:
        return x
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def shard_bounds(n: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """The rows [lo, hi) of an n-item batch that each of this process's
    devices takes: equal slices in rank order. n must divide over the
    mesh (`pad_batch`, or `train_step.pad_batch_to` with zero weights)."""
    if n % mesh.size:
        raise ValueError(f'a batch of {n} does not divide over a mesh of {mesh.size}; '
                         f'pad it to {padded_size(n, mesh)}')
    per = n // mesh.size
    first = mesh.rank * len(mesh.devices)
    return [((first + i) * per, (first + i + 1) * per) for i in range(len(mesh.devices))]


def shard_batch(batch, mesh: Mesh) -> list:
    """This process's shards of a batch pytree, one for each of its
    devices: every leaf's slice of the leading axis, placed on the shard's
    device (host arrays through pinned memory, `pipeline.to_device`)."""
    from posenet_tpu_torch.pipeline import to_device

    leaves = []
    tree_map(leaves.append, batch)
    bounds = shard_bounds(leaves[0].shape[0], mesh)
    return [tree_map(lambda x, lo=lo, hi=hi, d=d: to_device(x[lo:hi], d), batch)
            for (lo, hi), d in zip(bounds, mesh.devices)]


def replicate(tree, mesh: Mesh) -> list:
    """The tensors of `tree` on each of this process's devices, one copy
    per distinct device (a repeated device shares it)."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = tree_map(lambda t: t.to(d), tree)
    return [copies[d] for d in mesh.devices]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str, fn: Callable, args):
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    # Every rank is on this host: gloo and NCCL's bootstrap use the loopback.
    os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    initialize_distributed(backend=backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: tuple = (), backend: str = 'nccl'):
    """Run `fn(*args)` in `nprocs` new processes that form one world on
    this host, rank i with LOCAL_RANK i (its card under NCCL), as torchrun
    would start them; waits for all. `fn` and `args` must pickle (`fn` a
    module-level function). A rank that raises ends the others, and the
    error is raised here."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(nprocs, _free_port(), backend, fn, args),
                       nprocs=nprocs, join=True, start_method='spawn')
