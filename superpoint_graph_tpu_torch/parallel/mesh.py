"""Shard lists and their collectives: the sharded partitions' counterpart of
a JAX `Mesh` with `shard_map`.

Port of superpoint_graph_tpu/parallel/mesh.py (`make_mesh`). The JAX
package runs a sharded partition as one `shard_map` over a mesh of local
devices, its shards meeting in `psum`, `pmin` and `all_gather`. Here a mesh
is an ordered list of torch devices and an axis name. A device may repeat,
so that D shards run on one card: NCCL refuses two ranks on one GPU, so
this is the one way a single card runs the split and the merge of a
sharded partition.

The collectives are plain functions over the shards' tensors (`psum`,
`pmin`, `all_gather`). Each reduces or joins in shard order, so a result
repeats bit for bit, and each shard gets its own copy on its own device.
`run_shards` runs one function a shard, each in a thread of its own (the
body `shard_map` runs on each device); its shards reach the collectives
through their `Shard`, which meets the others at a barrier.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..device import cuda_device


class Mesh(NamedTuple):
    """The shards' devices, in shard order, and the axis name."""

    devices: tuple
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None,
              axis: str = "dp") -> Mesh:
    """A 1-D mesh over `devices` (default: every card, raising where there
    is none), cut to the first `n_devices`. A device may repeat, e.g.
    `devices=["cuda:0"] * 4` for four shards on one card."""
    if devices is None:
        devices = [cuda_device(i)
                   for i in range(max(torch.cuda.device_count(), 1))]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis)


def _spread(total, tensors):
    """`total` for every shard, on each shard's device: the first shard
    takes it, the others a copy (so no shard sees another's in-place
    writes)."""
    return [total] + [total.to(t.device, copy=True) for t in tensors[1:]]


def psum(tensors):
    """The sum of the shards' tensors, added in shard order on the first
    shard's device (JAX `lax.psum`)."""
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device)
    return _spread(total, tensors)


def pmin(tensors):
    """The element-wise minimum of the shards' tensors (JAX `lax.pmin`)."""
    total = tensors[0]
    for t in tensors[1:]:
        total = torch.minimum(total, t.to(total.device))
    return _spread(total, tensors)


def all_gather(tensors):
    """The shards' tensors joined along their first axis in shard order
    (JAX `lax.all_gather(..., tiled=True)`)."""
    total = torch.cat([t.to(tensors[0].device) for t in tensors])
    return _spread(total, tensors)


class _Rendezvous:
    """Where the shards of one `run_shards` call meet: each collective
    waits for every shard's tensor, one shard computes it over all of them,
    and each takes its own result."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [None] * n
        self.out = None

    def collect(self, index: int, tensor, collective):
        self.slots[index] = tensor
        if self.barrier.wait() == 0:
            self.out = collective(self.slots)
        self.barrier.wait()
        out = self.out[index]
        # every shard holds its result before the slots are used again
        self.barrier.wait()
        return out


class Shard:
    """One shard inside `run_shards`: its index, device and the shard
    count, and the collectives, which every shard must call in the same
    order."""

    def __init__(self, index: int, mesh: Mesh, rendezvous: _Rendezvous):
        self.index = index
        self.device = mesh.devices[index]
        self.size = mesh.size
        self._rdv = rendezvous

    def psum(self, tensor):
        return self._rdv.collect(self.index, tensor, psum)

    def pmin(self, tensor):
        return self._rdv.collect(self.index, tensor, pmin)

    def all_gather(self, tensor):
        return self._rdv.collect(self.index, tensor, all_gather)


def run_shards(fn, mesh: Mesh, args, timeout: float = 900.0) -> list:
    """fn(shard, *args[i]) for every shard i of `mesh`, each in its own
    thread (on its device for a card); returns the results in shard order.
    A shard that raises breaks the barrier, so the others stop at their
    next collective, and the first error is raised here. `timeout`
    (seconds) bounds each wait at a collective."""
    rdv = _Rendezvous(mesh.size, timeout)
    results = [None] * mesh.size
    errors = [None] * mesh.size

    def body(i):
        shard = Shard(i, mesh, rdv)
        try:
            if shard.device.type == "cuda":
                with torch.cuda.device(shard.device):
                    results[i] = fn(shard, *args[i])
            else:
                results[i] = fn(shard, *args[i])
        except BaseException as e:  # re-raised by the caller below
            errors[i] = e
            rdv.barrier.abort()

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors
                  if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)), None)
    if first is None:
        first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results
