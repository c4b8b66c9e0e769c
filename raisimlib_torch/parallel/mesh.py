"""Process groups and rank meshes: the port's counterpart of
raisimlib_tpu/parallel/mesh.py.

The JAX package runs one controller over a named `jax.sharding.Mesh` of
devices. PyTorch's idiom is one process per device, joined by
`torch.distributed`: NCCL between CUDA devices, gloo between CPU processes.
Here a `Mesh` is a grid of ranks with named axes, built on a
`torch.distributed.device_mesh.DeviceMesh`; every rank holds plain local
tensors (its shard of the batch), and the only cross-rank traffic is the
explicit collectives of the sharded functions.

One code path serves one card, one node and many: with no launcher
variables `init_distributed` makes a one-rank group, so a single card runs
the same collectives as a cluster. Launch N ranks on a node with

    torchrun --nproc-per-node N script.py

whose script calls `init_distributed()` first; it reads torchrun's
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK.

Every rank of the world must build the same meshes in the same order: a
mesh creates process groups, which is collective over the world.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from raisimlib_torch._device import resolve_device
from raisimlib_torch.utils import tree as tree_lib

_LOCAL_DEVICE: Optional[torch.device] = None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> torch.device:
  """Join (or form) the process group; call once per process before any mesh.

  The arguments default to the launcher's MASTER_ADDR:MASTER_PORT,
  WORLD_SIZE and RANK. With none of them, the process forms a one-rank
  group of its own. `device` None means this rank's card (cuda:LOCAL_RANK),
  and the group uses NCCL; `device="cpu"` uses gloo. Retries 3 times, as
  the JAX package does. Returns this rank's device; a second call returns
  it again."""
  global _LOCAL_DEVICE
  if dist.is_initialized():
    return local_device()
  env = os.environ
  if coordinator_address is None and "MASTER_ADDR" in env:
    coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
  num_processes = int(env.get("WORLD_SIZE", "1")) if num_processes is None else num_processes
  process_id = int(env.get("RANK", "0")) if process_id is None else process_id
  dev = resolve_device(device)
  kw = {}
  if dev.type == "cuda":
    local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
    dev = torch.device("cuda", local if dev.index is None else dev.index)
    torch.cuda.set_device(dev)
    kw["device_id"] = dev
  backend = "nccl" if dev.type == "cuda" else "gloo"
  if coordinator_address is None:
    if num_processes != 1:
      raise ValueError(f"{num_processes} processes need a coordinator address "
                       "(MASTER_ADDR/MASTER_PORT or coordinator_address)")
    kw["store"] = dist.HashStore()
  else:
    addr = coordinator_address
    kw["init_method"] = addr if "://" in addr else f"tcp://{addr}"
  last_err = None
  for _ in range(3):
    try:
      dist.init_process_group(backend, rank=process_id, world_size=num_processes, **kw)
      _LOCAL_DEVICE = dev
      return dev
    except RuntimeError as e:             # torch's network errors derive from it
      last_err = e
      time.sleep(2.0)
  raise RuntimeError(f"torch.distributed.init_process_group failed after retries: {last_err}")


def local_device() -> torch.device:
  """This rank's device (the one init_distributed chose)."""
  if _LOCAL_DEVICE is None:
    raise RuntimeError("call init_distributed() first")
  return _LOCAL_DEVICE


class Mesh:
  """A grid of global ranks with named axes. `devices` is that grid (as the
  JAX mesh's), `device_mesh` the DeviceMesh, `device` this rank's device.
  A rank outside the grid holds the object too (mesh creation is collective
  over the world) but must not call the mesh's collectives."""

  def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
    from torch.distributed.device_mesh import DeviceMesh

    self.devices = np.asarray(ranks)
    self.axis_names = tuple(axis_names)
    self.device = local_device()
    self.device_mesh = DeviceMesh(self.device.type, torch.as_tensor(self.devices),
                                  mesh_dim_names=self.axis_names)
    # the group over the whole mesh: its one axis's, or one of its own (creating
    # a group is collective over the world, so every rank makes it)
    if self.devices.ndim == 1:
      self._group = (self.device_mesh.get_group(self.axis_names[0])
                     if self.contains() else None)
    else:
      group = dist.new_group(self.devices.reshape(-1).tolist())
      self._group = group if self.contains() else None

  @property
  def shape(self) -> tuple:
    return self.devices.shape

  @property
  def size(self) -> int:
    return int(self.devices.size)

  def contains(self) -> bool:
    return dist.get_rank() in self.devices

  def index(self) -> int:
    """This rank's position in the grid, row-major over every axis: the
    shard of the batch it holds."""
    return int(np.flatnonzero(self.devices.reshape(-1) == dist.get_rank())[0])

  def coordinate(self, axis: str) -> int:
    return int(np.argwhere(self.devices == dist.get_rank())[0][self.axis_names.index(axis)])

  def axis_size(self, axis: str) -> int:
    return int(self.devices.shape[self.axis_names.index(axis)])

  def group(self, axis: Optional[str] = None):
    """The process group over one axis, or over the whole mesh."""
    if not self.contains():
      raise RuntimeError(f"rank {dist.get_rank()} is outside the mesh {self.devices.tolist()}")
    return self._group if axis is None else self.device_mesh.get_group(axis)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp") -> Mesh:
  """1-D data-parallel mesh over the first `n_devices` ranks (default: all)."""
  world = dist.get_world_size()
  n = world if n_devices is None else int(n_devices)
  if not 1 <= n <= world:
    raise ValueError(f"a mesh of {n} ranks in a world of {world}")
  return Mesh(np.arange(n), (axis_name,))


def make_host_chip_mesh(axis_names: Sequence[str] = ("host", "chip")) -> Mesh:
  """2-D (hosts x ranks per host) mesh. Ranks are grouped by node
  (LOCAL_WORLD_SIZE ranks a node, torchrun's contiguous numbering; all on
  one node where it is unset), so the trailing "chip" axis stays inside a
  node: keep tightly coupled reductions on it."""
  world = dist.get_world_size()
  per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
  if world % per_host:
    raise ValueError(f"uneven ranks per host: {world} ranks, {per_host} a host")
  return Mesh(np.arange(world).reshape(world // per_host, per_host), axis_names)


def shard_batch(mesh: Mesh, tree):
  """This rank's slice of axis 0 of every leaf of a pytree of global
  batches, on the rank's device. Rank-0 leaves have no batch axis and are
  replicated. A batch that does not divide the mesh raises ValueError."""
  n, i = mesh.size, mesh.index()

  def one(x):
    x = torch.as_tensor(x)
    if x.ndim == 0:
      return x.to(mesh.device)
    if x.shape[0] % n:
      raise ValueError(f"a batch of {x.shape[0]} does not divide the mesh's {n} ranks")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b].to(mesh.device).contiguous()

  return tree_lib.tree_map(one, tree)


def gather_batch(mesh: Mesh, tree):
  """Every rank's shards of a pytree, concatenated along axis 0 on every
  rank (the global batch, as reading back a JAX global array gives it):
  one all_gather a leaf over the mesh. Rank-0 leaves are returned as they
  are."""
  group = mesh.group()

  def one(x):
    if x.ndim == 0 or mesh.size == 1:
      return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)

  return tree_lib.tree_map(one, tree)
