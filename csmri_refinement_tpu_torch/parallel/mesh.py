"""The data-parallel mesh and its collectives, one process per card.

Port of ``csmri_refinement_tpu/parallel/mesh.py`` under the JAX names, with
torch meaning. The JAX package shards one logical global batch over a
GSPMD mesh and lets the compiler insert the collectives; here each process
holds its own rows of every global batch, and the runners call the
collectives themselves:

* ``Mesh``: the process group's size (``world``), this process's ``rank``,
  its device and the group (None in a single-process run);
* ``mesh_from_conf``: the config's ``mesh`` section against the running
  group; ``{"data": -1}`` (or no section) and ``{"data": world}`` give one
  card per process; any other ``data`` count and every ``spatial`` > 1
  raise;
* ``shard_batch`` / ``shard_stacked_batch``: this rank's contiguous rows of
  a global batch (axis 0, or axis 1 of a ``(steps, batch, ...)`` stack);
  a batch that does not divide over the world raises;
* ``replicate``: parameters and buffers broadcast from rank 0;
* ``gather_to_replicated``: batch-leading tensors all-gathered in rank
  order, so that every rank holds the global batch (the validation
  metrics);
* ``average_``: tensors averaged over the group in place (the gradients
  and the fetched losses; every rank's rows are equally many, so the mean
  of the ranks' means is the global batch's mean);
* ``sync_batchnorm``: the BatchNorm layers of a model take their train-mode
  statistics over the group (``models/unet.py::BatchNorm2d``, through the
  differentiable ``all_reduce_sum``) when the world is above 1.

Every other collective runs whenever the mesh has a group, a group of one
included (its results are then the single process's, bit for bit); without
a group each is the identity. A world of one keeps BatchNorm's local path,
whose statistics are the global batch's already.
"""

import dataclasses
from itertools import chain
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = 'data'
SPATIAL_AXIS = 'spatial'


@dataclasses.dataclass(frozen=True)
class Mesh:
  """One card per process: ``world`` processes, this one ``rank``."""
  world: int
  rank: int
  device: torch.device
  group: Optional[Any] = None

  @property
  def shard(self):
    """``(rank, world)``, the loader's ``process_shard``."""
    return self.rank, self.world

  def rows(self, n):
    """This rank's slice of a global axis of ``n``."""
    if n % self.world:
      raise ValueError('a global batch of {} does not divide over {} '
                       'processes'.format(n, self.world))
    per = n // self.world
    return slice(self.rank * per, (self.rank + 1) * per)


def _running_group():
  if dist.is_available() and dist.is_initialized():
    return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
  return 1, 0, None


def mesh_from_conf(conf, device='cuda'):
  """The run's mesh from the config's ``mesh`` section and the process
  group ``parallel.distributed.initialize`` started; None for a
  single-process run without a ``mesh`` section."""
  mesh_conf = conf.get_attr('mesh', default=None) or {}
  spatial = int(mesh_conf.get(SPATIAL_AXIS, 1) or 1)
  if spatial > 1:
    raise NotImplementedError(
        'mesh spatial={}: image rows sharded over cards are not ported '
        '(ROADMAP.md, Queue 1); use the data axis'.format(spatial))
  world, rank, group = _running_group()
  n = mesh_conf.get(DATA_AXIS, -1)
  if n not in (-1, 0, None) and int(n) != world:
    raise ValueError(
        'mesh data={} needs {} processes, one per card, and this run has {}: '
        'start them with torchrun or the config\'s distributed section '
        '(coordinator_address, num_processes, process_id)'.format(
            n, n, world))
  if group is None and not mesh_conf:
    return None
  return Mesh(world, rank, torch.device(device), group)


def multiprocess():
  """True in a run of more than one process."""
  return _running_group()[0] > 1


def _map(fn, tree):
  if isinstance(tree, dict):
    return {k: _map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, v) for v in tree)
  return fn(tree)


def _rows_of(x, mesh, axis):
  if getattr(x, 'ndim', 0) <= axis:
    return x
  index = (slice(None),) * axis + (mesh.rows(x.shape[axis]),)
  return x[index]


def shard_batch(batch, mesh):
  """This rank's rows of a global batch (arrays or tensors, leading axis
  the batch); the batch itself without a mesh."""
  if mesh is None:
    return batch
  return _map(lambda x: _rows_of(x, mesh, 0), batch)


def shard_stacked_batch(batch, mesh):
  """This rank's rows of a ``(steps, batch, ...)`` stack (axis 1)."""
  if mesh is None:
    return batch
  return _map(lambda x: _rows_of(x, mesh, 1), batch)


def replicate(module, mesh):
  """Broadcast a module's parameters and buffers from rank 0, so that
  every rank starts from the same state; returns the module."""
  if mesh is None or mesh.group is None:
    return module
  with torch.no_grad():
    for t in chain(module.parameters(), module.buffers()):
      dist.broadcast(t.data, 0, group=mesh.group)
  return module


def _gather(t, mesh):
  if not isinstance(t, torch.Tensor) or t.ndim == 0:
    return t
  wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
  parts = [torch.empty_like(wire) for _ in range(mesh.world)]
  dist.all_gather(parts, wire, group=mesh.group)
  out = torch.cat(parts)
  return out.to(torch.bool) if t.dtype == torch.bool else out


def gather_to_replicated(tree, mesh):
  """Every batch-leading tensor of ``tree`` all-gathered over the group in
  rank order: the global batch on every rank. Numpy arrays and scalars
  pass unchanged; so does the tree without a group."""
  if mesh is None or mesh.group is None:
    return tree
  return _map(lambda t: _gather(t, mesh), tree)


def average_(tensors, mesh):
  """Average ``tensors`` over the group in place: one flat all-reduce per
  dtype, divided by the world."""
  if mesh is None or mesh.group is None:
    return
  by_dtype = {}
  for t in tensors:
    by_dtype.setdefault(t.dtype, []).append(t)
  with torch.no_grad():
    for ts in by_dtype.values():
      flat = torch.cat([t.reshape(-1) for t in ts])
      dist.all_reduce(flat, group=mesh.group)
      flat /= mesh.world
      offset = 0
      for t in ts:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def average_gradients(params, mesh):
  """Average the ``.grad`` of ``params`` over the group (before the
  optimizer step); a parameter without a gradient keeps None."""
  average_([p.grad for p in params if p.grad is not None], mesh)


class _AllReduceSum(torch.autograd.Function):
  """Sum over the group whose backward sums the gradients over the group:
  every rank's loss reaches every rank's inputs."""

  @staticmethod
  def forward(ctx, t, group):
    ctx.group = group
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t

  @staticmethod
  def backward(ctx, g):
    g = g.clone()
    dist.all_reduce(g, group=ctx.group)
    return g, None


def all_reduce_sum(t, group):
  """``t`` summed over ``group``, differentiable."""
  return _AllReduceSum.apply(t, group)


def sync_batchnorm(module, mesh):
  """Make every BatchNorm layer of ``module`` compute its train-mode
  statistics over the mesh's group (a no-op without one, or in a world of
  one)."""
  from csmri_refinement_tpu_torch.models.unet import BatchNorm2d
  group = mesh.group if mesh is not None and mesh.world > 1 else None
  for m in module.modules():
    if isinstance(m, BatchNorm2d):
      m.process_group = group
  return module

