"""The (data, spatial) mesh and its collectives, one process per rank.

Port of ``csmri_refinement_tpu/parallel/mesh.py`` under the JAX names, with
torch meaning. The JAX package shards one logical global batch over a
GSPMD mesh and lets the compiler insert the collectives; here each process
holds its own part of every global batch, and the runners and layers call
the collectives themselves.

The mesh is JAX's ``np.array(devices).reshape(D, S)``: ``spatial`` is the
minor axis, so rank = d·S + s. The S adjacent ranks of one ``d`` form a
spatial group and hold the same images, each its own H/S image rows (row
block ``s``); the D ranks of one ``s`` form a data group.

* ``Mesh``: the world, this process's rank, its device, the world group
  (None in a single-process run), ``spatial`` (S) and the data and spatial
  groups; ``d``, ``s``, ``data`` (D) and ``shard`` = ``(d, D)``, the
  loader's ``process_shard`` (the S ranks of a spatial group load the same
  items);
* ``mesh_from_conf``: the config's ``mesh`` section against the running
  group. ``{"data": -1}`` (or no section) and ``{"data": world}`` give one
  data shard per process; ``{"data": D, "spatial": S}`` needs D·S
  processes (``data`` -1 takes world / S);
* ``shard_batch`` / ``shard_stacked_batch``: this rank's contiguous batch
  rows by ``d`` (axis 0, or axis 1 of a ``(steps, batch, ...)`` stack),
  then, for leaves of three or more dims after those, its image rows by
  ``s`` (the next axis), or for ``COLUMN_KEYS`` its image columns (the
  axis after); a batch, or image rows, that S does not divide raise, as
  JAX's ``shard_batch`` (``device_put`` of an uneven split) does. Inside
  a network a map's rows need not divide: where a stride or a pool splits
  a rank's rows, the layers hand the rows on by ``parallel/halo.py``'s
  layouts, as GSPMD reshards. The k-space and the mask (``COLUMN_KEYS``)
  are cut into column blocks by one balanced rule, ``col_bounds``: W // S
  columns each, and one more on each of the first W mod S ranks, so any
  width goes through. JAX's ``_batch_spec`` cuts their rows like every
  image; the DC's merge runs on whole columns
  (``ops/dc_kernel.py::dc_distributed``), so its k-space operands arrive
  in the layout they are used in;
* ``replicate``: parameters and buffers broadcast from rank 0;
* ``gather_to_replicated``: image rows all-gathered over the spatial group,
  then the batch over the data group, in rank order, so that every rank
  holds the global batch (the metrics). Leaves under ``COLUMN_KEYS`` are
  gathered along their columns instead; the ranks' blocks may differ in
  length, which the ranks exchange first (``gather_blocks`` pads each to
  the longest); leaves under ``WHOLE_KEYS`` are whole on every rank of a
  spatial group already (the discriminator's head outputs) and are
  gathered over the data group only;
* ``average_``: tensors averaged over the world in place. Every rank's loss
  is S times its share of its data group's loss: of a mean over an image's
  rows, which are equally many on every rank, the rank's mean; of a mean
  over a map whose rows the ranks hold unequally (a feature map below a
  split stride), S times the rank's sum over the whole map's count
  (``halo.mean``); of a value every rank of the spatial group holds whole,
  the value. Averaging over the world therefore sums the shares over the
  spatial group and averages over the data group, for the fetched losses
  and for the gradients alike;
* ``sync_batchnorm``: the BatchNorm layers of a model take their train-mode
  statistics over the world (``models/unet.py::BatchNorm2d``, through the
  differentiable ``all_reduce_sum``) when the world is above 1.

The collectives go through ``all_gather``, ``all_to_all``, ``all_reduce``
and ``broadcast`` below, on the group's backend: NCCL, or gloo, which takes
CUDA tensors for all four (the two ranks that share one card in
``chip_smoke.py`` phase 23, which checks it on every run).

Every other collective runs whenever the mesh has a group, a group of one
included (its results are then the single process's, bit for bit); without
a group each is the identity. A world of one keeps BatchNorm's local path,
whose statistics are the global batch's already. The layers' spatial side
(halos, row gathers, sums over the spatial group) is
``parallel/halo.py``.
"""

import dataclasses
from itertools import chain
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = 'data'
SPATIAL_AXIS = 'spatial'
# Batch keys whose leaves every rank of a spatial group holds whole.
WHOLE_KEYS = ('prob', 'logits')
# Batch keys whose leaves a spatial group splits into column blocks (all
# rows of W/S columns each; the DC's operands).
COLUMN_KEYS = ('kspace', 'mask')


@dataclasses.dataclass(frozen=True)
class Mesh:
  """``world`` processes as a (world / spatial, spatial) grid; this one is
  ``rank``."""
  world: int
  rank: int
  device: torch.device
  group: Optional[Any] = None
  spatial: int = 1
  data_group: Optional[Any] = None
  spatial_group: Optional[Any] = None

  @property
  def data(self):
    return self.world // self.spatial

  @property
  def d(self):
    return self.rank // self.spatial

  @property
  def s(self):
    return self.rank % self.spatial

  @property
  def shard(self):
    """``(d, D)``, the loader's ``process_shard``."""
    return self.d, self.data

  def rows(self, n):
    """This rank's slice of a global batch axis of ``n``."""
    if n % self.data:
      raise ValueError('a global batch of {} does not divide over {} '
                       'processes'.format(n, self.data))
    per = n // self.data
    return slice(self.d * per, (self.d + 1) * per)

  def image_rows(self, n):
    """This rank's slice of an image axis of ``n`` rows (H/S each)."""
    if n % self.spatial:
      raise ValueError('mesh spatial={}: an image of {} rows does not divide '
                       'into {} row blocks'.format(self.spatial, n,
                                                   self.spatial))
    per = n // self.spatial
    return slice(self.s * per, (self.s + 1) * per)

  def image_cols(self, n):
    """This rank's slice of an image axis of ``n`` columns
    (``col_bounds``)."""
    return slice(*col_bounds(n, self.spatial).block(self.s))


def col_bounds(n, spatial):
  """The column blocks of an image of ``n`` columns over ``spatial``
  ranks: n // spatial each, and one more on each of the first n mod
  spatial ranks (a ``halo.Rows`` layout of the columns)."""
  from csmri_refinement_tpu_torch.parallel.halo import Rows
  per, extra = divmod(n, spatial)
  return Rows(tuple(r * per + min(r, extra) for r in range(spatial + 1)))


def _running_group():
  if dist.is_available() and dist.is_initialized():
    return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
  return 1, 0, None


def _groups(world, rank, spatial):
  """(data group, spatial group) of ``rank``. Every process creates every
  group, in one order, as ``dist.new_group`` requires."""
  data = world // spatial
  if spatial == 1:
    return dist.group.WORLD, None
  if data == 1:
    return None, dist.group.WORLD
  mine = {}
  for s in range(spatial):
    group = dist.new_group([d * spatial + s for d in range(data)])
    if rank % spatial == s:
      mine['data'] = group
  for d in range(data):
    group = dist.new_group([d * spatial + s for s in range(spatial)])
    if rank // spatial == d:
      mine['spatial'] = group
  return mine['data'], mine['spatial']


def mesh_from_conf(conf, device='cuda'):
  """The run's mesh from the config's ``mesh`` section and the process
  group ``parallel.distributed.initialize`` started; None for a
  single-process run without a ``mesh`` section."""
  mesh_conf = conf.get_attr('mesh', default=None) or {}
  spatial = int(mesh_conf.get(SPATIAL_AXIS, 1) or 1)
  world, rank, group = _running_group()
  n = mesh_conf.get(DATA_AXIS, -1)
  if n in (-1, 0, None):
    if world % spatial:
      raise ValueError(
          'mesh spatial={} does not divide the {} processes of this run'
          .format(spatial, world))
    n = world // spatial
  n = int(n)
  if n * spatial != world:
    raise ValueError(
        'mesh data={} spatial={} needs {} processes, one per rank, and this '
        'run has {}: start them with torchrun or the config\'s distributed '
        'section (coordinator_address, num_processes, process_id)'.format(
            n, spatial, n * spatial, world))
  if group is None and not mesh_conf:
    return None
  data_group, spatial_group = (None, None) if group is None else \
      _groups(world, rank, spatial)
  return Mesh(world, rank, torch.device(device), group, spatial, data_group,
              spatial_group)


def multiprocess():
  """True in a run of more than one process."""
  return _running_group()[0] > 1


# -- collectives ---------------------------------------------------------------

def all_gather(t, group):
  """The list of every rank's ``t`` (one shape on every rank) in the
  group's rank order."""
  t = t.contiguous()
  parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
  dist.all_gather(parts, t, group=group)
  return parts


def all_to_all(t, group, send_sizes, recv_sizes):
  """Part i of ``t``, its next ``send_sizes[i]`` slices along axis 0, to
  rank i of the group; returns what every rank sent this one, in rank
  order along axis 0 (``recv_sizes[i]`` slices from rank i).
  ``dist.all_to_all_single``, which gloo runs on CUDA tensors too (its
  list form it refuses)."""
  t = t.contiguous()
  out = t.new_empty((sum(recv_sizes),) + tuple(t.shape[1:]))
  dist.all_to_all_single(out, t, list(recv_sizes), list(send_sizes),
                         group=group)
  return out


def all_reduce(t, group, op=dist.ReduceOp.SUM):
  """``t`` reduced over the group, in place; returns ``t``."""
  dist.all_reduce(t, op, group=group)
  return t


def broadcast(t, src, group):
  """``t`` from the world rank ``src``, in place."""
  dist.broadcast(t, src, group=group)
  return t


# -- trees ---------------------------------------------------------------------

ROWS, COLS, WHOLE = 'rows', 'cols', 'whole'


def _map(fn, tree, kind=ROWS):
  """``fn(leaf, kind)`` over a tree; ``kind`` is ``WHOLE`` under a dict key
  of ``WHOLE_KEYS``, ``COLS`` under one of ``COLUMN_KEYS``, else ``ROWS``."""
  if isinstance(tree, dict):
    return {k: _map(fn, v, WHOLE if k in WHOLE_KEYS else
                    COLS if k in COLUMN_KEYS else kind)
            for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, v, kind) for v in tree)
  return fn(tree, kind)


def _image_part(x, mesh, axis, kind):
  """This rank's image rows (axis ``axis``) or, for ``COLS``, columns (the
  axis after) of ``x``; ``x`` itself for ``WHOLE``."""
  if kind == WHOLE:
    return x
  if kind == COLS:
    return x[(slice(None),) * (axis + 1) +
             (mesh.image_cols(x.shape[axis + 1]),)]
  return x[(slice(None),) * axis + (mesh.image_rows(x.shape[axis]),)]


def _cut(x, mesh, axis, kind):
  ndim = getattr(x, 'ndim', 0)
  if ndim <= axis:
    return x
  x = x[(slice(None),) * axis + (mesh.rows(x.shape[axis]),)]
  if kind and mesh.spatial > 1 and ndim - axis >= 3:
    x = _image_part(x, mesh, axis + 1, kind)
  return x


def shard_batch(batch, mesh, rows=True):
  """This rank's part of a global batch (arrays or tensors, leading axis
  the batch): its batch rows and, with ``rows``, its image rows (or
  columns) of every leaf of three or more dims; the batch itself without a
  mesh."""
  if mesh is None:
    return batch
  return _map(lambda x, kind: _cut(x, mesh, 0, rows and kind), batch)


def shard_stacked_batch(batch, mesh):
  """This rank's part of a ``(steps, batch, ...)`` stack (axis 1, then its
  image rows or columns)."""
  if mesh is None:
    return batch
  return _map(lambda x, kind: _cut(x, mesh, 1, kind), batch)


def split_image_rows(batch, mesh):
  """This rank's image rows (axis 1) of every leaf of three or more dims of
  a batch the rank holds whole, its image columns (axis 2) of those under
  ``COLUMN_KEYS``, and those under ``WHOLE_KEYS`` whole: a batch prepared
  on whole images, cut for a spatial mesh."""
  if mesh is None or mesh.spatial == 1:
    return batch

  return _map(lambda x, kind: x if getattr(x, 'ndim', 0) < 3
              else _image_part(x, mesh, 1, kind), batch)


def replicate(module, mesh):
  """Broadcast a module's parameters and buffers from rank 0, so that
  every rank starts from the same state; returns the module."""
  if mesh is None or mesh.group is None:
    return module
  with torch.no_grad():
    for t in chain(module.parameters(), module.buffers()):
      broadcast(t.data, 0, mesh.group)
  return module


def gather_blocks(t, group, dim, counts=None):
  """``t`` of every rank of ``group`` joined along ``dim`` in rank order;
  rank r's block is ``counts[r]`` long (None: every block as long as
  this rank's). Each is padded to the longest for the ``all_gather`` and
  cut back."""
  wire = t.to(torch.uint8) if t.dtype == torch.bool else t
  if counts is None:
    counts = [wire.shape[dim]] * dist.get_world_size(group)
  sizes = list(wire.shape)
  sizes[dim] = max(counts) - wire.shape[dim]
  parts = all_gather(torch.cat([wire, wire.new_zeros(sizes)], dim), group)
  out = torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, counts)], dim)
  return out.to(torch.bool) if t.dtype == torch.bool else out


def gather_to_replicated(tree, mesh, rows=True):
  """Every tensor of ``tree`` gathered to the global batch in rank order:
  with ``rows``, the image rows (axis 1) of leaves of three or more dims
  over the spatial group (the columns, axis 2, of those under
  ``COLUMN_KEYS``; not those under ``WHOLE_KEYS``), then axis 0 over the
  data group. The ranks' blocks along the spatial axis may differ (a
  column block of a width S does not divide, a feature map below a stride
  that split a rank's rows): the leaves' lengths there are exchanged first,
  in one ``all_gather`` over the spatial group. Numpy arrays and scalars
  pass unchanged; so does the tree without a group."""
  if mesh is None or mesh.group is None:
    return tree
  spatial = rows and mesh.spatial_group is not None

  def axis(t, kind):
    """The axis of ``t`` that the spatial group splits, or None."""
    if spatial and isinstance(t, torch.Tensor) and t.ndim >= 3 and \
        kind != WHOLE:
      return 2 if kind == COLS else 1
    return None

  split = []

  def length(t, kind):
    if axis(t, kind):
      split.append(t.shape[axis(t, kind)])
  _map(length, tree)
  if split:
    lengths = all_gather(torch.tensor(split, device=mesh.device),
                         mesh.spatial_group)
    counts = iter(torch.stack(lengths, 1).tolist())

  def gather(t, kind):
    if not isinstance(t, torch.Tensor) or t.ndim == 0:
      return t
    if axis(t, kind):
      t = gather_blocks(t, mesh.spatial_group, axis(t, kind), next(counts))
    if mesh.data_group is not None:
      t = gather_blocks(t, mesh.data_group, 0)
    return t
  return _map(gather, tree)


def average_(tensors, mesh):
  """Average ``tensors`` over the world in place: one flat all-reduce per
  dtype, divided by the world."""
  if mesh is None or mesh.group is None:
    return
  by_dtype = {}
  for t in tensors:
    by_dtype.setdefault(t.dtype, []).append(t)
  with torch.no_grad():
    for ts in by_dtype.values():
      flat = torch.cat([t.reshape(-1) for t in ts])
      all_reduce(flat, mesh.group)
      flat /= mesh.world
      offset = 0
      for t in ts:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def average_gradients(params, mesh):
  """Average the ``.grad`` of ``params`` over the world (before the
  optimizer step); a parameter without a gradient keeps None."""
  average_([p.grad for p in params if p.grad is not None], mesh)


class _AllReduceSum(torch.autograd.Function):
  """Sum over the group whose backward sums the gradients over the group:
  every rank's loss reaches every rank's inputs."""

  @staticmethod
  def forward(ctx, t, group):
    ctx.group = group
    return all_reduce(t.clone(), group)

  @staticmethod
  def backward(ctx, g):
    return all_reduce(g.clone(), ctx.group), None


def all_reduce_sum(t, group):
  """``t`` summed over ``group``, differentiable."""
  return _AllReduceSum.apply(t, group)


def sync_batchnorm(module, mesh):
  """Make every BatchNorm layer of ``module`` compute its train-mode
  statistics over the mesh's world (a no-op without one, or in a world of
  one)."""
  from csmri_refinement_tpu_torch.models.unet import BatchNorm2d
  group = mesh.group if mesh is not None and mesh.world > 1 else None
  for m in module.modules():
    if isinstance(m, BatchNorm2d):
      m.process_group = group
  return module
