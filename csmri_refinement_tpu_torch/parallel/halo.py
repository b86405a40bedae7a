"""Image rows sharded over the mesh's spatial axis: halos, gathers, sums.

Port of what GSPMD inserts for the JAX package's ``spatial`` mesh axis
(``csmri_refinement_tpu/parallel/mesh.py:114-124`` shards the H axis of
every image-like leaf; the compiler adds the halo exchanges of the
SAME-padded convs and the DC's collectives). Here the layers call them:

* ``sharded_rows(mesh)``: inside the block, the tensors a layer gets are
  this rank's rows (row block ``mesh.s`` of ``mesh.spatial``) of its data
  shard's images; ``current()`` is that mesh, or None outside a block and
  for a mesh without a spatial axis. The runners enter it around their
  train and validation steps; the metrics run after the rows are gathered,
  outside it. A recompute in the backward (``models/remat.py``) enters it
  again, and every autograd function below keeps its mesh for its
  backward;
* ``halo_rows(x, top, bottom, mesh)``: this rank's rows with ``top`` rows
  of the rank above and ``bottom`` rows of the rank below (none at the
  image's top and bottom edges, where the caller pads as without a mesh);
  its backward sends the halo rows' gradients to their owners, where they
  add. The rows move by one ``all_gather`` of each rank's edge rows within
  the spatial group, forward and backward;
* ``gather_rows``: the whole image on every rank of the spatial group; its
  backward sums the gradient over the group and keeps this rank's rows;
* ``rows_to_cols`` / ``cols_to_rows``: a (B, H/S, W, ...) block of this
  rank's rows to the (B, H, W/S, ...) block of all rows of its columns
  (column block ``mesh.s``), and back: one all-to-all over the spatial
  group each (``mesh.all_to_all``), each the other's backward. The DC
  runs its column pass between them (``ops/dc_kernel.py``);
* ``sum_rows``: a sum over the spatial group whose backward sums the
  gradients over the group (``mesh.all_reduce_sum``);
* ``row_factor``: the largest downsampling factor of some models, which
  every rank's row count must divide (``mesh.Mesh.image_rows``).

Gradients follow one convention: each rank's loss is S times its share of
its data group's loss (``parallel/mesh.py``), and a value that every rank
of the spatial group computes from all of their rows takes the sum of the
ranks' gradients. The JAX package's ``dc.set_spatial_mesh`` and
``fft.set_spatial_mesh`` only switch XLA lowerings (around XLA:CPU's FFT
layout check under GSPMD) and change no result; the port has one DC route
and nothing to switch.
"""

import contextlib
import threading

import torch

from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib

_state = threading.local()


def current():
  """The spatial mesh of the enclosing ``sharded_rows`` block, or None."""
  return getattr(_state, 'mesh', None)


@contextlib.contextmanager
def sharded_rows(mesh):
  """Run the block on this rank's image rows of ``mesh`` (a no-op block for
  None or a mesh without a spatial axis)."""
  before = current()
  _state.mesh = mesh if mesh is not None and mesh.spatial > 1 else None
  try:
    yield
  finally:
    _state.mesh = before


def taken(mesh, top, bottom):
  """(rows above, rows below) that ``halo_rows`` adds on this rank."""
  return (top if mesh.s > 0 else 0,
          bottom if mesh.s < mesh.spatial - 1 else 0)


def _edges(x, dim, first, last):
  h = x.shape[dim]
  return torch.cat([x.narrow(dim, 0, first), x.narrow(dim, h - last, last)],
                   dim)


class _HaloRows(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, top, bottom, mesh, dim):
    h = x.shape[dim]
    if max(top, bottom) > h:
      raise ValueError('a halo of {} rows needs at least as many rows per '
                       'rank, and this rank holds {}'.format(
                           max(top, bottom), h))
    ctx.top, ctx.bottom, ctx.mesh, ctx.dim, ctx.h = top, bottom, mesh, dim, h
    if not top and not bottom:
      return x.clone()
    # every rank sends its first ``bottom`` rows (the bottom halo of the
    # rank above) and its last ``top`` rows (the top halo of the one below)
    parts = mesh_lib.all_gather(_edges(x, dim, bottom, top),
                                mesh.spatial_group)
    above, below = taken(mesh, top, bottom)
    pieces = [x]
    if above:
      pieces.insert(0, parts[mesh.s - 1].narrow(dim, bottom, top))
    if below:
      pieces.append(parts[mesh.s + 1].narrow(dim, 0, bottom))
    return torch.cat(pieces, dim)

  @staticmethod
  def backward(ctx, g):
    top, bottom, mesh, dim, h = ctx.top, ctx.bottom, ctx.mesh, ctx.dim, ctx.h
    if not top and not bottom:
      return g, None, None, None, None
    above, below = taken(mesh, top, bottom)
    grad = g.narrow(dim, above, h).clone()
    sizes = list(g.shape)
    sizes[dim] = top
    send_top = g.narrow(dim, 0, top) if above else g.new_zeros(sizes)
    sizes[dim] = bottom
    send_bottom = g.narrow(dim, above + h, bottom) if below else \
        g.new_zeros(sizes)
    parts = mesh_lib.all_gather(torch.cat([send_top, send_bottom], dim),
                                mesh.spatial_group)
    if mesh.s < mesh.spatial - 1 and top:   # the rank below took my last
      grad.narrow(dim, h - top, top).add_(parts[mesh.s + 1].narrow(dim, 0,
                                                                   top))
    if mesh.s > 0 and bottom:             # the rank above took my first
      grad.narrow(dim, 0, bottom).add_(parts[mesh.s - 1].narrow(dim, top,
                                                                bottom))
    return grad, None, None, None, None


def halo_rows(x, top, bottom, mesh, dim=2):
  """``x`` (this rank's rows along ``dim``; NCHW by default) with ``top``
  rows of the rank above and ``bottom`` rows of the rank below prepended
  and appended, where those ranks exist (``taken``)."""
  return _HaloRows.apply(x, int(top), int(bottom), mesh, dim)


class _GatherRows(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, dim):
    ctx.mesh, ctx.dim, ctx.h = mesh, dim, x.shape[dim]
    return torch.cat(mesh_lib.all_gather(x, mesh.spatial_group), dim)

  @staticmethod
  def backward(ctx, g):
    mesh = ctx.mesh
    g = mesh_lib.all_reduce(g.contiguous().clone(), mesh.spatial_group)
    return g.narrow(ctx.dim, mesh.s * ctx.h, ctx.h), None, None


def gather_rows(x, mesh, dim=2):
  """The spatial group's rows of ``x`` along ``dim`` in rank order: the
  whole image on every rank of the group."""
  return _GatherRows.apply(x, mesh, dim)


def _rows_to_cols(x, mesh):
  b, h, width = x.shape[:3]
  s = mesh.spatial
  if width % s:
    raise ValueError('{} columns do not divide over {} ranks'.format(width,
                                                                   s))
  w = width // s
  rest = tuple(x.shape[3:])
  # part j: the columns of rank j; what arrives from rank i: its rows
  send = x.reshape((b, h, s, w) + rest).movedim(2, 0)
  got = mesh_lib.all_to_all(send, mesh.spatial_group)
  return got.movedim(0, 1).reshape((b, s * h, w) + rest)


def _cols_to_rows(t, mesh):
  b, height, w = t.shape[:3]
  s = mesh.spatial
  h = height // s
  rest = tuple(t.shape[3:])
  # part j: the rows of rank j; what arrives from rank j: its columns
  send = t.reshape((b, s, h, w) + rest).movedim(1, 0)
  got = mesh_lib.all_to_all(send, mesh.spatial_group)
  return got.movedim(0, 2).reshape((b, h, s * w) + rest)


class _RowsToCols(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh):
    ctx.mesh = mesh
    return _rows_to_cols(x, mesh)

  @staticmethod
  def backward(ctx, g):
    return _cols_to_rows(g, ctx.mesh), None


class _ColsToRows(torch.autograd.Function):

  @staticmethod
  def forward(ctx, t, mesh):
    ctx.mesh = mesh
    return _cols_to_rows(t, mesh)

  @staticmethod
  def backward(ctx, g):
    return _rows_to_cols(g, ctx.mesh), None


def rows_to_cols(x, mesh):
  """This rank's rows x (B, H/S, W, ...) → all H rows of its W/S columns
  (B, H, W/S, ...), in row order."""
  return _RowsToCols.apply(x, mesh)


def cols_to_rows(t, mesh):
  """All rows of this rank's columns t (B, H, W/S, ...) → its rows of all
  W columns (B, H/S, W, ...)."""
  return _ColsToRows.apply(t, mesh)


def local_rows(x, mesh, dim):
  """This rank's rows of a whole tensor along ``dim``."""
  h = x.shape[dim] // mesh.spatial
  return x.narrow(dim, mesh.s * h, h)


def sum_rows(t, mesh):
  """``t`` summed over the spatial group, differentiable."""
  return mesh_lib.all_reduce_sum(t, mesh.spatial_group)


def row_factor(*modules):
  """The largest ``row_factor`` (downsampling factor) of the modules and
  their submodules; 1 for none."""
  return max([1] + [getattr(m, 'row_factor', 1) for module in modules
                    if module is not None for m in module.modules()])
