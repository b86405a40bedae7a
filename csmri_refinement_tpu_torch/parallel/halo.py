"""Image rows sharded over the mesh's spatial axis: layouts, halos, gathers.

Port of what GSPMD inserts for the JAX package's ``spatial`` mesh axis
(``csmri_refinement_tpu/parallel/mesh.py:114-134`` shards the H axis of
every image-like leaf, and raises where S does not divide it; inside a
network the compiler reshards each map whose rows a stride or a pool
splits, and adds the halo exchanges of the SAME-padded convs and the DC's
collectives). Here the layers call them:

* ``sharded_rows(mesh)``: inside the block, the tensors a layer gets are
  this rank's rows of its data shard's images; ``current()`` is that
  mesh, or None outside a block and for a mesh without a spatial axis.
  The runners enter it around their train and validation steps; the
  metrics run after the rows are gathered, outside it. A recompute in the
  backward (``models/remat.py``) enters it again, and every autograd
  function below keeps its mesh for its backward;
* ``Rows``: a map's row layout, the global rows ``[bounds[r], bounds[r +
  1])`` each rank r of the spatial group holds. An image has equal blocks
  of H/S rows (``Rows.equal``). A layer that reads a window of k rows at
  stride 2 (a strided conv, a max-pool) gives output row o to the rank
  that holds input row 2·o (``Rows.strided``), so a rank's output rows
  are those whose window starts on its stretch of the stride grid, and a
  rank may hold one row more than another, or none; up-sampling doubles
  every bound (``Rows.up2``). On equal blocks of an even count every
  layout stays equal blocks. The networks derive each map's layout from
  their input's, which is an image's equal blocks (``equal_rows``), and
  hand it to the layers; a network whose outputs a loss averages gives
  their layouts with them (VGG19's ``feature_rows``, the discriminator's
  ``feature_rows`` key). A layer given no layout takes equal blocks;
* ``fetch(x, mesh, rows, windows, mode)``: each rank's window of rows
  ``[lo, hi)`` of a map, from whichever ranks own them (rows past the
  image's edges padded by ``mode`` as ``F.pad`` would), and the rank
  layout's re-lay; its backward returns each row's gradient to its owner,
  where they add. One ``all_to_all`` with split sizes over the spatial
  group moves exactly the rows each rank lacks, forward and backward, and
  none when no rank lacks any;
* ``halo_rows(x, top, bottom, mesh)``: the one-hop case, where every
  window is the rank's rows with ``top`` rows above and ``bottom`` below
  and every rank holds at least as many (``one_hop``): one ``all_gather``
  of each rank's edge rows within the spatial group, forward and
  backward; none at the image's top and bottom edges, where the caller
  pads as without a mesh. Equal blocks always take it;
* ``gather_rows``: the whole map on every rank of the spatial group (the
  blocks padded to the largest for the ``all_gather``);
  its backward sums the gradient over the group and keeps this rank's
  rows;
* ``rows_to_cols`` / ``cols_to_rows``: a (B, H/S, W, ...) block of this
  rank's rows to the (B, H, w_s, ...) block of all rows of its columns
  (column block s of ``mesh.col_bounds``: W/S columns, or one more on the
  first W mod S ranks), and back: one all-to-all with split sizes over
  the spatial group each (``mesh.all_to_all``), each the other's
  backward. The DC runs its column pass between them
  (``ops/dc_kernel.py``);
* ``sum_rows``: a sum over the spatial group whose backward sums the
  gradients over the group (``mesh.all_reduce_sum``); ``mean``: a loss's
  mean of a map whose layout is uneven, as S times this rank's share.

Gradients follow one convention: each rank's loss is S times its share of
its data group's loss (``parallel/mesh.py``), and a value that every rank
of the spatial group computes from all of their rows takes the sum of the
ranks' gradients. The JAX package's ``dc.set_spatial_mesh`` and
``fft.set_spatial_mesh`` only switch XLA lowerings (around XLA:CPU's FFT
layout check under GSPMD) and change no result; the port has one DC route
and nothing to switch.
"""

import contextlib
import dataclasses
import functools
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


# -- layouts -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rows:
  """Rank r of the spatial group holds rows ``[bounds[r], bounds[r + 1])``
  of a map of ``bounds[-1]`` rows."""
  bounds: tuple

  @classmethod
  def equal(cls, n, spatial):
    return cls(tuple(n * r for r in range(spatial + 1)))

  @property
  def height(self):
    return self.bounds[-1]

  @property
  def spatial(self):
    return len(self.bounds) - 1

  def block(self, r):
    return self.bounds[r], self.bounds[r + 1]

  def count(self, r):
    return self.bounds[r + 1] - self.bounds[r]

  @property
  def counts(self):
    return [self.count(r) for r in range(self.spatial)]

  @property
  def even(self):
    return len(set(self.counts)) == 1

  def halo(self, top, bottom):
    """Each rank's window: its rows with ``top`` rows above and ``bottom``
    below (None for a rank that holds none)."""
    return tuple((a - top, b + bottom) if b > a else None
                 for a, b in zip(self.bounds, self.bounds[1:]))

  def strided(self, k, stride, before, after):
    """(output layout, each rank's window of input rows) of a VALID window
    of ``k`` rows at ``stride`` over this map padded by ``before`` and
    ``after`` rows: output row o reads input rows [stride·o − before,
    stride·o − before + k) and belongs to the rank holding input row
    stride·o."""
    out = (self.height + before + after - k) // stride + 1
    cut = tuple(min(-(-a // stride), out) for a in self.bounds[:-1]) + (out,)
    windows = tuple((stride * o0 - before, stride * (o1 - 1) - before + k)
                    if o1 > o0 else None for o0, o1 in zip(cut, cut[1:]))
    return Rows(cut), windows

  def up2(self):
    """The layout of a 2× up-sampling: every bound doubled."""
    return Rows(tuple(2 * b for b in self.bounds))


def equal_rows(x, mesh, dim):
  """An image's layout: equal blocks of ``x``'s rows along ``dim`` (S
  divides an image's rows, ``parallel/mesh.py``); None without a mesh."""
  if mesh is None:
    return None
  return Rows.equal(x.shape[dim], mesh.spatial)


def one_hop(rows, windows):
  """(top, bottom) when every window is its rank's rows with ``top`` rows
  above and ``bottom`` below, all from the adjacent ranks (each holds
  max(top, bottom) rows or more): ``halo_rows`` fetches them; else
  None."""
  top = bottom = None
  for r, window in enumerate(windows):
    if window is None:
      continue
    a, b = rows.block(r)
    top, bottom = a - window[0], window[1] - b
    break
  if top is None or top < 0 or bottom < 0 or \
      windows != rows.halo(top, bottom) or \
      min(rows.counts) < max(top, bottom):
    return None
  return top, bottom


def taken(mesh, top, bottom):
  """(rows above, rows below) that ``halo_rows`` adds on this rank."""
  return (top if mesh.s > 0 else 0,
          bottom if mesh.s < mesh.spatial - 1 else 0)


def chain_windows(rows, top, bottom):
  """The windows of a chain of convs that pads its tile's edges itself
  (``top`` and ``bottom``: the sums of its layers' pads): each rank's rows
  with ``top`` rows above and ``bottom`` below, within the image, and at
  the image's top or bottom edge at least top + bottom + 1 rows deep, as
  far as a reflection there reads through the layers."""
  depth, height = top + bottom + 1, rows.height
  windows = []
  for window in rows.halo(top, bottom):
    if window is not None:
      lo, hi = max(window[0], 0), min(window[1], height)
      if lo == 0:
        hi = max(hi, min(depth, height))
      if hi == height:
        lo = min(lo, max(height - depth, 0))
      window = lo, hi
    windows.append(window)
  return tuple(windows)


def tile(x, mesh, rows, top, bottom, dim):
  """(x with ``top`` rows above and ``bottom`` below, as far as the image
  reaches, the rows added above): the tile of a chain of convs that pads
  its edges itself. ``halo_rows`` on one hop, else ``fetch`` of
  ``chain_windows``."""
  if one_hop(rows, rows.halo(top, bottom)) is not None:
    return (halo_rows(x, top, bottom, mesh, dim),
            taken(mesh, top, bottom)[0])
  windows = chain_windows(rows, top, bottom)
  window = windows[mesh.s]
  above = 0 if window is None else rows.bounds[mesh.s] - window[0]
  return fetch(x, mesh, rows, windows, None, dim), above


def no_rows(shape, *graph):
  """A tensor of ``shape`` with no rows, joined to the autograd graph of
  the tensors in ``graph`` (None skipped) with zero gradients, so that a
  rank that holds none of a map's rows still runs every collective of the
  backward."""
  like = next(t for t in graph if t is not None)
  out = like.new_zeros(shape)
  for t in graph:
    if t is not None:
      out = out + t.sum() * 0
  return out


# -- one hop: edge rows by all_gather -------------------------------------------

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


# -- any window: rows by all_to_all ---------------------------------------------

def _source(i, height, mode):
  """The image row that padded row ``i`` reads (−1: a zero row)."""
  if 0 <= i < height:
    return i
  if mode == 'constant':
    return -1
  if mode == 'replicate':
    return min(max(i, 0), height - 1)
  if mode == 'reflect':
    j = -i if i < 0 else 2 * (height - 1) - i
    if 0 <= j < height:
      return j
  raise ValueError('row {} lies outside the {} rows of the map (pad mode '
                   '{})'.format(i, height, mode))


@dataclasses.dataclass(frozen=True)
class _Plan:
  """What ``fetch`` moves on rank s: ``send[q]`` its local rows rank q
  needs, ``recv[q]`` the rows it gets from rank q (global, sorted), and
  ``index``, each window row's row of the table [local rows | received
  rows in rank order | one zero row]; ``moves``: whether any rank sends a
  row to another."""
  send: tuple
  recv: tuple
  index: tuple
  moves: bool


@functools.lru_cache(maxsize=256)
def _plan(rows, windows, mode, s):
  spatial = rows.spatial
  owner = []
  for r in range(spatial):
    owner += [r] * rows.count(r)
  sources = [[] if w is None else [_source(i, rows.height, mode)
                                   for i in range(*w)] for w in windows]
  # need[q][r]: the sorted rows of rank q that rank r's window reads
  need = [[sorted({j for j in sources[r] if j >= 0 and owner[j] == q})
           if q != r else [] for r in range(spatial)] for q in range(spatial)]
  n = rows.count(s)
  recv = tuple(tuple(need[q][s]) for q in range(spatial))
  position, offset = {}, n
  for q in range(spatial):
    for j in recv[q]:
      position[j] = offset
      offset += 1
  a = rows.bounds[s]
  index = tuple(offset if j < 0 else j - a if owner[j] == s else position[j]
                for j in sources[s])
  return _Plan(tuple(tuple(j - a for j in need[s][r]) for r in range(spatial)),
               recv, index, any(need[q][r] for q in range(spatial)
                                for r in range(spatial)))


def _unique_groups(index):
  """``index``'s positions split into groups whose entries differ, so that
  each ``index_add_`` of a group adds once per row, in a fixed order."""
  groups, seen = [], []
  for p, i in enumerate(index):
    for g, used in zip(groups, seen):
      if i not in used:
        g.append(p)
        used.add(i)
        break
    else:
      groups.append([p])
      seen.append({i})
  return groups


def _long(values, device):
  return torch.tensor(values, dtype=torch.long, device=device)


class _Fetch(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, plan, dim):
    ctx.mesh, ctx.plan, ctx.dim, ctx.n = mesh, plan, dim, x.shape[dim]
    xr = x.movedim(dim, 0)
    parts = [xr]
    if plan.moves:
      send = torch.cat([xr.index_select(0, _long(idx, x.device))
                        for idx in plan.send])
      parts.append(mesh_lib.all_to_all(
          send, mesh.spatial_group, [len(i) for i in plan.send],
          [len(i) for i in plan.recv]))
    parts.append(xr.new_zeros((1,) + xr.shape[1:]))
    table = torch.cat(parts)
    ctx.table_rows = table.shape[0]
    return table.index_select(0, _long(plan.index, x.device)).movedim(0, dim)

  @staticmethod
  def backward(ctx, g):
    plan, mesh, n = ctx.plan, ctx.mesh, ctx.n
    gr = g.movedim(ctx.dim, 0)
    table = gr.new_zeros((ctx.table_rows,) + gr.shape[1:])
    for group in _unique_groups(plan.index):
      table.index_add_(0, _long([plan.index[p] for p in group], g.device),
                       gr.index_select(0, _long(group, g.device)))
    grad = table[:n].clone()
    if plan.moves:
      got = mesh_lib.all_to_all(
          table[n:table.shape[0] - 1], mesh.spatial_group,
          [len(i) for i in plan.recv], [len(i) for i in plan.send])
      offset = 0
      for idx in plan.send:
        if idx:
          grad.index_add_(0, _long(idx, g.device),
                          got[offset:offset + len(idx)])
          offset += len(idx)
    return grad.movedim(0, ctx.dim), None, None, None


def fetch(x, mesh, rows, windows, mode=None, dim=2):
  """This rank's window ``windows[mesh.s]`` (rows [lo, hi) of the map of
  layout ``rows`` whose block x holds along ``dim``; None: no rows); rows
  past the map's edges are padded by ``mode`` ('constant', 'reflect',
  'replicate'; None: there are none). Every rank of the spatial group
  calls it with the same layout and windows."""
  plan = _plan(rows, tuple(windows), mode, mesh.s)
  return _Fetch.apply(x, mesh, plan, dim)


# -- gathers, exchanges, sums -----------------------------------------------------

class _GatherRows(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, dim, rows):
    rows = rows or equal_rows(x, mesh, dim)
    ctx.mesh, ctx.dim, ctx.h = mesh, dim, x.shape[dim]
    ctx.start = rows.bounds[mesh.s]
    return mesh_lib.gather_blocks(x, mesh.spatial_group, dim, rows.counts)

  @staticmethod
  def backward(ctx, g):
    mesh = ctx.mesh
    g = mesh_lib.all_reduce(g.contiguous().clone(), mesh.spatial_group)
    return g.narrow(ctx.dim, ctx.start, ctx.h), None, None, None


def gather_rows(x, mesh, dim=2, rows=None):
  """The spatial group's rows of ``x`` along ``dim`` in rank order: the
  whole map on every rank of the group (layout ``rows``; None: equal
  blocks)."""
  return _GatherRows.apply(x, mesh, dim, rows)


def _rows_to_cols(x, mesh):
  b, h, width = x.shape[:3]
  s = mesh.spatial
  rest = tuple(x.shape[3:])
  cols = mesh_lib.col_bounds(width, s)
  w = cols.count(mesh.s)
  # part j: this rank's rows of the columns of rank j; what arrives from
  # rank i: its rows of this rank's columns
  send = torch.cat([x[:, :, slice(*cols.block(j))].reshape(-1)
                    for j in range(s)])
  got = mesh_lib.all_to_all(send, mesh.spatial_group,
                            [b * h * cols.count(j) * _numel(rest)
                             for j in range(s)],
                            [b * h * w * _numel(rest)] * s)
  return got.reshape((s, b, h, w) + rest).movedim(0, 1).reshape(
      (b, s * h, w) + rest)


def _cols_to_rows(t, mesh, width):
  b, height, w = t.shape[:3]
  s = mesh.spatial
  h = height // s
  rest = tuple(t.shape[3:])
  cols = mesh_lib.col_bounds(width, s)
  # part j: the rows of rank j; what arrives from rank j: its columns
  send = t.reshape((b, s, h, w) + rest).movedim(1, 0).reshape(-1)
  sizes = [b * h * cols.count(j) * _numel(rest) for j in range(s)]
  got = mesh_lib.all_to_all(send, mesh.spatial_group,
                            [b * h * w * _numel(rest)] * s, sizes)
  return torch.cat([part.reshape((b, h, cols.count(j)) + rest)
                    for j, part in enumerate(got.split(sizes))], 2)


def _numel(shape):
  n = 1
  for d in shape:
    n *= d
  return n


class _RowsToCols(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh):
    ctx.mesh, ctx.width = mesh, x.shape[2]
    return _rows_to_cols(x, mesh)

  @staticmethod
  def backward(ctx, g):
    return _cols_to_rows(g, ctx.mesh, ctx.width), None


class _ColsToRows(torch.autograd.Function):

  @staticmethod
  def forward(ctx, t, mesh, width):
    ctx.mesh = mesh
    return _cols_to_rows(t, mesh, width)

  @staticmethod
  def backward(ctx, g):
    return _rows_to_cols(g, ctx.mesh), None, None


def rows_to_cols(x, mesh):
  """This rank's rows x (B, H/S, W, ...) → all H rows of its columns
  (B, H, w_s, ...), in row order."""
  return _RowsToCols.apply(x, mesh)


def cols_to_rows(t, mesh, width):
  """All rows of this rank's columns t (B, H, w_s, ...) of images of
  ``width`` columns → its rows of all of them (B, H/S, W, ...)."""
  return _ColsToRows.apply(t, mesh, width)


def local_rows(x, mesh, dim, rows=None):
  """This rank's rows of a whole tensor along ``dim`` (layout ``rows``;
  None: equal blocks)."""
  if rows is None:
    h = x.shape[dim] // mesh.spatial
    return x.narrow(dim, mesh.s * h, h)
  return x.narrow(dim, rows.bounds[mesh.s], rows.count(mesh.s))


def sum_rows(t, mesh):
  """``t`` summed over the spatial group, differentiable."""
  return mesh_lib.all_reduce_sum(t, mesh.spatial_group)


def mean(t, rows, dim):
  """A loss's mean of the map ``t`` (this rank's block of layout ``rows``
  along ``dim``) as this rank's part of the convention: S times its share
  of the whole map's mean, ``torch.mean`` on equal blocks (or without a
  layout)."""
  if rows is None or rows.even:
    return torch.mean(t)
  per_row = _numel(t.shape[:dim] + t.shape[dim + 1:])
  return t.sum() * (rows.spatial / (rows.height * per_row))
