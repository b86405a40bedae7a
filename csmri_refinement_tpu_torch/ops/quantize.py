"""int8 quantized inference: the opt-in serving mode of the U-Net chains.

Port of ``csmri_refinement_tpu/ops/quantize.py``. Weights are quantized per
output channel (symmetric int8), activations per image, dynamically; the
quantized layers run through the int8 conv kernel (``ops/conv_chain.py``,
``csrc/conv_int8.cu``) with exact int32 sums and f32 per-layer epilogues
(dequant + bias + LeakyReLU + requant). The mode sits outside the 0.1 dB
default quality budget. Nothing enables it by default: it is reached only
through ``UNET(quantize_inference=True)``, the ``quantize_inference``
config key and ``build_flagship(..., quantize_inference=True)``.

Rounding is half to even (``torch.round``), as ``jnp.round`` is. A scale is
``amax · f32(1/127)``: the JAX package writes ``amax / 127.0``, which XLA
rewrites under ``jit`` into a multiply by the constant's reciprocal
(measured on its CPU backend), and one ulp of scale moves rounding ties.

Under a spatial mesh (``parallel/halo.py``; ``chain_forward_int8``'s
``mesh``) each rank holds its rows of the map (``rows``: their layout,
equal blocks or the unequal ones a pool that split a rank's rows left).
Every per-image amax is taken over the spatial group (an ``all_reduce``
MAX; a rank holding no rows adds 0), so each rank quantizes with the whole
image's scale; which layers are quantized is decided at the whole map's
height. The float prefix runs on one halo tile of its layers' pad
rows, as an eval chain does (``models/unet.py``); the quantized layers run
one at a time, each on a halo tile of its own pad rows, since each requant
needs the group's amax of the layer before. A layer's amax is then taken
over the rank's own rows of its output (the kernel's would include the
tile's halo rows, which the tile's own edges made wrong). int32 sums are
exact, so each rank's rows are the one-process output's, bit for bit.
"""

import torch
import torch.distributed as dist

from csmri_refinement_tpu_torch.models import layers
from csmri_refinement_tpu_torch.ops import conv_chain
from csmri_refinement_tpu_torch.ops.conv_chain import INV_127
from csmri_refinement_tpu_torch.parallel import halo
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib

# (layers, quantized layers) of every chain run since reset_trace_log(). A
# set, so that a serving loop does not grow it: only whether some chain ran
# nothing quantized is ever asked.
_TRACE_LOG = set()


def reset_trace_log():
  _TRACE_LOG.clear()


def fell_back_to_bf16():
  """True if a chain run since ``reset_trace_log()`` quantized no layer
  (the JAX package's VMEM-budget trim, ``conv_chain.int8_suffix_start``):
  it then ran entirely in the float compute dtype."""
  return any(q == 0 for _, q in _TRACE_LOG)


def quantize_weight(w):
  """Per-output-channel symmetric int8 quantization of an HWIO kernel.

  Returns (w_int8, scale) with w ≈ w_int8 · scale[None, None, None, :].
  """
  amax = w.abs().amax(dim=(0, 1, 2)).clamp_min(1e-12)
  scale = amax * INV_127
  wi = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
  return wi, scale.float()


def image_amax(y, mesh=None):
  """Per-image max |y| (B,) f32 of an NHWC tensor; under ``mesh``, of the
  whole image whose rows the ranks of the spatial group hold."""
  if y.shape[1]:
    amax = y.float().abs().amax(dim=(1, 2, 3))
  else:     # a rank that holds none of the rows
    amax = y.new_zeros(y.shape[:1], dtype=torch.float32)
  if mesh is not None:
    mesh_lib.all_reduce(amax, mesh.spatial_group, dist.ReduceOp.MAX)
  return amax


def quantize_act(x, mesh=None):
  """Dynamic per-image symmetric int8 quantization of an NHWC tensor.

  Returns (x_int8, scale) with scale (B,) f32. Divides by the scale, as
  the JAX package does (not a multiply by its reciprocal). Under ``mesh``
  x holds the rank's rows and the scale is the whole image's.
  """
  xf = x.float()
  amax = image_amax(xf, mesh).clamp_min(1e-12)
  scale = amax * INV_127
  xi = torch.clamp(torch.round(xf / scale[:, None, None, None]), -127, 127)
  return xi.to(torch.int8), scale


def quantize_chain(chain):
  """Quantize a folded chain's weights; bias and leakiness are unchanged
  (the epilogues stay f32)."""
  out = []
  for layer in chain:
    wi, ws = quantize_weight(layer.kernel.float())
    out.append(conv_chain.ChainLayer(wi, layer.bias, layer.leakiness, ws))
  return out


def chain_forward_int8(x, chain, *, pad_mode='reflection', mesh=None,
                       rows=None):
  """int8 serving-mode counterpart of ``conv_chain.chain_forward``.

  The suffix of layers ``conv_chain.int8_suffix_start`` picks runs
  quantized; the layers before it (e.g. the 2→32 stem) run in the compute
  dtype of ``x`` through ``conv_chain.conv_layer`` — the float conv kernel
  on the card. The JAX package runs those prefix layers as XLA convs with
  the bias added in the compute dtype; the math is the same, and the
  roundings differ slightly. Returns (B, H, W, Cout_last) in ``x.dtype``.
  Under a spatial ``mesh`` x holds the rank's rows of a map of layout
  ``rows`` (None: equal blocks; module docstring).
  """
  _, h, w, _ = x.shape
  n = len(chain)
  if mesh is not None:
    rows = rows or halo.equal_rows(x, mesh, 1)
    h = rows.height
  start = conv_chain.int8_suffix_start(chain, h, w)
  _TRACE_LOG.add((n, n - start))
  if mesh is not None:
    return _chain_rows_int8(x, chain, start, pad_mode, mesh, rows)
  for layer in chain[:start]:
    x = conv_chain.conv_layer(x, layer, pad_mode)
  if start == n:
    return x
  xi, a_scale = quantize_act(x)
  return conv_chain.fused_conv_chain_int8(
      xi, a_scale, quantize_chain(chain[start:]), pad_mode=pad_mode,
      out_dtype=x.dtype)


def _pads(layer):
  return layers.pad_sizes(layer.kernel.shape[0])


def _on_tile(x, top, bottom, mesh, rows, fn, channels, dtype):
  """``fn`` on the rank's rows of ``x`` (layout ``rows``) with ``top`` and
  ``bottom`` halo rows; the rank's rows of its output (``channels`` of
  ``dtype``: none on a rank that holds no rows)."""
  tile, above = halo.tile(x, mesh, rows, top, bottom, 1)
  if not x.shape[1]:
    return x.new_zeros(x.shape[:3] + (channels,), dtype=dtype)
  return fn(tile.contiguous()).narrow(1, above, x.shape[1])


def _chain_rows_int8(x, chain, start, pad_mode, mesh, rows):
  """``chain_forward_int8`` on the rank's rows of a spatial mesh."""
  n = len(chain)
  cout = lambda layer: layer.kernel.shape[-1]
  if start:
    def prefix(tile):
      for layer in chain[:start]:
        tile = conv_chain.conv_layer(tile, layer, pad_mode)
      return tile
    pads = [_pads(layer) for layer in chain[:start]]
    x = _on_tile(x, sum(p[0] for p in pads), sum(p[1] for p in pads), mesh,
                 rows, prefix, cout(chain[start - 1]), x.dtype)
  if start == n:
    return x
  xi, scale = quantize_act(x, mesh)
  for i, layer in enumerate(quantize_chain(chain[start:])):
    last = start + i + 1 == n
    out_dtype = x.dtype if last else torch.float32
    y = _on_tile(xi, *_pads(layer), mesh, rows, lambda tile: conv_chain.
                 conv_layer_int8(tile, scale, layer, pad_mode,
                                 out_dtype)[0], cout(layer),
                 out_dtype).contiguous()
    if last:
      return y
    amax = image_amax(y, mesh)
    if y.shape[1]:
      xi, scale = conv_chain.requant(y, amax)
    else:     # no rows to requantize: only the group's scale
      xi, scale = y.to(torch.int8), amax.clamp_min(1e-8) * INV_127
