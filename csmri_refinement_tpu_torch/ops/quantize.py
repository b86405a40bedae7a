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
"""

import torch

from csmri_refinement_tpu_torch.ops import conv_chain
from csmri_refinement_tpu_torch.ops.conv_chain import INV_127

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


def quantize_act(x):
  """Dynamic per-image symmetric int8 quantization of an NHWC tensor.

  Returns (x_int8, scale) with scale (B,) f32. Divides by the scale, as
  the JAX package does (not a multiply by its reciprocal).
  """
  xf = x.float()
  amax = xf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12)
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


def chain_forward_int8(x, chain, *, pad_mode='reflection'):
  """int8 serving-mode counterpart of ``conv_chain.chain_forward``.

  The suffix of layers ``conv_chain.int8_suffix_start`` picks runs
  quantized; the layers before it (e.g. the 2→32 stem) run in the compute
  dtype of ``x`` through ``conv_chain.conv_layer`` — the float conv kernel
  on the card. The JAX package runs those prefix layers as XLA convs with
  the bias added in the compute dtype; the math is the same, and the
  roundings differ slightly. Returns (B, H, W, Cout_last) in ``x.dtype``.
  """
  _, h, w, _ = x.shape
  n = len(chain)
  start = conv_chain.int8_suffix_start(chain, h, w)
  _TRACE_LOG.add((n, n - start))
  for layer in chain[:start]:
    x = conv_chain.conv_layer(x, layer, pad_mode)
  if start == n:
    return x
  xi, a_scale = quantize_act(x)
  return conv_chain.fused_conv_chain_int8(
      xi, a_scale, quantize_chain(chain[start:]), pad_mode=pad_mode,
      out_dtype=x.dtype)
