"""k-space data-consistency operator — the RecNet hot op.

Port of the dense ``data_consistency`` of
``csmri_refinement_tpu/ops/dc.py:448-486``:

    k   = fft2(x)                    # ortho, unshifted
    out = (1 - mask) * k + k0        # noiseless merge
    x'  = ifft2(out)

On a CUDA tensor it runs the hand-written DC kernel (``ops/dc_kernel.py``)
through ``_DCFunction``, whose backward is the same kernel (K1-bwd); on a
CPU tensor, its autodiffed plain ``torch.fft`` version. Always in float32.
The noisy merge, the sampled-lines ("skinny") lowering and the JAX
package's TPU lowering selectors are not ported: the dense DC is what the
JAX package runs under ``CSMRI_TPU_FUSED_DC=1``, and the skinny lowering
equals it exactly (its ``ops/dc.py:310-332``).

Under a spatial mesh (``parallel/halo.py``) ``x`` holds the rank's image
rows and ``k0`` and ``mask`` the whole images (every rank of the spatial
group holds them: a layout the JAX package shards, the same values):
``dc_kernel.dc_rows`` gathers x's rows and runs the same DC on the whole
image. The JAX package's ``set_spatial_mesh`` switches XLA lowerings only
and has no counterpart here.
"""

import torch

from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.ops.dc_kernel import kspace_merge_reference
from csmri_refinement_tpu_torch.parallel import halo

__all__ = ['data_consistency', 'kspace_merge_reference',
           'lines_acc_from_undersampling']


def lines_acc_from_undersampling(us):
  """Static acceleration divisor when an ``undersampling`` section
  guarantees a fixed-count Cartesian line mask, else None (port of the JAX
  ``ops/dc.py:341-351``)."""
  if not us:
    return None
  if us.get('sampling_scheme', 'varden') not in ('varden', 'cartesian'):
    return None
  if us.get('variable_acceleration', False):
    return None
  return float(us.get('acceleration_factor', 8))


def data_consistency(x, k0, mask):
  """Data-consistency step on packed tensors.

  x : (B, H, W, 2) float — current image estimate (real/imag channels)
  k0 : (B, H, W, 2) float — originally sampled k-space
  mask : (B, H, W, 1) float — 1 where k-space was sampled

  Returns the (B, H, W, 2) float32 image with sampled k-space restored.
  """
  f32 = lambda t: t.to(torch.float32).contiguous()
  mesh = halo.current()
  if mesh is not None:
    return dc_kernel.dc_rows(f32(x), f32(k0), f32(mask), mesh)
  return dc_kernel.dc_fused(f32(x), f32(k0), f32(mask))
