"""k-space data-consistency operator — the RecNet hot op.

Port of the dense ``data_consistency`` of
``csmri_refinement_tpu/ops/dc.py:448-501``:

    k   = fft2(x)                    # ortho, unshifted
    out = (1 - mask) * k + k0        # noiseless merge
    x'  = ifft2(out)

On a CUDA tensor the noiseless DC runs the hand-written DC kernel
(``ops/dc_kernel.py``) through ``_DCFunction``, whose backward is the same
kernel (K1-bwd); on a CPU tensor, its autodiffed plain ``torch.fft``
version. Always in float32.

With a ``noise_lvl`` the merge weighs the prediction against the noisy
samples (``kspace_merge_reference``), and the DC is the ``torch.fft``
composition (cuFFT on the card), autodiffed: the JAX package sends a noisy
DC to its non-Pallas composition too (its ``_gemm_mode``, ``dc.py:70-77``),
so there is no TPU kernel of it to port. ``data_consistency_complex``
takes complex64 images, ``data_consistency_np`` numpy arrays (the
reference's golden formula). The sampled-lines ("skinny") lowering and the
JAX package's TPU lowering selectors are not ported: the dense DC is what
the JAX package runs under ``CSMRI_TPU_FUSED_DC=1``, and the skinny lowering
equals it exactly (its ``ops/dc.py:310-332``).

Under a spatial mesh (``parallel/halo.py``) ``x`` holds the rank's image
rows and ``k0`` and ``mask`` all rows of its column block
(``parallel/mesh.py::COLUMN_KEYS``): ``dc_kernel.dc_distributed`` runs K1's
three passes with an all-to-all between each two, and each rank gets its
rows of the whole image's DC, bit for bit; the noisy DC runs the same
pipeline on the plain ``torch.fft`` passes with the noisy merge. The JAX
package's ``set_spatial_mesh`` switches XLA lowerings only and has no
counterpart here.
"""

import numpy as np
import torch

from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.ops.dc_kernel import kspace_merge_reference
from csmri_refinement_tpu_torch.parallel import halo
from csmri_refinement_tpu_torch.utils import profiling

__all__ = ['data_consistency', 'data_consistency_complex',
           'data_consistency_np', 'kspace_merge_reference',
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


def data_consistency(x, k0, mask, noise_lvl=None):
  """Data-consistency step on packed tensors.

  x : (B, H, W, 2) float — current image estimate (real/imag channels)
  k0 : (B, H, W, 2) float — originally sampled k-space
  mask : (B, H, W, 1) float — 1 where k-space was sampled
  noise_lvl : None (the DC kernel), or the noisy merge's level (the
    ``torch.fft`` composition)

  Returns the (B, H, W, 2) float32 image with sampled k-space restored.
  Runs in the span ``csmri.dc.<route of H>.<route of W>`` of the whole
  image (``dc_kernel.span_name``), ``csmri.dc.noisy`` with a
  ``noise_lvl``.
  """
  with profiling.span(_span, x, k0, noise_lvl):
    f32 = lambda t: t.to(torch.float32).contiguous()
    mesh = halo.current()
    if noise_lvl is not None:
      if mesh is None:
        return _dc_composed(f32(x), k0, mask, noise_lvl)
      return dc_kernel.dc_distributed_noisy(f32(x), k0, mask, noise_lvl,
                                            mesh)
    if mesh is not None:
      return dc_kernel.dc_distributed(f32(x), f32(k0), f32(mask), mesh)
    return dc_kernel.dc_fused(f32(x), f32(k0), f32(mask))


def _span(x, k0, noise_lvl):
  """The DC's span name; k0 holds the whole image's rows, on a spatial
  mesh too, and x all its columns."""
  if noise_lvl is not None:
    return 'csmri.dc.noisy'
  return dc_kernel.span_name('dc', x.device.type, k0.shape[1], x.shape[2])


def _dc_composed(x, k0, mask, noise_lvl):
  """The noisy DC of whole images: the plain passes of the DC kernel
  (per-axis ``torch.fft``), as on a spatial mesh."""
  return dc_kernel.dc_rows_ifft_plain(dc_kernel.dc_cols_plain(
      dc_kernel.dc_rows_fft_plain(x), k0, mask, noise_lvl))


def data_consistency_complex(xc, k0c, m, noise_lvl=None):
  """The DC on complex64 (B, H, W) images with a (B, H, W) mask, through
  ``torch.fft``."""
  k = kspace_merge_reference(fft.fft2(xc), k0c, m, noise_lvl)
  return fft.ifft2(k)


def data_consistency_np(x, y, mask, norm='ortho'):
  """The DC of numpy arrays: ``ifft2((1 − mask)·fft2(x) + y)`` over the
  last two axes (the reference's uncentred golden formula)."""
  xf = np.fft.fft2(x, axes=(-2, -1), norm=norm)
  return np.fft.ifft2((1 - mask) * xf + y, axes=(-2, -1), norm=norm)
