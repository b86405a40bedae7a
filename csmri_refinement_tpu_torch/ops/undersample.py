"""k-space forward model: retrospective undersampling.

Port of ``csmri_refinement_tpu/ops/undersample.py``: a batch of
ground-truth magnitude slices becomes the dict ``{inp, kspace, mask,
target}`` on the slices' device; ``center_crop_in_kspace`` crops a slice's
centred spectrum (the host pipeline's numpy twin is
``data/transforms.py::center_crop_in_kspace_np``).
"""

import math

import torch

from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.ops import masks as mask_ops


def shard_rows(draw, shape, shard):
  """``draw(shape)`` of the global batch cut to the rank's rows of
  ``shard=(rank, world)`` (``shape`` the rank's own)."""
  rank, world = shard or (0, 1)
  b = shape[0]
  return draw((b * world,) + tuple(shape[1:]))[rank * b:(rank + 1) * b]


def undersample(x, mask, generator=None, noise=0.0, shard=None):
  """Undersample complex image(s) ``x`` (..., H, W) with k-space ``mask``.

  ``noise`` > 0 adds complex AWGN of that power (fraction of peak signal),
  drawn from ``generator`` (for the global batch, kept for the rank's rows,
  with ``shard``). Returns (x_und, k_und), both complex.
  """
  k = fft.fft2(x)
  if noise and generator is not None:
    shape = tuple(x.shape)
    randn = lambda s: torch.randn(s, generator=generator, device=x.device)
    nr = shard_rows(randn, shape, shard)
    ni = shard_rows(randn, shape, shard)
    nz = math.sqrt(0.5) * torch.complex(nr, ni)
    # ortho-norm multiplicative factor
    k = k + nz * math.sqrt(noise) * math.sqrt(shape[-2] * shape[-1])
  k_und = mask * k
  x_und = fft.ifft2(k_und)
  return x_und, k_und


def undersample_batch(generator, gt, sampling_scheme='varden',
                      acceleration_factor=8, variable_acceleration=False,
                      noise=0.0, fixed_mask=None, shard=None):
  """Forward model for a batch of ground-truth slices.

  generator : torch.Generator on ``gt.device`` (masks and noise); may be
    None with ``fixed_mask`` and no noise
  gt : float (B, H, W) or (B, H, W, 1) — real slices in (0, 1)
  fixed_mask : optional (B, H, W) mask used instead of drawing one
  shard : ``(rank, world)`` of a data-parallel run: masks and noise are
    drawn for the global batch of ``B · world`` slices and the rank's
    rows kept, so that the draws do not depend on the world

  Returns NHWC float32 tensors:
    inp (B, H, W, 2), kspace (B, H, W, 2), mask (B, H, W, 1),
    target (B, H, W, 2).
  """
  if gt.ndim == 4:
    gt = gt[..., 0]
  batch, height, width = gt.shape

  if fixed_mask is not None:
    mask = torch.as_tensor(fixed_mask, dtype=torch.float32, device=gt.device)
  else:
    mask = shard_rows(lambda s: mask_ops.make_masks(
        generator, s[0], height, width, sampling_scheme=sampling_scheme,
        acceleration_factor=acceleration_factor,
        variable_acceleration=variable_acceleration, device=gt.device),
                 gt.shape, shard)

  x = gt.to(torch.complex64)
  x_und, k_und = undersample(x, mask, generator=generator, noise=noise,
                             shard=shard)
  return {
      'inp': fft.pack_complex(x_und),
      'kspace': fft.pack_complex(k_und),
      'mask': mask[..., None].to(torch.float32).contiguous(),
      'target': fft.pack_complex(x),
  }


def center_crop_in_kspace(img, size):
  """|ifft2c(centre crop(fft2c(img)))|: a real (H, W) tensor to
  (size, size) (or ``size`` = (h, w)), in f32."""
  if isinstance(size, int):
    size = (size, size)
  k = fft.fft2c(img.to(torch.complex64), axes=(0, 1))
  h, w = img.shape[0], img.shape[1]
  th, tw = size
  top, left = h // 2 - th // 2, w // 2 - tw // 2
  return fft.ifft2c(k[top:top + th, left:left + tw], axes=(0, 1)).abs()
