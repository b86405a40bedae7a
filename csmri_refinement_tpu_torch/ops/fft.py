"""FFT helpers and complex ⇄ real packing on channel-last layout.

Port of ``csmri_refinement_tpu/ops/fft.py:168-231`` on ``torch.fft``
(cuFFT on the card). The JAX package's matmul-DFT and radix splits
(``fft.py:127-165``) exist only because the TPU has no FFT unit and are not
ported.

Conventions (as in the JAX package):

* complex images are ``complex64`` tensors ``(..., H, W)``;
* packed images are ``float32`` tensors ``(..., H, W, 2)`` with
  ``[..., 0] = real`` and ``[..., 1] = imag``;
* ``fft2``/``ifft2`` are ortho-normalised and unshifted; ``fft2c`` and
  ``ifft2c`` are their centred variants over any two ``axes``.
"""

import torch


def pack_complex(x):
  """complex (..., H, W) → float32 (..., H, W, 2)."""
  return torch.stack([x.real, x.imag], dim=-1).to(torch.float32)


def unpack_complex(x):
  """float (..., H, W, 2) → complex64 (..., H, W).

  A single-channel tensor (..., H, W, 1) is treated as real-valued (masks).
  """
  if x.shape[-1] == 1:
    return x[..., 0].to(torch.complex64)
  return torch.complex(x[..., 0].float(), x[..., 1].float())


def fft2(x):
  """Ortho-normalised, unshifted 2D FFT over the last two axes."""
  return torch.fft.fft2(x, dim=(-2, -1), norm='ortho')


def ifft2(x):
  """Ortho-normalised, unshifted 2D inverse FFT over the last two axes."""
  return torch.fft.ifft2(x, dim=(-2, -1), norm='ortho')


def fft2c(x, axes=(-2, -1)):
  """Centred ortho 2D FFT: ifftshift, fft2, fftshift over ``axes``."""
  return torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(x, dim=axes),
                                           dim=axes, norm='ortho'), dim=axes)


def ifft2c(x, axes=(-2, -1)):
  """Centred ortho 2D inverse FFT: ifftshift, ifft2, fftshift over
  ``axes``."""
  return torch.fft.fftshift(torch.fft.ifft2(torch.fft.ifftshift(x, dim=axes),
                                            dim=axes, norm='ortho'), dim=axes)


def complex_abs(x, keepdims=True):
  """Magnitude of a packed complex image (..., H, W, 2) → (..., H, W, 1),
  in f32.

  Taken as torch's complex ``abs``, whose gradient at 0 + 0i is 0; the JAX
  package's ``sqrt(re² + im²)`` has a NaN gradient there. The values agree
  to rounding. Exact zeros do occur: the DC kernel's output holds some on
  a phantom's zero background, and one NaN would reach every weight
  through the VGG loss or the discriminator's magnitude input.
  """
  mag = torch.view_as_complex(x.float().contiguous()).abs()
  if keepdims:
    mag = mag[..., None]
  return mag
