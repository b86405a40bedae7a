"""Differentiable SSIM via grouped gaussian convolutions.

Port of ``csmri_refinement_tpu/ops/ssim.py``: 11×11 gaussian window with
sigma 1.5, per-channel grouped conv with SAME (half-window zero) padding,
C1 = 0.01², C2 = 0.03², on NHWC tensors, in float32. The JAX version pins
its conv to bf16x3 precision on the TPU; here the caller runs it with TF32
off (``metrics`` does) so the conv is full f32.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size, sigma=1.5):
  g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) /
             (2.0 * sigma ** 2))
  g = g / g.sum()
  return np.outer(g, g).astype(np.float32)


def _filter(img, window):
  """Depthwise conv of an NCHW image with an HW window, zero SAME pad."""
  c = img.shape[1]
  kernel = window.expand(c, 1, *window.shape[-2:])
  return F.conv2d(img, kernel, padding=window.shape[-1] // 2, groups=c)


def ssim(img1, img2, window_size=11):
  """Mean SSIM over an NHWC batch."""
  window = torch.from_numpy(_gaussian_window(window_size)).to(img1.device)
  img1 = img1.float().permute(0, 3, 1, 2)
  img2 = img2.float().permute(0, 3, 1, 2)

  mu1 = _filter(img1, window)
  mu2 = _filter(img2, window)
  mu1_sq = mu1 * mu1
  mu2_sq = mu2 * mu2
  mu1_mu2 = mu1 * mu2
  sigma1_sq = _filter(img1 * img1, window) - mu1_sq
  sigma2_sq = _filter(img2 * img2, window) - mu2_sq
  sigma12 = _filter(img1 * img2, window) - mu1_mu2

  c1 = 0.01 ** 2
  c2 = 0.03 ** 2
  ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
      ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
  return ssim_map.mean()
