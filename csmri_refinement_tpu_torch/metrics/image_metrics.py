"""Image-quality metrics: PSNR and SSIM.

Port of ``csmri_refinement_tpu/metrics/image_metrics.py:20-44`` on NHWC
tensors, computed in float32 with TF32 off (``utils/precision.py``), each
returning a Python float. HFEN and mutual information (host scipy/sklearn in
the JAX package) are not ported yet.
"""

import torch

from csmri_refinement_tpu_torch.ops import ssim as ssim_ops
from csmri_refinement_tpu_torch.utils.precision import full_f32


def compute_psnr(prediction, target):
  """PSNR assuming a (0, 1) range: 10·log10(1/mse)."""
  mse = torch.mean((prediction.float() - target.float()) ** 2)
  return float(10.0 * torch.log10(1.0 / mse))


def compute_ssim(prediction, target, window_size=11):
  """Gaussian-windowed SSIM."""
  with full_f32():
    return float(ssim_ops.ssim(prediction, target, window_size=window_size))
