"""Image-quality metrics: PSNR, SSIM, HFEN and mutual information.

Port of ``csmri_refinement_tpu/metrics/image_metrics.py``. PSNR and SSIM
(``:20-44``) run on NHWC tensors on their device, in float32 with TF32 off
(``utils/precision.py``). HFEN and mutual information (``:42-64``) run on
the host in numpy and scipy, as in the JAX package; ``on_host`` tells
``MetricFunction`` to fetch the batch once before it scores the examples.
Each returns a Python float.

Mutual information is the JAX package's ``sklearn.metrics.
mutual_info_score(None, None, contingency=p_xy)`` written out in numpy
(``mutual_info_of_contingency``), so the port needs no scikit-learn.
"""

import math

import numpy as np
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


def _host(x):
  """A float32 numpy array of a tensor (or array)."""
  if torch.is_tensor(x):
    return x.detach().to('cpu', torch.float32).numpy()
  return np.asarray(x)


def compute_hfen(prediction, target):
  """Normalised high-frequency error norm: a 15×15 Laplacian of Gaussian,
  sigma 1.5 (truncate 4.5), over every axis of the arrays."""
  from scipy.ndimage import gaussian_laplace
  pred_filtered = gaussian_laplace(_host(prediction), truncate=4.5,
                                   sigma=1.5)
  target_filtered = gaussian_laplace(_host(target), truncate=4.5, sigma=1.5)
  norm_diff = np.linalg.norm((pred_filtered - target_filtered).ravel())
  norm_target = np.linalg.norm(target_filtered.ravel())
  return float(norm_diff / norm_target)


def mutual_info_of_contingency(contingency):
  """Mutual information (nats) of a 2D contingency table, as
  ``sklearn.metrics.mutual_info_score(None, None, contingency=...)``
  computes it: the table is cast to integers first (a float table is
  truncated), logs are taken of the non-zero cells, terms below the f64
  epsilon are dropped and the sum is clipped at 0."""
  c = np.asarray(contingency).astype(np.int64)
  nzx, nzy = np.nonzero(c)
  nz_val = c[nzx, nzy]
  total = c.sum()
  pi = np.ravel(c.sum(axis=1))
  pj = np.ravel(c.sum(axis=0))
  if pi.size == 1 or pj.size == 1:
    return 0.0
  log_c = np.log(nz_val)
  c_nm = nz_val / total
  outer = pi.take(nzx) * pj.take(nzy)
  log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
  mi = c_nm * (log_c - math.log(total)) + c_nm * log_outer
  mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
  return float(np.clip(mi.sum(), 0.0, None))


def compute_mutual_information(prediction, target):
  """Mutual information of a 256-bin joint histogram over (0, 1)², with
  ``density=True``."""
  p_xy, _, _ = np.histogram2d(_host(prediction).ravel(),
                              _host(target).ravel(), bins=256,
                              range=((0, 1), (0, 1)), density=True)
  return mutual_info_of_contingency(p_xy)


compute_hfen.on_host = True
compute_mutual_information.on_host = True
