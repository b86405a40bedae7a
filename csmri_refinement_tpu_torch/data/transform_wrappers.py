"""Config → output transforms.

Port of ``csmri_refinement_tpu/data/transform_wrappers.py``: an output
transform maps (prediction, target) to the space metrics are computed in.

* reconstruction: packed complex (..., 2) → magnitude (..., 1), clamped to
  (0, 1);
* none: no transform.

The segmentation transform waits for the segmentation slice (ROADMAP
Queue 1 item 7).
"""

import torch


def _mag_clamp(x):
  mag = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)[..., None]
  return torch.clamp(mag, 0.0, 1.0)


def rec_output_transform(pred, target):
  return _mag_clamp(pred.float()), _mag_clamp(target.float())


def get_output_transform(application):
  if application == 'reconstruction':
    return rec_output_transform
  if application == 'none':
    return None
  raise NotImplementedError(
      'output transform for {!r} is not ported yet'.format(application))
