"""Config → output transforms.

Port of ``csmri_refinement_tpu/data/transform_wrappers.py``: an output
transform maps (prediction, target) to the space metrics are computed in.

* reconstruction: packed complex (..., 2) → magnitude (..., 1), clamped to
  (0, 1);
* segmentation: NHWC logits → softmax → argmax class map with a trailing
  channel dim; a (B, H, W) target gains the same dim;
* none: no transform.
"""

import torch


def _mag_clamp(x):
  mag = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)[..., None]
  return torch.clamp(mag, 0.0, 1.0)


def rec_output_transform(pred, target):
  return _mag_clamp(pred.float()), _mag_clamp(target.float())


def seg_output_transform(pred, target):
  classes = torch.argmax(torch.softmax(pred.float(), dim=-1), dim=-1)
  if target.dim() == 3:
    target = target[..., None]
  return classes[..., None], target


def get_output_transform(application):
  if application == 'reconstruction':
    return rec_output_transform
  if application == 'segmentation':
    return seg_output_transform
  if application == 'none':
    return None
  raise ValueError('Unknown application {!r}'.format(application))
