"""SegmentationScore: the semantic interpretability score (SIS).

Port of ``csmri_refinement_tpu/metrics/segmentation_score.py``: a frozen
segmentation U-Net used as a metric network. A reconstruction goes through
the network in eval mode, argmax over its logits gives a class map, and
the dice against the ground-truth label is taken per requested class with
``absent_value=1.0`` and averaged over those classes.

The network is built on the first call, on the device of the
reconstruction it scores, from the ``model`` section's seeded init and its
``pretrained_weights`` (a port checkpoint, ``training/model_setup.py``).
Its forward runs in full f32 (``utils/precision.full_f32``), as JAX runs it
at matmul precision ``'high'``: TF32 would move argmax decisions at class
boundaries. On the card its eval-mode conv chains launch the conv-chain
kernel (``ops/conv_chain.py``, f32 route).

The JAX package scores one example per call. Here a call takes a batch and
returns one score per example (``per_batch``, read by
``metrics.MetricFunction``): the network runs once on the examples that
are scored, in eval mode, where each example's logits do not depend on the
others, and the dice is taken per example. With ``skip_empty_images`` an
example whose label holds none of the requested classes scores ``None``
(dropped from the mean) and is not run. ``save_segmentations_path`` writes
each scored example's class map as ``{n:04d}_segm.npy`` (uint8), numbered
from 1 in the order scored.
"""

import os

import numpy as np
import torch

from csmri_refinement_tpu_torch.metrics.segmentation_metrics import (
    dice_counts, dice_from_counts)
from csmri_refinement_tpu_torch.utils.precision import full_f32


class SegmentationScore:

  per_batch = True

  def __init__(self, model_conf, conf_path, class_idx,
               save_segmentations_path=None, skip_empty_images=False):
    """``model_conf``: a model section (dict) of the segmentation network,
    ``pretrained_weights`` relative to the config file ``conf_path``;
    ``class_idx``: a class index or a list of them."""
    self.model_conf = dict(model_conf)
    self.conf_path = conf_path
    self.class_idxs = class_idx if isinstance(class_idx, list) \
        else [class_idx]
    self.skip_empty_images = skip_empty_images
    self.model = None
    self.save_segmentations_path = save_segmentations_path
    if save_segmentations_path is not None:
      parent_dir = os.path.dirname(save_segmentations_path)
      if not os.path.isdir(parent_dir):
        raise FileNotFoundError('Did not find path {}'.format(parent_dir))
      os.makedirs(save_segmentations_path, exist_ok=True)
      self.num_saved_segmns = 0

  def network(self, device):
    """The frozen segmentation network on ``device``, built on first use."""
    if self.model is None:
      from csmri_refinement_tpu_torch.models import construct_model
      from csmri_refinement_tpu_torch.training.model_setup import (
          apply_pretrained_weights)
      model = construct_model(self.model_conf)
      model.init_weights(torch.Generator().manual_seed(0))
      apply_pretrained_weights(model, self.model_conf, self.conf_path)
      self.model = model.to(device).eval().requires_grad_(False)
    return self.model

  def predict(self, prediction):
    """(B, H, W) class maps of (B, H, W, C) reconstructions."""
    with torch.no_grad(), full_f32():
      logits = self.network(prediction.device)(prediction.float())
    if isinstance(logits, dict):
      logits = logits['pred']
    return torch.argmax(logits, dim=-1)

  def _save_segmentations(self, segmentations):
    for segmentation in segmentations.cpu().numpy():
      self.num_saved_segmns += 1
      path = os.path.join(self.save_segmentations_path,
                          '{:04d}_segm.npy'.format(self.num_saved_segmns))
      np.save(path, segmentation.astype(np.uint8))

  def __call__(self, prediction, target):
    """prediction: (B, H, W, C) reconstructions; target: (B, H, W) label
    maps. Returns B scores, ``None`` for a skipped example."""
    keep = list(range(prediction.shape[0]))
    if self.skip_empty_images:
      present = torch.stack([(target == c).flatten(1).any(1)
                             for c in self.class_idxs]).any(0).tolist()
      keep = [i for i in keep if present[i]]
    scores = [None] * prediction.shape[0]
    if not keep:
      return scores
    if len(keep) < len(scores):
      index = torch.tensor(keep, device=prediction.device)
      prediction, target = prediction[index], target[index.to(target.device)]
    classes = self.predict(prediction)
    if self.save_segmentations_path is not None:
      self._save_segmentations(classes)
    target = target.to(classes.device)
    counts = torch.stack([dice_counts(classes, target, c)
                          for c in self.class_idxs], 1).tolist()
    for i, per_class in zip(keep, counts):
      scores[i] = sum(dice_from_counts(inter, denom, absent_value=1.0)
                      for inter, denom in per_class) / len(per_class)
    return scores
