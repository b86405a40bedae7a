"""Metric registry and wrapper.

Port of ``csmri_refinement_tpu/metrics/__init__.py``: ``get_metric_fn``
resolves a metric name to a ``MetricFunction`` that unwraps dict outputs by
key, applies the application's output transform (magnitude + clamp for
reconstruction, softmax → argmax for segmentation) and computes the metric
per example over the batch, returning a Min/Max accumulator; an example
scored ``None`` (the segmentation score's skipped images) is dropped.
Per-metric ``<name>_metric`` config keys (``pred_key``, ``target_key``,
``transform``) override the defaults. ``segmentation_score`` reads the
batch's ``label`` without a transform unless its section says otherwise
(JAX ``metrics/__init__.py:176-205``), and runs its network once per batch
(``per_batch``). HFEN and mutual information (``on_host``) fetch the batch
to the host once and score each example there, as the JAX package does.
"""

from functools import partial

import torch

from csmri_refinement_tpu_torch.metrics.metric import MaxMetric, MinMetric


class MetricFunction:
  """A per-example metric with key selection and output transform."""

  def __init__(self, metric_fn, metric_type, transform=None,
               pred_key='pred', target_key='target'):
    self.metric_fn = metric_fn
    self.metric_type = metric_type
    self.transform = transform
    self.pred_key = pred_key
    self.target_key = target_key

  def __call__(self, prediction, target, transform=True):
    """Per example for image batches (3-D or 4-D), else on the whole
    arrays; a ``per_batch`` metric takes the whole batch and returns one
    value per example. ``transform=False`` skips the output transform (the
    discriminator's probabilities)."""
    if isinstance(prediction, dict):
      prediction = prediction[self.pred_key]
    if isinstance(target, dict):
      target = target[self.target_key]
    transform = self.transform if transform else None
    if getattr(self.metric_fn, 'on_host', False):
      prediction, target = prediction.cpu(), target.cpu()
    with torch.no_grad():
      if getattr(self.metric_fn, 'per_batch', False):
        if transform is not None:
          prediction, target = transform(prediction, target)
        values = self.metric_fn(prediction, target)
      else:
        pairs = zip(prediction[:, None], target[:, None]) \
            if prediction.dim() in (3, 4) else [(prediction, target)]
        values = [self.metric_fn(*(transform(p, t) if transform else (p, t)))
                  for p, t in pairs]
    return self.metric_type([v for v in values if v is not None])


def _image_metric(name):
  from csmri_refinement_tpu_torch.metrics import image_metrics
  return getattr(image_metrics, name)


def _disc_accuracy_metric(conf, metric_name):
  from csmri_refinement_tpu_torch.metrics.scalar_metrics import disc_accuracy
  fake = metric_name in ('accuracy_fake', 'binary_accuracy', 'accuracy')
  real = metric_name in ('accuracy_real', 'accuracy')
  return partial(disc_accuracy, fake_accuracy=fake, real_accuracy=real)


def _dice_metric(class_idx):
  from csmri_refinement_tpu_torch.metrics.segmentation_metrics import (
      compute_dice)
  return partial(compute_dice, class_idx=class_idx)


def _average_dice_metric(conf, metric_name):
  from csmri_refinement_tpu_torch.metrics.segmentation_metrics import (
      compute_average_dice)
  if not conf.has_attr('dice_metric'):
    raise ValueError('Dice metric needs additional config under key '
                     '"dice_metric"')
  metric_conf = conf.dice_metric
  if 'num_classes' not in metric_conf:
    raise ValueError('Dice metric needs number of classes under key '
                     '"num_classes"')
  exclude_bg = metric_conf.get('exclude_background', False)
  return partial(compute_average_dice,
                 num_classes=metric_conf['num_classes'],
                 excluded_class=0 if exclude_bg else -1)


def _segmentation_score_metric(conf, metric_name):
  from csmri_refinement_tpu_torch.metrics.segmentation_score import (
      SegmentationScore)
  if not conf.has_attr('segmentation_score_metric'):
    raise ValueError('Segmentation score metric needs additional config '
                     'under key "segmentation_score_metric"')
  metric_conf = conf.segmentation_score_metric
  return SegmentationScore(
      metric_conf['model'], conf.file, class_idx=metric_conf.get('class'),
      save_segmentations_path=metric_conf.get('save_segmentations_path'),
      skip_empty_images=metric_conf.get('skip_empty_images', False))


_METRICS = {
    'psnr': (lambda conf, name: _image_metric('compute_psnr'), MaxMetric),
    'ssim': (lambda conf, name: _image_metric('compute_ssim'), MaxMetric),
    'hfen': (lambda conf, name: _image_metric('compute_hfen'), MinMetric),
    'mutual_information': (
        lambda conf, name: _image_metric('compute_mutual_information'),
        MaxMetric),
    'binary_accuracy': (_disc_accuracy_metric, MaxMetric),
    'accuracy': (_disc_accuracy_metric, MaxMetric),
    'accuracy_fake': (_disc_accuracy_metric, MaxMetric),
    'accuracy_real': (_disc_accuracy_metric, MaxMetric),
    'dice': (_average_dice_metric, MaxMetric),
    'dice_class_0': (lambda conf, name: _dice_metric(0), MaxMetric),
    'dice_class_1': (lambda conf, name: _dice_metric(1), MaxMetric),
    'dice_class_2': (lambda conf, name: _dice_metric(2), MaxMetric),
    'dice_class_3': (lambda conf, name: _dice_metric(3), MaxMetric),
    'segmentation_score': (_segmentation_score_metric, MaxMetric),
}


def get_metric_fn(conf, metric_name, pred_key='pred', target_key='target'):
  """Build a MetricFunction from config."""
  from csmri_refinement_tpu_torch.data.transform_wrappers import (
      get_output_transform)
  if metric_name not in _METRICS:
    raise ValueError('Unknown metric {}'.format(metric_name))
  metric_constructor, metric_type = _METRICS[metric_name]
  metric_fn = metric_constructor(conf, metric_name)
  metric_conf = conf.get_attr('{}_metric'.format(metric_name), default={})
  pred_key = metric_conf.get('pred_key', pred_key)
  if metric_name == 'segmentation_score':
    # SIS scores the raw reconstruction against the label map
    target_key = metric_conf.get('target_key', 'label')
    application = metric_conf.get('transform', 'none')
  else:
    target_key = metric_conf.get('target_key', target_key)
    application = metric_conf.get('transform', conf.application)
  transform = get_output_transform(application)
  return MetricFunction(metric_fn, metric_type, transform, pred_key,
                        target_key)


def get_loss_metric(value):
  return MinMetric(value)


def accumulate_metric(dictionary, metric_name, metric):
  if metric_name in dictionary:
    dictionary[metric_name].accumulate(metric)
  else:
    dictionary[metric_name] = metric
