"""Metric registry and wrapper.

Port of ``csmri_refinement_tpu/metrics/__init__.py`` for the
reconstruction metrics: ``get_metric_fn`` resolves a metric name to a
``MetricFunction`` that unwraps dict outputs by key, applies the
application's output transform (magnitude + clamp for reconstruction) and
computes the metric per example over the batch, returning a Min/Max
accumulator. Per-metric ``<name>_metric`` config keys (``pred_key``,
``target_key``, ``transform``) override the defaults. HFEN, mutual
information, dice and the segmentation score are not ported yet.
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
    arrays; ``transform=False`` skips the output transform (the
    discriminator's probabilities)."""
    if isinstance(prediction, dict):
      prediction = prediction[self.pred_key]
    if isinstance(target, dict):
      target = target[self.target_key]
    pairs = zip(prediction[:, None], target[:, None]) \
        if prediction.dim() in (3, 4) else [(prediction, target)]
    values = []
    with torch.no_grad():
      for p, t in pairs:
        if transform and self.transform is not None:
          p, t = self.transform(p, t)
        values.append(self.metric_fn(p, t))
    return self.metric_type(values)


def _image_metric(name):
  from csmri_refinement_tpu_torch.metrics import image_metrics
  return getattr(image_metrics, name)


def _disc_accuracy_metric(conf, metric_name):
  from csmri_refinement_tpu_torch.metrics.scalar_metrics import disc_accuracy
  fake = metric_name in ('accuracy_fake', 'binary_accuracy', 'accuracy')
  real = metric_name in ('accuracy_real', 'accuracy')
  return partial(disc_accuracy, fake_accuracy=fake, real_accuracy=real)


_METRICS = {
    'psnr': (lambda conf, name: _image_metric('compute_psnr'), MaxMetric),
    'ssim': (lambda conf, name: _image_metric('compute_ssim'), MaxMetric),
    'binary_accuracy': (_disc_accuracy_metric, MaxMetric),
    'accuracy': (_disc_accuracy_metric, MaxMetric),
    'accuracy_fake': (_disc_accuracy_metric, MaxMetric),
    'accuracy_real': (_disc_accuracy_metric, MaxMetric),
}


def get_metric_fn(conf, metric_name, pred_key='pred', target_key='target'):
  """Build a MetricFunction from config."""
  from csmri_refinement_tpu_torch.data.transform_wrappers import (
      get_output_transform)
  if metric_name not in _METRICS:
    raise NotImplementedError('metric {} is not ported yet'.format(
        metric_name))
  metric_constructor, metric_type = _METRICS[metric_name]
  metric_fn = metric_constructor(conf, metric_name)
  metric_conf = conf.get_attr('{}_metric'.format(metric_name), default={})
  pred_key = metric_conf.get('pred_key', pred_key)
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
