"""Streaming metric accumulators with direction-aware comparison.

Port (a copy) of ``csmri_refinement_tpu/metrics/metric.py``: an
accumulator is a (sum, count, last) triple plus a direction;
``MinMetric``/``MaxMetric`` only contribute the direction sign.
"""

import math


class Metric:
  """Running (sum, count) over scalar observations.

  Construct from a single number or any iterable of numbers. ``value``
  is the most recent observation if one exists, else the running mean;
  ``accumulate`` merges another accumulator into this one in place.
  """

  #: +1 if larger is better, -1 if smaller is better (set by subclasses).
  direction = 0

  def __init__(self, values):
    if _is_scalar(values):
      self._last = float(values)
      self.sum_values = self._last
      self.num_updates = 1
    else:
      vals = [float(v) for v in values]
      self._last = None
      self.sum_values = math.fsum(vals)
      self.num_updates = len(vals)

  @property
  def value(self):
    if self._last is not None:
      return self._last
    return self.sum_values / max(self.num_updates, 1)

  @property
  def worst_value(self):
    if not self.direction:
      raise NotImplementedError('Subclasses must override worst_value')
    return type(self)(-self.direction * math.inf)

  def accumulate(self, other):
    self._last = other._last
    self.sum_values += other.sum_values
    self.num_updates += other.num_updates

  def average(self):
    return type(self)(self.sum_values / max(self.num_updates, 1))

  def __gt__(self, other):
    """True iff self is BETTER than other (direction-aware)."""
    if not self.direction:
      raise NotImplementedError('Subclasses must override __gt__')
    return self.direction * (self.value - other.value) > 0

  def __str__(self):
    # adaptive precision: 4 decimals normally, more near zero so small
    # losses do not print as 0.0000 (matches reference log formatting)
    v = self.value
    for threshold, fmt in ((1e-4, '{:.4f}'), (1e-8, '{:.8f}')):
      if abs(v) >= threshold:
        return fmt.format(v)
    return '{:.12f}'.format(v)


def _is_scalar(values):
  try:
    iter(values)
  except TypeError:
    return True
  return False


class MinMetric(Metric):
  """Smaller is better (losses, HFEN)."""
  direction = -1


class MaxMetric(Metric):
  """Larger is better (PSNR, SSIM, dice, accuracy)."""
  direction = 1
