"""Early stopping.

Port (a copy: pure Python) of ``csmri_refinement_tpu/training/
early_stopping.py``. Three modes:

* patience-based: stop after ``patience`` epochs without a new best value;
* min-value floor: stop when the metric sinks below ``min_value``;
* max-difference: stop when the metric both failed to improve for
  ``patience`` epochs and moved more than ``max_difference`` since the
  start of the patience window.
"""


class EarlyStopper:
  def __init__(self, metric_name, patience, min_value=None,
               max_difference=None):
    assert patience >= 1
    assert (min_value is None) or (max_difference is None)
    self.name = metric_name
    self.patience = patience
    self.values_by_epoch = {}
    self.best_value_epoch = 0
    self.min_value = min_value
    self.max_difference = max_difference

  def record_value(self, value, epoch):
    self.values_by_epoch[epoch] = value

  def record_best_value(self, best_value, epoch):
    self.best_value_epoch = epoch

  def should_stop(self, epoch):
    if self.best_value_epoch == 0:
      # Still in best-value warmup period
      return False

    no_improvement = self.best_value_epoch + self.patience <= epoch
    if self.min_value is not None:
      return self.values_by_epoch[epoch].value < self.min_value
    if self.max_difference is not None:
      current = self.values_by_epoch[epoch]
      patience_value = self.values_by_epoch[max(epoch - self.patience, 1)]
      diff = abs(current.value - patience_value.value)
      return diff > self.max_difference and no_improvement
    return no_improvement

  def stop_reason(self, epoch):
    best = self.values_by_epoch.get(self.best_value_epoch)
    if self.min_value is not None:
      return ('Early stopping in epoch {} because metric {} sank below '
              'minimum value {} (best {} in epoch {}, last {})').format(
                  epoch, self.name, self.min_value, best,
                  self.best_value_epoch, self.values_by_epoch[epoch])
    if self.max_difference is not None:
      return ('Early stopping in epoch {} because metric {} did not improve '
              'for {} epochs and the difference exceeded {} (best {} in '
              'epoch {}, last {})').format(
                  epoch, self.name, self.patience, self.max_difference,
                  best, self.best_value_epoch, self.values_by_epoch[epoch])
    return ('Early stopping in epoch {} because metric {} did not improve '
            'for {} epochs (best {} in epoch {})').format(
                epoch, self.name, self.patience, best, self.best_value_epoch)
