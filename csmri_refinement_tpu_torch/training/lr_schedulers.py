"""Per-epoch learning-rate schedules.

Port (a copy: pure Python) of ``csmri_refinement_tpu/training/
lr_schedulers.py``:

* ``multistep`` — multiply by ``decay_factor`` at each epoch in
  ``decay_steps``;
* ``linear`` / ``polynomial`` — decay from ``learning_rate`` to
  ``end_learning_rate`` over ``decay_steps`` epochs, optionally starting at
  ``start_decay``.

Schedulers are ``lr(epoch) → float`` callables, stepped before each epoch by
the runner.
"""

import bisect


class MultiStepLR:
  def __init__(self, base_lr, decay_steps, decay_factor):
    self.base_lr = base_lr
    self.decay_steps = sorted(decay_steps)
    self.decay_factor = decay_factor

  def __call__(self, epoch):
    num_decays = bisect.bisect_right(self.decay_steps, epoch)
    return self.base_lr * (self.decay_factor ** num_decays)


class PolynomialDecayLR:
  def __init__(self, base_lr, end_lr, decay_epochs, from_epoch=0, power=1.0):
    self.base_lr = base_lr
    self.end_lr = end_lr
    self.from_epoch = from_epoch
    self.end_epoch = float(from_epoch + decay_epochs)
    self.power = power

  def __call__(self, epoch):
    if epoch < self.from_epoch:
      return self.base_lr
    epoch = min(float(epoch), self.end_epoch)
    frac = 1.0 - (epoch - self.from_epoch) / \
        (self.end_epoch - self.from_epoch)
    return (self.base_lr - self.end_lr) * (frac ** self.power) + self.end_lr


def get_lr_scheduler(optimizer_conf, scheduler_name):
  if scheduler_name == 'multistep':
    return MultiStepLR(optimizer_conf.learning_rate,
                       optimizer_conf.decay_steps,
                       optimizer_conf.decay_factor)
  if scheduler_name in ('linear', 'polynomial'):
    power = 1.0 if scheduler_name == 'linear' else optimizer_conf.decay_power
    return PolynomialDecayLR(
        optimizer_conf.learning_rate,
        optimizer_conf.end_learning_rate,
        optimizer_conf.decay_steps,
        optimizer_conf.get_attr('start_decay', default=0),
        power)
  raise ValueError(
      'Unknown learning rate scheduler {}'.format(scheduler_name))
