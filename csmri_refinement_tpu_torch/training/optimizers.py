"""Optimizer factory.

Port of ``csmri_refinement_tpu/training/optimizers.py``: Adam with
configurable betas (``torch.optim.Adam``, eps 1e-8: the same update as
``optax.adam``), RMSProp with ``alpha`` (``torch.optim.RMSprop``, eps
1e-8; optax adds eps under the square root, torch outside it).
``set_learning_rate`` writes a scheduled learning rate into the
optimizer's ``param_groups``, as the JAX package writes it into its
``inject_hyperparams`` state.
"""

import torch


def get_optimizer(conf, optimizer_name, params):
  """The optimizer a config section names, over ``params``."""
  lr = conf.learning_rate
  if optimizer_name == 'Adam':
    betas = (conf.get_attr('beta1', default=0.9),
             conf.get_attr('beta2', default=0.999))
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
  if optimizer_name == 'RMSProp':
    return torch.optim.RMSprop(params, lr=lr,
                               alpha=conf.get_attr('alpha', default=0.99),
                               eps=1e-8)
  raise ValueError('Unknown optimizer {}'.format(optimizer_name))


def set_learning_rate(optimizer, lr):
  for group in optimizer.param_groups:
    group['lr'] = lr
  return optimizer
