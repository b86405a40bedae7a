"""Optimizer factory.

Port of ``csmri_refinement_tpu/training/optimizers.py``: Adam with
configurable betas (``torch.optim.Adam``, eps 1e-8: the same update as
``optax.adam``), RMSProp with ``alpha`` (``RMSProp`` below, eps 1e-8
under the square root as ``optax.rmsprop`` has it; ``torch.optim.RMSprop``
adds it outside, which moves the step by orders of magnitude at small
|g|). ``set_learning_rate`` writes a scheduled learning rate into the
optimizer's ``param_groups``, as the JAX package writes it into its
``inject_hyperparams`` state.
"""

import torch


class RMSProp(torch.optim.Optimizer):
  """``optax.rmsprop``: ``nu = decay·nu + (1 − decay)·g²`` from ``nu = 0``,
  then ``p −= lr · g / √(nu + eps)``."""

  def __init__(self, params, lr, decay=0.9, eps=1e-8):
    super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

  @torch.no_grad()
  def step(self, closure=None):
    loss = None
    if closure is not None:
      with torch.enable_grad():
        loss = closure()
    for group in self.param_groups:
      for p in group['params']:
        if p.grad is None:
          continue
        state = self.state[p]
        if not state:
          state['nu'] = torch.zeros_like(p)
        nu = state['nu']
        nu.mul_(group['decay']).addcmul_(p.grad, p.grad,
                                         value=1 - group['decay'])
        p.addcdiv_(p.grad, (nu + group['eps']).sqrt_(), value=-group['lr'])
    return loss


def get_optimizer(conf, optimizer_name, params):
  """The optimizer a config section names, over ``params``."""
  lr = conf.learning_rate
  if optimizer_name == 'Adam':
    betas = (conf.get_attr('beta1', default=0.9),
             conf.get_attr('beta2', default=0.999))
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
  if optimizer_name == 'RMSProp':
    return RMSProp(params, lr=lr, decay=conf.get_attr('alpha', default=0.99),
                   eps=1e-8)
  raise ValueError('Unknown optimizer {}'.format(optimizer_name))


def set_learning_rate(optimizer, lr):
  for group in optimizer.param_groups:
    group['lr'] = lr
  return optimizer
