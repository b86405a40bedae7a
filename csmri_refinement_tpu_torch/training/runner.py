"""Standard runner: single-model training, one eager update per batch.

Port of ``csmri_refinement_tpu/training/runner.py``. The train step
(``runner.py:195-227``): forward, float32 loss epilogue, weighted criteria,
backward, optimizer step. The validation step (``runner.py:288-304``):
forward and criteria without gradients (no criteria with
``compute_metrics=False``, the inference loop's step). ``predict`` is the
model's eval-mode output on a prepared batch, for the validate CLI
(``runner.py:334-409``).

Precision. The validation step always runs in full float32
(``utils/precision.py::full_f32``: TF32 off), as the JAX package pins
evaluation to its ``'high'`` precision. The train step runs at the
process's PyTorch settings: by default cuDNN runs an f32 model's
convolutions in TF32 on the card, the counterpart of the TPU's default
single-pass bf16 precision in the JAX train step; a caller that wants full
f32 training sets ``torch.backends.cudnn.allow_tf32 = False``. The DC runs
in f32 either way (K1 and K1-bwd are f32 FFTs).

Masks of a train step come from a ``torch.Generator`` seeded with the run's
seed and the step count, so a resumed run continues the same stream.
``steps_per_fetch``, ``train_remat`` and ``train_dtype`` are not ported yet
and raise.
"""

import logging

import torch

from csmri_refinement_tpu_torch.metrics import get_loss_metric, get_metric_fn
from csmri_refinement_tpu_torch.models import construct_model, get_input_keys
from csmri_refinement_tpu_torch.models.criteria import get_criterion
from csmri_refinement_tpu_torch.training.base_runner import BaseRunner
from csmri_refinement_tpu_torch.training.lr_schedulers import (
    get_lr_scheduler)
from csmri_refinement_tpu_torch.training.model_setup import (
    apply_pretrained_weights)
from csmri_refinement_tpu_torch.training.optimizers import (get_optimizer,
                                                            set_learning_rate)
from csmri_refinement_tpu_torch.training.prep import get_batch_preparer
from csmri_refinement_tpu_torch.utils.checkpoints import (
    load_network_state, load_optimizer_state)
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.precision import full_f32


def _cast_f32(tree):
  """Float outputs to float32 at the loss boundary (no-op for f32)."""
  if isinstance(tree, dict):
    return {k: _cast_f32(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_cast_f32(v) for v in tree)
  if tree.is_floating_point() and tree.dtype != torch.float32:
    return tree.float()
  return tree


def _detach(tree):
  if isinstance(tree, dict):
    return {k: _detach(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_detach(v) for v in tree)
  return tree.detach()


def _loss_metrics(losses):
  """{'loss_<criterion>' and 'loss': MinMetric}, in one host fetch."""
  if not losses:
    return {}
  values = torch.stack([v.float() for v in losses.values()]).tolist()
  return {name if name == 'loss' else 'loss_' + name: get_loss_metric(value)
          for name, value in zip(losses, values)}


class Runner(BaseRunner):
  """Single input/output network with a weighted multi-criterion loss, on
  ``device`` (the card unless the caller asks for the CPU)."""

  def __init__(self, conf, mode='train', device='cuda'):
    super().__init__(conf, mode)
    self.device = torch.device(device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError('Runner: no CUDA device; pass device="cpu" to run '
                         'the plain versions on the CPU')
    if conf.get_attr('steps_per_fetch', default=1) != 1 or \
        conf.get_attr('train_remat') or conf.get_attr('train_dtype'):
      raise NotImplementedError('steps_per_fetch, train_remat and '
                                'train_dtype are not ported yet')
    model_conf = dict(conf.model)
    # The run's undersampling section gives RecNet its dc_lines_acc, as
    # the JAX runner threads it (runner.py:49-53).
    if conf.has_attr('undersampling'):
      model_conf.setdefault('undersampling', conf.undersampling)
    self.model = construct_model(model_conf)
    self.model.init_weights(torch.Generator().manual_seed(conf.seed))
    apply_pretrained_weights(self.model, model_conf, conf.file)
    self.model.to(self.device)
    self.input_keys = get_input_keys(self.model)
    self.val_metric_fns = {
        name: get_metric_fn(conf, name)
        for name in conf.get_attr('validation_metrics', default=[])}
    self.preparer = get_batch_preparer(conf, self.device)
    self.step = 0

    self.criteria = {}
    self.train_metric_fns = {}
    self.optimizer = None
    self.lr_scheduler = None
    if mode == 'train':
      names = [conf.loss_name] if conf.has_attr('loss_name') else \
          list(conf.get_attr('losses', default=[]))
      if not names:
        raise ValueError('Need at least one loss to optimize something!')
      self.criteria = {name: get_criterion(conf, name, device=self.device)
                       for name in names}
      self.loss_weights = self._loss_weights(
          conf.get_attr('loss_weights', default={}), self.criteria)
      opt_conf = Configuration.from_dict(conf.optimizer, conf)
      self.optimizer = get_optimizer(
          opt_conf, opt_conf.name, self.model.parameters())
      if opt_conf.has_attr('lr_scheduler'):
        self.lr_scheduler = get_lr_scheduler(opt_conf, opt_conf.lr_scheduler)
      self.train_metric_fns = {
          name: get_metric_fn(conf, name)
          for name in conf.get_attr('train_metrics', default=[])}

  def _model_inputs(self, batch):
    return [batch[k] for k in self.input_keys]

  # -- steps ------------------------------------------------------------------

  def train_batch(self, batch):
    """One update on a prepared batch; returns (losses with the weighted
    total under 'loss', model output), detached."""
    self.model.train()
    out = _cast_f32(self.model(*self._model_inputs(batch)))
    losses = {name: crit(out, batch) for name, crit in self.criteria.items()}
    total = sum(self.loss_weights[name] * loss
                for name, loss in losses.items())
    self.optimizer.zero_grad(set_to_none=True)
    total.backward()
    self.optimizer.step()
    self.step += 1
    losses = {name: loss.detach() for name, loss in losses.items()}
    losses['loss'] = total.detach()
    return losses, _detach(out)

  def _mask_generator(self):
    return torch.Generator(device=self.device).manual_seed(
        self.conf.seed * 2 ** 32 + self.step)

  def _train_step(self, batch_iter):
    host_batch = next(batch_iter, None)
    if host_batch is None:
      return 0, None, None
    batch = self.preparer.prepare_train(self._mask_generator(), host_batch)
    losses, out = self.train_batch(batch)
    return 1, _loss_metrics(losses), (batch, out)

  def _val_step(self, host_batch, compute_metrics=True):
    batch = self.preparer.prepare_val(host_batch)
    out = _cast_f32(self.predict(batch))
    if not compute_metrics:
      return {}, (batch, out)
    with torch.no_grad(), full_f32():
      losses = {name: crit(out, batch)
                for name, crit in self.criteria.items()}
    return _loss_metrics(losses), (batch, out)

  def predict(self, batch):
    """The model's eval-mode output on a prepared batch, in full f32."""
    self.model.eval()
    with torch.no_grad(), full_f32():
      return self.model(*self._model_inputs(batch))

  def _compute_train_metrics(self, data):
    batch, out = data
    return {name: fn(out, batch) for name, fn in self.train_metric_fns.items()}

  def _compute_test_metrics(self, data):
    batch, out = data
    return {name: fn(out, batch) for name, fn in self.val_metric_fns.items()}

  # -- bookkeeping ------------------------------------------------------------

  def __str__(self):
    return 'Model:\n{}'.format(self.model)

  def epoch_beginning(self, epoch):
    if self.lr_scheduler is not None:
      lr = self.lr_scheduler(epoch - 1)
      logging.info('Epoch %d learning rate: %g', epoch, lr)
      set_learning_rate(self.optimizer, lr)

  def state_dict(self):
    out = {'model': self.model.state_dict(), 'step': self.step}
    if self.optimizer is not None:
      out['optimizer'] = self.optimizer.state_dict()
    return out

  def load_state_dict(self, state_dict):
    """Restore from a runner state of either package (the model a port
    state dict or a flax tree)."""
    load_network_state(self.model, state_dict['model'])
    self.step = int(state_dict.get('step', 0))
    if 'optimizer' in state_dict and self.optimizer is not None:
      load_optimizer_state(self.optimizer, self.model,
                           state_dict['optimizer'])
    logging.debug('Restored runner state')
