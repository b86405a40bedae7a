"""Criterion registry and wrappers.

Port of ``csmri_refinement_tpu/models/criteria.py``: a criterion is
``(model_output, batch) → scalar loss``. ``CriterionWrapper`` selects the
prediction key from a dict output and the target key from the batch;
``FeaturePenalty`` pulls a named model output toward zero; ``VGG19`` is
the perceptual loss (``models/vgg_loss.py``, MSE on block 4 unless a
``vgg_loss`` section says otherwise); the adversarial losses
(``models/adversarial_loss.py``) take the discriminator's outputs on fakes
and reals instead, in the direction ``loss_type`` ('gen' or 'disc') names.
Reductions are means in float32.
"""

import torch
import torch.nn.functional as F


def mse_loss(pred, target):
  return torch.mean((pred - target) ** 2)


def l1_loss(pred, target):
  return torch.mean(torch.abs(pred - target))


def smooth_l1_loss(pred, target):
  """Huber with delta 1 (torch SmoothL1Loss)."""
  return F.smooth_l1_loss(pred, target, beta=1.0)


def cross_entropy_loss(logits, labels):
  """Dense CE over NHWC logits and (B, H, W) integer labels."""
  return F.cross_entropy(logits.permute(0, 3, 1, 2), labels.long())


def nll_loss(log_probs, labels):
  """NLL over NHWC log-probabilities."""
  picked = torch.gather(log_probs, -1, labels.long()[..., None])
  return -torch.mean(picked)


_SIMPLE_CRITERIA = {
    'MSE': mse_loss,
    'L1': l1_loss,
    'SmoothL1Loss': smooth_l1_loss,
    'CrossEntropy': cross_entropy_loss,
    'NLLLoss': nll_loss,
}


class CriterionWrapper:
  """Select pred/target keys, then apply the base criterion."""

  def __init__(self, criterion, target_key='target', input_key='pred'):
    self.criterion = criterion
    self.target_key = target_key
    self.input_key = input_key

  def _prediction(self, out_model):
    return out_model[self.input_key] if isinstance(out_model, dict) \
        else out_model

  def __call__(self, out_model, batch):
    return self.criterion(self._prediction(out_model), batch[self.target_key])


class CriterionWrapperWithScalarTarget(CriterionWrapper):
  """Regularise a named model output toward a scalar constant."""

  def __init__(self, criterion, scalar_target, input_key='pred'):
    super().__init__(criterion, input_key=input_key)
    self.scalar_target = scalar_target

  def __call__(self, out_model, batch):
    prediction = self._prediction(out_model)
    return self.criterion(prediction,
                          torch.full_like(prediction, self.scalar_target))


def _feature_penalty_criterion(conf):
  penalty = conf.get_attr('feature_penalty')
  if not penalty or 'input_key' not in penalty:
    raise ValueError('FeaturePenalty needs "feature_penalty" with an '
                     '"input_key"')
  criterion_name = penalty.get('criterion', 'MSE')
  if criterion_name not in _SIMPLE_CRITERIA:
    raise ValueError('Unknown criterion {} for feature penalty '
                     'loss'.format(criterion_name))
  return CriterionWrapperWithScalarTarget(
      _SIMPLE_CRITERIA[criterion_name], scalar_target=0.0,
      input_key=penalty['input_key'])


_ADVERSARIAL = ('GAN', 'LSGAN', 'WGAN', 'FeatureMatching',
                'gan', 'lsgan', 'wgan', 'feature-matching')


def _vgg_criterion(conf, loss_name, target_key, device):
  from csmri_refinement_tpu_torch.models import torch_dtype
  from csmri_refinement_tpu_torch.models.vgg_loss import VGGLoss
  section = conf.get_attr('vgg_loss', default={})
  dtype = section.get('dtype') or conf.get_attr('train_dtype')
  vgg_loss = VGGLoss(loss_name, section.get('blocks', -1),
                     section.get('criterion', 'MSE'), section.get('weights'),
                     weights_path=conf.get_attr('vgg_weights_path'),
                     conf_path=conf.file,
                     allow_random_init=conf.get_attr('vgg_random_init',
                                                     default=False),
                     device=device,
                     remat=conf.get_attr('train_remat', default=False),
                     dtype=torch_dtype(dtype))
  return CriterionWrapper(vgg_loss, target_key)


def get_criterion(conf, loss_name, target_key=None, input_key=None,
                  loss_type=None, device='cuda'):
  """Criterion factory; ``loss_target_keys`` remaps a loss's target key,
  ``loss_type`` picks an adversarial loss's direction, ``device`` holds a
  VGG19's weights (the card unless the caller asks for the CPU). The
  VGG19 computes in ``vgg_loss.dtype`` if given, else in the run's
  ``train_dtype`` (JAX ``criteria.py:105-140``): the runners build
  criteria in mode 'train' only. The other criteria are dtype-free
  reductions."""
  if input_key is None:
    input_key = 'pred'
  if target_key is None:
    target_key = conf.get_attr('loss_target_keys', default={}).get(
        loss_name, 'target')
  if loss_name in _SIMPLE_CRITERIA:
    return CriterionWrapper(_SIMPLE_CRITERIA[loss_name], target_key,
                            input_key)
  if loss_name in _ADVERSARIAL:
    from csmri_refinement_tpu_torch.models.adversarial_loss import (
        get_adversarial_loss)
    return get_adversarial_loss(conf, loss_name, loss_type)
  if loss_name == 'VGG19':
    return _vgg_criterion(conf, loss_name, target_key, device)
  if loss_name == 'FeaturePenalty':
    return _feature_penalty_criterion(conf)
  raise ValueError('Unknown loss {}'.format(loss_name))
