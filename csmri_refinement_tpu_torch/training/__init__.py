"""Runner registry: ``build_runner(conf, runner_type, mode, device)``.

``standard`` (``training/runner.py``) and ``adversarial``
(``training/adversarial_runner.py``), as in the JAX package.
"""


def build_runner(conf, runner_type, mode, device='cuda'):
  if runner_type == 'standard':
    from csmri_refinement_tpu_torch.training.runner import Runner
    return Runner(conf, mode, device)
  if runner_type == 'adversarial':
    from csmri_refinement_tpu_torch.training.adversarial_runner import (
        AdversarialRunner)
    return AdversarialRunner(conf, mode, device)
  raise ValueError('Unknown runner type {!r}'.format(runner_type))
