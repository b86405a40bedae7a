"""Runner registry: ``build_runner(conf, runner_type, mode, device)``.

Only the ``standard`` runner is ported; the adversarial runner waits for
the GAN slice (ROADMAP Queue 1 item 6).
"""


def build_runner(conf, runner_type, mode, device='cuda'):
  if runner_type != 'standard':
    raise NotImplementedError(
        'runner type {!r} is not ported yet'.format(runner_type))
  from csmri_refinement_tpu_torch.training.runner import Runner
  return Runner(conf, mode, device)
