"""Checkpoint deploy tool: strip a training checkpoint for inference.

    python -m csmri_refinement_tpu_torch.deploy_checkpoint \
        {standard,adversarial} IN OUT

Port of the JAX package's top-level ``deploy_checkpoint.py``: keeps the
checkpoint's conf and its inference network only (``standard`` →
``model``, ``adversarial`` → ``generator``), dropping the optimizers, the
discriminator, the epoch and the best metrics
(``utils/checkpoints.py::inference_checkpoint_from_training_checkpoint``).
``IN`` is a checkpoint of either package; ``OUT`` is a port checkpoint
(``torch.save``). A JAX checkpoint's network, a flax tree, becomes the
port's state dict of that network: the model its conf section names
(``model``, ``generator_model``) is built and the tree loaded into it
(``utils/jax_weights.py``). ``validate`` and ``pretrained_weights`` read
the result.
"""

import argparse
import sys

import torch

from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.utils.checkpoints import (
    inference_checkpoint_from_training_checkpoint, is_flax_tree,
    load_checkpoint, load_network_state)

# runner type → (the network's runner-state key, its conf section)
NETWORKS = {'standard': ('model', 'model'),
            'adversarial': ('generator', 'generator_model')}


def _parser():
  parser = argparse.ArgumentParser(
      description='Make inference checkpoint from training checkpoint')
  parser.add_argument('runner_type', choices=sorted(NETWORKS),
                      help='Runner type the checkpoint was trained with')
  parser.add_argument('input_checkpoint', help='Path to input checkpoint')
  parser.add_argument('output_checkpoint', help='Path to output checkpoint')
  return parser


def deploy(checkpoint, runner_type):
  """The inference checkpoint of ``checkpoint`` (either package's), its
  network a port state dict."""
  out = inference_checkpoint_from_training_checkpoint(checkpoint,
                                                      runner_type)
  key, section = NETWORKS[runner_type]
  state = out['runner'][key]
  if is_flax_tree(state):
    conf = out['conf']
    model = construct_model(conf.get(section, conf.get('model')))
    load_network_state(model, state)
    out['runner'][key] = model.state_dict()
  return out


def main(argv):
  args = _parser().parse_args(argv)
  out = deploy(load_checkpoint(args.input_checkpoint), args.runner_type)
  torch.save(out, args.output_checkpoint)
  print('Wrote inference checkpoint to {}'.format(args.output_checkpoint))
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
