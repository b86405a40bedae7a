"""Pretrained weights grafted into a model or its wrapper's sub-models.

Port of ``csmri_refinement_tpu/training/model_setup.py``: a model section
(or, for a ``RefinementWrapper``, its ``pretrained_model`` or
``learnable_model`` section) may name another run's checkpoint with
``pretrained_weights: [path, key]``; the network state found there
replaces the seeded init of that (sub-)model, every tensor of it. Paths
are relative to the config file; ``null`` disables loading. A checkpoint
of either package serves: a port state dict loads strict, a JAX
checkpoint's flax tree through ``utils/jax_weights.py``
(``utils/checkpoints.py::load_network_state``).
"""

import logging

from csmri_refinement_tpu_torch.utils.checkpoints import (
    load_network_state, resolve_pretrained_weights)


def apply_pretrained_weights(model, model_conf, conf_file):
  """Load the checkpoints ``model_conf`` (a model section as a dict)
  declares into ``model`` in place."""
  if 'pretrained_weights' in model_conf:
    state = resolve_pretrained_weights(model_conf, conf_file)
    if state is not None:
      load_network_state(model, state)
  for sub_key in ('pretrained_model', 'learnable_model'):
    sub = model_conf.get(sub_key)
    if isinstance(sub, dict) and 'pretrained_weights' in sub:
      state = resolve_pretrained_weights(sub, conf_file)
      if state is not None:
        load_network_state(getattr(model, sub_key), state)
        logging.info('Grafted pretrained weights into %s', sub_key)
