"""Recompute in the backward: the port's ``jax.checkpoint`` / ``nn.remat``.

``checkpoint(fn, *args, generators=())`` runs ``fn(*args)`` keeping none
of its intermediate tensors; the backward runs ``fn`` again to rebuild
them (``torch.utils.checkpoint``, non-reentrant). JAX's remat is
functional, so the recompute there has no side effects; a torch module's
forward has two, and both are undone here so that a recomputed run is
bit-equal to a stored one:

* BatchNorm's running statistics: ``models/unet.py::BatchNorm2d`` moves
  them inside its train-mode forward, and skips that while
  ``recomputing()`` is true, so the momentum is applied once;
* dropout's random stream: ``models/layers.py::channel_dropout`` draws
  from an explicit ``torch.Generator``, which ``torch.utils.checkpoint``
  does not replay (it saves the global generators only). Each generator in
  ``generators`` is set back to its state at the forward for the
  recompute, so the same masks are drawn, and then to where it stood, so
  the stream goes on as without the recompute.

A recompute under a spatial mesh runs in the backward, outside the
runner's ``parallel/halo.py::sharded_rows`` block (and in autograd's own
thread on the card): the block of the forward is entered again for it.
"""

import contextlib
import threading

import torch.utils.checkpoint

from csmri_refinement_tpu_torch.parallel import halo

_state = threading.local()


def recomputing():
  """True inside a backward's recompute of a checkpointed function (in
  the thread that runs it)."""
  return getattr(_state, 'recomputing', False)


@contextlib.contextmanager
def _recompute(generators, states, mesh):
  before = getattr(_state, 'recomputing', False)
  now = [g.get_state() for g in generators]
  for g, s in zip(generators, states):
    g.set_state(s)
  _state.recomputing = True
  try:
    with halo.sharded_rows(mesh):
      yield
  finally:
    _state.recomputing = before
    for g, s in zip(generators, now):
      g.set_state(s)


def checkpoint(fn, *args, generators=()):
  """``fn(*args)``, recomputed in the backward instead of stored; the
  ``generators`` that ``fn`` draws from replay their draws."""
  states = [g.get_state() for g in generators]
  mesh = halo.current()
  return torch.utils.checkpoint.checkpoint(
      fn, *args, use_reentrant=False,
      context_fn=lambda: (contextlib.nullcontext(),
                          _recompute(generators, states, mesh)))
