"""Seeded weights of a network, made on the device in one draw.

``draw`` takes a state dict's names and shapes (the program's module tree)
and returns a value for every float entry from one ``torch.randn`` call on
the generator's device, in float32, each entry by a law of its kind:

* a conv weight (4-D): He-normal for the LeakyReLU that follows it,
  N(0, 2 / ((1 + a²) · fan_in));
* a conv bias: N(0, 0.05²);
* a BatchNorm's weight 1 + N(0, 0.1²), bias and running mean N(0, 0.1²),
  running variance exp(N(0, 0.3²)): statistics of a trained model rather
  than the identity of a fresh one;
* the refinement wrapper's ``scale``: 0.1 + N(0, 0.02²), so that the U-Net
  moves the prediction (a fresh wrapper's 0 would hide it).

Integer entries (BatchNorm's counters) are zeros. An entry of another kind
raises, so a network with new parameters gets a law before it runs.
"""

import math

import torch


def _is_bn(name):
  module = name.rsplit('.', 2)[-2] if name.count('.') >= 1 else ''
  return module.startswith('bn') or module.endswith('_bn')


def _law(name, z, shape, leak):
  leaf = name.rsplit('.', 1)[-1]
  if leaf == 'running_var':
    return torch.exp(0.3 * z)
  if leaf == 'running_mean':
    return 0.1 * z
  if _is_bn(name):
    if leaf == 'weight':
      return 1.0 + 0.1 * z
    if leaf == 'bias':
      return 0.1 * z
  if leaf == 'weight' and len(shape) == 4:
    fan_in = shape[1] * shape[2] * shape[3]
    return z * math.sqrt(2.0 / ((1.0 + leak * leak) * fan_in))
  if leaf == 'bias' and len(shape) == 1:
    return 0.05 * z
  if name == 'scale':
    return 0.1 + 0.02 * z
  raise ValueError('no law for the weight {} {}'.format(name, tuple(shape)))


def draw(state, gen, leak):
  """{name: float32 tensor on ``gen``'s device} for every entry of
  ``state``; ``leak(name)`` is the slope of the LeakyReLU after a conv."""
  floats = [n for n, t in state.items() if t.is_floating_point()]
  total = sum(state[n].numel() for n in floats)
  z = torch.randn(total, generator=gen, device=gen.device)
  out, offset = {}, 0
  for name, t in state.items():
    if not t.is_floating_point():
      out[name] = torch.zeros_like(t, device=gen.device)
      continue
    part = z[offset:offset + t.numel()].view(t.shape)
    offset += t.numel()
    out[name] = _law(name, part, t.shape, leak(name)).contiguous()
  return out
