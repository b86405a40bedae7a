"""Inputs of a cell, made on the device from the run's seed.

A plain copy of what the port's data path computes, so that the program is
handed only finished inputs:

* ``phantoms``: ground-truth slices in [0, 1], sums of random ellipses
  (the ScarSeg LGE data is not in the repository);
* ``varden_masks``: the variable-density Cartesian line masks of the
  port's ``ops/masks.py::cartesian_mask`` (the kt-FOCUSS line pdf, Gumbel
  top-k over it, the centre lines always sampled, uncentred);
* ``undersample``: the ortho FFT forward model of the port's
  ``ops/undersample.py::undersample_batch``, giving ``inp``, ``kspace``,
  ``mask`` and ``target`` in the layout ``prepare_train`` returns.

Every draw comes from one ``torch.Generator`` on the device, in a fixed
order, so a seed gives the same pool on every run. The line count of a
mask is fixed by the side and the acceleration, so every seed does the same
work.
"""

import math

import torch


def phantoms(gen, batch, height, width, ellipses):
  """(batch, height, width) float32 slices in [0, 1]: ``ellipses`` random
  ellipses of signed intensity each, min-max scaled per slice."""
  device = gen.device
  p = torch.rand(batch, ellipses, 6, generator=gen, device=device)
  y = torch.linspace(-1.0, 1.0, height, device=device)[None, :, None]
  x = torch.linspace(-1.0, 1.0, width, device=device)[None, None, :]
  img = torch.zeros(batch, height, width, device=device)
  for e in range(ellipses):
    cy, cx = (p[:, e, 0] - 0.5) * 1.2, (p[:, e, 1] - 0.5) * 1.2
    ay, ax = 0.1 + 0.5 * p[:, e, 2], 0.1 + 0.5 * p[:, e, 3]
    theta = p[:, e, 4] * math.pi
    cos, sin = torch.cos(theta), torch.sin(theta)
    dy = y - cy[:, None, None]
    dx = x - cx[:, None, None]
    u = (dx * cos[:, None, None] + dy * sin[:, None, None]) / ax[:, None, None]
    v = (dy * cos[:, None, None] - dx * sin[:, None, None]) / ay[:, None, None]
    img += (2.0 * p[:, e, 5] - 1.0)[:, None, None] * (u * u + v * v <= 1.0)
  low = img.amin(dim=(1, 2), keepdim=True)
  span = (img.amax(dim=(1, 2), keepdim=True) - low).clamp_min(1e-6)
  return (img - low) / span


def varden_masks(gen, batch, height, width, acceleration, centre_lines):
  """(batch, height, width) float32 masks of whole lines along the width:
  ``max(height // acceleration, centre_lines)`` lines a mask, the
  ``centre_lines`` central ones always, the rest drawn without replacement
  from the kt-FOCUSS pdf; uncentred (ifftshift)."""
  device = gen.device
  idx = torch.arange(height, device=device)
  centre = (idx >= height // 2 - centre_lines // 2) & \
      (idx < height // 2 + centre_lines // 2)
  x = idx.to(torch.float32) - height / 2
  pdf = torch.exp(-(0.5 / (height / 10.0) ** 2) * x ** 2) + \
      (height / (2.0 * acceleration)) / height
  pdf = torch.where(centre, 0.0, pdf)
  pdf = pdf / pdf.sum()
  drawn = max(int(height // float(acceleration)), centre_lines) - centre_lines
  u = torch.rand(batch, height, generator=gen, device=device)
  gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
  scores = torch.where(pdf > 0, torch.log(pdf) + gumbel, -torch.inf)
  lines = torch.zeros(batch, height, device=device)
  lines.scatter_(1, torch.topk(scores, drawn, dim=1).indices, 1.0)
  lines = torch.where(centre, 1.0, lines)
  mask = lines[:, :, None].expand(batch, height, width)
  return torch.fft.ifftshift(mask, dim=(1, 2)).contiguous()


def _pack(z):
  return torch.stack([z.real, z.imag], dim=-1).to(torch.float32).contiguous()


def undersample(gt, mask):
  """{inp, kspace, mask, target} of real slices ``gt`` (B, H, W) under
  ``mask`` (B, H, W): NHWC float32, the k-space ortho and unshifted."""
  x = gt.to(torch.complex64)
  k = torch.fft.fft2(x, norm='ortho') * mask
  return {'inp': _pack(torch.fft.ifft2(k, norm='ortho')), 'kspace': _pack(k),
          'mask': mask[..., None].contiguous(), 'target': _pack(x)}


def batch(gen, traffic, keys):
  """One batch of the traffic's shape, with the named keys only."""
  if traffic['sampling'] != 'varden':
    raise ValueError('only varden sampling is generated, not {!r}'.format(
        traffic['sampling']))
  b, h, w = traffic['batch'], traffic['height'], traffic['width']
  gt = phantoms(gen, b, h, w, traffic['ellipses'])
  mask = varden_masks(gen, b, h, w, traffic['acceleration'],
                      traffic['centre_lines'])
  full = undersample(gt, mask)
  return {k: full[k] for k in keys}


def pool(gen, traffic, keys):
  """``traffic['pool']`` distinct batches, drawn one after another."""
  return [batch(gen, traffic, keys) for _ in range(traffic['pool'])]
