"""Undersampling masks: host numpy and on-device torch.

Port of ``csmri_refinement_tpu/ops/masks.py``:

* the host generators — ``cartesian_mask_np`` (``:37``),
  ``radial_sampling_np`` (``:75``), ``var_dens_mask_2d`` (``:128``),
  ``nlines_mask`` (``:151``), ``lowres_mask`` (``:177``),
  ``shear_grid_mask`` (``:198``), ``undersampling_rate`` (``:235``),
  ``get_undersampling_sensitivity`` (``:240``) and
  ``get_mask_generator_np`` (``:295``) — the JAX package's code with its
  draw order, so the same ``RandomState`` gives the same mask, bit for bit;
* ``radial_masks_np``: the radial path of ``get_mask_generator_np``,
  which the batch preparer's train and validation masks both take;
* ``cartesian_num_lines`` (``:282``) and ``_cartesian_pdf`` (``:334``);
* ``cartesian_mask`` (``:348-412``) — Gumbel top-k line selection, drawn
  from an explicit ``torch.Generator`` on the mask's device;
* ``make_masks`` (``:415-445``): cartesian masks on the device; radial
  ones on the host from a ``RandomState`` seeded by the generator.

``jax.random`` and ``torch.Generator`` give different bits from one seed:
for cartesian masks the two packages agree on the line count and the
sampling distribution, not on the lines drawn. Tests that compare models
feed both the same numpy mask.
"""

import numpy as np
import torch

CARTESIAN_CENTRAL_LINES = 8


def normal_pdf(length, sensitivity):
  """Unnormalised gaussian pdf over line indices."""
  return np.exp(-sensitivity * (np.arange(length) - length / 2) ** 2)


def cartesian_mask_np(shape, acc, sample_n=10, centred=False, rng=None):
  """Variable-density cartesian line mask (numpy).

  shape: (..., nx, ny); acc: acceleration factor (float ok).
  """
  if rng is None:
    rng = np.random
  n, nx, ny = int(np.prod(shape[:-2])), shape[-2], shape[-1]
  pdf_x = normal_pdf(nx, 0.5 / (nx / 10.) ** 2)
  lmda = nx / (2. * acc)
  n_lines = int(nx // acc)

  pdf_x += lmda * 1. / nx

  if sample_n:
    pdf_x[nx // 2 - sample_n // 2:nx // 2 + sample_n // 2] = 0
    pdf_x /= np.sum(pdf_x)
    n_lines -= sample_n

  mask = np.zeros((n, nx))
  for i in range(n):
    idx = rng.choice(nx, n_lines, False, pdf_x)
    mask[i, idx] = 1

  if sample_n:
    mask[:, nx // 2 - sample_n // 2:nx // 2 + sample_n // 2] = 1

  mask = np.repeat(mask[:, :, None], ny, axis=2)
  mask = mask.reshape(shape)

  if not centred:
    mask = np.fft.ifftshift(mask, axes=(-2, -1))
  return mask


def radial_sampling_np(shape, n_lines, angle_begin=0, rand=False,
                       golden_angle=False, centred=True, rng=None):
  """Golden-angle or uniform radial spokes gridded to cartesian, on the
  square of the larger side (cropped back to (nx, ny)). ``n_lines`` is the
  number of spokes per mask."""
  if rng is None:
    rng = np.random
  GOLDEN_ANGLE = np.pi / ((1 + np.sqrt(5)) / 2)

  n, nx0, ny0 = int(np.prod(shape[:-2])), shape[-2], shape[-1]
  nx = ny = max(nx0, ny0)

  mask = np.zeros((n, nx, ny), dtype=int)

  if rand:
    angle_begin = np.pi * rng.random_sample()

  y = np.arange(-nx / 2, nx / 2, 1)
  x = np.arange(-ny / 2, ny / 2, 1)

  if golden_angle:
    angles = np.array([angle_begin + i * GOLDEN_ANGLE
                       for i in range(n_lines * n)])
  else:
    angles = np.tile(np.arange(0, np.pi, np.pi / n_lines), n)
    angles = angles + np.repeat(rng.random_sample(n) * np.pi / n_lines,
                                n_lines)

  kloc_all = np.outer(y, np.cos(angles)) + 1j * np.outer(x, np.sin(angles))

  # Round to the nearest cartesian location, recentre, wrap out-of-range.
  kloc1 = np.round(kloc_all + (0.5 + 0.5j)) + ((nx / 2) + (ny / 2) * 1j)
  kloc1real = np.real(kloc1)
  kloc1real = kloc1real - nx * (kloc1real > nx)
  kloc1imag = np.imag(kloc1)
  kloc1imag = kloc1imag - ny * (kloc1imag > ny)
  kloc1real = kloc1real + nx * (kloc1real < 1)
  kloc1imag = kloc1imag + ny * (kloc1imag < 1)
  t = np.repeat(np.arange(n), n_lines * nx)
  xi = (kloc1real.transpose().reshape(-1) - 1).astype(int)
  yi = (kloc1imag.transpose().reshape(-1) - 1).astype(int)
  mask[t, xi, yi] = 1

  if nx0 != ny0:
    xpad = (nx - nx0) // 2
    ypad = (ny - ny0) // 2
    mask = mask[:, xpad:nx - xpad, ypad:ny - ypad]

  if not centred:
    mask = np.fft.ifftshift(mask, axes=(-2, -1))
  return mask.reshape(shape)


def var_dens_mask_2d(shape, ivar, sample_high_freq=True, rng=None,
                     sample_n=9):
  """Variable-density 2D Bernoulli mask from a separable gaussian pdf of
  sensitivity ``ivar``, with a fully sampled centre block of side
  ``sample_n`` (odd)."""
  if rng is None:
    rng = np.random
  if len(shape) == 3:
    nt, nx, ny = shape
  else:
    nx, ny = shape
    nt = 1
  pdf = np.outer(normal_pdf(nx, ivar), normal_pdf(ny, ivar))
  if sample_high_freq:
    pdf = pdf / 1.1 + 0.01
  mask = rng.binomial(1, np.broadcast_to(pdf, (nt, nx, ny)))
  xc, yc = nx // 2, ny // 2
  half = sample_n // 2
  mask[:, xc - half:xc + half + 1, yc - half:yc + half + 1] = 1
  if nt == 1 and len(shape) == 2:
    return mask.reshape(nx, ny)
  return mask


def nlines_mask(shape, n, centred=False, sample_centre=True, sample_n=1,
                rng=None):
  """``n`` k-space lines per frame of a (nt, nx, ny) mask, uniformly at
  random, ``sample_n`` of them the central lines (redrawn until the random
  ones miss the centre)."""
  if rng is None:
    rng = np.random
  nt, nx, ny = shape
  mask = np.zeros(shape)
  center = set()
  if sample_centre:
    xc = nx // 2
    s = sample_n // 2
    center = set(range(xc - s, xc - s + sample_n))
    mask[:, xc - s:xc - s + sample_n, :] = 1
    n -= sample_n
  if n > 0:
    for t in range(nt):
      idx = rng.choice(nx, n, replace=False)
      while center and center.intersection(idx.tolist()):
        idx = rng.choice(nx, n, replace=False)
      mask[t, idx, :] = 1
  if not centred:
    mask = np.fft.ifftshift(mask, axes=(-2, -1))
  return mask


def lowres_mask(shape, n, centred=False, skip=True, rng=None):
  """Low-resolution acquisition: the ``n`` central lines, or with ``skip``
  ``n`` offsets from the centre with random signs."""
  if rng is None:
    rng = np.random
  nt, nx, ny = shape
  mask = np.zeros((nt, nx, 1))
  xc = nx // 2
  for t in range(nt):
    if skip:
      sign = ((rng.binomial(1, 0.5, n) - 0.5) * 2).astype(int)
      mask[t, xc + np.arange(n) * sign, :] = 1
    else:
      s = n // 2
      mask[t, xc - s:xc - s + n, :] = 1
  mask = np.repeat(mask, ny, axis=-1)
  if not centred:
    mask = np.fft.ifftshift(mask, axes=(-2, -1))
  return mask


def shear_grid_mask(shape, acceleration_rate, sample_low_freq=True,
                    centred=False, sample_n=10, rng=None, perturb=False):
  """Shear-grid (k-t) sampling: frame t samples every
  ``acceleration_rate``-th line from a phase shifted by t, optionally each
  line moved by -1, 0 or 1, plus ``sample_n`` low-frequency lines."""
  if rng is None:
    rng = np.random
  nt, nx, ny = shape
  start = rng.randint(0, acceleration_rate)
  mask = np.zeros((nt, nx))
  for t in range(nt):
    mask[t, (start + t) % acceleration_rate::acceleration_rate] = 1

  if perturb:
    shift = np.array([-1, 0, 1])[rng.randint(0, 3, size=nt * nx)]
    new_mask = np.zeros_like(mask)
    for t in range(nt):
      for x in range(nx):
        if mask[t, x]:
          new_mask[t, (x + shift[t * x]) % nx] = 1
    mask = new_mask

  xc = nx // 2
  xl = sample_n // 2
  if sample_low_freq and centred:
    xh = xl + (1 if sample_n % 2 == 0 else 0)
    mask[:, xc - xl:xc + xh + 1] = 1
  elif sample_low_freq:
    xh = xl - (1 if sample_n % 2 == 1 else 0)
    if xl > 0:
      mask[:, :xl] = 1
    if xh > 0:
      mask[:, -xh:] = 1

  return np.repeat(mask[..., np.newaxis], ny, axis=-1)


def undersampling_rate(mask):
  """Fraction of k-space sampled."""
  return float(np.sum(mask)) / mask.size


def get_undersampling_sensitivity(dim, target_factor, num_trials=20,
                                  tol=1.0, rng=None, max_iters=40):
  """The ``var_dens_mask_2d`` sensitivity whose masks of side ``dim``
  sample 1/``target_factor`` of k-space on average (``num_trials`` masks
  per reading, within ``tol`` percent), by bisection in log space."""
  if rng is None:
    rng = np.random.RandomState(0)
  target_rate = 1.0 / target_factor

  def mean_rate(ivar):
    masks = var_dens_mask_2d((num_trials,) + tuple(dim), ivar, rng=rng)
    return masks.mean()

  lo, hi = 1e-8, 1e-2
  while mean_rate(hi) > target_rate and hi < 1e3:
    hi *= 10
  if mean_rate(lo) < target_rate:
    raise ValueError(
        'Cannot reach target rate {}: masks sample a fully-covered center '
        'block; ensure (central samples)/mask.size < 1/factor'.format(
            target_rate))
  for _ in range(max_iters):
    mid = np.sqrt(lo * hi)
    rate = mean_rate(mid)
    if abs(rate - target_rate) <= tol * target_rate / 100.0:
      return mid
    if rate > target_rate:
      lo = mid
    else:
      hi = mid
  return np.sqrt(lo * hi)


def cartesian_num_lines(nx, acc, sample_n=CARTESIAN_CENTRAL_LINES):
  """Total sampled-line count of a static-acceleration cartesian mask:
  the reference's f64 ``int(nx // acc)``, floored at the guaranteed centre
  lines."""
  base = int(nx // float(acc))
  return max(base, int(sample_n)) if sample_n else base


def radial_masks_np(shape, spokes, rng, variable=False):
  """(B, n, n) radial masks from ``rng``: golden-angle spokes from a random
  start, uncentred. ``spokes`` per mask, or with ``variable`` a count
  drawn per mask from [1, n/2 - 1)."""
  if variable:
    size = shape[-1]
    counts = rng.randint(1, len(np.arange(1, size // 2)), shape[0])
    mask = np.array([
        radial_sampling_np((1, size, size), int(counts[i]), rand=True,
                           golden_angle=True, centred=False, rng=rng)
        for i in range(shape[0])])
    return mask.reshape(shape)
  return radial_sampling_np(shape, int(spokes), rand=True, golden_angle=True,
                            centred=False, rng=rng)


def get_mask_generator_np(sampling_scheme, im_shape, acceleration_factor,
                          variable=False, rng=None):
  """A closure drawing one (B, n, n) host mask per call from ``rng``:
  radial (``radial_masks_np``) or cartesian with 8 centre lines, with
  ``variable`` a count of spokes or an acceleration U(1, 1.5·acc) per
  mask."""
  if rng is None:
    rng = np.random

  def mask_gen():
    if sampling_scheme == 'radial':
      return radial_masks_np(im_shape, acceleration_factor, rng, variable)
    if variable:
      mask = np.zeros(im_shape)
      for i in range(im_shape[0]):
        acc_r = float(rng.uniform(1, acceleration_factor * 1.5))
        mask[i] = cartesian_mask_np(im_shape[1:], acc_r,
                                    CARTESIAN_CENTRAL_LINES,
                                    centred=False, rng=rng)
      return mask
    return cartesian_mask_np(im_shape, acceleration_factor,
                             CARTESIAN_CENTRAL_LINES, centred=False, rng=rng)

  return mask_gen


def _centre(nx, sample_n, device):
  idx = torch.arange(nx, device=device)
  return (idx >= nx // 2 - sample_n // 2) & (idx < nx // 2 + sample_n // 2)


def _cartesian_pdf(nx, acc, sample_n, device=None):
  """The kt-FOCUSS line pdf; ``acc`` is a float or a (B,) tensor, giving a
  (nx,) or (B, nx) pdf."""
  x = torch.arange(nx, dtype=torch.float32, device=device) - nx / 2
  pdf = torch.exp(-(0.5 / (nx / 10.) ** 2) * x ** 2)
  if torch.is_tensor(acc):
    pdf = pdf + (nx / (2. * acc[:, None])) / nx
  else:
    pdf = pdf + (nx / (2. * acc)) / nx
  if sample_n:
    pdf = torch.where(_centre(nx, sample_n, device), 0.0, pdf)
    pdf = pdf / pdf.sum(dim=-1, keepdim=True)
  return pdf


def cartesian_mask(generator, shape, acc, sample_n=CARTESIAN_CENTRAL_LINES,
                   centred=False, device=None):
  """Batched variable-density cartesian mask on ``device``.

  generator : torch.Generator on ``device``
  shape : (batch, nx, ny)
  acc : float, or a (batch,) float tensor of per-example accelerations

  Gumbel top-k over the log-pdf equals numpy's sequential
  choice-without-replacement in distribution.
  """
  batch, nx, ny = shape
  if torch.is_tensor(acc):
    acc = acc.to(device=device, dtype=torch.float32)
    n_lines = torch.floor(nx / acc).to(torch.int64) - (sample_n or 0)
    pdf = _cartesian_pdf(nx, acc, sample_n, device)
  else:
    n_lines = torch.full((batch,), cartesian_num_lines(nx, acc, sample_n) -
                         (sample_n or 0), dtype=torch.int64, device=device)
    pdf = _cartesian_pdf(nx, float(acc), sample_n, device).expand(batch, nx)
  u = torch.rand((batch, nx), generator=generator, device=device)
  u = u.clamp_min(torch.finfo(torch.float32).tiny)
  gumbel = -torch.log(-torch.log(u))
  scores = torch.where(pdf > 0, torch.log(pdf) + gumbel, -torch.inf)
  rank = torch.argsort(torch.argsort(-scores, dim=-1), dim=-1)
  mask_x = (rank < n_lines[:, None]).to(torch.float32)
  if sample_n:
    mask_x = torch.where(_centre(nx, sample_n, device), 1.0, mask_x)
  mask = mask_x[:, :, None].expand(batch, nx, ny)
  if not centred:
    mask = torch.fft.ifftshift(mask, dim=(-2, -1))
  return mask.contiguous()


def draw_seed(generator, device=None):
  """One seed in [0, 2**31 - 1) from ``generator`` (on ``device``), for a
  host ``RandomState``."""
  return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                           device=device))


def make_masks(generator, batch, height, width, sampling_scheme='varden',
               acceleration_factor=8, variable_acceleration=False,
               sample_n=CARTESIAN_CENTRAL_LINES, device=None):
  """Batched masks on ``device``: cartesian (``varden``/``cartesian``)
  drawn there, variable acceleration taking acc ~ U(1, 1.5·acc) per
  example; ``radial`` rasterised on the host, as in the JAX package, from
  a ``RandomState`` seeded by one draw of ``generator`` (f32).
  """
  if sampling_scheme == 'radial':
    rng = np.random.RandomState(draw_seed(generator, device))
    mask = radial_sampling_np((batch, height, width),
                              int(acceleration_factor), rand=True,
                              golden_angle=True, centred=False, rng=rng)
    return torch.as_tensor(mask, dtype=torch.float32, device=device)
  if sampling_scheme not in ('varden', 'cartesian'):
    raise ValueError('Unknown sampling scheme {}'.format(sampling_scheme))
  if variable_acceleration:
    u = torch.rand((batch,), generator=generator, device=device)
    acc = 1.0 + u * (acceleration_factor * 1.5 - 1.0)
  else:
    acc = float(acceleration_factor)
  return cartesian_mask(generator, (batch, height, width), acc,
                        sample_n=sample_n, centred=False, device=device)
