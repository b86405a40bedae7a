"""Fused k-space data consistency: the CUDA kernel and its plain version.

Port of the TPU kernel ``csmri_refinement_tpu/ops/dc_pallas.py``
(``_dc_kernel``, wrapper ``dc_pallas``):

    y = F⁻¹((1 − m)·F x + k0)        F = ortho, unshifted 2D DFT

on packed ``(B, H, W, 2)`` float32 images, ``(B, H, W, 1)`` float32 masks.

* ``dc_plain`` — the plain PyTorch version: ``torch.fft`` fft2 → merge →
  ifft2 in f32. The CPU path and the oracle the kernel is held against.
* ``dc_cuda`` — the wrapper of ``csrc/dc.cu``: checks its inputs, allocates
  the output and the k-space scratch, launches on the current stream and
  counts its calls in ``dc_cuda.launches`` (one per DC, whatever the number
  of CUDA launches inside).
* ``dc_plain_vjp`` / ``dc_bwd_cuda`` — the backward (K1-bwd), the Hermitian
  VJP of the JAX package's ``ops/dc.py:99-111`` ``_dc_fused_bwd``:
  ``grad_x = DC(g, 0, m)``, ``grad_k0 = fft2(g)``. ``dc_bwd_cuda`` runs
  ``grad_x`` on the same kernel in its no-k0 mode (a null k0 is zero) and
  counts in ``dc_bwd_cuda.launches``.
* ``_DCFunction`` — the ``torch.autograd.Function``: forward K1, backward
  K1-bwd; ``grad_k0`` only when k0 needs it, by ``torch.fft.fft2`` (the JAX
  package computes it outside Pallas too); the mask gets none.
* ``dc_op`` — K1 as the custom op ``csmri::dc`` (``torch.library``): its
  CPU implementation is ``dc_plain``, its CUDA one ``dc_cuda`` (looked up
  by its module-level name at each call, so the launch count and a
  recording replacement see every launch); a fake implementation gives
  ``torch.export`` its shape, so that a serving artifact's graph holds the
  kernel (``utils/export.py``).
* ``dc_fused`` — the device dispatch: where a gradient is needed, a CPU
  tensor takes ``dc_plain`` (autodiffed ``torch.fft``) and a CUDA tensor
  ``_DCFunction``; elsewhere (evaluation, a frozen network) the custom op.
* ``dc_rows`` — the DC of a spatial mesh's rank (``parallel/halo.py``): x
  holds the rank's image rows, k0 and mask the whole images. x's rows are
  all-gathered within the spatial group and the DC runs on the whole image
  (K1 on the card, the custom op without a gradient), of which the rank
  keeps its rows: K1's output equals the one-process run's bit for bit.
  The backward (``_RowsDCFunction``) all-gathers the gradient's rows, runs
  K1-bwd on the whole image and keeps the rank's rows. The DC's
  x-Jacobian is linear and Hermitian, so K1-bwd of the gathered gradient
  is the sum of every rank's contribution: no reduce-scatter is needed.
  ``grad_k0`` is the rank's share, ``fft2`` of its rows of the gradient
  (zero elsewhere), as each rank's loss is its share. Every rank of the
  group runs the whole DC: S-fold redundant work, left for a row-distributed
  DC (``ROADMAP.md``, Queue 2).

The kernel takes images of sides 2 to 512, by the route ``dc_route`` names
by shape: square power-of-two sides by mixed-radix line FFTs
(``FFT_PLANS``), every other side and every non-square image by dense DFT
lines, as the TPU kernel computes every side (its DFT matrices,
``dc_pallas.py:77``). A CUDA tensor of a larger side raises.
"""

import ctypes
import functools

import numpy as np
import torch

from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.ops import native
from csmri_refinement_tpu_torch.parallel import halo

MAX_SIZE = 512


def kspace_merge_reference(k, k0, mask, noise_lvl=None):
  """Merge predicted k-space with the sampled lines: noiseless, or with a
  ``noise_lvl`` weighing the prediction against the noisy samples (JAX
  ``ops/dc.py:448-452``; a ``noise_lvl`` of 0 merges as noiseless)."""
  if noise_lvl:
    return (1 - mask) * k + mask * (k + noise_lvl * k0) / (1 + noise_lvl)
  return (1 - mask) * k + k0


def dc_plain(x, k0, mask):
  """Plain PyTorch DC on packed tensors, in float32."""
  xc = fft.unpack_complex(x.float())
  k0c = fft.unpack_complex(k0.float())
  k = kspace_merge_reference(fft.fft2(xc), k0c, mask[..., 0].float())
  return fft.pack_complex(fft.ifft2(k))


@functools.lru_cache(maxsize=None)
def _lib():
  lib = native.library('dc')
  lib.dc_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
      ctypes.c_void_p]
  lib.dc_forward.restype = ctypes.c_int
  lib.dc_forward_dft.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
      ctypes.c_void_p]
  lib.dc_forward_dft.restype = ctypes.c_int
  return lib


# The line FFT's mixed-radix plan, per n: the radices of its stages, each
# an in-register DFT of 2 to 16 points (``csrc/dc.cu`` compiles the same
# plans and refuses any other). A thread holds the largest radix's points.
FFT_PLANS = {2: (2,), 4: (4,), 8: (8,), 16: (16,), 32: (8, 4), 64: (8, 8),
             128: (16, 8), 256: (16, 16), 512: (8, 8, 8)}


def plan_code(n):
  """The plan as the kernel checks it: one byte per stage's radix."""
  return sum(r << (8 * s) for s, r in enumerate(FFT_PLANS[n]))


def fft_tables(n):
  """The inter-stage twiddles of the plan, in f64 rounded once to f32.

  Stage s ≥ 1 (span Ns = product of the earlier radices, radix r) has a
  table of Ns·r entries, ``[q·Ns + m] = exp(−2πi·m·q/(Ns·r))``; the tables
  are concatenated in stage order. Returns an (entries, 2) float32 array
  (one zero entry when the plan has a single stage).
  """
  parts = []
  span = 1
  for s, r in enumerate(FFT_PLANS[n]):
    if s:
      q, m = np.meshgrid(np.arange(r), np.arange(span), indexing='ij')
      parts.append(np.exp(-2j * np.pi * m * q / (span * r)).reshape(-1))
    span *= r
  w = np.concatenate(parts) if parts else np.zeros(1, np.complex128)
  return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


def dft_table(n):
  """The n roots ``exp(−2πi·m/n)``, m < n, of the dense-DFT route, in f64
  rounded once to f32: an (n, 2) float32 array."""
  w = np.exp(-2j * np.pi * np.arange(n) / n)
  return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


def dc_route(h, w):
  """How the kernel transforms an image of H×W: ``'fft'`` (its radix plans,
  square power-of-two sides), ``'dft'`` (its dense DFT lines, any other
  sides from 2 to 512) or None (no route: a side outside 2 to 512)."""
  if not (2 <= h <= MAX_SIZE and 2 <= w <= MAX_SIZE):
    return None
  return 'fft' if h == w and h in FFT_PLANS else 'dft'


@functools.lru_cache(maxsize=None)
def _tables(route, n, device):
  table = fft_tables(n) if route == 'fft' else dft_table(n)
  return torch.from_numpy(table).to(device)


def _check(name, t, shape, device):
  if t.device != device or t.dtype != torch.float32:
    raise ValueError('dc_cuda: {} must be float32 on {}, got {} on {}'.format(
        name, device, t.dtype, t.device))
  if tuple(t.shape) != shape:
    raise ValueError('dc_cuda: {} must have shape {}, got {}'.format(
        name, shape, tuple(t.shape)))
  if not t.is_contiguous():
    raise ValueError('dc_cuda: {} must be contiguous'.format(name))


def _launch(name, x, k0, mask):
  """Check the inputs and run ``dc_forward``; ``k0`` None launches the
  no-k0 mode."""
  if x.device.type != 'cuda':
    raise ValueError('{} takes CUDA tensors, got {}'.format(name, x.device))
  if x.ndim != 4 or x.shape[-1] != 2:
    raise ValueError('{}: x must be (B, H, W, 2), got {}'.format(
        name, tuple(x.shape)))
  b, h, w, _ = x.shape
  route = dc_route(h, w)
  if route is None or not 1 <= b <= 65535:
    raise ValueError('{} takes images of sides 2 to {} and 1 to 65535 of '
                     'them, got {}'.format(name, MAX_SIZE, tuple(x.shape)))
  _check('x', x, (b, h, w, 2), x.device)
  if k0 is not None:
    _check('k0', k0, (b, h, w, 2), x.device)
  _check('mask', mask, (b, h, w, 1), x.device)
  # the kernel moves 16 bytes at a time
  x = x.clone() if x.data_ptr() % 16 else x
  if k0 is not None and k0.data_ptr() % 16:
    k0 = k0.clone()
  y = torch.empty_like(x)
  scratch = torch.empty_like(x)
  tw_h, tw_w = _tables(route, h, x.device), _tables(route, w, x.device)
  k0_ptr = None if k0 is None else native.ptr(k0)
  with torch.cuda.device(x.device):
    if route == 'fft':
      code = plan_code(h)
      status = _lib().dc_forward(
          native.ptr(x), k0_ptr, native.ptr(mask), native.ptr(y),
          native.ptr(scratch), native.ptr(tw_h), native.ptr(tw_w), code, code,
          b, h, w, native.stream_of(x))
    else:
      status = _lib().dc_forward_dft(
          native.ptr(x), k0_ptr, native.ptr(mask), native.ptr(y),
          native.ptr(scratch), native.ptr(tw_h), native.ptr(tw_w), b, h, w,
          native.stream_of(x))
  native.check(status, 'dc_forward')
  return y


def dc_cuda(x, k0, mask):
  """Launch the DC kernel (csrc/dc.cu) on CUDA tensors."""
  y = _launch('dc_cuda', x, k0, mask)
  dc_cuda.launches += 1
  return y


dc_cuda.launches = 0


def dc_bwd_cuda(g, mask):
  """K1-bwd: ``grad_x = DC(g, 0, mask)``, the DC kernel without k0."""
  y = _launch('dc_bwd_cuda', g, None, mask)
  dc_bwd_cuda.launches += 1
  return y


dc_bwd_cuda.launches = 0


def dc_plain_vjp(g, mask, need_k0=True):
  """Plain Hermitian VJP of the DC: ``(grad_x, grad_k0)`` for the output
  gradient ``g``; ``grad_k0`` is None unless ``need_k0``."""
  k = fft.fft2(fft.unpack_complex(g.float()))
  grad_x = fft.pack_complex(fft.ifft2((1 - mask[..., 0].float()) * k))
  return grad_x, fft.pack_complex(k) if need_k0 else None


class _DCFunction(torch.autograd.Function):
  """DC with its Hermitian backward: K1 forward, K1-bwd backward on CUDA
  tensors; on CPU tensors the same formula through the plain versions."""

  @staticmethod
  def forward(ctx, x, k0, mask):
    ctx.save_for_backward(mask)
    if x.device.type == 'cpu':
      return dc_plain(x, k0, mask)
    return dc_cuda(x, k0, mask)

  @staticmethod
  def backward(ctx, g):
    mask, = ctx.saved_tensors
    need_x, need_k0 = ctx.needs_input_grad[:2]
    g = g.float().contiguous()
    if g.device.type == 'cpu':
      grad_x, grad_k0 = dc_plain_vjp(g, mask, need_k0)
      return grad_x if need_x else None, grad_k0, None
    grad_x = dc_bwd_cuda(g, mask) if need_x else None
    grad_k0 = fft.pack_complex(fft.fft2(fft.unpack_complex(g))) \
        if need_k0 else None
    return grad_x, grad_k0, None


@torch.library.custom_op('csmri::dc', mutates_args=(), device_types='cpu')
def dc_op(x: torch.Tensor, k0: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
  """K1 without a gradient: the plain version on the CPU."""
  return dc_plain(x, k0, mask)


@dc_op.register_kernel('cuda')
def _dc_op_cuda(x, k0, mask):
  return dc_cuda(x, k0, mask)


@dc_op.register_fake
def _dc_op_fake(x, k0, mask):
  return torch.empty(x.shape, dtype=torch.float32, device=x.device)


def _needs_grad(*tensors):
  return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def dc_fused(x, k0, mask):
  """DC on packed tensors: the kernels (forward and backward) on CUDA, the
  autodiffed plain version on CPU; without a gradient, ``csmri::dc``."""
  if not _needs_grad(x, k0):
    return torch.ops.csmri.dc(x, k0, mask)
  if x.device.type == 'cpu':
    return dc_plain(x, k0, mask)
  return _DCFunction.apply(x, k0, mask)


def _own_rows(y, mesh):
  return halo.local_rows(y, mesh, 1).contiguous()


class _RowsDCFunction(torch.autograd.Function):
  """``dc_rows`` with a gradient: K1 on the gathered image forward, K1-bwd
  on the gathered gradient backward (plain versions on CPU tensors)."""

  @staticmethod
  def forward(ctx, x, k0, mask, mesh):
    ctx.save_for_backward(mask)
    ctx.mesh, ctx.h = mesh, x.shape[1]
    whole = halo.gather_rows(x, mesh, dim=1)
    y = dc_plain(whole, k0, mask) if x.device.type == 'cpu' else \
        dc_cuda(whole, k0, mask)
    return _own_rows(y, mesh)

  @staticmethod
  def backward(ctx, g):
    mask, = ctx.saved_tensors
    mesh, h = ctx.mesh, ctx.h
    need_x, need_k0 = ctx.needs_input_grad[:2]
    g = g.float().contiguous()
    grad_x = grad_k0 = None
    if need_x:
      whole = halo.gather_rows(g, mesh, dim=1)
      grad_x = _own_rows(dc_plain_vjp(whole, mask, False)[0]
                         if g.device.type == 'cpu' else
                         dc_bwd_cuda(whole, mask), mesh)
    if need_k0:
      share = g.new_zeros(mask.shape[:3] + (2,))
      share[:, mesh.s * h:(mesh.s + 1) * h] = g
      grad_k0 = fft.pack_complex(fft.fft2(fft.unpack_complex(share)))
    return grad_x, grad_k0, None, None


def dc_rows(x, k0, mask, mesh):
  """The DC of the rank's rows ``x`` (B, H/S, W, 2) of a spatial mesh,
  with the whole images' ``k0`` (B, H, W, 2) and ``mask`` (B, H, W, 1):
  the rank's rows of the whole image's DC."""
  h = x.shape[1]
  if k0.shape[1] != h * mesh.spatial or mask.shape[1] != k0.shape[1]:
    raise ValueError('dc_rows: {} rows on each of {} ranks need k0 and mask '
                     'of {} rows, got {} and {}'.format(
                         h, mesh.spatial, h * mesh.spatial, k0.shape[1],
                         mask.shape[1]))
  if not _needs_grad(x, k0):
    return _own_rows(torch.ops.csmri.dc(halo.gather_rows(x, mesh, dim=1),
                                        k0, mask), mesh)
  return _RowsDCFunction.apply(x, k0, mask, mesh)
