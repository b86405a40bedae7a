"""K5: int8 primitive probes (counterpart of ``scripts/probe_int8_prims.py``).

The TPU probe asked whether Mosaic accepts the int8 primitives of the
quantized chain kernel. These ask the same of the port's int8 conv kernel
(K3) on the same inputs (``RandomState(0)`` int8 in -127..127, then f32
``randn · 3``): s8 × s8 → s32 (256×128 · 128×128) on ``wgmma`` m64n64k32,
both operands K-major in shared memory (b transposed by the kernel; the
descriptors' layout fields from ``mma_descriptors``), an int8 lane roll
moved as 16-byte vectors of 32-bit words, an int8 iota select, the
whole-tile f32 → int8 requant as one cluster of 8 blocks that share their
maxima through distributed shared memory, and the s8 product with an f32
dequant (×0.01) from the accumulators. Each is exact: atol 1e-5, as the
TPU probe. ``throughput`` times the library's s8 and bf16 products at
4096³ as yardsticks (the TPU script's XLA dots).

    python -m csmri_refinement_tpu_torch.probes.int8_prims [--device cpu]
"""

import numpy as np
import torch

from csmri_refinement_tpu_torch import probes
from csmri_refinement_tpu_torch.ops import native

R, L = probes.R, probes.L
ATOL = 1e-5


def _mm(a, b):
  """s8 · s8 → s32, exact: float64 holds every sum (|sum| ≤ 128·127²)."""
  return (a.double() @ b.double()).to(torch.int32)


def _requant(f):
  amax = f.abs().max().clamp_min(1e-8)
  s = torch.full_like(amax, 127.0) / amax    # one division, as the kernel
  return torch.clamp(torch.round(f * s), -127, 127).to(torch.int8)


def _select(a):
  col = torch.arange(L, device=a.device)
  return torch.where(col < 32, a, torch.zeros_like(a))


def mma_descriptors():
  """(A, B) layout fields of the s8 product's ``wgmma`` descriptors
  (``csrc/probes.cu`` checks them). Both operands K-major (PTX transposes
  no 8-bit operand): a row of 128 bytes of K per row of A and per column
  of b, the 128-byte swizzle, 8-row groups 1024 bytes apart (SBO); the
  LBO is unused (16), since one row spans all of K."""
  d = probes.descriptor(16, 1024, 128)
  return d, d


# name: (op of csrc/probes.cu, output dtype, inputs, plain)
PROBES = {
    's8 x s8 -> s32 mma': (0, torch.int32, 'ab', _mm),
    'int8 lane roll via 32-bit words': (
        1, torch.int8, 'a', lambda a: torch.cat([a[:, -32:], a[:, :-32]], 1)),
    'int8 where(iota) select': (2, torch.int8, 'a', _select),
    'f32 -> int8 dynamic requant': (3, torch.int8, 'f', _requant),
    's8 mma + f32 dequant': (4, torch.float32, 'ab',
                             lambda a, b: _mm(a, b).float() * 0.01),
}


def probe_inputs(device='cuda'):
  """{'a': (R, L) int8, 'b': (L, L) int8, 'f': (R, L) f32}, drawn as the
  TPU probe draws them."""
  rng = np.random.RandomState(0)
  a = rng.randint(-127, 128, (R, L)).astype(np.int8)
  b = rng.randint(-127, 128, (L, L)).astype(np.int8)
  f = (rng.randn(R, L).astype(np.float32) * 3)
  return {k: torch.from_numpy(v).to(device)
          for k, v in (('a', a), ('b', b), ('f', f))}


def plain(name, *inputs):
  return PROBES[name][3](*inputs)


def probe_cuda(name, *inputs):
  """Launch the named probe's kernel (csrc/probes.cu) on CUDA tensors."""
  op, out_dtype, keys, _ = PROBES[name]
  first = inputs[0]
  want = {'a': ((R, L), torch.int8), 'b': ((L, L), torch.int8),
          'f': ((R, L), torch.float32)}
  for key, t in zip(keys, inputs):
    if (t.device.type != 'cuda' or (tuple(t.shape), t.dtype) != want[key] or
        not t.is_contiguous()):
      raise ValueError('probe {!r} takes contiguous CUDA inputs {}'.format(
          name, [want[k] for k in keys]))
  y = torch.empty((R, L), dtype=out_dtype, device=first.device)
  b = native.ptr(inputs[1]) if len(inputs) > 1 else None
  with torch.cuda.device(first.device):
    status = probes.lib().probe_int8(op, native.ptr(first), b,
                                     native.ptr(y), R, *mma_descriptors(),
                                     native.stream_of(first))
  native.check(status, 'probe_int8 ' + name)
  probe_cuda.launches += 1
  return y


probe_cuda.launches = 0


def probe(name, *inputs):
  """The named probe: its kernel on CUDA, its plain version on CPU."""
  if inputs[0].device.type == 'cpu':
    return plain(name, *inputs)
  return probe_cuda(name, *inputs)


def run_all(device='cuda'):
  """Every K5 probe against its plain version; a list of ``Result``s."""
  data = probe_inputs(device)
  results = []
  for name, (_, _, keys, _) in PROBES.items():
    results.append(probes.run_probe(name, lambda *t, n=name: probe(n, *t),
                                    lambda *t, n=name: plain(n, *t),
                                    [data[k] for k in keys], ATOL))
  return results


def throughput():
  """{'s8' | 'bf16': (ms, TOP/s)} of ``torch._int_mm`` (s8 → s32) and a
  bf16 ``torch.matmul`` at 4096³, CUDA events over 10 calls after a
  warm-up: the library's yardsticks beside the card's 1979 / 989 dense
  peaks. Needs a card."""
  n, iters = 4096, 10
  gen = torch.Generator(device='cuda').manual_seed(0)
  a8 = torch.randint(-127, 128, (n, n), device='cuda', generator=gen,
                     dtype=torch.int8)
  b8 = torch.randint(-127, 128, (n, n), device='cuda', generator=gen,
                     dtype=torch.int8)
  abf, bbf = a8.bfloat16(), b8.bfloat16()
  out = {}
  for name, fn in (('s8', lambda: torch._int_mm(a8, b8)),
                   ('bf16', lambda: torch.matmul(abf, bbf))):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
      fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    out[name] = (ms, 2 * n ** 3 / ms / 1e9)
  return out


def print_throughput():
  for name, (ms, rate) in throughput().items():
    print('{} 4096^3 matmul: {:.3f} ms = {:.0f} T{}/s'.format(
        name, ms, rate, 'OP' if name == 's8' else 'FLOP'), flush=True)


if __name__ == '__main__':
  probes.main(run_all, __doc__.split('\n')[0], on_card=print_throughput)
