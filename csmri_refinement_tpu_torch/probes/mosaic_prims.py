"""K4: bf16 layout probes (counterpart of ``scripts/probe_mosaic_prims.py``).

The TPU probe asked which Mosaic primitives a bf16 Pallas kernel may use.
These ask the same of the moves the port's bf16 conv kernel (K2) makes in
shared memory, on the same tiles (``x = arange · 1e-3`` in bf16): a lane
roll moved as single values and as 32-bit pairs, a row roll, unaligned row
reads and writes, an iota select, a strided mid-dim read, a scratch chain,
a pair roll on a 250-row tile, each a band of 16 rows a block staged with
16-byte loads (plus the rows it reads across the band's edge) and stored
with 16-byte stores; and K2's halo read: a ``wgmma`` bf16 A operand
through a no-swizzle K-major descriptor that starts at an odd pixel of a
planar halo (``odd_pixel_descriptors``), times the identity. Each is
exact: atol 1e-6, as the TPU probe.

    python -m csmri_refinement_tpu_torch.probes.mosaic_prims [--device cpu]
"""

import math

import torch

from csmri_refinement_tpu_torch import probes
from csmri_refinement_tpu_torch.ops import native

R, L = probes.R, probes.L
ATOL = 1e-6


def _roll_lanes(x, shift):
  return torch.cat([x[:, -shift:], x[:, :-shift]], dim=1)


def _roll_pairs(x, shift):
  """Lane roll of a bf16 tile moved as 32-bit words (two lanes each)."""
  return _roll_lanes(x.view(torch.int32), shift // 2).view(torch.bfloat16)


def _write_rows(x):
  y = torch.zeros_like(x)
  y[1:R - 15] = x[:R - 16]
  return y


def _scratch_chain(x):
  s = torch.zeros(R + 16, L, dtype=x.dtype, device=x.device)
  s[8:8 + R] = x
  s[0:8] = s[8:16]
  return s[1:1 + R] * 2


def _iota_select(x):
  col = torch.arange(L, device=x.device)
  return torch.where(col < 32, x * 2, x)


def _odd_pixels(x):
  """The tile as 16-channel pixels, pixels 1 .. n-15, in f32."""
  return x.reshape(-1, 16)[1:-15].float()


# name: (op of csrc/probes.cu, input shape, output shape, output dtype, plain)
PROBES = {
    'lane roll bf16 by 32': (0, (R, L), (R, L), torch.bfloat16,
                             lambda x: _roll_lanes(x, 32)),
    'lane roll bf16 as 32-bit pairs': (1, (R, L), (R, L), torch.bfloat16,
                                       lambda x: _roll_pairs(x, 32)),
    'row roll bf16 by 1': (2, (R, L), (R, L), torch.bfloat16,
                           lambda x: torch.cat([x[-1:], x[:-1]])),
    'unaligned row read': (3, (R, L), (R - 16, L), torch.bfloat16,
                           lambda x: x[1:R - 15]),
    'unaligned row write': (4, (R, L), (R, L), torch.bfloat16, _write_rows),
    'bf16 where(iota) select': (5, (R, L), (R, L), torch.bfloat16,
                                _iota_select),
    'strided mid-dim read': (6, (64, 8, L), (64, L), torch.bfloat16,
                             lambda x: x[:, 3, :]),
    'scratch write+unaligned read': (7, (R, L), (R, L), torch.bfloat16,
                                     _scratch_chain),
    'pair roll by 64 on 250-row tile': (8, (250, L), (250, L),
                                        torch.bfloat16,
                                        lambda x: _roll_pairs(x, 64)),
    'wgmma bf16 A descriptor at odd pixel': (
        9, (R, L), (R * L // 16 - 16, 16), torch.float32, _odd_pixels),
}

ODD_TILES = 1    # 64-pixel tiles per block of the odd-pixel probe


def odd_pixel_plane():
  """Bytes of one channel plane of the odd-pixel probe's staged halo: the
  block's 64 · ODD_TILES pixels plus one, rounded to 8, 16 bytes each."""
  return (64 * ODD_TILES + 8) * 16


def odd_pixel_descriptors():
  """(A, B) layout fields of the odd-pixel probe's ``wgmma`` descriptors
  (``csrc/probes.cu`` checks them), no swizzle, K-major. A is K2's halo
  descriptor: 16-byte pixel rows, 8-pixel groups 128 bytes apart (SBO),
  channels 8-15 one plane on (LBO). B, the 16 × 16 identity: 16-byte rows
  of 8 k, 8-row groups 128 bytes apart, k 8-15 256 bytes on."""
  return (probes.descriptor(odd_pixel_plane(), 128),
          probes.descriptor(256, 128))


def probe_input(shape, device='cuda'):
  """``arange · 1e-3`` in bf16, the TPU probe's input."""
  x = torch.arange(math.prod(shape), dtype=torch.float32, device=device)
  return x.reshape(shape).to(torch.bfloat16) * 1e-3


def plain(name, x):
  return PROBES[name][4](x)


def probe_cuda(name, x):
  """Launch the named probe's kernel (csrc/probes.cu) on a CUDA tile."""
  op, in_shape, out_shape, out_dtype, _ = PROBES[name]
  if x.device.type != 'cuda' or x.dtype != torch.bfloat16:
    raise ValueError('probe_cuda takes a bf16 CUDA tensor')
  if tuple(x.shape) != in_shape or not x.is_contiguous():
    raise ValueError('probe {!r} takes a contiguous {} tile'.format(
        name, in_shape))
  y = torch.empty(out_shape, dtype=out_dtype, device=x.device)
  rows = x.numel() // L
  with torch.cuda.device(x.device):
    status = probes.lib().probe_bf16(op, native.ptr(x), native.ptr(y), rows,
                                     *odd_pixel_descriptors(),
                                     native.stream_of(x))
  native.check(status, 'probe_bf16 ' + name)
  probe_cuda.launches += 1
  return y


probe_cuda.launches = 0


def probe(name, x):
  """The named probe: its kernel on CUDA, its plain version on CPU."""
  return plain(name, x) if x.device.type == 'cpu' else probe_cuda(name, x)


def run_all(device='cuda'):
  """Every K4 probe against its plain version; a list of ``Result``s."""
  results = []
  for name, (_, in_shape, _, _, _) in PROBES.items():
    x = probe_input(in_shape, device)
    results.append(probes.run_probe(name, lambda t, n=name: probe(n, t),
                                    lambda t, n=name: plain(n, t), [x],
                                    ATOL))
  return results


if __name__ == '__main__':
  probes.main(run_all, __doc__.split('\n')[0])
