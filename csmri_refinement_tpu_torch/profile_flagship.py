"""Where the flagship forward's device time goes, by kernel.

    python -m csmri_refinement_tpu_torch.profile_flagship [--dtype bf16]
        [--size 256] [--batch 32]

``--dtype int8`` is bf16 compute with the U-Net's int8 serving mode
(``quantize_inference``), as ``bench.py --dtype int8``.

Builds ``build_flagship`` on the card at the flagship's 256² and B = 32
(as ``chip_smoke.py``; ``--size`` and ``--batch`` change them, e.g. B = 1
for the bench's batch-1 latency rows), warms up, times ten forwards untraced with CUDA
events, then traces three forwards with ``torch.profiler`` (CPU + CUDA
activities) and prints: the card's name and power limit, the untraced
time per forward, the traced wall time per forward, the summed device time
of every kernel, the device's idle share over the window, and the kernels
with the most device time. TF32 is off. Needs a CUDA device.
"""

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from csmri_refinement_tpu_torch.flagship import build_flagship

_DTYPES = {'bf16': torch.bfloat16, 'f32': torch.float32,
           'int8': torch.bfloat16}
SIZE, BATCH, FORWARDS, TOP = 256, 32, 3, 25
UNTRACED = 10


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--dtype', choices=sorted(_DTYPES), default='bf16')
  parser.add_argument('--size', type=int, default=SIZE)
  parser.add_argument('--batch', type=int, default=BATCH)
  args = parser.parse_args(argv)
  torch.backends.cudnn.allow_tf32 = False    # f32 means f32, as in chip_smoke
  torch.backends.cuda.matmul.allow_tf32 = False

  card = card_line()
  size, b = args.size, args.batch
  model, undersample_batch = build_flagship(
      size, _DTYPES[args.dtype], 'cuda', seed=0,
      quantize_inference=args.dtype == 'int8')
  gen = torch.Generator(device='cuda').manual_seed(0)
  batch = undersample_batch(gen, torch.rand(b, size, size, device='cuda',
                                            generator=gen), 'varden', 8)
  inputs = [batch[k] for k in ('inp', 'kspace', 'mask')]
  with torch.inference_mode():
    for _ in range(2):
      model(*inputs)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(UNTRACED):
      model(*inputs)
    end.record()
    torch.cuda.synchronize()
    untraced_ms = start.elapsed_time(end) / UNTRACED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      for _ in range(FORWARDS):
        model(*inputs)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3

  print(card)
  print('flagship forward {}^2 {} B{}: {:.3f} ms per forward untraced (CUDA '
        'events, {} forwards)'.format(size, args.dtype, b, untraced_ms,
                                      UNTRACED))
  report(prof, wall_ms, FORWARDS, 'flagship forward {}^2 {} B{}'.format(
      size, args.dtype, b), 'forward')


def card_line():
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def device_events(prof):
  """The ``key_averages()`` entries of the device's own operations
  (kernels, copies, sets), the most device time first.

  An op's entry repeats its kernels' time, and so does the device-side
  entry of each ``record_function`` range (``csmri.*`` spans, which the
  port opens while a profiler records): such an entry's device time is
  its whole span on the device's timeline, so it is left out, as
  torch's own table leaves it out of its device sum."""
  events = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]
  events.sort(key=lambda e: -e.self_device_time_total)
  return events


def report(prof, wall_ms, n, title, unit):
  """Print wall and device-busy ms per ``unit``, the idle share and the
  kernels with the most device time, from a ``torch.profiler`` trace of
  ``n`` units."""
  events = device_events(prof)
  device_ms = sum(e.self_device_time_total for e in events) / 1e3
  print('{}: wall {:.3f} ms per {} (traced), device busy {:.3f} ms per {}, '
        'idle share {:.1%}'.format(title, wall_ms / n, unit, device_ms / n,
                                   unit, max(0.0, 1 - device_ms / wall_ms)))
  print('{:>12} {:>7} {:>6}  kernel'.format('ms/' + unit, 'calls', 'share'))
  for e in events[:TOP]:
    ms = e.self_device_time_total / 1e3 / n
    print('{:12.4f} {:7d} {:6.1%}  {}'.format(
        ms, e.count // n, ms * n / device_ms, e.key[:110]))


if __name__ == '__main__':
  main()
