"""Benchmark: the flagship serving forward's throughput, on the card.

    python -m csmri_refinement_tpu_torch.bench [--batch-size 128]
        [--image-size 256] [--iters 10] [--warmup 3]
        [--dtype {f32,bf16,int8}] [--platform {cpu,gpu}] [--profile DIR]
        [--components] [--extra-sizes N ...] [--train] [--latency]
        [--train-steps 8] [--train-dtype DTYPE] [--fused-conv]
        [--budget SECONDS]

Counterpart of the JAX package's top-level ``bench.py``, with its flags, its
output contract and its metric names. It measures slices/s of
``flagship.build_flagship`` (RecNet 3×3×32 with a DC after each block, then
the refinement U-Net in a real-penalty-add wrapper, the ``configs/1+2``
recipe) on a varden-8× batch, on the card unless ``--platform cpu`` is
given. ``f32`` is full f32 (TF32 off), ``bf16`` bf16 compute, ``int8`` bf16
compute with the int8 serving mode (``quantize_inference``).

Prints ONE JSON line on stdout: either
  {"metric", "value", "unit"}              (a measurement), or
  {"metric", "error", "stage", "unit"}     (a structured failure, exit != 0).
The extra rows (``--extra-sizes``, ``--latency``, ``--train``) go to stderr
behind an ``extra: `` prefix and ``--components`` prints its table there, so
that stdout and stderr merged hold exactly one bare JSON line.

The record cannot be lost: the command runs a watchdog parent that imports
no torch and re-executes this module as a measurement child. The child
sends stage markers, and the headline the moment it has it, to the parent,
which relays the headline at once. If the child hangs (in CUDA
initialisation, say), fails, or overruns the wall-clock budget, the parent
kills it and prints a structured error whose ``stage`` tells a card that
never came up (``preflight``; ``backend_init_hang`` past the preflight
deadline) from a failure of the program (``measure``).

Unlike the JAX tool it never falls back: a failed headline is an error
record of stage ``measure`` and a non-zero exit, not a retry in f32 at
another batch. It prints no ``vs_baseline`` (the JAX tool's target is a
TPU's). ``--fused-conv`` is taken and changes nothing: the port's eval
U-Net always runs its conv chains through the conv kernels; the latency
rows still name it, as the JAX tool's do. The time is eager PyTorch under
``torch.inference_mode()``, with no CUDA graph and no ``torch.compile``.
"""

import argparse
import json
import os
import sys
import time

_CHILD_ENV = '_CSMRI_BENCH_CHILD'
# The preflight (import torch, CUDA initialisation, a small matmul and its
# fetch) takes seconds on a healthy card; past this it is wedged.
_PREFLIGHT_DEADLINE_S = 210.0
_DEFAULT_BUDGET_S = 540.0
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _metric_name(image_size, dtype_str):
  return ('{s}x{s} recon slices/sec/chip (cascade+refine inference, '
          '{d} compute)'.format(s=image_size, d=dtype_str))


# ---------------------------------------------------------------------------
# Watchdog parent: no torch, just child supervision and the stdout contract.
# ---------------------------------------------------------------------------


def parent_main(argv, args):
  import queue
  import signal
  import subprocess
  import threading

  budget = args.budget
  if budget is None:
    default = _DEFAULT_BUDGET_S
    if args.train or args.components or args.latency or args.extra_sizes:
      default = 4 * _DEFAULT_BUDGET_S  # runs with extras take far longer
    budget = float(os.environ.get('CSMRI_BENCH_BUDGET_S', default))

  env = dict(os.environ)
  env[_CHILD_ENV] = '1'
  # the child imports this package, wherever the parent was started from
  env['PYTHONPATH'] = os.pathsep.join(
      [_REPO] + [p for p in [env.get('PYTHONPATH')] if p])
  child = subprocess.Popen(
      [sys.executable, '-m', 'csmri_refinement_tpu_torch.bench'] + list(argv),
      stdout=subprocess.PIPE, env=env, text=True, bufsize=1)

  lines = queue.Queue()

  def _reader():
    try:
      for line in child.stdout:
        lines.put(line)
    finally:
      lines.put(None)

  threading.Thread(target=_reader, daemon=True).start()

  state = {'stage': 'spawn', 'printed': False, 'headline': False,
           'error': None}

  def emit(record):
    if state['printed']:
      return
    state['printed'] = True
    print(json.dumps(record))
    sys.stdout.flush()

  def emit_error(error):
    emit({'metric': _metric_name(args.image_size, args.dtype),
          'error': error, 'stage': state['stage'], 'unit': 'slices/s'})

  def finish(error, rc):
    try:
      child.kill()
    except Exception:
      pass
    # A headline the child already sent still counts: drain the reader
    # (briefly, bounded) up to its end-of-stream mark before judging.
    drain_deadline = time.monotonic() + 2.0
    while not state['headline']:
      try:
        line = lines.get(timeout=max(0.0,
                                     drain_deadline - time.monotonic()))
      except queue.Empty:
        break
      if line is None:
        break
      try:
        msg = json.loads(line)
      except ValueError:
        continue
      if isinstance(msg, dict) and msg.pop('_kind', None) == 'headline':
        state['headline'] = True
        emit(msg)
    if state['headline']:
      sys.exit(0)
    emit_error(error)
    sys.exit(rc)

  class _Term(Exception):
    pass

  def _on_signal(signum, frame):
    raise _Term(signal.Signals(signum).name)

  for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
    try:
      signal.signal(sig, _on_signal)
    except (ValueError, OSError):
      pass

  start = time.monotonic()
  preflight_ok = False
  try:
    while True:
      # Drain what the child already sent BEFORE judging deadlines: a
      # headline waiting in the queue outranks a deadline.
      try:
        line = lines.get_nowait()
      except queue.Empty:
        now = time.monotonic()
        if not preflight_ok and now - start > _PREFLIGHT_DEADLINE_S:
          finish('backend_init_hang', 3)
        if now - start > budget:
          finish('budget_exceeded', 3)
        try:
          line = lines.get(timeout=1.0)
        except queue.Empty:
          continue
      if line is None:  # the child's stdout ended
        rc = child.wait()
        if state['headline']:
          sys.exit(0)
        finish(state['error'] or 'child_exit_rc_{}'.format(rc), 3)
      try:
        msg = json.loads(line)
      except ValueError:
        continue  # stray child output never breaks the contract
      if not isinstance(msg, dict):
        continue
      kind = msg.pop('_kind', None)
      if kind == 'stage':
        state['stage'] = msg.get('stage', state['stage'])
        if state['stage'] == 'preflight_ok':
          preflight_ok = True
      elif kind == 'failed':
        state['error'] = msg.get('error')
      elif kind == 'headline':
        state['headline'] = True
        emit(msg)
  except _Term as e:
    finish(str(e).lower(), 3)


# ---------------------------------------------------------------------------
# Measurement child.
# ---------------------------------------------------------------------------


def _send(kind, record):
  print(json.dumps(dict(record, _kind=kind)))
  sys.stdout.flush()


def _mark(stage):
  _send('stage', {'stage': stage})


def _headline(record):
  _send('headline', record)


def preflight(device):
  """CUDA initialisation, a 256×256 f32 matmul and its sum fetched; raises
  where there is no card (unless ``device`` is ``'cpu'``) or the sum is
  wrong."""
  import torch
  if device == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError('no CUDA device; pass --platform cpu to run the '
                         'plain versions on the CPU')
    torch.cuda.init()
  x = torch.ones(256, 256, device=device)
  got = float((x @ x).sum())
  if got != 256.0 * 256 * 256:
    raise RuntimeError('preflight matmul sum {} != 256^3'.format(got))


def build_forward(image_size, dtype_str, device='cuda'):
  """(forward, model, batch_for) of the flagship at ``image_size``².

  ``dtype_str``: f32 | bf16 | int8 (bf16 compute with the int8 serving
  mode, ``ops/quantize.py``, outside the 0.1 dB default quality budget).
  ``forward(inp, kspace, mask)`` returns ``pred``; ``batch_for(b)`` is a
  varden-8× batch of ``b`` uniform slices from a generator on ``device``
  seeded with 0, as are the weights."""
  import torch
  from csmri_refinement_tpu_torch.flagship import build_flagship
  if dtype_str not in ('f32', 'bf16', 'int8'):
    raise ValueError('dtype must be f32, bf16 or int8, got {!r}'.format(
        dtype_str))
  dtype = torch.float32 if dtype_str == 'f32' else torch.bfloat16
  model, undersample_batch = build_flagship(
      image_size, dtype, device, 0, quantize_inference=dtype_str == 'int8')

  def batch_for(batch_size):
    gen = torch.Generator(device=device).manual_seed(0)
    gt = torch.rand(batch_size, image_size, image_size, device=device,
                    generator=gen)
    return undersample_batch(gen, gt, 'varden', 8)

  def forward(inp, kspace, mask):
    return model(inp, kspace, mask)['pred']

  return forward, model, batch_for


def run_bench(batch_size, image_size, iters, warmup, dtype_str,
              device='cuda'):
  """Slices/s of the forward: the best of 4 pairs of a pass of ``warmup``
  forwards subtracted from a pass of ``warmup + iters``.

  Each pass is data-dependent (every forward takes the previous ``pred``,
  cast to ``inp``'s dtype, as its input) and ends in one scalar fetched to
  the host, so it ends when the card has done its work."""
  import math
  import torch
  from csmri_refinement_tpu_torch.utils.precision import full_f32

  forward, _, batch_for = build_forward(image_size, dtype_str, device)
  batch = batch_for(batch_size)
  inp, kspace, mask = batch['inp'], batch['kspace'], batch['mask']

  def loop(n):
    x = inp
    with torch.inference_mode(), full_f32():
      for _ in range(n):
        x = forward(x, kspace, mask).to(inp.dtype)
      return float(x.float().sum())

  val = loop(warmup)
  if not math.isfinite(val):
    raise FloatingPointError('non-finite benchmark output {}'.format(val))
  loop(warmup + iters)

  best = 0.0
  for _ in range(4):
    start = time.perf_counter()
    loop(warmup)
    base = time.perf_counter() - start

    start = time.perf_counter()
    loop(warmup + iters)
    elapsed = time.perf_counter() - start

    # the warm pass's fixed issue and fetch cost is subtracted; a pair in
    # which noise outweighs the ``iters`` forwards says nothing
    if elapsed > base:
      best = max(best, batch_size * iters / (elapsed - base))
  if not best:
    raise RuntimeError('no pass of {} forwards outlasted its pass of {}: '
                       'raise --iters'.format(warmup + iters, warmup))
  return best


def _ms_per_call(fn, device, iters=8, warmup=2):
  """Mean ms per call: CUDA events on the card (``timed_ms``), the host
  clock on the CPU."""
  if device == 'cuda':
    from csmri_refinement_tpu_torch.utils.profiling import timed_ms
    return timed_ms(fn, iters=iters, warmup=warmup)
  for _ in range(warmup):
    fn()
  start = time.perf_counter()
  for _ in range(iters):
    fn()
  return (time.perf_counter() - start) * 1e3 / iters


def run_components(image_size, batch_size, dtype_str, device='cuda'):
  """Milliseconds per batch of the forward's three parts, on stderr: the
  RecNet 3×3×32 (3 DCs), the refinement U-Net (10 conv-chain layers) and
  one DC."""
  import torch
  from csmri_refinement_tpu_torch.models.recnet import RecNet
  from csmri_refinement_tpu_torch.models.unet import UNET
  from csmri_refinement_tpu_torch.ops import dc as dc_ops
  from csmri_refinement_tpu_torch.utils.precision import full_f32

  dt = torch.bfloat16 if dtype_str == 'bf16' else torch.float32
  b, s = batch_size, image_size
  gen = torch.Generator(device=device).manual_seed(1)
  inp = torch.randn(b, s, s, 2, device=device, generator=gen).to(dt)
  ksp = torch.randn(b, s, s, 2, device=device, generator=gen)
  mask = torch.ones(b, s, s, 1, device=device)

  recnet = RecNet(num_blocks=3, num_convs=3, num_filters=32, dtype=dt)
  unet = UNET(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
              encode_filters=[32, 64, 128], decode_filters=[64, 32],
              kernel_size=4, upsampling_mode='nn-resize-conv',
              output_activation='none', padding='reflection',
              decoder_act_upsampling_only=True, dtype=dt)
  for net in (recnet, unet):
    net.init_weights(torch.Generator().manual_seed(0))
    net.to(device).eval()
  x32 = inp.float()
  rows = []
  with torch.inference_mode(), full_f32():
    rows.append(('recnet 3x3x32', _ms_per_call(
        lambda: recnet(inp, ksp, mask), device)))
    rows.append(('refinement unet', _ms_per_call(lambda: unet(inp), device)))
    rows.append(('dc (fused)', _ms_per_call(
        lambda: dc_ops.data_consistency(x32, ksp, mask), device)))

  for name, ms in rows:
    sys.stderr.write('component {:24s} {:8.2f} ms/batch ({} B{} {})\n'
                     .format(name, ms, s, b, dtype_str))
  sys.stderr.flush()


def _extra_row(row):
  """An extra measurement, on stderr behind a non-JSON prefix.

  A reader that merges stdout and stderr and takes the last JSON-looking
  line as the record must find the headline only; 'extra: ' keeps every
  such row unparseable as JSON while it stays grep-able."""
  sys.stderr.write('extra: ' + json.dumps(row) + '\n')
  sys.stderr.flush()


def _train_runner(config, runner_type, image_size, batch_size, train_dtype,
                  device, edit=None):
  """A runner of ``configs/<config>`` in mode 'train' on Synthetic
  ``image_size``² phantoms at ``batch_size``, and one host batch."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils.config import Configuration

  with open(os.path.join(_REPO, 'configs', config)) as f:
    raw = json.load(f)
  if edit is not None:
    edit(raw)
  raw.update({
      'train_dataset': 'Synthetic', 'validation_dataset': 'Synthetic',
      'synthetic': {'image_size': image_size, 'num_train': batch_size * 4,
                    'num_val': batch_size},
      'batch_size': batch_size, 'num_data_workers': 0,
  })
  if train_dtype:
    raw['train_dtype'] = train_dtype
  conf = Configuration.from_dict(raw)
  runner = build_runner(conf, runner_type, mode='train', device=device)
  dataset = load_dataset(conf, None, 'Synthetic', 'train')
  loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                      num_workers=0)
  return runner, next(iter(loader))


def _train_rows(runner, host_batch, batch_size, steps, steps_per_fetch):
  """Samples/s of ``runner``'s train step: per step (each update's losses
  fetched), then with ``steps_per_fetch`` updates a fetch. Returns both."""

  def timed(calls, batches):
    updates = 0
    start = time.perf_counter()
    for _ in range(calls):
      updates += runner._train_step(iter(batches))[0]
    return batch_size * updates / (time.perf_counter() - start)

  runner.steps_per_fetch = 1
  timed(2, [host_batch])  # warm
  per_step = timed(steps, [host_batch])

  runner.steps_per_fetch = steps_per_fetch
  batches = [host_batch] * steps_per_fetch
  timed(1, batches)  # warm
  per_fetch = timed(max(steps // steps_per_fetch, 2), batches)
  return per_step, per_fetch


def run_train_bench(image_size, batch_size, steps, train_dtype=None,
                    device='cuda', steps_per_fetch=8):
  """GAN training throughput (``configs/2-refinement.json`` on Synthetic
  data, no pretrained RecNet, a seeded VGG19): samples/s of the D-then-G
  update, per step and with ``steps_per_fetch`` updates a fetch, as two
  extra rows."""

  def edit(raw):
    # random init: the same compute; a throughput bench, not a quality run
    del raw['generator_model']['pretrained_model']['pretrained_weights']
    raw['vgg_random_init'] = True

  runner, host_batch = _train_runner('2-refinement.json', 'adversarial',
                                     image_size, batch_size, train_dtype,
                                     device, edit)
  tag = ', {} compute'.format(train_dtype) if train_dtype else ''
  per_step, per_fetch = _train_rows(runner, host_batch, batch_size, steps,
                                    steps_per_fetch)
  _extra_row({
      'metric': '{s}x{s} GAN train samples/sec/chip (flagship recipe, '
                'D-then-G step{t})'.format(s=image_size, t=tag),
      'value': round(per_step, 2), 'unit': 'samples/s'})
  _extra_row({
      'metric': '{s}x{s} GAN train samples/sec/chip (steps_per_fetch={k} '
                'scan{t})'.format(s=image_size, k=steps_per_fetch, t=tag),
      'value': round(per_fetch, 2), 'unit': 'samples/s'})


def run_standard_train_bench(image_size, batch_size, steps, train_dtype=None,
                             device='cuda', steps_per_fetch=8):
  """RecNet training throughput (``configs/1-recnet.json``, MSE, on
  Synthetic data): per step and with ``steps_per_fetch`` updates a fetch,
  as two extra rows."""
  runner, host_batch = _train_runner('1-recnet.json', 'standard', image_size,
                                     batch_size, train_dtype, device)
  tag = ', {} compute'.format(train_dtype) if train_dtype else ''
  per_step, per_fetch = _train_rows(runner, host_batch, batch_size, steps,
                                    steps_per_fetch)
  _extra_row({
      'metric': '{s}x{s} RecNet train samples/sec/chip (configs/1 recipe, '
                'per-step fetch{t})'.format(s=image_size, t=tag),
      'value': round(per_step, 2), 'unit': 'samples/s'})
  _extra_row({
      'metric': '{s}x{s} RecNet train samples/sec/chip (steps_per_fetch='
                '{k} scan{t})'.format(s=image_size, k=steps_per_fetch, t=tag),
      'value': round(per_fetch, 2), 'unit': 'samples/s'})


def _failed(stage, error):
  """An extra that failed: its message and traceback on stderr."""
  import traceback
  sys.stderr.write('bench: {} failed ({}: {})\n'.format(
      stage, type(error).__name__, error))
  traceback.print_exc()
  sys.stderr.flush()


def child_main(args):
  device = 'cpu' if args.platform == 'cpu' else 'cuda'
  try:
    # A card that never comes up stalls or fails here, where the parent's
    # deadline or this record names the stage.
    _mark('preflight')
    preflight(device)
    _mark('preflight_ok')

    _mark('measure')
    from csmri_refinement_tpu_torch.utils.profiling import trace
    with trace(args.profile):
      slices_per_sec = run_bench(args.batch_size, args.image_size,
                                 args.iters, args.warmup, args.dtype, device)
  except Exception as e:
    # no fallback: the parent prints the error record and exits non-zero
    _send('failed', {'error': '{}: {}'.format(type(e).__name__, e)[:300]})
    raise

  # The official record goes out FIRST; everything after is best-effort.
  _headline({'metric': _metric_name(args.image_size, args.dtype),
             'value': round(slices_per_sec, 1), 'unit': 'slices/s'})

  _mark('extras')
  if args.components:
    try:
      run_components(args.image_size, args.batch_size, args.dtype, device)
    except Exception as e:
      _failed('--components', e)

  if args.train:
    # the paper's batches (GAN 5, RecNet 20) and large-batch throughput
    dtag = ', {} compute'.format(args.train_dtype) if args.train_dtype \
        else ''
    for bs, st in ((5, args.train_steps), (32, max(args.train_steps // 2, 2))):
      try:
        run_train_bench(args.image_size, bs, st, args.train_dtype, device)
      except Exception as e:
        _failed('GAN train batch {}'.format(bs), e)
        _extra_row({
            'metric': '{s}x{s} GAN train samples/sec/chip (batch {b}{t})'
                      .format(s=args.image_size, b=bs, t=dtag),
            'error': type(e).__name__})
    for bs in (20, 128):
      try:
        run_standard_train_bench(args.image_size, bs,
                                 max(args.train_steps, 8), args.train_dtype,
                                 device)
      except Exception as e:
        _failed('RecNet train batch {}'.format(bs), e)
        _extra_row({
            'metric': '{s}x{s} RecNet train samples/sec/chip (batch {b}{t})'
                      .format(s=args.image_size, b=bs, t=dtag),
            'error': type(e).__name__})

  extra_sizes = args.extra_sizes
  if extra_sizes is None:
    extra_sizes = [512] if args.image_size != 512 else []

  if args.latency:
    # Batch-1 single-slice serving latency (the paper's validate runs at
    # batch 1), with more iterations: each call does ~100x less work.
    for size in [args.image_size] + list(extra_sizes):
      try:
        rate = run_bench(1, size, max(args.iters * 5, 30), args.warmup,
                         args.dtype, device)
        row = {'metric': '{s}x{s} recon batch-1 serving latency '
                         '({d}{f} compute)'.format(
                             s=size, d=args.dtype,
                             f='+fused' if args.fused_conv else ''),
               'value': round(1e3 / rate, 2), 'unit': 'ms/slice'}
      except Exception as e:
        _failed('latency at {}'.format(size), e)
        row = {'metric': '{s}x{s} recon batch-1 serving latency'
                         .format(s=size), 'error': type(e).__name__}
      _extra_row(row)

  # The batch stays the headline's (at least 8) at every size.
  for size in extra_sizes:
    try:
      extra = run_bench(max(args.batch_size, 8), size, args.iters,
                        args.warmup, args.dtype, device)
      row = {'metric': _metric_name(size, args.dtype),
             'value': round(extra, 1), 'unit': 'slices/s'}
    except Exception as e:
      _failed('size {}'.format(size), e)
      row = {'metric': '{s}x{s} recon slices/sec/chip'.format(s=size),
             'error': type(e).__name__}
    _extra_row(row)


def main(argv):
  parser = argparse.ArgumentParser(
      prog='python -m csmri_refinement_tpu_torch.bench')
  parser.add_argument('--batch-size', type=int, default=128)
  parser.add_argument('--image-size', type=int, default=256)
  parser.add_argument('--iters', type=int, default=10)
  parser.add_argument('--warmup', type=int, default=3)
  parser.add_argument('--dtype', default='bf16',
                      choices=['f32', 'bf16', 'int8'])
  parser.add_argument('--platform', default=None, choices=['cpu', 'gpu'],
                      help='gpu (the default): the card, whose absence is '
                           'an error; cpu: the kernels\' plain versions')
  parser.add_argument('--profile', metavar='DIR', default=None,
                      help='write a torch.profiler trace of the headline '
                           'measurement into DIR')
  parser.add_argument('--components', action='store_true',
                      help='also print a per-component ms table to stderr')
  parser.add_argument('--extra-sizes', type=int, nargs='*', default=None,
                      help='extra resolutions measured to stderr (stdout '
                           'stays one JSON line). Default: the paper '
                           'resolution 512. Pass an empty list to skip.')
  parser.add_argument('--train', action='store_true',
                      help='also measure GAN (batch 5, 32) and RecNet '
                           '(batch 20, 128) training throughput; stderr '
                           'rows')
  parser.add_argument('--latency', action='store_true',
                      help='also measure batch-1 serving latency at the '
                           'main and extra sizes; stderr rows')
  parser.add_argument('--train-steps', type=int, default=8)
  parser.add_argument('--train-dtype', default=None,
                      help='training compute dtype for the --train rows '
                           '(e.g. bfloat16); parameters stay f32')
  parser.add_argument('--fused-conv', action='store_true',
                      help='taken for the JAX tool\'s command lines; the '
                           'eval U-Net always runs its chains through the '
                           'conv kernels')
  parser.add_argument('--budget', type=float, default=None,
                      help='watchdog wall-clock budget in seconds (default '
                           'env CSMRI_BENCH_BUDGET_S or {}, four times that '
                           'with extras); past it the headline, if sent, '
                           'or a structured error is printed'.format(
                               int(_DEFAULT_BUDGET_S)))
  args = parser.parse_args(argv)

  if os.environ.get(_CHILD_ENV):
    child_main(args)
  else:
    parent_main(argv, args)


if __name__ == '__main__':
  main(sys.argv[1:])
