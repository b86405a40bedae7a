#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``csmri_refinement_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit. Phases, each failing loudly with a non-zero exit:

1. require a CUDA device; print the card's name and power limit;
2. build both hand-written kernels from ``csrc/`` (nvcc, in parallel);
3. DC kernel vs its plain version (cuFFT) at 256², B=32 and 512², B=8, f32,
   and the sampled k-space lines of its output vs k0;
4. conv-chain kernel vs its plain version on the five flagship U-Net chains
   at their shapes for a 256² input, B=32, bf16, plus k3 zero-pad,
   replicate-pad and f32 cases;
5. the main path: ``build_flagship(256, bf16)`` on a varden-8× batch,
   B=32, a few forwards under ``torch.inference_mode()``, with the kernels'
   launch counters set to 0 just before and read just after;
6. the same weights and inputs, f32, B=2, on the card (kernels) and on the
   CPU (plain versions): outputs and PSNR must agree;
7. timings with CUDA events: each kernel, its plain version, the library
   call, and the forward's slices/s;
8. the DC backward (K1-bwd, through ``_DCFunction``) vs its plain version
   ``dc_plain_vjp`` at the training shape (256², B=16) and 512², B=4, with
   and without a k0 gradient;
9. the second main path, standard RecNet training: the trainer's CLI
   (``csmri_refinement_tpu_torch.train``) on ``configs/synthetic-recnet.json``
   unchanged (RecNet 3×3×32, f32, 256², B=16, varden 8×, MSE, Adam 2e-4),
   one epoch of 8 steps and a validation, with the launch counters set to
   0 just before and read just after: 3 K1 + 3 K1-bwd per step;
10. the same init and the same five fixed-mask batches, trained on the card
    (kernels) and on the CPU (plain versions): losses must agree;
11. timings: K1-bwd, its plain version and the cuFFT composition, and the
    train step with TF32 off and on.

Also prints the bounds of the TPU kernels not ported yet (K3-K5), from
their shapes. Prints a ``{"kernels": [...]}`` line, then, last,
``{"ok": true, "device":
{...}}``. TF32 is off throughout (except the one TF32 step timing), so every
f32 reference is full f32.
"""

import copy
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEVICE = 'cuda'
SIZE = 256         # the flagship image side
BATCH = 32         # slices per forward on the main path

# Published H100 SXM peaks at 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12

# bf16 chain tolerance, relative to max |ref|: kernel and plain version
# round every layer's output to bf16 at the same place, but sum in another
# order; a near-tie then rounds to the neighbouring bf16 value (2^-8
# relative) and the next layer carries that on. 2e-2 is five such steps.
BF16_REL_TOL = 2e-2
F32_ATOL = 2e-4          # tests/test_dc_pallas.py:26, test_conv_pallas.py:75
E2E_ATOL = 5e-4          # tests/test_conv_pallas.py:130
PSNR_TOL_DB = 0.1        # tests/test_forward_parity.py:8-11
GRAD_ATOL = 2e-3         # tests/test_dc_pallas.py:46

TRAIN_CONFIG = os.path.join(REPO, 'configs', 'synthetic-recnet.json')
TRAIN_BATCH = 16         # batch_size of the config
TRAIN_STEPS = 5          # card vs CPU steps
# Card vs CPU losses, both full f32: cuDNN vs oneDNN convs and the DC
# kernel vs pocketfft sum in other orders (~1e-6 relative per op), and five
# Adam steps carry that on; the CPU trajectory test against the JAX runner
# sees 1.5e-6 (tests/test_torch_port_train.py). 1e-3 leaves a wide margin
# for that noise and none for a wrong gradient or update.
LOSS_RTOL = 1e-3


def fail(msg):
  print('chip_smoke FAILED: ' + msg, file=sys.stderr)
  sys.exit(1)


def require(cond, msg):
  if not cond:
    fail(msg)


def card_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout
  return out.strip().splitlines()[0]


def sync():
  torch.cuda.synchronize()


def time_ms(fn, iters=20, warmup=3):
  """Mean ms per call with CUDA events, after warm-up."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  sync()
  return start.elapsed_time(end) / iters


def dc_phase():
  """Phase 3; returns (max_abs_err at the main-path shape, inputs)."""
  from csmri_refinement_tpu_torch.ops import dc_kernel, fft, masks
  errs = {}
  inputs = None
  for b, n in ((BATCH, SIZE), (BATCH // 4, 2 * SIZE)):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + n)
    x = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
    gt = torch.complex(torch.randn(b, n, n, device=DEVICE, generator=gen),
                       torch.randn(b, n, n, device=DEVICE, generator=gen))
    mask = masks.cartesian_mask(gen, (b, n, n), 8, device=DEVICE)
    k0c = mask * fft.fft2(gt)
    k0 = fft.pack_complex(k0c).contiguous()
    m = mask[..., None].contiguous()
    got = dc_kernel.dc_cuda(x, k0, m)
    sync()
    want = dc_kernel.dc_plain(x, k0, m)
    err = (got - want).abs().max().item()
    out_k = fft.fft2(fft.unpack_complex(got))
    line_err = (out_k - k0c)[mask > 0].abs().max().item()
    print('K1 dc {}x{}x{}: max|kernel-plain| {:.3e}, sampled-line err '
          '{:.3e} (tol {})'.format(b, n, n, err, line_err, F32_ATOL))
    require(err <= F32_ATOL, 'DC kernel differs from its plain version')
    require(line_err <= F32_ATOL, 'DC kernel does not keep sampled lines')
    errs[n] = err
    if n == SIZE:
      inputs = (x, k0, m, fft.unpack_complex(x), k0c, mask)
  return errs[SIZE], inputs


def unet_chains(model):
  unet = model.learnable_model
  return [('encode_0', unet.encode_0), ('encode_1', unet.encode_1),
          ('encode_2', unet.encode_2), ('decode_0.decode', unet.decode_0.decode),
          ('decode_1.decode', unet.decode_1.decode)]


CHAIN_SHAPES = {   # input (H, W, Cin) of each chain for a SIZE² image
    'encode_0': (SIZE, SIZE, 2), 'encode_1': (SIZE // 2, SIZE // 2, 32),
    'encode_2': (SIZE // 4, SIZE // 4, 64),
    'decode_0.decode': (SIZE // 2, SIZE // 2, 128),
    'decode_1.decode': (SIZE, SIZE, 64)}


def conv_phase(model, batch):
  """Phase 4; returns (max_abs_err over the flagship chains, chain cases)."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)

  def run(name, x, chain, pad, rel_tol=None, atol=None):
    got = cc.fused_conv_chain(x, chain, pad_mode=pad)
    sync()
    want = plain_chain(x, chain, pad)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = atol if atol is not None else rel_tol * scale
    print('K2 chain {} {} {} {}: max|kernel-plain| {:.3e}, max|ref| {:.3e}, '
          'tol {:.3e}'.format(name, tuple(x.shape), str(x.dtype), pad, err,
                              scale, tol))
    require(got.shape == want.shape and got.dtype == want.dtype,
            'chain {} output shape or dtype'.format(name))
    require(err <= tol, 'conv chain {} differs from its plain '
            'version'.format(name))
    return err

  cases = []
  err_main = 0.0
  for name, unit in unet_chains(model):
    h, w, cin = CHAIN_SHAPES[name]
    x = torch.randn(batch, h, w, cin, device=DEVICE,
                    generator=gen).to(torch.bfloat16)
    chain = unit.chain_layers()
    err_main = max(err_main, run(name, x, chain, unit.padding,
                                 rel_tol=BF16_REL_TOL))
    cases.append((name, x, chain, unit.padding))

  def layers(k, widths):
    out = []
    for cin, cout in zip(widths[:-1], widths[1:]):
      w = torch.randn(k, k, cin, cout, device=DEVICE, generator=gen)
      out.append(cc.ChainLayer(w * math.sqrt(2.0 / (k * k * cin)),
                               torch.randn(cout, device=DEVICE,
                                           generator=gen) * 0.1, 0.1))
    return out

  def rand(b, h, c):
    return torch.randn(b, h, h, c, device=DEVICE, generator=gen)

  half, quarter = SIZE // 2, SIZE // 4
  run('k3_zero', rand(8, half, 32).to(torch.bfloat16),
      layers(3, (32, 32, 32)), 'zero', rel_tol=BF16_REL_TOL)
  run('k4_replicate', rand(4, quarter, 64).to(torch.bfloat16),
      layers(4, (64, 64, 64)), 'replication', rel_tol=BF16_REL_TOL)
  run('k4_reflect_f32', rand(4, half, 32), layers(4, (32, 64, 64)),
      'reflection', atol=F32_ATOL)
  run('k3_zero_f32_cin2', rand(2, quarter, 2), layers(3, (2, 32, 16)),
      'zero', atol=F32_ATOL)
  return err_main, cases


def psnr(pred, target):
  mag = lambda t: torch.sqrt(t[..., 0] ** 2 + t[..., 1] ** 2)
  mse = torch.mean((mag(pred).double() - mag(target).double()) ** 2)
  return (10 * torch.log10(1.0 / mse)).item()


def e2e_phase(P):
  """Phase 6: f32 kernels on the card vs plain versions on the CPU."""
  model_cpu, undersample_batch = P.build_flagship(SIZE, torch.float32, 'cpu',
                                                  SEED)
  with torch.no_grad():
    model_cpu.scale.fill_(0.5)    # at its zero init the U-Net skips pred
  model_gpu = copy.deepcopy(model_cpu).to(DEVICE)
  gen = torch.Generator().manual_seed(SEED + 2)
  batch = undersample_batch(gen, torch.rand(2, SIZE, SIZE, generator=gen),
                            'varden', 8)
  args = [batch[k] for k in ('inp', 'kspace', 'mask')]
  with torch.inference_mode():
    want = model_cpu(*args)
    got = model_gpu(*[a.to(DEVICE) for a in args])
    sync()
  for key in ('pred', 'prescaled_refinement'):
    err = (got[key].cpu() - want[key]).abs().max().item()
    print('e2e f32 {}: max|cuda-cpu| {:.3e} (max|ref| {:.3e}, tol {})'.format(
        key, err, want[key].abs().max().item(), E2E_ATOL))
    require(err <= E2E_ATOL, 'end-to-end {} differs between card and '
            'CPU'.format(key))
  p_gpu = psnr(got['pred'].cpu(), batch['target'])
  p_cpu = psnr(want['pred'], batch['target'])
  print('e2e f32 PSNR: card {:.4f} dB, CPU {:.4f} dB'.format(p_gpu, p_cpu))
  require(abs(p_gpu - p_cpu) < PSNR_TOL_DB, 'end-to-end PSNR differs')


def chain_cost(cases):
  flops = bytes_ = 0
  for _, x, chain, _ in cases:
    b, h, w, _ = x.shape
    for layer in chain:
      k, _, cin, cout = layer.kernel.shape
      flops += 2 * b * h * w * k * k * cin * cout
      bytes_ += 2 * (b * h * w * (cin + cout) + k * k * cin * cout) + 4 * cout
  return flops, bytes_


def pending_bounds(cases):
  """Bounds (ms) of the TPU kernels not ported yet, from their shapes:
  K3 on the flagship chains in int8 (1-byte activations and weights, f32
  scales), K4's 256×128 bf16 probe tiles (read once, written once), K5's
  s8 (256×128)·(128×128) → s32 product."""
  ops, _ = chain_cost(cases)
  k3_bytes = 0
  for _, x, chain, _ in cases:
    b, h, w, _ = x.shape
    for layer in chain:
      k, _, cin, cout = layer.kernel.shape
      k3_bytes += b * h * w * (cin + cout) + k * k * cin * cout + 4 * cout
  rows, lanes = 256, 128       # scripts/probe_{mosaic,int8}_prims.py R, L
  k4_bytes = 2 * rows * lanes * 2
  k5_ops = 2 * rows * lanes * lanes
  k5_bytes = rows * lanes + lanes * lanes + 4 * rows * lanes
  return {
      'K3': max(ops / INT8_OPS, k3_bytes / HBM_BYTES_PER_S) * 1e3,
      'K4': k4_bytes / HBM_BYTES_PER_S * 1e3,
      'K5': max(k5_ops / INT8_OPS, k5_bytes / HBM_BYTES_PER_S) * 1e3}


def plain_chain(x, chain, pad):
  from csmri_refinement_tpu_torch.ops import conv_chain
  for layer in chain:
    x = conv_chain.conv_layer_plain(x, layer, pad)
  return x


def library_chain(x, chain, pad):
  """The chain as cuDNN calls: bf16, channels_last, F.pad + F.conv2d."""
  from csmri_refinement_tpu_torch.models import layers as L
  cl = torch.channels_last
  y = x.permute(0, 3, 1, 2)
  for layer in chain:
    k = layer.kernel.shape[0]
    w = layer.kernel.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=cl)
    y = L.same_pad(y, k, pad).contiguous(memory_format=cl)
    y = F.leaky_relu(F.conv2d(y, w, layer.bias.to(x.dtype)), layer.leakiness)
  return y


def dc_bwd_phase():
  """Phase 8; returns (max_abs_err at the training shape, inputs)."""
  from csmri_refinement_tpu_torch.ops import dc_kernel, masks
  errs = {}
  inputs = None
  for b, n in ((TRAIN_BATCH, SIZE), (TRAIN_BATCH // 4, 2 * SIZE)):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7 * n)
    x = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
    k0 = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
    g = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
    m = masks.cartesian_mask(gen, (b, n, n), 8, device=DEVICE)[..., None]
    m = m.contiguous()
    for need_k0 in (True, False):
      xr = x.clone().requires_grad_()
      k0r = k0.clone().requires_grad_(need_k0)
      dc_kernel._DCFunction.apply(xr, k0r, m).backward(g)
      sync()
      want_x, want_k0 = dc_kernel.dc_plain_vjp(g, m, need_k0)
      err = (xr.grad - want_x).abs().max().item()
      if need_k0:
        err = max(err, (k0r.grad - want_k0).abs().max().item())
      else:
        require(k0r.grad is None, 'k0 got a gradient it did not ask for')
      print('K1-bwd dc {}x{}x{} k0 grad {}: max|kernel-plain| {:.3e} (tol '
            '{})'.format(b, n, n, need_k0, err, GRAD_ATOL))
      require(err <= GRAD_ATOL, 'DC backward differs from dc_plain_vjp')
      errs[n] = max(errs.get(n, 0.0), err)
    if n == SIZE:
      inputs = (g, m)
  return errs[SIZE], inputs


def train_main_path():
  """Phase 9: the trainer's CLI on the card, counters around it."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.ops import dc_kernel
  sync()
  dc_kernel.dc_cuda.launches = 0
  dc_kernel.dc_bwd_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([TRAIN_CONFIG, '--dry', '--conf', 'num_epochs=1',
                       'epochs_per_validation=1'])
  sync()
  secs = time.perf_counter() - t0
  fwd, bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
  steps = runner.step
  val_batches = 2      # num_val 32 / batch 16
  print('train main path: {} steps + validation in {:.1f} s, K1 launches {}, '
        'K1-bwd launches {}'.format(steps, secs, fwd, bwd))
  require(steps == 8, 'expected 8 train steps (128 slices / 16)')
  require(bwd == 3 * steps, 'expected 3 K1-bwd launches per train step')
  require(fwd == 3 * (steps + val_batches),
          'expected 3 K1 launches per train step and validation batch')
  return runner, fwd, bwd


def fixed_batches(conf, n):
  """n host batches of the config's phantoms with fixed varden masks."""
  from csmri_refinement_tpu_torch.data import load_dataset
  from csmri_refinement_tpu_torch.ops import masks
  data = load_dataset(conf, 'Synthetic', 'train')
  gen = torch.Generator().manual_seed(SEED + 5)
  out = []
  for i in range(n):
    gt = torch.stack([torch.from_numpy(data[j]['gt'])
                      for j in range(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)])
    mask = masks.cartesian_mask(gen, tuple(gt.shape), 8)
    out.append((gt, mask))
  return out


def train_parity_phase():
  """Phase 10: the same steps on the card and on the CPU, TF32 off."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_json(TRAIN_CONFIG)
  cpu = Runner(conf, 'train', 'cpu')
  gpu = Runner(conf, 'train', DEVICE)
  gpu.model.load_state_dict(cpu.model.state_dict())
  worst = 0.0
  for step, (gt, mask) in enumerate(fixed_batches(conf, TRAIN_STEPS)):
    want = cpu.train_batch(us.undersample_batch(None, gt,
                                                fixed_mask=mask))[0]['loss']
    got = gpu.train_batch(us.undersample_batch(
        None, gt.to(DEVICE), fixed_mask=mask.to(DEVICE)))[0]['loss']
    want, got = want.item(), got.item()
    rel = abs(got - want) / abs(want)
    worst = max(worst, rel)
    print('train parity step {}: loss card {:.8e}, CPU {:.8e}, rel {:.2e} '
          '(tol {})'.format(step, got, want, rel, LOSS_RTOL))
    require(math.isfinite(got) and rel <= LOSS_RTOL,
            'card and CPU training losses differ')
  ref = cpu.model.state_dict()
  perr = max((v.cpu() - ref[k]).abs().max().item()
             for k, v in gpu.model.state_dict().items())
  print('train parity after {} steps: worst loss rel {:.2e}, max|param '
        'card-CPU| {:.3e}'.format(TRAIN_STEPS, worst, perr))
  return gpu


def main():
  require(torch.cuda.is_available(), 'no CUDA device')
  sys.path.insert(0, REPO)
  import csmri_refinement_tpu_torch as P
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel, native
  line = card_line()
  print(line)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  kind = torch.cuda.get_device_name(0)
  print('torch {} cuda {} on {} ({})'.format(torch.__version__,
                                             torch.version.cuda, kind, line))

  # Phase 2: build
  t0 = time.perf_counter()
  report = native.build()
  for name, (secs, log) in report.items():
    print('built csrc/{}.cu in {:.1f} s'.format(name, secs))
    for ln in log.splitlines():
      if 'registers' in ln or 'spill' in ln:
        print('  ptxas {}: {}'.format(name, ln.strip()), file=sys.stderr)
  print('kernel build: {:.1f} s'.format(time.perf_counter() - t0))

  # Phase 3: DC kernel
  dc_err, dc_inputs = dc_phase()

  # Phase 4: conv-chain kernel on the flagship chains
  model, undersample_batch = P.build_flagship(SIZE, torch.bfloat16, DEVICE,
                                              SEED)
  conv_err, chain_cases = conv_phase(model, BATCH)

  # Phase 5: the main path
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
  gt = torch.rand(BATCH, SIZE, SIZE, device=DEVICE, generator=gen)
  batch = undersample_batch(gen, gt, 'varden', 8)
  args = [batch[k] for k in ('inp', 'kspace', 'mask')]
  n_forwards = 3
  sync()
  dc_kernel.dc_cuda.launches = 0
  conv_chain.conv_layer_cuda.launches = 0
  with torch.inference_mode():
    for _ in range(n_forwards):
      out = model(*args)
      sync()
  dc_launches = dc_kernel.dc_cuda.launches
  conv_launches = conv_chain.conv_layer_cuda.launches
  print('main path: {} forwards, DC launches {}, conv-chain layer launches '
        '{}'.format(n_forwards, dc_launches, conv_launches))
  require(dc_launches == 3 * n_forwards, 'expected 3 DC launches per forward')
  require(conv_launches == 10 * n_forwards,
          'expected 10 conv-chain layer launches per forward')
  pred = out['pred']
  require(tuple(pred.shape) == (BATCH, SIZE, SIZE, 2),
          'pred shape {}'.format(tuple(pred.shape)))
  require(bool(torch.isfinite(pred.float()).all()), 'pred is not finite')

  # Phase 6: end-to-end, card vs CPU
  e2e_phase(P)

  # Phase 7: timings
  x, k0, m, xc, k0c, mask = dc_inputs
  dc_ms = time_ms(lambda: dc_kernel.dc_cuda(x, k0, m))
  dc_plain_ms = time_ms(lambda: dc_kernel.dc_plain(x, k0, m))
  dc_lib_ms = time_ms(lambda: torch.fft.ifft2(
      (1 - mask) * torch.fft.fft2(xc, norm='ortho') + k0c, norm='ortho'))
  b, n = x.shape[0], x.shape[1]
  dc_bytes = 28 * b * n * n
  dc_flops = 10 * b * n * n * math.log2(n * n)
  dc_bound = max(dc_bytes / HBM_BYTES_PER_S, dc_flops / F32_FLOPS) * 1e3
  print('K1 dc B{} {}^2: kernel {:.4f} ms, plain {:.4f} ms, cuFFT {:.4f} ms, '
        'bound {:.4f} ms ({})'.format(b, n, dc_ms, dc_plain_ms, dc_lib_ms,
                                      dc_bound, line))

  def chains(fn):
    return lambda: [fn(cx, ch, pad) for _, cx, ch, pad in chain_cases]

  conv_ms = time_ms(chains(
      lambda cx, ch, pad: conv_chain.fused_conv_chain(cx, ch, pad_mode=pad)),
                    iters=5, warmup=1)
  conv_plain_ms = time_ms(chains(plain_chain), iters=3, warmup=1)
  cl_cases = [(nm, cx.permute(0, 3, 1, 2).contiguous(
      memory_format=torch.channels_last).permute(0, 2, 3, 1), ch, pad)
              for nm, cx, ch, pad in chain_cases]
  conv_lib_ms = time_ms(lambda: [library_chain(cx, ch, pad)
                                        for _, cx, ch, pad in cl_cases],
                        iters=5, warmup=1)
  c_flops, c_bytes = chain_cost(chain_cases)
  conv_bound = max(c_bytes / HBM_BYTES_PER_S, c_flops / BF16_FLOPS) * 1e3
  for name, cx, ch, pad in chain_cases:
    one = time_ms(lambda: conv_chain.fused_conv_chain(
        cx, ch, pad_mode=pad), iters=5, warmup=1)
    lib = time_ms(lambda: library_chain(cx, ch, pad), iters=5,
                  warmup=1)
    f, _ = chain_cost([(name, cx, ch, pad)])
    print('K2 {} B{}: kernel {:.3f} ms ({:.1f} TFLOP/s), cuDNN {:.3f} ms, '
          '{:.2f} GFLOP'.format(name, cx.shape[0], one, f / one / 1e9, lib,
                                f / 1e9))
  print('K2 conv chains B{} (10 layers): kernel {:.3f} ms, plain {:.3f} ms, '
        'cuDNN {:.3f} ms, bound {:.4f} ms, {:.1f} GFLOP ({})'.format(
            BATCH, conv_ms, conv_plain_ms, conv_lib_ms, conv_bound,
            c_flops / 1e9, line))

  with torch.inference_mode():
    fwd_ms = time_ms(lambda: model(*args), iters=5, warmup=1)
  print('flagship forward {}^2 bf16 B{}: {:.3f} ms, {:.1f} slices/s; of '
        'which DC kernel {:.3f} ms, conv-chain kernel {:.3f} ms ({})'.format(
            SIZE, BATCH, fwd_ms, BATCH / fwd_ms * 1e3, 3 * dc_ms,
            conv_ms, line))

  # Phase 8: the DC backward kernel
  bwd_err, (g, gm) = dc_bwd_phase()

  # Phase 9: the training main path
  runner, train_fwd, train_bwd = train_main_path()
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  val_set = load_dataset(runner.conf, 'Synthetic', 'val')
  val_losses, val_metrics = runner.validate(
      DataLoader(val_set, TRAIN_BATCH))
  vals = {k: v.value for k, v in list(val_losses.items()) +
          list(val_metrics.items())}
  print('train main path validation: {}'.format(vals))
  require(all(math.isfinite(v) for v in vals.values()),
          'validation metrics are not finite')
  require(0 < vals['ssim'] <= 1 and vals['psnr'] > 10,
          'validation metrics out of range')

  # Phase 10: card vs CPU training
  gpu_runner = train_parity_phase()

  # Phase 11: timings of the training path
  from csmri_refinement_tpu_torch.ops import fft
  gc = fft.unpack_complex(g)
  gmask = gm[..., 0]
  bwd_ms = time_ms(lambda: dc_kernel.dc_bwd_cuda(g, gm))
  dc16_ms = time_ms(lambda: dc_kernel.dc_cuda(g, g, gm))
  bwd_plain_ms = time_ms(lambda: dc_kernel.dc_plain_vjp(g, gm, False))
  bwd_lib_ms = time_ms(lambda: torch.fft.ifft2(
      (1 - gmask) * torch.fft.fft2(gc, norm='ortho'), norm='ortho'))
  b, n = g.shape[0], g.shape[1]
  bwd_bytes = 20 * b * n * n       # g 8, mask 4, grad_x 8 (no k0)
  bwd_flops = 10 * b * n * n * math.log2(n * n)
  bwd_bound = max(bwd_bytes / HBM_BYTES_PER_S, bwd_flops / F32_FLOPS) * 1e3
  print('K1-bwd dc B{} {}^2: kernel {:.4f} ms, plain {:.4f} ms, cuFFT '
        '{:.4f} ms, bound {:.4f} ms ({})'.format(
            b, n, bwd_ms, bwd_plain_ms, bwd_lib_ms, bwd_bound, line))
  gt, mask = fixed_batches(gpu_runner.conf, 1)[0]
  from csmri_refinement_tpu_torch.ops import undersample as us
  tbatch = us.undersample_batch(None, gt.to(DEVICE),
                                fixed_mask=mask.to(DEVICE))
  step_ms = {}
  for tf32 in (False, True):
    torch.backends.cudnn.allow_tf32 = tf32
    step_ms[tf32] = time_ms(lambda: gpu_runner.train_batch(tbatch),
                            iters=10, warmup=2)
  torch.backends.cudnn.allow_tf32 = False
  for tf32, ms in step_ms.items():
    print('RecNet train step {}^2 f32 B{} TF32 {}: {:.3f} ms, {:.1f} '
          'slices/s; of which K1 {:.3f} ms + K1-bwd {:.3f} ms ({})'.format(
              SIZE, TRAIN_BATCH, 'on' if tf32 else 'off', ms,
              TRAIN_BATCH / ms * 1e3, 3 * dc16_ms,
              3 * bwd_ms, line))

  print('bounds of the kernels still to port: {}'.format(', '.join(
      '{} {:.6f} ms'.format(k, v) for k, v in pending_bounds(
          chain_cases).items())))

  kernels = [
      {'name': 'dc', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/dc.cu',
       'replaces': 'csmri_refinement_tpu/ops/dc_pallas.py:36',
       'launches': dc_launches + train_fwd, 'max_abs_err': dc_err,
       'ms': dc_ms,
       'plain_ms': dc_plain_ms, 'bound_ms': dc_bound,
       'bound_by': 'bytes' if dc_bytes / HBM_BYTES_PER_S >=
                   dc_flops / F32_FLOPS else 'operations',
       'library_ms': dc_lib_ms},
      {'name': 'conv_chain', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_chain.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:247',
       'launches': conv_launches, 'max_abs_err': conv_err, 'ms': conv_ms,
       'plain_ms': conv_plain_ms, 'bound_ms': conv_bound,
       'bound_by': 'bytes' if c_bytes / HBM_BYTES_PER_S >=
                   c_flops / BF16_FLOPS else 'operations',
       'library_ms': conv_lib_ms},
      {'name': 'dc_bwd', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/dc.cu',
       'replaces': 'csmri_refinement_tpu/ops/dc.py:99',
       'launches': train_bwd, 'max_abs_err': bwd_err, 'ms': bwd_ms,
       'plain_ms': bwd_plain_ms, 'bound_ms': bwd_bound,
       'bound_by': 'bytes' if bwd_bytes / HBM_BYTES_PER_S >=
                   bwd_flops / F32_FLOPS else 'operations',
       'library_ms': bwd_lib_ms},
  ]
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
