#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``csmri_refinement_tpu_torch``).

    python3 chip_smoke.py [--probes-only | --int8-only [--tree DIR] |
                           --f32-only [--tree DIR] | --scarseg-only]

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit. Phases, each failing loudly with a non-zero exit:

1. require a CUDA device; print the card's name and power limit;
2. build the five hand-written kernel sources of ``csrc/`` (nvcc, in
   parallel), printing ``ptxas``'s register and spill lines; the probes',
   K3's and K2's f32 route's must show no C7517 (a drained ``wgmma``
   pipeline);
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
   call, and the forward's slices/s; K1 at both phase-3 shapes beside
   cuFFT's composition; K2 per chain, then each of the 10 flagship layers
   with its route, ms, TFLOP/s and share of its own bound. K1, K1-bwd and
   the single layers are timed as device time (``graph_ms``: CUDA-graph
   replays), since their wrappers' host time exceeds the shorter kernels;
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
11. timings: K1-bwd, its plain version and the cuFFT composition; K1's
    dense-DFT route (no main path takes it) at 320² and 256×192, B=2, K1
    and K1-bwd against their plain versions and timed beside them; the
    train step with TF32 off and on;
12. the int8 conv kernel (K3) and its requant kernel vs their plain
    versions: the quantized layers of the five flagship chains at 256²,
    B=32 (real weights, ``quantize_act`` inputs), a k3 zero-pad and a k4
    replicate chain, and the requant on an all-zero image and on .5 ties;
13. the third main path, the int8 serving forward:
    ``build_flagship(256, bf16, quantize_inference=True)``, B=32, a few
    forwards with the counters set to 0 just before and read just after
    (3 K1 + 3 K2 + 7 K3 + 2 requants each), then 512², B=4 (3 + 6 + 4 + 1,
    and a chain that quantizes nothing), and at 512² each of those K3 and
    requant launches against its plain version as in phase 12;
14. int8 quality: f32 compute on the card vs on the CPU; int8 vs f32 on
    the card, for the flagship U-Net against the JAX package's reading on
    the same weights and batch, for the JAX suite's U-Net against its bar;
    the port's quality-vs-dtype table at 256²;
15. timings: K3 on each of the 7 quantized flagship layers and the requant
    kernel on each of its 2 inputs as device time (``graph_ms``), with
    TOP/s and share of the layer's bound, beside K2 bf16 on the same
    layers; the sums beside their plain versions, the function's bound
    and cuDNN's bf16 convs as a yardstick; the int8 forward beside the
    bf16 one; then the primitive probes (K4, K5) as their own path: every probe
    OK with one launch each; then each probe's kernel, plain version and
    library call (``torch.roll``, ``torch._int_mm``, ... where one PyTorch
    call computes its function) as device time (``graph_ms``) beside the
    kernel's eager calls, and the library's s8 and bf16 products at 4096³;
16. the fourth main path, GAN refinement training: the trainer's CLI on
    ``configs/2-refinement.json`` at its full widths on Synthetic 256²
    phantoms (40 train, 10 validation, B = 5: 8 steps and 2 validation
    batches), the VGG19 from its seeded init, the frozen RecNet grafted
    from a checkpoint of phase 9's runner, with the counters set to 0 just
    before and read just after: 3 K1 per generator forward, 0 K1-bwd, 10
    K2 per validation forward, all on the f32 routes (``csrc/conv_f32.cu``),
    the RecNet equal to its checkpoint; K1 and K2 (f32) at the path's
    B = 5 shapes against their plain versions; GAN
    updates on the card and on the CPU at 128² (the discriminator's
    gradients on the same inputs within 1e-3 of each tensor's max, the
    first update's losses and the second's gen_loss within 1e-3, the
    third's printed) and at narrow widths at 64² (every loss of three
    updates within 1e-3); ms per GAN step at 256², B = 5, TF32 off and on;
    the validation forward's 10 f32 layers timed as in 17 (e); the
    flagship decoders' subpixel up-convs beside the explicit path they
    replace (device time);
17. the fifth main path, segmentation training, and the segmentation score
    (SIS): (a) the trainer's CLI on ``configs/3-train-segmentation-unet.json``
    at its full widths on Synthetic 256² phantoms (40 train, 16 validation,
    B = 8: 5 steps and 2 validation batches), counters around it: 18 K2
    (f32 route) launches per validation forward, none in train mode, and
    one best checkpoint by dice_class_1; (b) the segmentation score as a
    validation metric of the GAN runner, its network from (a)'s checkpoint,
    the generator from phase 16, counters around the validation: 3 K1 per
    batch and 10 + 18 K2; (c) every K2 launch of a segmentation forward at
    256², B = 5 and 8, and at 128², B = 1, against its plain version;
    (d) card against CPU at 128², B = 2: the eval logits, the class maps
    where the CPU's margin is above rounding, the score, the first
    full-width training step and three narrow ones at 64² (the later
    full-width steps printed); (e) ms per segmentation train step (TF32
    off and on) and per score call at B = 5, and K2's f32 route on each of
    the 18 layers of a validation forward: route, device time, TFLOP/s,
    share of the route's bound (3 TF32 products per MAC at 495 TFLOP/s;
    the direct stem's bytes) and of the f32-FMA bound, beside its plain
    version and the faster cuDNN f32 call (plain or channels-last) under
    cuDNN's heuristic and under ``cudnn.benchmark``, and the sums;
18. the paper's data and evaluation path at 512²: (1) a ScarSeg-format
    tree written under the git-ignored ``resources/chip_smoke/`` (the 36
    cases of ``STATIC_SPLIT``, phantom LGE volumes 512² × 4 slices int16
    and their uint8 labels, ~150 MB, removed at the end), its write and a
    fold's load timed; (2) ``configs/1-recnet.json`` as written through the
    training CLI (``--data-dir``, one epoch: 5 steps at B = 20 and 2
    validation batches), counters around it: 21 K1 and 15 K1-bwd; K1 and
    K1-bwd at (20, 512, 512, 2) against their plain versions; (3) the
    validate CLI on its best checkpoint (metrics at -b 20, 24 ``.mat``
    records at -b 1 --raw), the first 4 slices again on the CPU: each
    prediction within 5e-4 of max |target|, PSNR within 0.01 dB, SSIM
    within 1e-4; ``eval_results`` over both record dirs (24 finite rows,
    equal means over the 4 common slices); (4) ``configs/2-refinement.json``
    through the CLI (a copy naming (2)'s checkpoint as its RecNet,
    ``vgg_random_init``, 10 + 10 slices: 2 steps and 2 validation batches
    at B = 5): 3 K1 per generator forward, 10 K2 f32 per validation
    forward, each K2 launch of one forward against its plain version, then
    validate -b 5 -i with its PNGs decoded; (5)
    ``configs/3-train-segmentation-unet.json`` through the CLI (16 + 8
    slices: 2 steps and 1 validation batch at B = 8): 18 K2 f32 per eval
    forward and none in train mode, each launch of one eval forward held to
    its plain version, then validate; (6) the three train steps at 512²
    (TF32 off and on), the loader's host ms per batch and the step loop's
    wait with prefetch, the RecNet's validation forward at B = 1 and 20,
    K1 and K1-bwd beside their plain versions, cuFFT and the bound, and
    the GAN's 10 K2 f32 layers at 512², B = 5 as in 17 (e);
19. the trainer's surface on (4)'s config and tree, before the tree is
    removed (2 steps and 2 validation batches per epoch, each step's losses
    summarised, 4 epochs): (a) the training CLI as a process, SIGTERM once
    its log shows epoch 1's first step: exit 0 after that epoch, the
    preemption logged, a checkpoint for the next epoch; (b) ``--resume`` on
    it in this process with ``--profile-dir``, ``-v`` and
    ``--print-parameters`` and a recording writer in place of
    ``train._summary_writer``: both networks and both optimizers equal the
    checkpoint bit for bit right after the restore, the run trains on to
    epoch 4 with the counters around it (3 K1 per generator forward, 10 K2
    f32 per validation forward), ``train/<name>`` scalars at the JAX
    global steps, ``validation/<name>`` scalars and one finite grid per
    validation (the last grid and metrics equal a validation of the trained
    runner), and the profiler's trace names K1's and K2 f32's kernels;
    (c) ``deploy_checkpoint adversarial`` on the last checkpoint, then
    ``validate`` on both files: identical metrics; (d) an epoch with the
    recording writer and with summaries off, and the train step with and
    without the profiler, in turns.

``--scarseg-only`` runs phases 1, 2, 18 and 19 alone (no result line).
``--f32-only`` runs phases 1 and 2 for the conv sources and times K2's f32
route on the 18 segmentation layer shapes (seeded weights) after holding
each to its plain version (no result line); with ``--tree DIR`` an earlier
tree times its own f32 route on the same layers in the same call.
``--probes-only`` runs phases 1 and 2 for the probes' source and the
probes of phase 15 alone, and prints their ``{"kernels": [...]}`` entries
(no result line). ``--int8-only`` runs phases 1 and 2 for the conv
sources and the K3 table of phase 15 alone (no result line); with
``--tree DIR`` it imports the port package from another checkout inside
this one (an earlier tree, unpacked by ``git archive`` into a git-ignored
directory, one that has ``utils/profiling.py``), so that two trees are
timed in turns on one card.

Prints a ``{"kernels": [...]}`` line, then, last, ``{"ok": true, "device":
{...}}``. TF32 is off throughout (except the one TF32 step timing), so every
f32 reference is full f32.
"""

import copy
import glob
import json
import logging
import math
import os
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.realpath(__file__))
SEED = 0
DEVICE = 'cuda'
SIZE = 256         # the flagship image side
BATCH = 32         # slices per forward on the main path

# Published H100 SXM peaks at 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
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
# K3 vs its plain version, relative to max |ref| (chains of quantized
# layers): the int32 sums are exact and the epilogues round alike, so the
# design target is bit-identity; a requant tie that rounds the other way
# moves one value by one int8 step (1/127 of that layer's amax). At most
# 1e-3 of the elements may differ by more than float noise (1e-5).
INT8_STEP = 1 / 127
INT8_NOISE = 1e-5
INT8_MAX_SHARE = 1e-3
# int8 forward, card vs CPU (f32 compute): the float layers before each
# quantization sum in another order (cuDNN/K2 vs oneDNN, ~1e-6); a value
# that close to a rounding boundary quantizes one step the other way and
# later layers carry it. The port differs from the JAX package on the CPU
# for the same reason, and given JAX's float input to each quantized
# suffix the gap closes to float rounding (tests/int8_parity_readings.py).
INT8_E2E_REL = 2e-2
INT8_VS_F32_REL = 0.05   # tests/test_conv_pallas.py:153-169
# The flagship U-Net's int8-vs-f32 error (max |Δ| / max |f32| of its output)
# on phase 14's weights and batch, as the JAX package reads it on the CPU
# (jitted, its Pallas kernel in interpret mode, the port's weights exported
# to a flax tree): ``python tests/int8_parity_readings.py``, which reads
# 0.059201 for the port there. The reading is a max over 131072 outputs; a
# requant tie that rounds the other way moves single values, not the max of
# the quantization error. A tenth of the reading leaves 30 times the CPU gap.
INT8_VS_F32_FLAGSHIP_JAX = 0.059019744
INT8_VS_F32_FLAGSHIP_RTOL = 0.1
# Launches per int8 forward (K1, K2, K3 conv, K3 requant), from the JAX
# package's suffix rule on the flagship chains (ops/conv_chain.py).
INT8_LAUNCHES = {256: (3, 3, 7, 2), 512: (3, 6, 4, 1)}
# The GAN refinement path (configs/2-refinement.json on Synthetic 256²):
# 8 train steps and 2 validation batches of 5.
GAN_BATCH, GAN_TRAIN, GAN_VAL = 5, 40, 10
GAN_PARITY_SIZE, GAN_PARITY_STEPS = 128, 3
GAN_NARROW_SIZE = 64
# Card vs CPU GAN updates. The discriminator's gradient is not a smooth
# function of its input at full width: its last layers hold 4×4 positions
# per image at 128², and a LeakyReLU kink crossed there moves a tensor's
# gradient by a large share of its max under 1e-5 relative input noise
# (phase 16 prints it; 0.13 on an H100 machine's CPU), and the fakes'
# background is rounding noise on the first layer's kink, so the sign of
# the first conv's bias gradient is decided by rounding
# (tests/test_torch_port_gan.py). The card's generator output (DC kernel,
# cuDNN) differs from the CPU's by rounding, and Adam's first step is ±lr
# whatever a gradient's size, so the updates part: at full width gen_loss
# 6.8e-5 and disc_loss 3.5e-4 apart at the second update and 1.2e-3 and
# 2.9e-3 at the third (NVIDIA H100 80GB HBM3, 700 W). So at full width the
# first update's losses and the second's gen_loss are gated at LOSS_RTOL
# and the third's printed; the discriminator's gradients on the same
# inputs read 1.44e-4 of each tensor's max apart (card vs f64 1.02e-5, the
# CPU's f32 vs f64 1.42e-4), gated at GAN_GRAD_REL, seven times that; and
# every update of the narrow widths at 64² is gated at LOSS_RTOL.
GAN_GRAD_REL = 1e-3
GAN_DIR = os.path.join(REPO, 'resources', 'chip_smoke')
# The segmentation path (configs/3-train-segmentation-unet.json on
# Synthetic 256²): 5 train steps and 2 validation batches of 8. Each eval
# forward of its U-Net launches K2's f32 route on 9 chains (5 encoder and 4
# decoder units) of 2 layers; its train mode launches none.
SEG_BATCH, SEG_TRAIN, SEG_VAL = 8, 40, 16
SEG_CHAIN_LAYERS = 18
SEG_PARITY_SIZE, SEG_PARITY_BATCH, SEG_PARITY_STEPS = 128, 2, 3
SEG_NARROW_SIZE = 64
# Card vs CPU class maps: the logits differ by summation order (~1e-6 of
# max |logit|), so a pixel whose top two logits are closer than that may
# take either class. Maps are held equal where the CPU's top-two margin is
# above SEG_MARGIN_REL of max |logit|, a hundred times the rounding.
SEG_MARGIN_REL = 1e-4
# Segmentation score card vs CPU: a dice over 256² pixels moves by ~1e-5
# per flipped pixel of its class; 1e-3 leaves room for the near-tie pixels
# above and none for a wrong class map.
SIS_ATOL = 1e-3
# Phase 18: the paper's configs as written on a ScarSeg-format tree of the
# 36 cases at 512² (4 slices each: 96 train, 24 validation slices).
# configs/1-recnet.json trains at B = 20: 5 steps (the last of 16) and 2
# validation batches (20 + 4).
SCAR_SIZE, SCAR_SLICES = 512, 4
RECNET_CONFIG = os.path.join(REPO, 'configs', '1-recnet.json')
REC_BATCH, REC_STEPS, REC_VAL_BATCHES = 20, 5, 2
# validate card vs CPU on the same slices: the f32 forward bars of phase 6
# (predictions within E2E_ATOL of max |target|), the PSNR bar tighter.
SCAR_PSNR_DB, SCAR_SSIM = 0.01, 1e-4


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


def graph_ms(fn, calls=20, replays=5):
  """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
  graph after a warm-up, the graph replayed. Unlike ``timed_ms`` it leaves
  out the host's cost of each call (a wrapper's checks, allocations and
  launch), which bounds an eager loop of kernels shorter than it."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(calls):
      fn()
  graph.replay()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(replays):
    graph.replay()
  end.record()
  sync()
  return start.elapsed_time(end) / (replays * calls)


def dc_phase():
  """Phase 3; returns (max_abs_err at the main-path shape, {side:
  inputs})."""
  from csmri_refinement_tpu_torch.ops import dc_kernel, fft, masks
  errs = {}
  inputs = {}
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
    inputs[n] = (x, k0, m, fft.unpack_complex(x), k0c, mask)
  return errs[SIZE], inputs


def unet_chains(model):
  unet = model.learnable_model
  return [('encode_0', unet.encode_0), ('encode_1', unet.encode_1),
          ('encode_2', unet.encode_2), ('decode_0.decode', unet.decode_0.decode),
          ('decode_1.decode', unet.decode_1.decode)]


def chain_shapes(size):
  """Input (H, W, Cin) of each flagship chain for a size² image."""
  return {'encode_0': (size, size, 2), 'encode_1': (size // 2, size // 2, 32),
          'encode_2': (size // 4, size // 4, 64),
          'decode_0.decode': (size // 2, size // 2, 128),
          'decode_1.decode': (size, size, 64)}


CHAIN_SHAPES = chain_shapes(SIZE)


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

  def rand(b, h, c):
    return torch.randn(b, h, h, c, device=DEVICE, generator=gen)

  half, quarter = SIZE // 2, SIZE // 4
  run('k3_zero', rand(8, half, 32).to(torch.bfloat16),
      random_chain(gen, 3, (32, 32, 32)), 'zero', rel_tol=BF16_REL_TOL)
  run('k4_replicate', rand(4, quarter, 64).to(torch.bfloat16),
      random_chain(gen, 4, (64, 64, 64)), 'replication', rel_tol=BF16_REL_TOL)
  run('k4_reflect_f32', rand(4, half, 32), random_chain(gen, 4, (32, 64, 64)),
      'reflection', atol=F32_ATOL)
  run('k3_zero_f32_cin2', rand(2, quarter, 2),
      random_chain(gen, 3, (2, 32, 16)), 'zero', atol=F32_ATOL)
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


def k2_layer_table(cases, line):
  """Each flagship K2 layer on its own, device time (``graph_ms``):
  route, ms, TFLOP/s, and the share of its own bound (operations or bytes,
  whichever is larger)."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  total = 0.0
  for name, x, chain, pad in cases:
    for i, layer in enumerate(chain):
      b, h, w, cin = x.shape
      k, _, _, cout = layer.kernel.shape
      ms = graph_ms(lambda: conv_chain.conv_layer_cuda(x, layer, pad),
                    calls=5, replays=2)
      flops = 2 * b * h * w * k * k * cin * cout
      bytes_ = 2 * (b * h * w * (cin + cout) + k * k * cin * cout) + 4 * cout
      b_ms, by = bound(flops, bytes_, BF16_FLOPS)
      print('K2 layer {}[{}] B{} {}^2 {}->{} k{}: route {}, {:.4f} ms, {:.1f} '
            'TFLOP/s, {:.1%} of its bound {:.4f} ms ({}) ({})'.format(
                name, i, b, h, cin, cout, k,
                conv_chain.conv_route(cin, cout, x.dtype), ms,
                flops / ms / 1e9, b_ms / ms, b_ms, by, line))
      total += ms
      x = conv_chain.conv_layer_cuda(x, layer, pad)
  print('K2 layers one by one: {:.3f} ms ({})'.format(total, line))


def f32_layer_cost(x, layer):
  """(flops, bytes, the route's bound (ms, by), the FMA bound (ms, by)) of
  one f32 layer: its input, weights, bias and output each moved once; the
  3xTF32 route does 3 TF32 products per MAC at the TF32 peak, the direct
  route and the FMA kernel one f32 FMA per MAC at the f32 peak."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  b, h, w, cin = x.shape
  k, _, _, cout = layer.kernel.shape
  flops = 2 * b * h * w * k * k * cin * cout
  bytes_ = 4 * (b * h * w * (cin + cout) + k * k * cin * cout + cout)
  route = conv_chain.conv_route(cin, cout, torch.float32)
  own = bound(flops, bytes_, F32_FLOPS) if route == 'direct' else \
      bound(3 * flops, bytes_, TF32_FLOPS)
  return flops, bytes_, own, bound(flops, bytes_, F32_FLOPS)


def cudnn_f32_ms(x, layer, pad):
  """The faster of the two cuDNN f32 calls on one layer (TF32 off): the
  plain version's F.pad + F.conv2d and ``library_chain`` channels-last;
  device time. Returns (plain ms, faster ms)."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  x_cl = x.permute(0, 3, 1, 2).contiguous(
      memory_format=torch.channels_last).permute(0, 2, 3, 1)
  plain_ms = graph_ms(lambda: conv_chain.conv_layer_plain(x, layer, pad),
                      calls=3, replays=2)
  lib_ms = graph_ms(lambda: library_chain(x_cl, [layer], pad), calls=3,
                    replays=2)
  return plain_ms, min(plain_ms, lib_ms)


def f32_layer_table(label, calls, line):
  """K2's f32 route on each layer of ``calls`` ([(x, layer, pad, ...)]) as
  device time (``graph_ms``): route, ms, TFLOP/s, the share of the route's
  bound and of the f32-FMA bound; beside the plain version and the faster
  cuDNN f32 call under cuDNN's heuristic and under ``cudnn.benchmark``
  (the flag restored after). Returns the sums {'ms', 'plain_ms',
  'cudnn_ms', 'cudnn_bench_ms', 'cudnn_best_ms' (the faster of the two
  modes per layer), 'bound_ms', 'fma_bound_ms'}."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  sums = dict.fromkeys(('ms', 'plain_ms', 'cudnn_ms', 'cudnn_bench_ms',
                        'cudnn_best_ms', 'bound_ms', 'fma_bound_ms'), 0.0)
  flag = torch.backends.cudnn.benchmark
  for i, (x, layer, pad) in enumerate(c[:3] for c in calls):
    b, h, w, cin = x.shape
    k, _, _, cout = layer.kernel.shape
    flops, _, (b_ms, by), (f_ms, f_by) = f32_layer_cost(x, layer)
    ms = graph_ms(lambda: conv_chain.conv_layer_cuda(x, layer, pad),
                  calls=3, replays=2)
    plain_ms, lib_ms = cudnn_f32_ms(x, layer, pad)
    torch.backends.cudnn.benchmark = True
    try:
      _, bench_ms = cudnn_f32_ms(x, layer, pad)
    finally:
      torch.backends.cudnn.benchmark = flag
    route = conv_chain.conv_route(cin, cout, x.dtype)
    print('K2 f32 {} layer {:2d} B{} {}x{} {}->{} k{}: route {}, {:.4f} ms, '
          '{:.1f} TFLOP/s, {:.1%} of its bound {:.4f} ms ({}), {:.1%} of the '
          'FMA bound {:.4f} ms ({}); plain {:.4f} ms; faster cuDNN f32 call '
          '{:.4f} ms (heuristic), {:.4f} ms (cudnn.benchmark) ({})'.format(
              label, i, b, h, w, cin, cout, k, route, ms, flops / ms / 1e9,
              b_ms / ms, b_ms, by, f_ms / ms, f_ms, f_by, plain_ms, lib_ms,
              bench_ms, line))
    for key, v in (('ms', ms), ('plain_ms', plain_ms), ('cudnn_ms', lib_ms),
                   ('cudnn_bench_ms', bench_ms),
                   ('cudnn_best_ms', min(lib_ms, bench_ms)), ('bound_ms', b_ms),
                   ('fma_bound_ms', f_ms)):
      sums[key] += v
  print('K2 f32 {} layers ({}): kernel {:.3f} ms, plain {:.3f} ms, faster '
        'cuDNN f32 call {:.3f} ms (heuristic), {:.3f} ms (cudnn.benchmark); '
        'bound {:.3f} ms ({:.1%}), FMA bound {:.3f} ms ({:.1%}) ({})'.format(
            label, len(calls), sums['ms'], sums['plain_ms'], sums['cudnn_ms'],
            sums['cudnn_bench_ms'], sums['bound_ms'],
            sums['bound_ms'] / sums['ms'], sums['fma_bound_ms'],
            sums['fma_bound_ms'] / sums['ms'], line))
  return sums


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


def dc_dft_phase(line):
  """Phase 11, K1's dense-DFT route (sides with no radix plan, non-square
  images), which no main path takes: at 320² and 256×192, B=2, K1 with k0
  against ``dc_plain`` and K1-bwd against ``dc_plain_vjp``, then each as
  device time beside its plain version, cuFFT's composition and the DC's
  bound."""
  from csmri_refinement_tpu_torch.ops import dc_kernel, fft, masks
  for h, w in ((320, 320), (256, 192)):
    b = 2
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + h + w)
    x = torch.randn(b, h, w, 2, device=DEVICE, generator=gen)
    k0 = torch.randn(b, h, w, 2, device=DEVICE, generator=gen)
    mask = masks.cartesian_mask(gen, (b, h, w), 8, device=DEVICE)
    m = mask[..., None].contiguous()
    require(dc_kernel.dc_route(h, w) == 'dft', 'route of {}x{}'.format(h, w))
    fwd = dc_kernel.dc_cuda(x, k0, m)
    bwd = dc_kernel.dc_bwd_cuda(x, m)
    sync()
    errs = ((fwd - dc_kernel.dc_plain(x, k0, m)).abs().max().item(),
            (bwd - dc_kernel.dc_plain_vjp(x, m, False)[0]).abs().max().item())
    xc, k0c = fft.unpack_complex(x), fft.unpack_complex(k0)
    flops = 10 * b * h * w * math.log2(h * w)
    for name, err, kern, plain, lib, nbytes in (
        ('K1', errs[0], lambda: dc_kernel.dc_cuda(x, k0, m),
         lambda: dc_kernel.dc_plain(x, k0, m),
         lambda: torch.fft.ifft2((1 - mask) * torch.fft.fft2(
             xc, norm='ortho') + k0c, norm='ortho'), 28),
        ('K1-bwd', errs[1], lambda: dc_kernel.dc_bwd_cuda(x, m),
         lambda: dc_kernel.dc_plain_vjp(x, m, False),
         lambda: torch.fft.ifft2((1 - mask) * torch.fft.fft2(
             xc, norm='ortho'), norm='ortho'), 20)):
      b_ms, by = bound(flops, nbytes * b * h * w, F32_FLOPS)
      print('{} dc dense-DFT route B{} {}x{}: max|kernel-plain| {:.3e} (tol '
            '{}); kernel {:.4f} ms, plain {:.4f} ms, cuFFT {:.4f} ms, bound '
            '{:.4f} ms ({}) ({})'.format(name, b, h, w, err, F32_ATOL,
                                         graph_ms(kern), graph_ms(plain),
                                         graph_ms(lib), b_ms, by, line))
    require(max(errs) <= F32_ATOL,
            'DC dense-DFT route differs from its plain version at '
            '{}x{}'.format(h, w))


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
  data = load_dataset(conf, None, 'Synthetic', 'train')
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


def random_chain(gen, k, widths):
  """He-scaled random k×k layers (bias 0.1·randn, LeakyReLU 0.1)."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  out = []
  for cin, cout in zip(widths[:-1], widths[1:]):
    w = torch.randn(k, k, cin, cout, device=DEVICE, generator=gen)
    out.append(cc.ChainLayer(w * math.sqrt(2.0 / (k * k * cin)),
                             torch.randn(cout, device=DEVICE,
                                         generator=gen) * 0.1, 0.1))
  return out


def plain_int8_chain(x, scale, qlayers, pad, out_dtype):
  """A quantized chain through the plain versions only."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  for i, layer in enumerate(qlayers):
    last = i + 1 == len(qlayers)
    y, amax = cc.conv_layer_int8_plain(x, scale, layer, pad,
                                       out_dtype if last else torch.float32,
                                       not last)
    if last:
      return y
    x, scale = cc.requant_plain(y, amax)


def int8_gate(name, got, want):
  got, want = got.float(), want.float()
  ref = want.abs().max().item()
  diff = (got - want).abs()
  err = diff.max().item()
  off = int((diff > INT8_NOISE * ref).sum().item())
  print('K3 chain {} {}: max|kernel-plain| {:.3e}, max|ref| {:.3e}, tol '
        '{:.3e}; {} of {} elements beyond {:g}·max|ref| (allowed share '
        '{:g})'.format(name, tuple(got.shape), err, ref, INT8_STEP * ref, off,
                       diff.numel(), INT8_NOISE, INT8_MAX_SHARE))
  require(got.shape == want.shape, 'int8 chain {} shape'.format(name))
  require(err <= INT8_STEP * ref and off <= INT8_MAX_SHARE * diff.numel(),
          'int8 chain {} differs from its plain version'.format(name))


def int8_check(name, x, chain, pad, out_dtype, errs, launches):
  """One quantized chain: layer by layer, each kernel (K3 conv, requant)
  vs its plain version on the kernel's own inputs, the worst error and the
  launches added to ``errs`` and ``launches``; then the kernels' chain vs
  the plain chain (``int8_gate``)."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  from csmri_refinement_tpu_torch.ops import quantize
  xi, scale = quantize.quantize_act(x)
  qlayers = quantize.quantize_chain(chain)
  xk, sk = xi, scale
  for i, layer in enumerate(qlayers):
    last = i + 1 == len(qlayers)
    args = (xk, sk, layer, pad, out_dtype if last else torch.float32,
            not last)
    y, amax = cc.conv_layer_int8_cuda(*args)
    sync()
    want, _ = cc.conv_layer_int8_plain(*args)
    errs['conv'] = max(errs['conv'],
                       (y.float() - want.float()).abs().max().item())
    launches['conv'] += 1
    if last:
      break
    xk, sk = cc.requant_cuda(y, amax)
    sync()
    want_x, want_s = cc.requant_plain(y, amax)
    errs['requant'] = max(errs['requant'],
                          (xk.float() - want_x.float()).abs().max().item(),
                          (sk - want_s).abs().max().item())
    launches['requant'] += 1
  int8_gate(name, y, plain_int8_chain(xi, scale, qlayers, pad, out_dtype))


def int8_flagship_checks(model, size, batch, gen):
  """``int8_check`` on the quantized suffix of each flagship chain at the
  chain's shape for a size² input, B = ``batch`` (randn inputs, the
  model's weights): every K3 conv and requant launch the int8 forward makes
  at that size, each against its plain version. Returns (errs, launches),
  {'conv', 'requant'} each."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  errs = {'conv': 0.0, 'requant': 0.0}
  launches = {'conv': 0, 'requant': 0}
  for name, unit in unet_chains(model):
    h, w, _ = chain_shapes(size)[name]
    chain = unit.chain_layers()
    start = cc.int8_suffix_start(chain, h, w)
    if start == len(chain):    # nothing quantized (the VMEM trim)
      continue
    cin = chain[start].kernel.shape[2]
    x = torch.randn(batch, h, w, cin, device=DEVICE, generator=gen)
    int8_check('{} {}^2'.format(name, size), x.to(torch.bfloat16),
               chain[start:], unit.padding, torch.bfloat16, errs, launches)
  require((launches['conv'], launches['requant']) == INT8_LAUNCHES[size][2:],
          'expected {} quantized layers and {} requants in the flagship '
          'chains at {}^2'.format(*INT8_LAUNCHES[size][2:], size))
  return errs, launches


def int8_phase(model):
  """Phase 12; returns {'conv', 'requant'} max errs."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
  errs, launches = int8_flagship_checks(model, SIZE, BATCH, gen)
  half, quarter = SIZE // 2, SIZE // 4
  int8_check('k3_zero', torch.randn(8, half, half, 32, device=DEVICE,
                                    generator=gen),
             random_chain(gen, 3, (32, 32, 32)), 'zero', torch.bfloat16, errs,
             launches)
  int8_check('k4_replicate_f32', torch.randn(4, quarter, quarter, 64,
                                             device=DEVICE, generator=gen),
             random_chain(gen, 4, (64, 64, 64)), 'replication', torch.float32,
             errs, launches)

  # the requant on an all-zero image (the 1e-8 floor) and on exact .5 ties
  y = torch.randn(3, 16, 16, 32, device=DEVICE, generator=gen)
  y[0] = y[0].clamp(-127 * 0.25, 127 * 0.25)
  y[0, 0, 0, 0] = 127 * 0.25          # amax: y · 127/amax = 4y, exact
  y[0, 1, 0, :4] = torch.tensor([0.5, 1.5, 2.5, -3.5], device=DEVICE) * 0.25
  y[2] = 0
  amax = y.abs().amax(dim=(1, 2, 3))
  xk, sk = cc.requant_cuda(y, amax)
  sync()
  want_x, want_s = cc.requant_plain(y, amax)
  print('K3 requant ties/zero image: kernel {} scales {}, plain {} scales '
        '{}'.format(xk[0, 1, 0, :4].tolist(), sk.tolist(),
                    want_x[0, 1, 0, :4].tolist(), want_s.tolist()))
  require(torch.equal(xk, want_x) and torch.equal(sk, want_s) and
          xk[0, 1, 0, :4].tolist() == [0, 2, 2, -4] and
          not bool(xk[2].any()), 'requant kernel on ties / zero image')
  print('K3 kernels vs plain on the same inputs: conv max {:.3e}, requant '
        'max {:.3e}'.format(errs['conv'], errs['requant']))
  return errs


def int8_main_path(P, args):
  """Phase 13: the int8 serving forward, counters around it; at 512² also
  every K3 launch of its chains against the plain versions. Returns the
  256² model, its (K3 conv, requant) launches and the 512² checks' max
  errs."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  from csmri_refinement_tpu_torch.ops import dc_kernel, quantize
  counters = (dc_kernel.dc_cuda, cc.conv_layer_cuda, cc.conv_layer_int8_cuda,
              cc.requant_cuda)

  def drive(model, inputs, n):
    sync()
    for c in counters:
      c.launches = 0
    quantize.reset_trace_log()
    with torch.inference_mode():
      for _ in range(n):
        out = model(*inputs)
      sync()
    got = tuple(c.launches for c in counters)
    pred = out['pred']
    b, size = inputs[0].shape[0], inputs[0].shape[1]
    print('int8 main path {}^2 B{}: {} forwards, launches K1 {} K2 {} K3 '
          'conv {} K3 requant {}, a chain fell back to float: {}'.format(
              size, b, n, *got, quantize.fell_back_to_bf16()))
    require(tuple(pred.shape) == (b, size, size, 2) and
            bool(torch.isfinite(pred.float()).all()),
            'int8 pred at {}^2 is not finite or of the wrong shape'.format(
                size))
    require(got == tuple(n * c for c in INT8_LAUNCHES[size]),
            'int8 launches at {}^2: expected {} per forward'.format(
                size, INT8_LAUNCHES[size]))
    return got

  model8, _ = P.build_flagship(SIZE, torch.bfloat16, DEVICE, SEED,
                               quantize_inference=True)
  got = drive(model8, args, 3)
  require(not quantize.fell_back_to_bf16(), 'a 256^2 chain fell back')
  big = 2 * SIZE
  model_big, undersample_batch = P.build_flagship(
      big, torch.bfloat16, DEVICE, SEED, quantize_inference=True)
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
  batch = undersample_batch(gen, torch.rand(4, big, big, device=DEVICE,
                                            generator=gen), 'varden', 8)
  drive(model_big, [batch[k] for k in ('inp', 'kspace', 'mask')], 1)
  require(quantize.fell_back_to_bf16(), 'expected a 512^2 chain with no '
          'quantized layer (the JAX package\'s VMEM trim)')
  del batch
  errs, _ = int8_flagship_checks(model_big, big, 4, gen)
  print('K3 kernels vs plain at {}^2 B4: conv max {:.3e}, requant max '
        '{:.3e}'.format(big, errs['conv'], errs['requant']))
  del model_big
  return model8, got[2:], errs


def int8_quality_inputs(P):
  """Phase 14's models and batch, on the CPU: the flagship at SIZE², f32
  compute, int8 and f32, scale 0.5 (at its zero init the U-Net skips
  pred), and a varden-8× batch of 2, all from seeds."""
  models = []
  for quantized in (True, False):
    model, undersample_batch = P.build_flagship(
        SIZE, torch.float32, 'cpu', SEED, quantize_inference=quantized)
    with torch.no_grad():
      model.scale.fill_(0.5)
    models.append(model)
  gen = torch.Generator().manual_seed(SEED + 2)
  batch = undersample_batch(gen, torch.rand(2, SIZE, SIZE, generator=gen),
                            'varden', 8)
  return models[0], models[1], batch


def rel_max_err(got, ref):
  return ((got - ref).abs().max() / ref.abs().max()).item()


def int8_quality_phase(P, line):
  """Phase 14: int8 with f32 compute, card vs CPU; int8 vs f32 on the card,
  against the JAX package's reading; the quality-vs-dtype table."""
  from csmri_refinement_tpu_torch import quality_dtype_table as qt
  model_cpu, f32_cpu, batch = int8_quality_inputs(P)
  model_gpu = copy.deepcopy(model_cpu).to(DEVICE)
  f32_gpu = copy.deepcopy(f32_cpu).to(DEVICE)
  args = [batch[k] for k in ('inp', 'kspace', 'mask')]
  with torch.inference_mode():
    want = model_cpu(*args)
    want_f32 = f32_cpu(*args)
    got = model_gpu(*[a.to(DEVICE) for a in args])
    ref = f32_gpu(*[a.to(DEVICE) for a in args])
    sync()
  err = (got['pred'].cpu() - want['pred']).abs().max().item()
  rel = err / want['pred'].abs().max().item()
  p_gpu = psnr(got['pred'].cpu(), batch['target'])
  p_cpu = psnr(want['pred'], batch['target'])
  print('int8 f32-compute pred, card vs CPU: max|Δ|/max|ref| {:.3e} (tol {}), '
        'PSNR card {:.4f} dB, CPU {:.4f} dB'.format(rel, INT8_E2E_REL, p_gpu,
                                                   p_cpu))
  require(rel <= INT8_E2E_REL, 'int8 forward differs between card and CPU')
  require(abs(p_gpu - p_cpu) < PSNR_TOL_DB, 'int8 PSNR differs')
  key = 'prescaled_refinement'      # the U-Net's own output
  rel_flagship = rel_max_err(got[key], ref[key])
  rel_cpu = rel_max_err(want[key], want_f32[key])
  print('int8 vs f32, the flagship U-Net at {}^2 B2, relative max error: '
        'card {:.6f}, CPU {:.6f}, the JAX package {:.6f} (tol {:g} of '
        'it)'.format(SIZE, rel_flagship, rel_cpu, INT8_VS_F32_FLAGSHIP_JAX,
                     INT8_VS_F32_FLAGSHIP_RTOL))
  require(abs(rel_flagship - INT8_VS_F32_FLAGSHIP_JAX) <=
          INT8_VS_F32_FLAGSHIP_RTOL * INT8_VS_F32_FLAGSHIP_JAX,
          'the flagship\'s int8 error differs from the JAX package\'s')
  # The JAX suite's bar on its own U-Net (tests/test_conv_pallas.py:157-169:
  # encoders [32, 64], 64², randn input), with the port's seeded init.
  from csmri_refinement_tpu_torch.models.unet import UNET
  kw = dict(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
            encode_filters=[32, 64], decode_filters=[32], kernel_size=4,
            upsampling_mode='nn-resize-conv', output_activation='none',
            padding='reflection', decoder_act_upsampling_only=True)
  unet8 = UNET(quantize_inference=True, **kw)
  unet8.init_weights(torch.Generator().manual_seed(SEED))
  unet = UNET(**kw)
  unet.load_state_dict(unet8.state_dict())
  x = torch.randn(2, 64, 64, 2, device=DEVICE,
                  generator=torch.Generator(device=DEVICE).manual_seed(SEED))
  with torch.inference_mode():
    a, b = unet8.to(DEVICE).eval()(x), unet.to(DEVICE).eval()(x)
  rel8 = rel_max_err(a, b)
  print('int8 vs f32 on the card, relative max error of the JAX suite\'s '
        'U-Net: {:.4f} (must be in (0, {}))'.format(rel8, INT8_VS_F32_REL))
  require(0 < rel8 < INT8_VS_F32_REL, 'int8 vs f32 relative error')
  rows = qt.table((SIZE,), 8, DEVICE, refinement_scale=0.5)
  print('quality vs dtype, {}^2, 8 phantoms, scale 0.5 ({}):'.format(SIZE,
                                                                    line))
  qt.print_table(rows)
  require(all(math.isfinite(r[2]) and math.isfinite(r[4]) for r in rows),
          'quality table has a non-finite score')


def bound(ops, bytes_, peak):
  """(ms, 'bytes' or 'operations'): the larger of bytes over the HBM rate
  and operations over ``peak``."""
  b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
  return max(b_ms, o_ms), 'bytes' if b_ms >= o_ms else 'operations'


def k3_cases(model):
  """The quantized flagship layers at 256², B=32, each on the input the
  kernels give it: [(label, conv args, the previous layer's (f32 output,
  amax) that the requant kernel turned into this input, or None for a
  chain's first layer, the float layer)]. Works on any tree of the port
  (``--tree``)."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  from csmri_refinement_tpu_torch.ops import quantize
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
  out = []
  for name, unit in unet_chains(model):
    h, w, _ = CHAIN_SHAPES[name]
    chain = unit.chain_layers()
    start = cc.int8_suffix_start(chain, h, w)
    x = torch.randn(BATCH, h, w, chain[start].kernel.shape[2], device=DEVICE,
                    generator=gen).to(torch.bfloat16)
    xi, scale = quantize.quantize_act(x)
    fed = None
    for i, layer in enumerate(quantize.quantize_chain(chain[start:])):
      last = start + i + 1 == len(chain)
      args = (xi, scale, layer, unit.padding,
              torch.bfloat16 if last else torch.float32, not last)
      out.append(('{}[{}]'.format(name, start + i), args, fed,
                  chain[start + i]))
      if not last:
        fed = cc.conv_layer_int8_cuda(*args)
        xi, scale = cc.requant_cuda(*fed)
  sync()
  return out


def k3_table(cases, line):
  """Phase 15, K3: each quantized flagship layer as device time
  (``graph_ms``), with TOP/s and the share of the layer's own bound (its
  int8 input, weights and output each moved once), beside K2 bf16 on the
  same layer, and the requant kernel on each input it makes. Returns
  {'k3', 'requant', 'k2'} sums in ms."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  sums = {'k3': 0.0, 'requant': 0.0, 'k2': 0.0}
  for label, args, fed, flayer in cases:
    ms = graph_ms(lambda: cc.conv_layer_int8_cuda(*args), calls=5, replays=2)
    b, h, w, cin = args[0].shape
    k, _, _, cout = flayer.kernel.shape
    ops = 2 * b * h * w * k * k * cin * cout
    bytes_ = (b * h * w * cin + k * k * cin * cout + 8 * cout + 4 * b +
              b * h * w * cout * args[4].itemsize)
    b_ms, by = bound(ops, bytes_, INT8_OPS)
    xb = torch.randn(b, h, w, cin, device=DEVICE).to(torch.bfloat16)
    k2_ms = graph_ms(lambda: cc.conv_layer_cuda(xb, flayer, args[3]),
                     calls=5, replays=2)
    extra = ''
    if fed is not None:
      rq = graph_ms(lambda: cc.requant_cuda(*fed), calls=5, replays=2)
      extra = '; the requant of its input {:.4f} ms'.format(rq)
      sums['requant'] += rq
    sums['k3'] += ms
    sums['k2'] += k2_ms
    print('K3 layer {} B{} {}^2 {}->{} k{}: {:.4f} ms, {:.1f} TOP/s, {:.1%} '
          'of its bound {:.4f} ms ({}); K2 bf16 {:.4f} ms ({:.1f} TFLOP/s){} '
          '({})'.format(label, b, h, cin, cout, k, ms, ops / ms / 1e9,
                        b_ms / ms, b_ms, by, k2_ms, ops / k2_ms / 1e9, extra,
                        line))
  print('K3 the {} quantized flagship layers, device time: {:.4f} ms, requant '
        'kernel {:.4f} ms, together {:.4f} ms; K2 bf16 on the same layers '
        '{:.4f} ms ({})'.format(len(cases), sums['k3'], sums['requant'],
                                sums['k3'] + sums['requant'], sums['k2'],
                                line))
  return sums


def int8_timings(cases, line):
  """Phase 15, K3: the per-layer table, then the plain versions, the
  function's bound and cuDNN's bf16 convs on the same layers."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  sums = k3_table(cases, line)
  conv_plain_ms = timed_ms(lambda: [cc.conv_layer_int8_plain(*a)
                                   for _, a, _, _ in cases],
                          iters=2, warmup=1)
  fed = [f for _, _, f, _ in cases if f is not None]
  rq_plain_ms = timed_ms(lambda: [cc.requant_plain(*f) for f in fed], iters=5)
  cl = torch.channels_last
  yard = [(torch.randn(a[0].shape, device=DEVICE).to(torch.bfloat16).permute(
      0, 3, 1, 2).contiguous(memory_format=cl).permute(0, 2, 3, 1), layer,
           a[3]) for _, a, _, layer in cases]
  cudnn_ms = graph_ms(lambda: [library_chain(x, [layer], pad)
                               for x, layer, pad in yard], calls=2, replays=2)
  # The function's bound, as the TPU kernel computes it: each chain's int8
  # input read once, its weights, scales and bias, and its last output
  # written once. The f32 intermediates and the requant between layers are
  # costs of the port's split into one launch per layer, not of the work,
  # so they count in no bound of K3; the requant's own bound below is that
  # of its elementwise pass alone.
  ops = bytes_ = 0
  for _, (x, _, layer, _, dt, want_amax), prev, _ in cases:
    b, h, w, cin = x.shape
    k, _, _, cout = layer.kernel.shape
    ops += 2 * b * h * w * k * k * cin * cout
    bytes_ += k * k * cin * cout + 8 * cout
    if prev is None:
      bytes_ += b * h * w * cin + 4 * b
    if not want_amax:
      bytes_ += b * h * w * cout * dt.itemsize
  rq_bytes = sum(5 * y.numel() + 8 * y.shape[0] for y, _ in fed)
  conv_bound, conv_by = bound(ops, bytes_, INT8_OPS)
  rq_bound, rq_by = bound(0, rq_bytes, INT8_OPS)
  total = sums['k3'] + sums['requant']
  print('K3 conv, the {} quantized flagship layers B{} {}^2: kernel {:.4f} '
        'ms ({:.1f} TOP/s), plain {:.3f} ms, bound {:.4f} ms ({}: {:.1f} GOP, '
        '{:.1f} MB); cuDNN bf16 on the same layers {:.3f} ms (the nearest '
        'yardstick: no PyTorch call computes an int8 conv) ({})'.format(
            len(cases), BATCH, SIZE, sums['k3'], ops / sums['k3'] / 1e9,
            conv_plain_ms, conv_bound, conv_by, ops / 1e9, bytes_ / 1e6,
            cudnn_ms, line))
  print('K3 requant, {} launches: kernel {:.4f} ms, plain {:.4f} ms, bound '
        'of the pass alone {:.4f} ms ({}); conv + requant {:.4f} ms = {:.2f}x '
        'the function\'s bound {:.4f} ms ({})'.format(
            len(fed), sums['requant'], rq_plain_ms, rq_bound, rq_by, total,
            total / conv_bound, conv_bound, line))
  return {'conv': (sums['k3'], conv_plain_ms, conv_bound, conv_by),
          'requant': (sums['requant'], rq_plain_ms, rq_bound, rq_by)}


def int8_only(P, line):
  """``--int8-only``: K3 against its plain version on the flagship layers'
  inputs, then the K3 table, on the tree whose package was imported."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  print('tree: {}'.format(os.path.dirname(os.path.dirname(
      os.path.abspath(P.__file__)))))
  model, _ = P.build_flagship(SIZE, torch.bfloat16, DEVICE, SEED)
  cases = k3_cases(model)
  worst = 0.0
  for _, args, _, _ in cases:
    got = cc.conv_layer_int8_cuda(*args)[0]
    sync()
    want = cc.conv_layer_int8_plain(*args)[0]
    ref = want.float().abs().max().item()
    worst = max(worst, (got.float() - want.float()).abs().max().item() / ref)
  print('K3 flagship layers, max |kernel-plain| / max|ref| {:.3e}'.format(
      worst))
  require(worst <= INT8_NOISE, 'K3 differs from its plain version')
  k3_table(cases, line)


def f32_only(P, line):
  """``--f32-only``: K2's f32 route on the 18 segmentation layer shapes at
  256², B = 8 (seeded He weights, LeakyReLU'd inputs), against its plain
  version, then each layer's device time and the sum, on the tree whose
  package was imported (an earlier tree times its own f32 route)."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  print('tree: {}'.format(os.path.dirname(os.path.dirname(
      os.path.abspath(P.__file__)))))
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
  side, cin, total = SIZE, 2, 0.0
  widths = [32, 32, 64, 64, 128, 128, 256, 256, 512, 512, 256, 256, 128,
            128, 64, 64, 32, 32]
  sides = [1, 1, 2, 2, 4, 4, 8, 8, 16, 16, 8, 8, 4, 4, 2, 2, 1, 1]
  for i, (cout, f) in enumerate(zip(widths, sides)):
    side = SIZE // f
    x = F.leaky_relu(torch.randn(SEG_BATCH, side, side, cin, device=DEVICE,
                                 generator=gen), 0.2)
    w = torch.randn(3, 3, cin, cout, device=DEVICE, generator=gen) * (
        2.0 / (9 * cin)) ** 0.5
    layer = cc.ChainLayer(w, 0.1 * torch.randn(cout, device=DEVICE,
                                               generator=gen), 0.2)
    got = cc.conv_layer_cuda(x, layer, 'reflection')
    sync()
    want = cc.conv_layer_plain(x, layer, 'reflection')
    err = (got - want).abs().max().item()
    require(err <= F32_ATOL * max(1.0, want.abs().max().item()),
            'K2 f32 layer {} differs from its plain version'.format(i))
    ms = graph_ms(lambda: cc.conv_layer_cuda(x, layer, 'reflection'),
                  calls=3, replays=2)
    total += ms
    print('K2 f32 layer {:2d} B{} {}^2 {}->{} k3: route {}, {:.4f} ms, '
          'max|kernel-plain| {:.3e} ({})'.format(
              i, SEG_BATCH, side, cin, cout,
              cc.conv_route(cin, cout, torch.float32), ms, err, line))
    cin = cout
  print('K2 f32 the 18 segmentation layers B{} {}^2: {:.3f} ms ({})'.format(
      SEG_BATCH, SIZE, total, line))


def probe_phase(line):
  """Phase 15, probes: each probe entry point driven as its own path with
  its counter set to 0 before and read after; then timings. Returns the
  probes' entries of the kernels line."""
  from csmri_refinement_tpu_torch import probes
  from csmri_refinement_tpu_torch.probes import int8_prims, mosaic_prims
  runs = {}
  for module in (mosaic_prims, int8_prims):
    sync()
    module.probe_cuda.launches = 0
    results = module.run_all(DEVICE)
    sync()
    launches = module.probe_cuda.launches
    probes.print_results(results)
    require(all(r.status == 'OK' for r in results),
            'a probe of {} is not OK'.format(module.__name__))
    require(launches == len(module.PROBES), 'expected one launch per probe')
    runs[module] = (launches, max(r.max_abs_err for r in results))

  times = probe_timings(line)
  rows, lanes = probes.R, probes.L
  roll, mm = 'lane roll bf16 by 32', 's8 x s8 -> s32 mma'
  bounds = {roll: bound(0, 2 * rows * lanes * 2, BF16_FLOPS),
            mm: bound(2 * rows * lanes * lanes,
                      rows * lanes + lanes * lanes + 4 * rows * lanes,
                      INT8_OPS)}
  for name in (roll, mm):
    print('{} ({}x{}): bound {:.6f} ms ({}); kernel {:.4f} ms, library '
          '{:.4f} ms, device time ({})'.format(name, rows, lanes,
                                               *bounds[name],
                                               times[name]['ms'],
                                               times[name]['library_ms'],
                                               line))
  for name, (ms, rate) in int8_prims.throughput().items():
    print('library {} 4096^3 matmul: {:.3f} ms = {:.1f} T{}/s of {} peak '
          '({})'.format(name, ms, rate, 'OP' if name == 's8' else 'FLOP',
                        1979 if name == 's8' else 989, line))
  entries = []
  for name, module, probe, replaces in (
      ('probe_mosaic', mosaic_prims, roll, 'scripts/probe_mosaic_prims.py:27'),
      ('probe_int8', int8_prims, mm, 'scripts/probe_int8_prims.py:26')):
    launches, err = runs[module]
    entries.append({
        'name': name, 'route': 'cuda',
        'source': 'csmri_refinement_tpu_torch/csrc/probes.cu',
        'replaces': replaces, 'launches': launches, 'max_abs_err': err,
        **times[probe], 'bound_ms': bounds[probe][0],
        'bound_by': bounds[probe][1]})
  return entries


def probe_library_calls():
  """{probe name: the one PyTorch call that computes its function}; a
  probe without one (the scratch chain, the odd-pixel MMA, the requant,
  the dequant product) is absent. The bf16 select's ×2 is a second
  launch: no single call computes where(col < 32, 2x, x)."""
  from csmri_refinement_tpu_torch import probes
  rows, lanes = probes.R, probes.L
  low = torch.arange(lanes, device=DEVICE) < 32
  words = lambda t, shift: torch.roll(t.view(torch.int32), shift, 1)
  return {
      'lane roll bf16 by 32': lambda x: torch.roll(x, 32, 1),
      'lane roll bf16 as 32-bit pairs': lambda x: words(x, 16),
      'row roll bf16 by 1': lambda x: torch.roll(x, 1, 0),
      'unaligned row read': lambda x: x[1:rows - 15].clone(),
      'unaligned row write': lambda x: F.pad(x[:rows - 16], (0, 0, 1, 15)),
      'bf16 where(iota) select': lambda x: torch.where(low, x * 2, x),
      'strided mid-dim read': lambda x: x[:, 3, :].contiguous(),
      'pair roll by 64 on 250-row tile': lambda x: words(x, 32),
      's8 x s8 -> s32 mma': torch._int_mm,
      'int8 lane roll via 32-bit words': lambda a: words(a, 8),
      'int8 where(iota) select': lambda a: torch.where(low, a, 0),
  }


def probe_timings(line):
  """Every probe on its own inputs: kernel, plain version and library call
  as device time (``graph_ms``), and the kernel's eager calls
  (``timed_ms``, with the wrapper's host time). Prints one line a probe;
  returns {name: {'ms', 'plain_ms', 'library_ms', 'eager_ms'}}."""
  from csmri_refinement_tpu_torch.probes import int8_prims, mosaic_prims
  library = probe_library_calls()
  data = int8_prims.probe_inputs(DEVICE)
  cases = [(name, mosaic_prims,
            [mosaic_prims.probe_input(spec[1], DEVICE)])
           for name, spec in mosaic_prims.PROBES.items()]
  cases += [(name, int8_prims, [data[k] for k in spec[2]])
            for name, spec in int8_prims.PROBES.items()]
  out = {}
  for name, module, inputs in cases:
    lib = library.get(name)
    fns = {'ms': lambda: module.probe_cuda(name, *inputs),
           'plain_ms': lambda: module.plain(name, *inputs)}
    if lib:
      fns['library_ms'] = lambda: lib(*inputs)
    # in turns, each timed twice (a, b, c, c, b, a), so that a drift of
    # the card's clock over the sequence favours none of them
    runs = [(k, graph_ms(fns[k])) for k in list(fns) + list(fns)[::-1]]
    t = {key: sum(ms for k, ms in runs if k == key) / 2 for key in fns}
    t.setdefault('library_ms', None)
    t['eager_ms'] = timed_ms(fns['ms'])
    out[name] = t
    print('probe {:34s} device ms: kernel {:.5f}, plain {:.5f}, library {}; '
          'kernel eager {:.5f} ms ({})'.format(
              name, t['ms'], t['plain_ms'],
              'none' if lib is None else '{:.5f}'.format(t['library_ms']),
              t['eager_ms'], line))
  return out


# Sources whose wgmma K loops must keep the MMA pipe full: ptxas warns
# C7517 where it drains it.
NO_C7517 = ('probes', 'conv_int8', 'conv_f32')


def gan_cli_phase(recnet_runner):
  """Phase 16 (a): the GAN refinement CLI on the card at the full widths
  of configs/2-refinement.json, its frozen RecNet grafted from a
  checkpoint of phase 9's runner; counters around it. Returns (the
  runner, its config file, K1 and K2 launches)."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  from csmri_refinement_tpu_torch.utils import checkpoints
  os.makedirs(GAN_DIR, exist_ok=True)
  ckpt = os.path.join(GAN_DIR, 'recnet.ckpt')
  checkpoints.save_checkpoint(ckpt, recnet_runner.conf, recnet_runner, 1, {})
  conf_path = os.path.join(GAN_DIR, '2-refinement-synthetic.json')
  with open(conf_path, 'w') as f:
    json.dump(synthetic_refinement_conf(
        SIZE, GAN_TRAIN, GAN_VAL, GAN_BATCH, ['recnet.ckpt', 'model']), f)
  frozen = checkpoints.load_model_state_dict(ckpt, 'model')
  sync()
  dc_kernel.dc_cuda.launches = 0
  dc_kernel.dc_bwd_cuda.launches = 0
  conv_chain.conv_layer_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([conf_path, '--dry'])
  sync()
  secs = time.perf_counter() - t0
  k1, k1_bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
  k2 = conv_chain.conv_layer_cuda.launches
  k2_f32 = conv_chain.conv_layer_f32_cuda.launches
  steps, val_batches = runner.step, GAN_VAL // GAN_BATCH
  print('GAN main path: {} steps + {} validation batches in {:.1f} s, K1 '
        'launches {}, K1-bwd launches {}, K2 launches {} (f32 routes {})'
        .format(steps, val_batches, secs, k1, k1_bwd, k2, k2_f32))
  require(steps == GAN_TRAIN // GAN_BATCH, 'expected 8 GAN steps (40 / 5)')
  require(k1 == 3 * (steps + val_batches),
          'expected 3 K1 launches per generator forward')
  require(k1_bwd == 0, 'the frozen RecNet launched K1-bwd')
  require(k2 == k2_f32 == 10 * val_batches,
          'expected 10 K2 f32 launches per validation forward')
  require_frozen(runner, frozen, 'after the CLI epoch')
  return runner, conf_path, frozen, k1, k2


def gan_kernel_checks(runner):
  """Phase 16: K1 and K2 at the GAN path's shapes against their plain
  versions: the DC at 256², B = 5 (each generator forward), and the f32
  conv chains of the trained generator's U-Net at B = 5 (validation), to
  F32_ATOL of max(1, max |ref|). Returns (the chains' max |kernel - plain|,
  their 10 layers [(x, layer, pad)] as the chains launch them)."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  from csmri_refinement_tpu_torch.ops import dc_kernel, masks
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
  b = GAN_BATCH
  x = torch.randn(b, SIZE, SIZE, 2, device=DEVICE, generator=gen)
  k0 = torch.randn(b, SIZE, SIZE, 2, device=DEVICE, generator=gen)
  m = masks.cartesian_mask(gen, (b, SIZE, SIZE), 8,
                           device=DEVICE)[..., None].contiguous()
  got = dc_kernel.dc_cuda(x, k0 * m, m)
  sync()
  err = (got - dc_kernel.dc_plain(x, k0 * m, m)).abs().max().item()
  print('K1 dc GAN shape {}x{}x{}: max|kernel-plain| {:.3e} (tol {})'.format(
      b, SIZE, SIZE, err, F32_ATOL))
  require(err <= F32_ATOL, 'DC kernel differs from its plain version')
  runner.gen.eval()
  worst, layers = 0.0, []
  with torch.no_grad():
    for name, unit in unet_chains(runner.gen):
      h, w, _ = CHAIN_SHAPES[name]
      chain = unit.chain_layers()
      cin = chain[0].kernel.shape[2]
      x = torch.randn(b, h, w, cin, device=DEVICE, generator=gen)
      xi = x
      for layer in chain:
        layers.append((xi, layer, unit.padding))
        xi = cc.conv_layer_cuda(xi, layer, unit.padding)
      got = cc.fused_conv_chain(x, chain, pad_mode=unit.padding)
      sync()
      want = plain_chain(x, chain, unit.padding)
      err = (got - want).abs().max().item()
      tol = F32_ATOL * max(1.0, want.abs().max().item())
      print('K2 chain {} GAN f32 {}: max|kernel-plain| {:.3e}, tol {:.3e}'
            .format(name, tuple(x.shape), err, tol))
      require(err <= tol, 'f32 conv chain {} differs from its plain '
              'version'.format(name))
      worst = max(worst, err)
  return worst, layers


def require_frozen(runner, frozen, when):
  got = runner.gen.pretrained_model.state_dict()
  require(set(got) == set(frozen) and all(
      torch.equal(v.cpu(), frozen[k]) for k, v in got.items()),
          'the frozen RecNet differs from its checkpoint ' + when)
  print('GAN frozen RecNet equals its checkpoint {} ({} tensors)'.format(
      when, len(got)))


def gan_batches(conf, n, size):
  """n host batches of the config's phantoms with fixed varden masks."""
  from csmri_refinement_tpu_torch.data import load_dataset
  from csmri_refinement_tpu_torch.ops import masks
  data = load_dataset(conf, None, 'Synthetic', 'train')
  gen = torch.Generator().manual_seed(SEED + 7)
  out = []
  for i in range(n):
    gt = torch.stack([torch.from_numpy(data[j]['gt'])
                      for j in range(i * GAN_BATCH, (i + 1) * GAN_BATCH)])
    out.append((gt, masks.cartesian_mask(gen, (GAN_BATCH, size, size), 8)))
  return out


def gan_runner_pair(conf_d):
  """A CPU and a card AdversarialRunner of ``conf_d``, the card's
  generator, discriminator and VGG19 weights copied from the CPU's."""
  from csmri_refinement_tpu_torch.training.adversarial_runner import (
      AdversarialRunner)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict(conf_d)
  cpu = AdversarialRunner(conf, 'train', 'cpu')
  gpu = AdversarialRunner(conf, 'train', DEVICE)
  gpu.gen.load_state_dict(cpu.gen.state_dict())
  gpu.disc.load_state_dict(cpu.disc.state_dict())
  gpu.gen_criteria['VGG19'].criterion.vgg.load_state_dict(
      cpu.gen_criteria['VGG19'].criterion.vgg.state_dict())
  return conf, cpu, gpu


def gan_updates(label, cpu, gpu, batches, gated):
  """The same updates on both runners; each update's gen_loss and
  disc_loss printed, and held within LOSS_RTOL where ``gated(step,
  name)``. Returns the worst gated relative difference."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  worst = 0.0
  for step, (gt, mask) in enumerate(batches):
    want = cpu.train_batch(us.undersample_batch(None, gt,
                                                fixed_mask=mask))[0]
    got = gpu.train_batch(us.undersample_batch(
        None, gt.to(DEVICE), fixed_mask=mask.to(DEVICE)))[0]
    for name in ('gen_loss', 'disc_loss'):
      w, g = want[name].item(), got[name].item()
      rel = abs(g - w) / abs(w)
      gate = gated(step, name)
      print('GAN parity {} step {}: {} card {:.8e}, CPU {:.8e}, rel {:.2e} '
            '(tol {})'.format(label, step, name, g, w, rel,
                              LOSS_RTOL if gate else 'none'))
      require(math.isfinite(g) and (rel <= LOSS_RTOL or not gate),
              'card and CPU GAN losses differ')
      worst = max(worst, rel) if gate else worst
  require(cpu.pool.count == gpu.pool.count == len(batches) * GAN_BATCH,
          'the pool left its fill phase')
  print('GAN parity {}: worst gated loss rel {:.2e}; losses after {} '
        'updates {}'.format(label, worst, len(batches), {
            k: round(v.item(), 6) for k, v in got.items()}))
  return worst


def gan_parity_phase():
  """Phase 16 (b): card against CPU, TF32 off, dropout off, the pool in
  its fill phase, the same weights and Synthetic batches. Full widths at
  128² (the smallest side whose discriminator keeps its 4×4 head): the
  discriminator's gradients on the same inputs within GAN_GRAD_REL, the
  first update's losses and the second's gen_loss within LOSS_RTOL, the
  rest printed (GAN_GRAD_REL's comment says why). The narrow widths at
  64²: every loss of three updates within LOSS_RTOL."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  size = GAN_PARITY_SIZE
  conf, cpu, gpu = gan_runner_pair(synthetic_refinement_conf(
      size, GAN_PARITY_STEPS * GAN_BATCH, GAN_BATCH, GAN_BATCH,
      dropout=False))
  batches = gan_batches(conf, GAN_PARITY_STEPS, size)

  # The discriminator's gradients on the same inputs, before any update.
  gt, mask = batches[0]
  batch = us.undersample_batch(None, gt, fixed_mask=mask)
  cpu.gen.train()
  with torch.no_grad():
    out = cpu.gen(*cpu._gen_inputs(batch))
  fake = cpu.disc_input_fn.build(out)
  real = cpu.disc_input_fn.build(batch['target'])
  crit = cpu.disc_adv_criteria['gan']
  noisy = fake * (1 + 1e-5 * torch.randn(
      fake.shape, generator=torch.Generator().manual_seed(SEED)))
  grads = {}
  for name, dev, dt, x in (('cpu', 'cpu', torch.float32, fake),
                           ('card', DEVICE, torch.float32, fake),
                           ('f64', 'cpu', torch.float64, fake),
                           ('noisy', 'cpu', torch.float32, noisy)):
    disc = copy.deepcopy(cpu.disc).to(dev, dt).train()
    loss = crit(disc(x.to(dev, dt)), disc(real.to(dev, dt)))
    grads[name] = [g.double().cpu() for g in torch.autograd.grad(
        loss, list(disc.parameters()))]

  def worst(a, b):
    return max(((x - y).abs().max().item() / y.abs().max().item(), n)
               for (n, _), x, y in zip(cpu.disc.named_parameters(),
                                       grads[a], grads[b]))
  err = worst('card', 'cpu')
  print('GAN parity {}^2: discriminator gradients on the same inputs, worst '
        'max|diff| / max|grad|: card vs CPU {:.2e} ({}) (tol {}); card vs '
        'f64 {:.2e}, CPU vs f64 {:.2e}; the CPU\'s own under 1e-5 relative '
        'input noise {:.2e} ({})'.format(
            size, err[0], err[1], GAN_GRAD_REL, worst('card', 'f64')[0],
            worst('cpu', 'f64')[0], *worst('noisy', 'cpu')))
  require(err[0] <= GAN_GRAD_REL, 'card and CPU discriminator gradients '
          'differ')
  gan_updates('{}^2'.format(size), cpu, gpu, batches,
              lambda step, name: step == 0 or (step == 1 and
                                               name == 'gen_loss'))

  size = GAN_NARROW_SIZE
  conf, cpu, gpu = gan_runner_pair(synthetic_refinement_conf(
      size, GAN_PARITY_STEPS * GAN_BATCH, GAN_BATCH, GAN_BATCH,
      dropout=False, narrow=True))
  gan_updates('{}^2 narrow'.format(size), cpu, gpu,
              gan_batches(conf, GAN_PARITY_STEPS, size),
              lambda step, name: True)


def gan_timing_phase(conf_path, frozen, line):
  """Phase 16 (c): ms per GAN step at 256², B = 5, TF32 off and on, CUDA
  events around whole steps on one prepared batch after warm-up."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_json(conf_path)
  runner = build_runner(conf, 'adversarial', 'train', DEVICE)
  require_frozen(runner, frozen, 'when grafted')
  gt, mask = gan_batches(conf, 1, SIZE)[0]
  batch = us.undersample_batch(None, gt.to(DEVICE),
                               fixed_mask=mask.to(DEVICE))
  step_ms = {}
  for tf32 in (False, True):
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    step_ms[tf32] = timed_ms(lambda: runner.train_batch(batch), iters=10,
                            warmup=3)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  for tf32, ms in step_ms.items():
    print('GAN refinement step {}^2 f32 B{} TF32 {}: {:.3f} ms, {:.1f} '
          'slices/s ({})'.format(SIZE, GAN_BATCH, 'on' if tf32 else 'off',
                                 ms, GAN_BATCH / ms * 1e3, line))
  require_frozen(runner, frozen, 'after the timed steps')
  return step_ms


def up_conv_timings(model, line):
  """Phase 16 (d): each flagship decoder's up-conv at 256², B = 32, bf16,
  as device time: the subpixel form beside the explicit nearest-up2 →
  reflect pad → k4 conv it replaces."""
  from csmri_refinement_tpu_torch.models import layers as L
  unet = model.learnable_model
  cl = torch.channels_last
  for name, size in (('decode_0', SIZE // 4), ('decode_1', SIZE // 2)):
    conv = getattr(unet, name).up_conv
    cin = conv.weight.shape[1]
    x = torch.randn(BATCH, cin, size, size, device=DEVICE,
                    dtype=torch.bfloat16).contiguous(memory_format=cl)
    w, b = conv.weight.to(torch.bfloat16), None if conv.bias is None \
        else conv.bias.to(torch.bfloat16)

    def explicit():
      up = F.interpolate(x, scale_factor=2, mode='nearest')
      return L.same_conv(up, w, b, conv.pad_mode).permute(0, 2, 3, 1)
    with torch.inference_mode():
      err = (conv(x).float() - explicit().float()).abs().max().item()
      ref = explicit().float().abs().max().item()
      sub_ms = graph_ms(lambda: conv(x))
      exp_ms = graph_ms(explicit)
    require(err <= BF16_REL_TOL * ref, 'subpixel up-conv differs from the '
            'explicit path')
    print('up-conv {} {}^2->{}^2 {}->{} B{} bf16: subpixel {:.4f} ms, '
          'explicit {:.4f} ms, max|diff| {:.3e} of max {:.3e} ({})'.format(
              name, size, 2 * size, cin, conv.weight.shape[0], BATCH, sub_ms,
              exp_ms, err, ref, line))


def seg_cli_phase():
  """Phase 17 (a): the segmentation CLI on the card at the full widths of
  configs/3-train-segmentation-unet.json, one epoch of Synthetic 256²
  (B = 8), counters around it; it keeps the best checkpoint by
  dice_class_1. Returns (the runner, the config as a dict, the best
  checkpoint, the K2 launches)."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  from csmri_refinement_tpu_torch.profile_seg import (
      synthetic_segmentation_conf)
  from csmri_refinement_tpu_torch.utils import checkpoints
  conf_d = synthetic_segmentation_conf(SIZE, SEG_TRAIN, SEG_VAL, SEG_BATCH)
  os.makedirs(GAN_DIR, exist_ok=True)
  conf_path = os.path.join(GAN_DIR, '3-train-segmentation-synthetic.json')
  with open(conf_path, 'w') as f:
    json.dump(conf_d, f)
  log_dir = os.path.join(GAN_DIR, 'runs')
  shutil.rmtree(log_dir, ignore_errors=True)
  sync()
  dc_kernel.dc_cuda.launches = 0
  conv_chain.conv_layer_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([conf_path, '--log-dir', log_dir])
  sync()
  secs = time.perf_counter() - t0
  k2, k1 = conv_chain.conv_layer_cuda.launches, dc_kernel.dc_cuda.launches
  k2_f32 = conv_chain.conv_layer_f32_cuda.launches
  steps, val_batches = runner.step, SEG_VAL // SEG_BATCH
  best = glob.glob(os.path.join(log_dir, '*', 'best_dice_class_1', '*.ckpt'))
  print('segmentation main path: {} steps + {} validation batches in {:.1f} '
        's, K2 launches {} (f32 routes {}), K1 launches {}, best checkpoints '
        '{}'.format(steps, val_batches, secs, k2, k2_f32, k1, best))
  require(steps == SEG_TRAIN // SEG_BATCH, 'expected 5 segmentation steps')
  require(k2 == k2_f32 == SEG_CHAIN_LAYERS * val_batches,
          'expected 18 K2 f32 launches per validation forward and none in '
          'train mode')
  require(k1 == 0, 'the segmentation path launched K1')
  require(len(best) == 1, 'expected one best checkpoint by dice_class_1')
  vals = checkpoints.load_checkpoint(best[0])['best_val_metrics']
  vals = {k: v['value'] for k, v in vals.items()}
  print('segmentation main path validation: {}'.format(vals))
  require(all(0 <= vals[k] <= 1 for k in ('dice_class_0', 'dice_class_1'))
          and math.isfinite(vals['loss_CrossEntropy']),
          'segmentation validation metrics out of range')
  return runner, conf_d, best[0], k2


def sis_gan_phase(gan_conf_path, gen_state, seg_conf_d, best):
  """Phase 17 (b): the segmentation score as a validation metric of the GAN
  runner, its network from (a)'s best checkpoint, the generator phase 16
  trained; counters around the validation. Returns (the score, the K2
  launches of its network)."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils import checkpoints
  from csmri_refinement_tpu_torch.utils.config import Configuration
  with open(gan_conf_path) as f:
    conf_d = json.load(f)
  conf_d.update(
      include_labels=True,
      validation_metrics=['psnr', 'ssim', 'segmentation_score'],
      segmentation_score_metric={'model': dict(
          seg_conf_d['model'], pretrained_weights=[best, 'model']),
                                 'class': 1})
  conf_path = os.path.join(GAN_DIR, '2-refinement-synthetic-sis.json')
  with open(conf_path, 'w') as f:
    json.dump(conf_d, f)
  conf = Configuration.from_json(conf_path)
  runner = build_runner(conf, 'adversarial', 'train', DEVICE)
  runner.gen.load_state_dict(gen_state)
  loader = DataLoader(load_dataset(conf, None, 'Synthetic', 'val'), GAN_BATCH)
  sync()
  dc_kernel.dc_cuda.launches = 0
  conv_chain.conv_layer_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  _, val_losses, val_metrics = runner.validate(loader)
  sync()
  k1, k2 = dc_kernel.dc_cuda.launches, conv_chain.conv_layer_cuda.launches
  k2_f32 = conv_chain.conv_layer_f32_cuda.launches
  val_batches = GAN_VAL // GAN_BATCH
  vals = {k: v.value for k, v in list(val_losses.items()) +
          list(val_metrics.items())}
  print('GAN validation with the segmentation score: {} batches, K1 '
        'launches {}, K2 launches {} (f32 routes {}; 10 generator + 18 '
        'segmentation per batch): {}'.format(val_batches, k1, k2, k2_f32,
                                             vals))
  require(k1 == 3 * val_batches, 'expected 3 K1 launches per generator '
          'forward')
  require(k2 == k2_f32 == (10 + SEG_CHAIN_LAYERS) * val_batches,
          'expected 10 + 18 K2 f32 launches per validation batch')
  sis = vals['gen_segmentation_score']
  require(0 <= sis <= 1 and all(math.isfinite(v) for v in vals.values()),
          'GAN validation with the segmentation score out of range')
  score = runner.val_metric_fns['segmentation_score'].metric_fn
  want = checkpoints.load_model_state_dict(best, 'model')
  require(all(torch.equal(v.cpu(), want[k])
              for k, v in score.model.state_dict().items()),
          'the segmentation score\'s network differs from its checkpoint')
  return score, k1, k2


def chain_launches(net, *net_inputs):
  """The K2 launches of ``net``'s eval-mode forward on ``net_inputs``,
  redone one by one: each chain unit's input is caught on the way (a forward
  pre-hook), then its layers are launched on it in turn. Returns [(x,
  layer, pad, y)], in the forward's order."""
  from csmri_refinement_tpu_torch.models.unet import ConvEncodeUnit
  from csmri_refinement_tpu_torch.ops import conv_chain
  from csmri_refinement_tpu_torch.utils.precision import full_f32
  inputs = []
  hooks = [m.register_forward_pre_hook(
      lambda unit, args: inputs.append((unit, args[0])))
           for m in net.modules() if isinstance(m, ConvEncodeUnit)]
  try:
    with torch.no_grad(), full_f32():
      net(*net_inputs)
  finally:
    for hook in hooks:
      hook.remove()
  calls = []
  with torch.no_grad():
    for unit, xi in inputs:
      xi = xi.float().contiguous()
      for layer in unit.chain_layers():
        y = conv_chain.conv_layer_cuda(xi, layer, unit.padding)
        calls.append((xi, layer, unit.padding, y))
        xi = y
  sync()
  return calls


def seg_inputs(size, n, fold='val', noise=0.0):
  """n Synthetic segmentation items of side ``size``: (inp (n, size, size,
  2) with ``noise`` added, labels (n, size, size)), on the CPU."""
  from csmri_refinement_tpu_torch.data import load_dataset
  from csmri_refinement_tpu_torch.profile_seg import (
      synthetic_segmentation_conf)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict(synthetic_segmentation_conf(size, n, n))
  data = load_dataset(conf, None, 'Synthetic', fold)
  inp = torch.stack([torch.from_numpy(data[i]['inp']) for i in range(n)])
  if noise:
    inp = inp + noise * torch.randn(
        inp.shape, generator=torch.Generator().manual_seed(SEED + 17))
  label = torch.stack([torch.from_numpy(data[i]['target'])
                       for i in range(n)])
  return inp, label


def seg_kernel_checks(score):
  """Phase 17 (c): every K2 launch of one segmentation-score forward (256²,
  B = 5), of a validation forward (256², B = 8) and of one forward at 128²,
  B = 1 against ``conv_layer_plain``, to F32_ATOL of max(1, max |ref|).
  Returns (the B = 8 launches, the largest |kernel - plain|)."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  cases, worst = {}, 0.0
  for label, size, b in (('SIS', SIZE, GAN_BATCH), ('validation', SIZE,
                                                    SEG_BATCH),
                         ('single image', SIZE // 2, 1)):
    x = seg_inputs(size, b)[0].to(DEVICE)
    calls = chain_launches(score.network(x.device), x)
    require(len(calls) == SEG_CHAIN_LAYERS, 'expected 18 K2 launches per '
            'segmentation forward, got {}'.format(len(calls)))
    errs = []
    for xi, layer, pad, y in calls:
      want = conv_chain.conv_layer_plain(xi, layer, pad)
      err = (y - want).abs().max().item()
      tol = F32_ATOL * max(1.0, want.abs().max().item())
      require(y.shape == want.shape and err <= tol,
              'K2 f32 layer {} {} differs from its plain version ({:.3e} > '
              '{:.3e})'.format(tuple(xi.shape), tuple(layer.kernel.shape),
                               err, tol))
      errs.append(err)
    sides = sorted({c[0].shape[1] for c in calls})
    print('K2 f32 {} forward {}^2 B{}: {} launches (images {}^2 to {}^2, Cin '
          '{} to {}), max|kernel-plain| {:.3e} (tol {} of max(1, max|ref|))'
          .format(label, size, b, len(calls), sides[0], sides[-1],
                  min(c[1].kernel.shape[2] for c in calls),
                  max(c[1].kernel.shape[2] for c in calls), max(errs),
                  F32_ATOL))
    cases[label] = calls
    worst = max(worst, max(errs))
  return cases['validation'], worst


def seg_runner_pair(conf_d):
  """A CPU and a card segmentation Runner of ``conf_d``, the card's weights
  copied from the CPU's."""
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict(conf_d)
  cpu = Runner(conf, 'train', 'cpu')
  gpu = Runner(conf, 'train', DEVICE)
  gpu.model.load_state_dict(cpu.model.state_dict())
  return cpu, gpu


def seg_steps(label, cpu, gpu, size, gated):
  """SEG_PARITY_STEPS updates of both runners on the same Synthetic
  batches; each loss printed, held within LOSS_RTOL where
  ``gated(step)``."""
  inp, target = seg_inputs(size, SEG_PARITY_STEPS * SEG_PARITY_BATCH,
                           fold='train')
  for step in range(SEG_PARITY_STEPS):
    rows = slice(step * SEG_PARITY_BATCH, (step + 1) * SEG_PARITY_BATCH)
    host = {'inp': inp[rows], 'target': target[rows]}
    want = cpu.train_batch(cpu.preparer.prepare_train(None, host))[0]
    got = gpu.train_batch(gpu.preparer.prepare_train(None, host))[0]
    w, g = want['loss'].item(), got['loss'].item()
    rel = abs(g - w) / abs(w)
    print('segmentation parity {} step {}: loss card {:.8e}, CPU {:.8e}, rel '
          '{:.2e} (tol {})'.format(label, step, g, w, rel,
                                   LOSS_RTOL if gated(step) else 'none'))
    require(math.isfinite(g) and (rel <= LOSS_RTOL or not gated(step)),
            'card and CPU segmentation losses differ')


def seg_parity_phase(conf_d, best):
  """Phase 17 (d): card against CPU at 128², B = 2, TF32 off. The network
  of (a)'s checkpoint in eval mode: logits within E2E_ATOL of max |ref|,
  class maps equal where the CPU's top-two margin is above SEG_MARGIN_REL
  of max |logit|, the segmentation score within SIS_ATOL. Training at full
  width: the first step's loss within LOSS_RTOL, the later ones printed
  (after Adam's first step rounding-decided gradient signs part the
  weights, as in phase 16); at narrow widths at 64² every step's."""
  from csmri_refinement_tpu_torch.metrics.segmentation_score import (
      SegmentationScore)
  from csmri_refinement_tpu_torch.profile_seg import (
      synthetic_segmentation_conf)
  size, b = SEG_PARITY_SIZE, SEG_PARITY_BATCH
  x, label = seg_inputs(size, b, noise=0.05)
  section = dict(conf_d['model'], pretrained_weights=[best, 'model'])
  scores = {}
  logits = {}
  for dev in ('cpu', DEVICE):
    score = SegmentationScore(section, None, class_idx=1)
    net = score.network(torch.device(dev))
    with torch.no_grad():
      logits[dev] = net(x.to(dev)).cpu()
    scores[dev] = score(x.to(dev), label.to(dev))
  want, got = logits['cpu'], logits[DEVICE]
  scale = want.abs().max().item()
  err = (got - want).abs().max().item()
  top2 = want.topk(2, dim=-1).values
  sure = (top2[..., 0] - top2[..., 1]) > SEG_MARGIN_REL * scale
  differ = want.argmax(-1) != got.argmax(-1)
  print('segmentation eval {}^2 B{} card vs CPU: logits max|diff| {:.3e} of '
        'max {:.3e} (tol {} of it); class maps differ at {} pixels, {} of '
        'them with a CPU margin above {} of max (tol 0), {} pixels under it; '
        'segmentation score card {} CPU {} (tol {})'.format(
            size, b, err, scale, E2E_ATOL, int(differ.sum()),
            int((differ & sure).sum()), SEG_MARGIN_REL, int((~sure).sum()),
            scores[DEVICE], scores['cpu'], SIS_ATOL))
  require(err <= E2E_ATOL * scale, 'card and CPU segmentation logits differ')
  require(not bool((differ & sure).any()), 'card and CPU class maps differ')
  require(all(abs(g - w) <= SIS_ATOL
              for g, w in zip(scores[DEVICE], scores['cpu'])),
          'card and CPU segmentation scores differ')

  cpu, gpu = seg_runner_pair(synthetic_segmentation_conf(
      size, SEG_PARITY_STEPS * b, b, b))
  seg_steps('{}^2'.format(size), cpu, gpu, size, lambda step: step == 0)
  cpu, gpu = seg_runner_pair(synthetic_segmentation_conf(
      SEG_NARROW_SIZE, SEG_PARITY_STEPS * b, b, b, narrow=True))
  seg_steps('{}^2 narrow'.format(SEG_NARROW_SIZE), cpu, gpu, SEG_NARROW_SIZE,
            lambda step: True)


def seg_timing_phase(runner, score, calls, line):
  """Phase 17 (e): ms per segmentation train step at 256², B = 8, TF32 off
  and on (no K2 launch in train mode), ms per segmentation-score call at
  B = 5, and K2's f32 route on each of the 18 validation-forward layers
  (``f32_layer_table``). Returns the table's sums."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  inp, target = seg_inputs(SIZE, SEG_BATCH, fold='train')
  batch = runner.preparer.prepare_train(None, {'inp': inp, 'target': target})
  conv_chain.conv_layer_cuda.launches = 0
  runner.train_batch(batch)
  sync()
  require(conv_chain.conv_layer_cuda.launches == 0,
          'a segmentation train step launched K2')
  step_ms = {}
  for tf32 in (False, True):
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    step_ms[tf32] = timed_ms(lambda: runner.train_batch(batch), iters=10,
                            warmup=2)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  for tf32, ms in step_ms.items():
    print('segmentation train step {}^2 f32 B{} TF32 {}: {:.3f} ms, {:.1f} '
          'slices/s ({})'.format(SIZE, SEG_BATCH, 'on' if tf32 else 'off', ms,
                                 SEG_BATCH / ms * 1e3, line))
  pred, label = (t.to(DEVICE) for t in seg_inputs(SIZE, GAN_BATCH,
                                                  noise=0.05))
  sis_ms = timed_ms(lambda: score(pred, label), iters=10, warmup=2)
  print('segmentation score call {}^2 B{}: {:.3f} ms, {:.1f} slices/s '
        '({})'.format(SIZE, GAN_BATCH, sis_ms, GAN_BATCH / sis_ms * 1e3,
                      line))
  return f32_layer_table('segmentation', calls, line)


def decode_png(path):
  """(width, height, pixels) of an 8-bit grayscale PNG, its zlib stream
  inflated and each row's filter byte checked to be 0 (the validate CLI's
  PNGs); fails on anything else."""
  with open(path, 'rb') as f:
    data = f.read()
  require(data[:8] == b'\x89PNG\r\n\x1a\n', path + ' is not a PNG')
  pos, chunks = 8, {}
  while pos < len(data):
    n, kind = struct.unpack('>I4s', data[pos:pos + 8])
    body = data[pos + 8:pos + 8 + n]
    crc, = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])
    require(zlib.crc32(kind + body) & 0xffffffff == crc,
            'bad CRC in ' + path)
    chunks[kind] = chunks.get(kind, b'') + body
    pos += 12 + n
  width, height, depth, color = struct.unpack('>IIBB', chunks[b'IHDR'][:10])
  require(depth == 8 and color == 0, path + ' is not 8-bit grayscale')
  rows = zlib.decompress(chunks[b'IDAT'])
  require(len(rows) == height * (width + 1), 'bad IDAT size in ' + path)
  require(all(rows[r * (width + 1)] == 0 for r in range(height)),
          'unexpected row filter in ' + path)
  return width, height, rows


def scarseg_data_phase(root):
  """Phase 18 (1): the ScarSeg-format tree of 36 cases at 512² × 4 slices
  under ``root``, then a fold's load timed."""
  from csmri_refinement_tpu_torch.data import datasets, load_dataset
  from csmri_refinement_tpu_torch.utils.config import Configuration
  t0 = time.perf_counter()
  written = datasets.write_scarseg_phantoms(root, SCAR_SIZE, SCAR_SLICES,
                                            seed=SEED)
  write_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  train_set = load_dataset(Configuration.from_json(RECNET_CONFIG), root,
                           'ScarSeg', 'train')
  load_s = time.perf_counter() - t0
  print('ScarSeg tree: 36 cases of {}^2 x {} slices, {:.1f} MB written in '
        '{:.2f} s; train fold ({} slices) loaded in {:.2f} s (host)'.format(
            SCAR_SIZE, SCAR_SLICES, written / 1e6, write_s, len(train_set),
            load_s))
  require(len(train_set) == 24 * SCAR_SLICES, 'expected 96 training slices')


def scarseg_recnet_phase(data_dir, run_root):
  """Phase 18 (2): configs/1-recnet.json as written through the training
  CLI, one epoch on the tree, counters around it. Returns (the runner,
  its best checkpoint, K1 and K1-bwd launches)."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.ops import dc_kernel
  sync()
  dc_kernel.dc_cuda.launches = 0
  dc_kernel.dc_bwd_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([RECNET_CONFIG, '--data-dir', data_dir, '--log-dir',
                       run_root, '--device', DEVICE, '--conf',
                       'num_epochs=1'])
  sync()
  secs = time.perf_counter() - t0
  k1, k1_bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
  best = glob.glob(os.path.join(run_root, '1-recnet_*', 'best_loss_MSE',
                                '*.ckpt'))
  print('ScarSeg 1-recnet: {} steps (B {}) + {} validation batches in {:.1f} '
        's, K1 launches {}, K1-bwd launches {}'.format(
            runner.step, REC_BATCH, REC_VAL_BATCHES, secs, k1, k1_bwd))
  require(runner.step == REC_STEPS, 'expected 5 steps (96 slices / 20)')
  require(k1 == 3 * (REC_STEPS + REC_VAL_BATCHES) and k1_bwd == 3 * REC_STEPS,
          'expected 21 K1 and 15 K1-bwd launches')
  require(len(best) == 1, 'expected one best checkpoint by loss_MSE')
  return runner, best[0], k1, k1_bwd


def scarseg_dc_phase(line):
  """Phase 18 (2, 6): K1 and K1-bwd at (20, 512, 512, 2) against their
  plain versions, then as device time beside them, cuFFT's composition and
  the bytes bound. Returns {name: (err, ms, plain ms, bound ms, by,
  cuFFT ms)}."""
  from csmri_refinement_tpu_torch.ops import dc_kernel, fft, masks
  b, n = REC_BATCH, SCAR_SIZE
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
  x = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
  mask = masks.cartesian_mask(gen, (b, n, n), 8, device=DEVICE)
  m = mask[..., None].contiguous()
  k0 = torch.randn(b, n, n, 2, device=DEVICE, generator=gen) * m
  xc, k0c = fft.unpack_complex(x), fft.unpack_complex(k0)
  flops = 10 * b * n * n * math.log2(n * n)
  out = {}
  for name, tol, nbytes, kern, plain, lib in (
      ('K1', F32_ATOL, 28, lambda: dc_kernel.dc_cuda(x, k0, m),
       lambda: dc_kernel.dc_plain(x, k0, m),
       lambda: torch.fft.ifft2((1 - mask) * torch.fft.fft2(
           xc, norm='ortho') + k0c, norm='ortho')),
      ('K1-bwd', GRAD_ATOL, 20, lambda: dc_kernel.dc_bwd_cuda(x, m),
       lambda: dc_kernel.dc_plain_vjp(x, m, False)[0],
       lambda: torch.fft.ifft2((1 - mask) * torch.fft.fft2(
           xc, norm='ortho'), norm='ortho'))):
    got = kern()
    sync()
    err = (got - plain()).abs().max().item()
    print('{} dc 1-recnet shape {}x{}x{}x2: max|kernel-plain| {:.3e} (tol '
          '{})'.format(name, b, n, n, err, tol))
    require(err <= tol, name + ' differs from its plain version at 512^2, '
            'B = 20')
    b_ms, by = bound(flops, nbytes * b * n * n, F32_FLOPS)
    ms, plain_ms, lib_ms = graph_ms(kern), graph_ms(plain), graph_ms(lib)
    print('{} dc B{} {}^2: kernel {:.4f} ms, plain {:.4f} ms, cuFFT {:.4f} '
          'ms, bound {:.4f} ms ({}) ({})'.format(name, b, n, ms, plain_ms,
                                                 lib_ms, b_ms, by, line))
    out[name] = (err, ms, plain_ms, b_ms, by, lib_ms)
  return out


def mat_records(out_dir):
  from scipy.io import loadmat
  return {os.path.basename(p): loadmat(p)
          for p in glob.glob(os.path.join(out_dir, '*.mat'))}


def scarseg_validate_phase(data_dir, best, out_root, line):
  """Phase 18 (3): the validate CLI on the run's best checkpoint: metrics
  at -b 20, .mat records at -b 1 --raw, on the card; the first 4 slices
  on the card and on the CPU, held to each other; eval_results over both
  record dirs."""
  from csmri_refinement_tpu_torch import eval_results, validate
  common = [RECNET_CONFIG, best, '--data-dir', data_dir, '-f', 'val']
  runs = {}
  for label, device, flags in (
      ('metrics -b 20', DEVICE, ['-b', '20']),
      ('raw -b 1', DEVICE, ['-b', '1', '--raw']),
      ('metrics, 4 slices', DEVICE, ['-b', '4', '--conf',
                                     'num_validation_subset_samples=4']),
      ('metrics, 4 slices', 'cpu', ['-b', '4', '--conf',
                                    'num_validation_subset_samples=4']),
      ('raw, 4 slices', 'cpu', ['-b', '1', '--raw', '--conf',
                                'num_validation_subset_samples=4'])):
    sync()
    t0 = time.perf_counter()
    res = validate.main(common + flags + ['--device', device, '--out-dir',
                                          os.path.join(out_root, device)])
    sync()
    secs = time.perf_counter() - t0
    runs[(label, device)] = res['ScarSeg']
    print('validate {} on {}: {:.2f} s (CLI, host clock), metrics {}'.format(
        label, device, secs, res['ScarSeg']['metrics']))
  card = mat_records(runs[('raw -b 1', DEVICE)]['output_dir'])
  cpu = mat_records(runs[('raw, 4 slices', 'cpu')]['output_dir'])
  require(len(card) == 24 and len(cpu) == 4 and set(cpu) <= set(card),
          'expected 24 card and 4 CPU .mat records')
  worst = 0.0
  for name, want in cpu.items():
    got = card[name]
    require(str(got['case'][0]) == str(want['case'][0]) and
            int(got['slice'][0]) == int(want['slice'][0]),
            'record names differ for ' + name)
    err = float(abs(got['pred'] - want['pred']).max())
    bar = E2E_ATOL * float(abs(want['target']).max())
    require(err <= bar and got['pred'].shape == (SCAR_SIZE, SCAR_SIZE, 2),
            'card and CPU predictions differ for {} ({:.3e} > {:.3e})'.format(
                name, err, bar))
    worst = max(worst, err / bar)
  want = runs[('metrics, 4 slices', 'cpu')]['metrics']
  got = runs[('metrics, 4 slices', DEVICE)]['metrics']
  print('validate card vs CPU, 4 slices at {}^2: predictions within {:.3f} '
        'of the bar ({} of max|target|); PSNR {:.6f} / {:.6f} dB, SSIM {:.6f}'
        ' / {:.6f}'.format(SCAR_SIZE, worst, E2E_ATOL, got['psnr'],
                           want['psnr'], got['ssim'], want['ssim']))
  require(abs(got['psnr'] - want['psnr']) <= SCAR_PSNR_DB and
          abs(got['ssim'] - want['ssim']) <= SCAR_SSIM,
          'card and CPU validation metrics differ')
  src = os.path.join(data_dir, 'scar_segmentation')
  evals = {}
  for side, device, key in (('card', DEVICE, 'raw -b 1'),
                            ('cpu', 'cpu', 'raw, 4 slices')):
    res_dir = os.path.join(out_root, 'eval_' + side)
    os.makedirs(res_dir)
    _, evals[side] = eval_results.main([
        '--src-path', src, '--results-path', res_dir, '--device', device,
        runs[(key, device)]['output_dir']])
  card, cpu = evals['card'], evals['cpu']
  require(len(card['psnr']) == 24 and all(
      math.isfinite(v) for m in card.values() for v in m.values()),
          'eval_results: expected 24 finite rows')
  keys = list(cpu['psnr'])
  for metric, bar in (('psnr', SCAR_PSNR_DB), ('ssim', SCAR_SSIM)):
    a = sum(card[metric][k] for k in keys) / len(keys)
    b = sum(cpu[metric][k] for k in keys) / len(keys)
    print('eval_results {} over the 4 common slices: card {:.6f}, CPU {:.6f}'
          .format(metric, a, b))
    require(abs(a - b) <= bar, 'eval_results means differ for ' + metric)
  print('eval_results card: {} rows, PSNR mean {:.4f} dB, SSIM mean {:.4f}'
        .format(len(card['psnr']), sum(card['psnr'].values()) / 24,
                sum(card['ssim'].values()) / 24))


def hold_launches(label, calls, expected, batch):
  """Phase 18: ``calls`` ([(x, layer, pad, y)], ``chain_launches``) are
  ``expected`` K2 f32 launches, each within F32_ATOL of max(1, max |ref|)
  of its plain version. Returns the largest |kernel - plain|."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  require(len(calls) == expected, 'expected {} K2 launches per {} forward, '
          'got {}'.format(expected, label, len(calls)))
  worst = 0.0
  for xi, layer, pad, y in calls:
    want = conv_chain.conv_layer_plain(xi, layer, pad)
    err = (y - want).abs().max().item()
    tol = F32_ATOL * max(1.0, want.abs().max().item())
    require(err <= tol, 'K2 f32 {} layer {} differs from its plain version '
            '({:.3e} > {:.3e})'.format(label, tuple(xi.shape), err, tol))
    worst = max(worst, err)
  print('K2 f32 {} forward {}^2 B{}: {} launches, max|kernel-plain| {:.3e} '
        '(tol {} of max(1, max|ref|))'.format(label, SCAR_SIZE, batch,
                                              expected, worst, F32_ATOL))
  return worst


def scarseg_gan_phase(data_dir, best, work, line):
  """Phase 18 (4): configs/2-refinement.json through the training CLI, its
  frozen RecNet from (2)'s checkpoint (a copy of the config naming it),
  2 steps and 2 validation batches at 512², B = 5, counters around it;
  every K2 f32 launch of one validation forward held to its plain
  version; then validate -i and its PNGs decoded. Returns (the config
  path, K1 and K2 launches, the largest |kernel - plain|, the forward's
  launches)."""
  from csmri_refinement_tpu_torch import train, validate
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  with open(os.path.join(REPO, 'configs', '2-refinement.json')) as f:
    conf_d = json.load(f)
  conf_d['generator_model']['pretrained_model']['pretrained_weights'] = [
      best, 'model']
  conf_path = os.path.join(work, '2-refinement.json')
  with open(conf_path, 'w') as f:
    json.dump(conf_d, f)
  overrides = ['vgg_random_init=true', 'num_train_subset_samples=10',
               'num_validation_subset_samples=10']
  sync()
  dc_kernel.dc_cuda.launches = 0
  dc_kernel.dc_bwd_cuda.launches = 0
  conv_chain.conv_layer_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([conf_path, '--data-dir', data_dir, '--log-dir',
                       os.path.join(work, 'runs'), '--device', DEVICE,
                       '--conf', 'num_epochs=1'] + overrides)
  sync()
  secs = time.perf_counter() - t0
  k1, k1_bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
  k2, k2_f32 = (conv_chain.conv_layer_cuda.launches,
                conv_chain.conv_layer_f32_cuda.launches)
  print('ScarSeg 2-refinement: {} steps + 2 validation batches at {}^2 B{} '
        'in {:.1f} s, K1 launches {}, K1-bwd {}, K2 {} (f32 routes {})'
        .format(runner.step, SCAR_SIZE, GAN_BATCH, secs, k1, k1_bwd, k2,
                k2_f32))
  require(runner.step == 2, 'expected 2 GAN steps (10 slices / 5)')
  require(k1 == 3 * (2 + 2) and k1_bwd == 0,
          'expected 3 K1 launches per generator forward, no K1-bwd')
  require(k2 == k2_f32 == 10 * 2,
          'expected 10 K2 f32 launches per validation forward')
  conf = runner.conf
  host = next(iter(DataLoader(load_dataset(conf, data_dir, 'ScarSeg', 'val'),
                              GAN_BATCH)))
  batch = runner.preparer.prepare_val(host)
  runner.gen.eval()
  calls = chain_launches(runner.gen, *[batch[k]
                                       for k in runner.gen_input_keys])
  worst = hold_launches('GAN validation', calls, 10, GAN_BATCH)
  ckpt = glob.glob(os.path.join(work, 'runs', '2-refinement_*',
                                'periodic-chkpt_*.ckpt'))
  require(len(ckpt) == 1, 'expected one periodic GAN checkpoint')
  res = validate.main([conf_path, ckpt[0], '--data-dir', data_dir, '-b',
                       str(GAN_BATCH), '-i', '--device', DEVICE,
                       '--out-dir', os.path.join(work, 'gan_out'), '--conf']
                      + overrides)['ScarSeg']
  pngs = sorted(glob.glob(os.path.join(res['output_dir'], '*_pred.png')))
  require(len(pngs) == 10, 'expected 10 prediction PNGs')
  for path in pngs:
    width, height, _ = decode_png(path)
    require((width, height) == (SCAR_SIZE, SCAR_SIZE), path + ' size')
  print('validate -b 5 -i of the GAN: {} PNGs of {}^2 decoded, metrics {}'
        .format(len(pngs), SCAR_SIZE, res['metrics']))
  return conf_path, k1, k2, worst, calls, runner


def scarseg_seg_phase(data_dir, work):
  """Phase 18 (5): configs/3-train-segmentation-unet.json through the
  training CLI, 2 steps and 1 validation batch at 512², B = 8; every K2
  launch of one eval forward held to its plain version; then validate.
  Returns (the runner, K2 launches, the largest |kernel - plain|)."""
  from csmri_refinement_tpu_torch import train, validate
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.ops import conv_chain
  config = os.path.join(REPO, 'configs', '3-train-segmentation-unet.json')
  overrides = ['num_train_subset_samples=16', 'num_validation_subset_samples=8']
  sync()
  conv_chain.conv_layer_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([config, '--data-dir', data_dir, '--log-dir',
                       os.path.join(work, 'seg_runs'), '--device', DEVICE,
                       '--conf', 'num_epochs=1'] + overrides)
  sync()
  secs = time.perf_counter() - t0
  k2, k2_f32 = (conv_chain.conv_layer_cuda.launches,
                conv_chain.conv_layer_f32_cuda.launches)
  print('ScarSeg segmentation: {} steps + 1 validation batch at {}^2 B{} in '
        '{:.1f} s, K2 launches {} (f32 routes {})'.format(
            runner.step, SCAR_SIZE, SEG_BATCH, secs, k2, k2_f32))
  require(runner.step == 2, 'expected 2 segmentation steps (16 / 8)')
  require(k2 == k2_f32 == SEG_CHAIN_LAYERS,
          'expected 18 K2 f32 launches per eval forward and none in train '
          'mode')
  host = next(iter(DataLoader(load_dataset(runner.conf, data_dir, 'ScarSeg',
                                           'val'), SEG_BATCH)))
  batch = runner.preparer.prepare_val(host)
  runner.model.eval()
  calls = chain_launches(runner.model, batch['inp'])
  worst = hold_launches('segmentation eval', calls, SEG_CHAIN_LAYERS,
                        SEG_BATCH)
  best = glob.glob(os.path.join(work, 'seg_runs', '*', 'best_dice_class_1',
                                '*.ckpt'))
  require(len(best) == 1, 'expected one best checkpoint by dice_class_1')
  metrics = validate.main([config, best[0], '--data-dir', data_dir, '-b',
                           str(SEG_BATCH), '--device', DEVICE, '--conf']
                          + overrides)['ScarSeg']['metrics']
  print('validate of the segmentation U-Net: {}'.format(metrics))
  require(all(0 <= metrics[k] <= 1 for k in ('dice_class_0',
                                                'dice_class_1')),
          'segmentation dice out of range')
  return runner, k2, worst


def step_times(label, runner, batch, batch_size, line):
  """ms per train step, TF32 off and on, CUDA events around whole steps on
  one prepared batch after warm-up."""
  step_ms = {}
  for tf32 in (False, True):
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    step_ms[tf32] = timed_ms(lambda: runner.train_batch(batch), iters=5,
                            warmup=2)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  for tf32, ms in step_ms.items():
    print('{} train step {}^2 f32 B{} TF32 {}: {:.3f} ms, {:.1f} slices/s '
          '({})'.format(label, SCAR_SIZE, batch_size, 'on' if tf32 else 'off',
                        ms, batch_size / ms * 1e3, line))


def scarseg_timings(data_dir, rec_runner, gan_runner, seg_runner, line):
  """Phase 18 (6): train steps of the three configs at 512², TF32 off and
  on; the loader's host ms per batch without prefetch and the step loop's
  wait for a batch with it; the RecNet's validation forward at B = 1 and
  20."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  conf = rec_runner.conf
  train_set = load_dataset(conf, data_dir, 'ScarSeg', 'train')
  loader = DataLoader(train_set, REC_BATCH, shuffle=True, seed=SEED,
                      num_workers=conf.num_data_workers, prefetch=1)
  t0 = time.perf_counter()
  hosts = list(loader)
  host_ms = (time.perf_counter() - t0) * 1e3 / len(hosts)
  gen = torch.Generator(device=DEVICE).manual_seed(SEED)
  batch = rec_runner.preparer.prepare_train(gen, hosts[0])
  step_times('1-recnet', rec_runner, batch, REC_BATCH, line)
  loader = DataLoader(train_set, REC_BATCH, shuffle=True, seed=SEED,
                      num_workers=conf.num_data_workers, prefetch=2)
  sync()
  t0 = time.perf_counter()
  rec_runner.train_epoch(loader, 2, steps_per_train_summary=100)
  sync()
  epoch_ms = (time.perf_counter() - t0) * 1e3 / len(loader)
  print('1-recnet loader at {}^2 B{} ({} threads): host {:.2f} ms per batch '
        'without prefetch; with prefetch 2 the step loop waits {:.2f} ms per '
        'batch in next(loader), {:.2f} ms per step in all ({})'.format(
            SCAR_SIZE, REC_BATCH, conf.num_data_workers, host_ms,
            loader.wait_s * 1e3 / len(loader), epoch_ms, line))
  val_set = load_dataset(conf, data_dir, 'ScarSeg', 'val')
  for b in (1, REC_BATCH):
    host = next(iter(DataLoader(val_set, b)))
    vbatch = rec_runner.preparer.prepare_val(host)
    ms = timed_ms(lambda: rec_runner.predict(vbatch), iters=5, warmup=2)
    print('1-recnet validation forward {}^2 B{}: {:.3f} ms, {:.1f} slices/s '
          '({})'.format(SCAR_SIZE, b, ms, b / ms * 1e3, line))
  host = next(iter(DataLoader(load_dataset(gan_runner.conf, data_dir,
                                           'ScarSeg', 'train'), GAN_BATCH)))
  step_times('2-refinement', gan_runner, gan_runner.preparer.prepare_train(
      gen, host), GAN_BATCH, line)
  host = next(iter(DataLoader(load_dataset(seg_runner.conf, data_dir,
                                           'ScarSeg', 'train'), SEG_BATCH)))
  step_times('segmentation', seg_runner, seg_runner.preparer.prepare_train(
      gen, host), SEG_BATCH, line)


class RecordingWriter:
  """Phase 19: tensorboardX's ``SummaryWriter`` surface that the training
  CLI calls, recording what it is given (the card machine has no
  tensorboardX)."""

  def __init__(self):
    self.scalars = []
    self.images = []
    self.closed = False

  def add_scalar(self, tag, value, step):
    self.scalars.append((tag, float(value), int(step)))

  def add_image(self, tag, image, step):
    self.images.append((tag, np.array(image), int(step)))

  def close(self):
    self.closed = True


# Phase 19: configs/2-refinement.json as phase 18 (4) runs it, each step's
# losses summarised, checkpoints only at the last epoch or on preemption.
SURFACE_EPOCHS = 4
SURFACE_OVERRIDES = ['vgg_random_init=true', 'num_train_subset_samples=10',
                     'num_validation_subset_samples=10',
                     'steps_per_train_summary=1', 'epochs_per_checkpoint=100',
                     'num_epochs={}'.format(SURFACE_EPOCHS)]
SURFACE_STEPS = 10 // GAN_BATCH      # train steps per epoch
# K1 per epoch: one generator forward per train step and per validation
# batch; K2 f32: 10 per validation forward.
SURFACE_K1, SURFACE_K2 = 3 * (SURFACE_STEPS + 2), 10 * 2


def preemption_phase(data_dir, conf_path, run_dir):
  """Phase 19 (a): the training CLI as a process, SIGTERM once the log
  shows epoch 1's first step: it must exit 0 after that epoch with a
  checkpoint for the next one. Returns (the epoch it stopped after, the
  checkpoint)."""
  cmd = [sys.executable, '-m', 'csmri_refinement_tpu_torch.train', conf_path,
         '--data-dir', data_dir, '--run-dir', run_dir, '--device', DEVICE,
         '--conf'] + SURFACE_OVERRIDES
  t0 = time.perf_counter()
  proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  try:
    deadline = time.time() + 300
    log = ''
    while time.time() < deadline and proc.poll() is None:
      logs = glob.glob(os.path.join(run_dir, 'log_train_*.txt'))
      if logs:
        with open(logs[0]) as f:
          log = f.read()
        if '===> Epoch[1](1/' in log:
          break
      time.sleep(0.05)
    signalled = time.perf_counter() - t0
    if proc.poll() is None and '===> Epoch[1](1/' in log:
      proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=300)
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.communicate()
  if proc.returncode != 0 or '===> Epoch[1](1/' not in log:
    print(out[-4000:], file=sys.stderr)
  require('===> Epoch[1](1/' in log,
          'the preempted CLI never logged its first step')
  require(proc.returncode == 0, 'the preempted CLI exited {}'.format(
      proc.returncode))
  stops = [ln for ln in out.splitlines() if 'Preemption: stopping after' in ln]
  require(len(stops) == 1 and 'Preemption requested' in out,
          'the preempted CLI did not log its preemption')
  epoch = int(stops[0].split('after epoch ')[1].split()[0])
  require(epoch < SURFACE_EPOCHS, 'the preempted run reached the last epoch')
  ckpts = glob.glob(os.path.join(run_dir, 'periodic-chkpt_*_{}.ckpt'.format(
      epoch + 1)))
  require(len(ckpts) == 1, 'no checkpoint for epoch {}'.format(epoch + 1))
  print('preemption: SIGTERM {:.1f} s after start, at epoch 1\'s first step; '
        'exit 0 after epoch {} of {} in {:.1f} s; {}'.format(
            signalled, epoch, SURFACE_EPOCHS, time.perf_counter() - t0,
            os.path.basename(ckpts[0])))
  print('preemption: logged "{}"'.format(stops[0].split(': ', 1)[1]))
  return epoch, ckpts[0]


def require_restored(path, runner):
  """Phase 19 (b): right after the restore, both networks (parameters and
  BN statistics) and both optimizers (moments, steps, groups) equal the
  checkpoint's bit for bit. Returns the number of tensors compared."""
  want = torch.load(path, map_location='cpu', weights_only=True)['runner']
  count = 0

  def same(got, ref, what):
    nonlocal count
    if isinstance(ref, dict):
      require(isinstance(got, dict) and set(got) == set(ref),
              what + ': other keys')
      for key in ref:
        same(got[key], ref[key], '{}/{}'.format(what, key))
    elif isinstance(ref, list):
      require(len(got) == len(ref), what + ': other length')
      for i, (g, r) in enumerate(zip(got, ref)):
        same(g, r, '{}/{}'.format(what, i))
    elif isinstance(ref, torch.Tensor):
      require(got.dtype == ref.dtype and torch.equal(got.cpu(), ref),
              what + ' differs from the checkpoint')
      count += 1
    else:
      require(got == ref, what + ' differs from the checkpoint')
  same(runner.gen.state_dict(), want['generator'], 'generator')
  same(runner.disc.state_dict(), want['discriminator'], 'discriminator')
  same(runner.gen_optimizer.state_dict(), want['gen_optimizer'],
       'gen_optimizer')
  same(runner.disc_optimizer.state_dict(), want['disc_optimizer'],
       'disc_optimizer')
  require(runner.step == want['step'], 'step differs from the checkpoint')
  return count


def resume_phase(data_dir, conf_path, ckpt, start, prof_dir):
  """Phase 19 (b): ``--resume`` in this process with ``--profile-dir``,
  ``-v`` and ``--print-parameters`` and a recording writer: the bit-exact
  restore, epochs ``start``..4 with K1 and K2 f32 counted, the summaries,
  the trace. Returns (the runner, the writer, K1 and K2 f32 launches)."""
  import contextlib
  import io
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  from csmri_refinement_tpu_torch.utils.diagnostics import parameter_shapes
  writer = RecordingWriter()
  restored = []
  original = (train._summary_writer, train.restore_checkpoint)

  def checked_restore(path, runner):
    state = original[1](path, runner)
    restored.append(require_restored(path, runner))
    return state
  train._summary_writer = lambda run_dir: writer
  train.restore_checkpoint = checked_restore
  out = io.StringIO()
  sync()
  dc_kernel.dc_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  t0 = time.perf_counter()
  try:
    with contextlib.redirect_stdout(out):
      runner = train.main([conf_path, '--data-dir', data_dir, '--resume',
                           ckpt, '--device', DEVICE, '--profile-dir',
                           prof_dir, '-v', '--print-parameters', '--conf'] +
                          SURFACE_OVERRIDES)
    sync()
  finally:
    train._summary_writer, train.restore_checkpoint = original
    logging.getLogger().setLevel(logging.INFO)
  secs = time.perf_counter() - t0
  k1, k2 = dc_kernel.dc_cuda.launches, conv_chain.conv_layer_f32_cuda.launches
  text = out.getvalue()
  epochs = SURFACE_EPOCHS - start + 1
  require(restored and restored[0] > 0, 'the resume restored nothing')
  print('resume: {} tensors of both networks and both optimizers equal the '
        'checkpoint\'s bit for bit right after the restore'.format(
            restored[0]))
  done = [e for e in range(1, SURFACE_EPOCHS + 1)
          if '===> Epoch {} Complete'.format(e) in text]
  require(done == list(range(start, SURFACE_EPOCHS + 1)),
          'the resumed run trained epochs {}'.format(done))
  print('resume: epochs {} to {} in {:.1f} s (profiled), {} steps; K1 '
        'launches {} (3 per generator forward), K2 f32 {} (10 per validation '
        'forward)'.format(start, SURFACE_EPOCHS, secs, runner.step, k1, k2))
  require(k1 == SURFACE_K1 * epochs and k2 == SURFACE_K2 * epochs,
          'expected {} K1 and {} K2 f32 launches'.format(SURFACE_K1 * epochs,
                                                         SURFACE_K2 * epochs))
  for name, module in (('generator', runner.gen),
                       ('discriminator', runner.disc)):
    n = sum(math.prod(shape) for _, shape in parameter_shapes(module))
    require('{}: {:,} parameters'.format(name, n) in text and
            n == sum(p.numel() for p in module.parameters()),
            '--print-parameters did not count the ' + name)
    print('--print-parameters: {}: {:,} parameters'.format(name, n))
  require('DEBUG: Configuration object' in text and
          '\n     gen_psnr: ' in text, '-v logged no config or step metrics')
  print('-v: the resolved config and each step\'s metrics logged at DEBUG '
        '({} lines captured)'.format(text.count('\n')))
  return runner, writer, k1, k2


def require_summaries(runner, writer, start, data_dir):
  """Phase 19 (b): ``train/<name>`` scalars at the JAX global steps,
  ``validation/<name>`` at the epochs' ends, one grid per validation: a
  finite (1, H, W) array; the last grid and metrics equal a validation of
  the trained runner."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  require(writer.closed, 'the writer was not closed')
  steps = {}
  for tag, value, step in writer.scalars:
    require(math.isfinite(value), '{} at {} is not finite'.format(tag, step))
    steps.setdefault(tag, []).append(step)
  epochs = range(start, SURFACE_EPOCHS + 1)
  train_steps = [SURFACE_STEPS * (e - 1) + b for e in epochs
                 for b in range(1, SURFACE_STEPS + 1)]
  val_steps = [SURFACE_STEPS * e for e in epochs]
  train_tags = sorted(t for t in steps if t.startswith('train/'))
  val_tags = sorted(t for t in steps if t.startswith('validation/'))
  for tag in ('train/gen_loss', 'train/disc_loss', 'train/gen_loss_gan',
              'train/gen_loss_VGG19', 'train/gen_psnr', 'validation/gen_psnr',
              'validation/gen_ssim', 'validation/gen_loss_VGG19'):
    require(tag in steps, 'no {} scalars'.format(tag))
  for tag in train_tags:
    require(steps[tag] == train_steps, '{} at steps {}'.format(tag,
                                                                steps[tag]))
  for tag in val_tags:
    require(steps[tag] == val_steps, '{} at steps {}'.format(tag, steps[tag]))
  print('summaries: {} train tags at steps {}, {} validation tags at steps '
        '{}'.format(len(train_tags), train_steps, len(val_tags), val_steps))
  grids = [(tag, img, step) for tag, img, step in writer.images]
  require([(t, s) for t, _, s in grids] ==
          [('validation/targets_and_predictions_0', s) for s in val_steps],
          'image summaries {}'.format([(t, s) for t, _, s in grids]))
  side = SCAR_SIZE + 2
  for _, img, _ in grids:
    require(img.shape == (1, 3 * side + 2, 4 * side + 2) and
            np.isfinite(img).all(), 'a grid of shape {}'.format(img.shape))
  conf = runner.conf
  loader = DataLoader(load_dataset(conf, data_dir, 'ScarSeg', 'val'),
                      GAN_BATCH, num_samples=10)
  data, _, metrics = runner.validate(loader, num_batches_to_return=1)
  named = runner.get_named_outputs(data[0])
  grid = train.make_comparison_grid(named['target'], named['prediction'],
                                    GAN_BATCH)
  require(np.array_equal(grid, grids[-1][1]),
          'the last grid differs from a validation of the trained runner')
  last = {t: v for t, v, s in writer.scalars if s == val_steps[-1] and
          t.startswith('validation/')}
  for name, metric in metrics.items():
    require(last['validation/' + name] == metric.value,
            'validation/{} differs from the runner\'s'.format(name))
  print('summaries: {} grids of {}, finite; the last grid and the {} '
        'validation metrics equal a validation of the trained runner'.format(
            len(grids), grids[0][1].shape, len(metrics)))


def require_trace(prof_dir):
  """Phase 19 (b): the profiler's Chrome trace names K1's and K2 f32's
  kernels among its CUDA kernels."""
  traces = glob.glob(os.path.join(prof_dir, '*.pt.trace.json'))
  require(len(traces) == 1, 'expected one trace, found {}'.format(traces))
  with open(traces[0]) as f:
    events = json.load(f)['traceEvents']
  kernels = {}
  for e in events:
    if e.get('cat') == 'kernel':
      kernels[e['name']] = kernels.get(e['name'], 0) + 1
  found = {}
  for label, symbols in (('K1 (csrc/dc.cu)', ('row_fft', 'col_dc')),
                         ('K2 f32 (csrc/conv_f32.cu)',
                          ('conv_tf32x3_kernel', 'conv_direct_kernel'))):
    found[label] = sum(n for name, n in kernels.items()
                       if any(s in name for s in symbols))
    require(found[label] > 0, 'the trace names no {} kernel'.format(label))
  print('trace {}: {:.1f} MB, {} CUDA kernel names, {} launches; {}'.format(
      os.path.basename(traces[0]), os.path.getsize(traces[0]) / 1e6,
      len(kernels), sum(kernels.values()), ', '.join(
          '{} {}'.format(k, v) for k, v in found.items())))


def deploy_phase(data_dir, conf_path, run_dir, work):
  """Phase 19 (c): deploy_checkpoint on the last checkpoint; validate on
  the deployed file and on the training checkpoint: identical metrics."""
  from csmri_refinement_tpu_torch import deploy_checkpoint, validate
  last = sorted(glob.glob(os.path.join(run_dir, 'periodic-chkpt_*.ckpt')),
                key=lambda p: int(p.rsplit('_', 1)[1].split('.')[0]))[-1]
  deployed = os.path.join(work, 'deployed.ckpt')
  deploy_checkpoint.main(['adversarial', last, deployed])
  require(set(torch.load(deployed, weights_only=True)['runner']) ==
          {'generator'}, 'the deployed file holds more than the generator')
  results = [validate.main([conf_path, path, '--data-dir', data_dir, '-b',
                            str(GAN_BATCH), '--dry', '--device', DEVICE,
                            '--conf'] + SURFACE_OVERRIDES)['ScarSeg']
             ['metrics'] for path in (last, deployed)]
  require(results[0] == results[1], 'validate differs on the deployed '
          'checkpoint: {} vs {}'.format(results[1], results[0]))
  print('deploy: {} ({:.1f} MB) -> deployed ({:.1f} MB); validate metrics '
        'identical: {}'.format(os.path.basename(last),
                               os.path.getsize(last) / 1e6,
                               os.path.getsize(deployed) / 1e6, results[0]))


def surface_timings(runner, data_dir, line):
  """Phase 19 (d): one epoch (its train steps and validation) with the
  recording writer and with summaries off, in turns; the train step with
  and without the profiler, in turns."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.utils.profiling import trace
  conf = runner.conf
  train_loader = DataLoader(load_dataset(conf, data_dir, 'ScarSeg', 'train'),
                            GAN_BATCH, shuffle=True, seed=conf.seed,
                            num_samples=10, num_workers=4)
  val_loader = DataLoader(load_dataset(conf, data_dir, 'ScarSeg', 'val'),
                          GAN_BATCH, num_samples=10, num_workers=4)

  def epoch(writer):
    sync()
    t0 = time.perf_counter()
    runner.train_epoch(train_loader, SURFACE_EPOCHS, writer, 1)
    train.run_validation(conf, runner, SURFACE_EPOCHS, val_loader, {}, {},
                         writer, len(train_loader))
    sync()
    return (time.perf_counter() - t0) * 1e3
  epoch(None)
  times = {False: [], True: []}
  for on in (False, True, True, False):
    times[on].append(epoch(RecordingWriter() if on else None))
  off, on = (sum(times[k]) / 2 for k in (False, True))
  print('GAN epoch at {}^2 B{} ({} steps + 2 validation batches), TF32 off: '
        'summaries off {:.3f} ms, recording writer {:.3f} ms ({:+.2f}%) '
        '({})'.format(SCAR_SIZE, GAN_BATCH, SURFACE_STEPS, off, on,
                      100 * (on / off - 1), line))
  # where the summaries' time goes: the validation batch returned to the
  # host for the grid (``BaseRunner.validate``'s ``to_host``), then the grid
  returned, batches = {}, {}
  for n in (0, 1, 1, 0):
    sync()
    t0 = time.perf_counter()
    batches[n], _, _ = runner.validate(val_loader, num_batches_to_return=n)
    returned.setdefault(n, []).append((time.perf_counter() - t0) * 1e3)
  data = batches[1][0]
  nbytes = sum(t.numel() * t.element_size() for t in _tensors(data))
  t0 = time.perf_counter()
  named = runner.get_named_outputs(data)
  train.save_images_to_tensorboard(RecordingWriter(), conf, GAN_BATCH, 0,
                                   'grid', named['prediction'],
                                   named['target'])
  grid_ms = (time.perf_counter() - t0) * 1e3
  v0, v1 = (sum(returned[k]) / 2 for k in (0, 1))
  print('GAN validation (2 batches): {:.3f} ms, returning one batch to the '
        'host {:.3f} ms ({:.1f} MB: the batch, the generator\'s outputs and '
        'the discriminator\'s features on fakes and reals); its grid {:.3f} '
        'ms on the host ({})'.format(v0, v1, nbytes / 1e6, grid_ms, line))
  gen = torch.Generator(device=DEVICE).manual_seed(SEED)
  host = next(iter(DataLoader(load_dataset(conf, data_dir, 'ScarSeg',
                                           'train'), GAN_BATCH)))
  batch = runner.preparer.prepare_train(gen, host)
  step = {False: [], True: []}
  with tempfile.TemporaryDirectory(dir=GAN_DIR) as prof:
    for on in (False, True, True, False):
      with trace(prof if on else None):
        step[on].append(timed_ms(lambda: runner.train_batch(batch), iters=5,
                                 warmup=1))
  off, on = (sum(step[k]) / 2 for k in (False, True))
  print('GAN train step at {}^2 B{}, TF32 off: {:.3f} ms, under '
        '--profile-dir\'s profiler {:.3f} ms ({:+.2f}%) ({})'.format(
            SCAR_SIZE, GAN_BATCH, off, on, 100 * (on / off - 1), line))


def _tensors(tree):
  """Every tensor of a nested dict, list or tuple."""
  if isinstance(tree, dict):
    tree = list(tree.values())
  if isinstance(tree, (list, tuple)):
    return [t for item in tree for t in _tensors(item)]
  return [tree] if isinstance(tree, torch.Tensor) else []


def surface_phase(data_dir, conf_path, work, line):
  """Phase 19: the trainer's surface on the paper's GAN config at 512²
  (phase 18 (4)'s config copy and tree). Returns the K1 and K2 f32
  launches of the resumed run."""
  run_dir = os.path.join(work, 'surface_run')
  start, ckpt = preemption_phase(data_dir, conf_path, run_dir)
  prof_dir = os.path.join(work, 'surface_trace')
  runner, writer, k1, k2 = resume_phase(data_dir, conf_path, ckpt, start + 1,
                                        prof_dir)
  require_summaries(runner, writer, start + 1, data_dir)
  require_trace(prof_dir)
  deploy_phase(data_dir, conf_path, run_dir, work)
  surface_timings(runner, data_dir, line)
  return k1, k2


def scarseg_phase(line):
  """Phase 18: the paper's three configs on a ScarSeg-format tree at 512²,
  the validate and eval_results CLIs; the tree is removed after. Returns
  the launches and errors for the kernels line."""
  os.makedirs(GAN_DIR, exist_ok=True)
  work = tempfile.mkdtemp(prefix='scarseg_', dir=GAN_DIR)
  try:
    data_dir = os.path.join(work, 'data')
    scarseg_data_phase(data_dir)
    rec_runner, best, k1, k1_bwd = scarseg_recnet_phase(
        data_dir, os.path.join(work, 'runs'))
    dc = scarseg_dc_phase(line)
    scarseg_validate_phase(data_dir, best, os.path.join(work, 'out'), line)
    gan_conf, gan_k1, gan_k2, gan_err, gan_calls, gan_runner = \
        scarseg_gan_phase(data_dir, best, work, line)
    seg_runner, seg_k2, seg_err = scarseg_seg_phase(data_dir, work)
    scarseg_timings(data_dir, rec_runner, gan_runner, seg_runner, line)
    f32_layer_table('GAN validation {}^2'.format(SCAR_SIZE),
                    [c[:3] for c in gan_calls], line)
    del rec_runner, gan_runner, seg_runner, gan_calls
    # Phase 19: the trainer's surface on the same tree
    surf_k1, surf_k2 = surface_phase(data_dir, gan_conf, work, line)
  finally:
    shutil.rmtree(work, ignore_errors=True)
  return {'k1': k1 + gan_k1 + surf_k1, 'k1_bwd': k1_bwd,
          'k2_f32': gan_k2 + seg_k2 + surf_k2,
          'dc_err': dc['K1'][0], 'dc_bwd_err': dc['K1-bwd'][0],
          'f32_err': max(gan_err, seg_err)}


def build_phase(names):
  """Phase 2: build the named kernel sources in parallel; print each
  kernel's ptxas lines, and fail if ptxas drained a wgmma pipeline
  (C7517) in a probe, in K3 or in K2's f32 route."""
  from csmri_refinement_tpu_torch.ops import native
  t0 = time.perf_counter()
  report = native.build(names)
  for name, (secs, log) in report.items():
    print('built csrc/{}.cu in {:.1f} s'.format(name, secs))
    drained = [ln.strip() for ln in log.splitlines() if 'C7517' in ln]
    for ln in log.splitlines():
      if 'registers' in ln or 'spill' in ln or 'C7517' in ln:
        print('  ptxas {}: {}'.format(name, ln.strip()),
              file=sys.stdout if name in NO_C7517 else sys.stderr)
    print('ptxas {}: {} C7517 warnings'.format(name, len(drained)))
    if name in NO_C7517:
      require(not drained, 'ptxas drains a wgmma pipeline in ' + name)
  print('kernel build: {:.1f} s'.format(time.perf_counter() - t0))


def main(argv=None):
  argv = sys.argv[1:] if argv is None else argv
  probes_only = '--probes-only' in argv
  int8_only_mode = '--int8-only' in argv
  f32_only_mode = '--f32-only' in argv
  scarseg_only = '--scarseg-only' in argv
  tree = os.path.realpath(argv[argv.index('--tree') + 1]) if '--tree' in \
      argv else REPO
  require(os.path.commonpath([tree, REPO]) == REPO,
          '--tree must name a directory inside the checkout')
  # graph_ms of a plain version that is a view (the unaligned row read,
  # the mid-dim read) captures an empty graph, which times as ~0
  warnings.filterwarnings('ignore', 'The CUDA Graph is empty')
  require(torch.cuda.is_available(), 'no CUDA device')
  sys.path.insert(0, os.path.abspath(tree))
  import csmri_refinement_tpu_torch as P
  # CUDA-event timing: utils/profiling.py's timed_ms, for every phase
  global timed_ms
  from csmri_refinement_tpu_torch.utils.profiling import timed_ms
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel, native
  line = card_line()
  print(line)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  kind = torch.cuda.get_device_name(0)
  print('torch {} cuda {} on {} ({})'.format(torch.__version__,
                                             torch.version.cuda, kind, line))

  if probes_only:   # phases 1, 2 and the probes of 15 alone
    build_phase(('probes',))
    print(json.dumps({'kernels': probe_phase(line)}))
    return
  if int8_only_mode:   # phases 1, 2 and the K3 table of 15 alone
    build_phase(('conv_chain', 'conv_int8'))
    int8_only(P, line)
    return
  if f32_only_mode:    # phases 1, 2 and the f32 layers of 17 (e) alone
    build_phase(tuple(n for n in ('conv_chain', 'conv_f32')
                      if n in native.KERNELS))
    f32_only(P, line)
    return
  build_phase(native.KERNELS)
  if scarseg_only:     # phases 1, 2 and 18 alone
    print(json.dumps(scarseg_phase(line)))
    return

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
  for n in sorted(dc_inputs, reverse=True):   # 512^2 B8, then the main path
    x, k0, m, xc, k0c, mask = dc_inputs[n]
    dc_ms = graph_ms(lambda: dc_kernel.dc_cuda(x, k0, m))
    dc_plain_ms = graph_ms(lambda: dc_kernel.dc_plain(x, k0, m))
    dc_lib_ms = graph_ms(lambda: torch.fft.ifft2(
        (1 - mask) * torch.fft.fft2(xc, norm='ortho') + k0c, norm='ortho'))
    b = x.shape[0]
    dc_bytes = 28 * b * n * n
    dc_flops = 10 * b * n * n * math.log2(n * n)
    dc_bound, dc_by = bound(dc_flops, dc_bytes, F32_FLOPS)
    print('K1 dc B{} {}^2: kernel {:.4f} ms, plain {:.4f} ms, cuFFT {:.4f} '
          'ms ({:.2f}x the kernel), bound {:.4f} ms ({})'.format(
              b, n, dc_ms, dc_plain_ms, dc_lib_ms, dc_lib_ms / dc_ms,
              dc_bound, line))

  def chains(fn):
    return lambda: [fn(cx, ch, pad) for _, cx, ch, pad in chain_cases]

  conv_ms = timed_ms(chains(
      lambda cx, ch, pad: conv_chain.fused_conv_chain(cx, ch, pad_mode=pad)),
                    iters=5, warmup=1)
  conv_plain_ms = timed_ms(chains(plain_chain), iters=3, warmup=1)
  cl_cases = [(nm, cx.permute(0, 3, 1, 2).contiguous(
      memory_format=torch.channels_last).permute(0, 2, 3, 1), ch, pad)
              for nm, cx, ch, pad in chain_cases]
  conv_lib_ms = timed_ms(lambda: [library_chain(cx, ch, pad)
                                        for _, cx, ch, pad in cl_cases],
                        iters=5, warmup=1)
  c_flops, c_bytes = chain_cost(chain_cases)
  conv_bound, conv_by = bound(c_flops, c_bytes, BF16_FLOPS)
  for name, cx, ch, pad in chain_cases:
    one = timed_ms(lambda: conv_chain.fused_conv_chain(
        cx, ch, pad_mode=pad), iters=5, warmup=1)
    lib = timed_ms(lambda: library_chain(cx, ch, pad), iters=5,
                  warmup=1)
    f, _ = chain_cost([(name, cx, ch, pad)])
    print('K2 {} B{}: kernel {:.3f} ms ({:.1f} TFLOP/s), cuDNN {:.3f} ms, '
          '{:.2f} GFLOP'.format(name, cx.shape[0], one, f / one / 1e9, lib,
                                f / 1e9))
  print('K2 conv chains B{} (10 layers): kernel {:.3f} ms ({:.1f} TFLOP/s), '
        'plain {:.3f} ms, cuDNN {:.3f} ms, bound {:.4f} ms, {:.1f} GFLOP '
        '({})'.format(BATCH, conv_ms, c_flops / conv_ms / 1e9, conv_plain_ms,
                      conv_lib_ms, conv_bound, c_flops / 1e9, line))
  k2_layer_table(chain_cases, line)

  with torch.inference_mode():
    fwd_ms = timed_ms(lambda: model(*args), iters=5, warmup=1)
  print('flagship forward {}^2 bf16 B{}: {:.3f} ms, {:.1f} slices/s; of '
        'which DC kernel {:.3f} ms, conv-chain kernel {:.3f} ms ({})'.format(
            SIZE, BATCH, fwd_ms, BATCH / fwd_ms * 1e3, 3 * dc_ms,
            conv_ms, line))

  # Phase 8: the DC backward kernel
  bwd_err, (g, gm) = dc_bwd_phase()

  # Phase 9: the training main path
  runner, train_fwd, train_bwd = train_main_path()
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  val_set = load_dataset(runner.conf, None, 'Synthetic', 'val')
  _, val_losses, val_metrics = runner.validate(
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
  bwd_ms = graph_ms(lambda: dc_kernel.dc_bwd_cuda(g, gm))
  bwd_eager_ms = timed_ms(lambda: dc_kernel.dc_bwd_cuda(g, gm))
  dc16_ms = graph_ms(lambda: dc_kernel.dc_cuda(g, g, gm))
  bwd_plain_ms = graph_ms(lambda: dc_kernel.dc_plain_vjp(g, gm, False))
  bwd_lib_ms = graph_ms(lambda: torch.fft.ifft2(
      (1 - gmask) * torch.fft.fft2(gc, norm='ortho'), norm='ortho'))
  b, n = g.shape[0], g.shape[1]
  bwd_bytes = 20 * b * n * n       # g 8, mask 4, grad_x 8 (no k0)
  bwd_flops = 10 * b * n * n * math.log2(n * n)
  bwd_bound, bwd_by = bound(bwd_flops, bwd_bytes, F32_FLOPS)
  print('K1-bwd dc B{} {}^2: kernel {:.4f} ms (eager calls {:.4f} ms, '
        'bound by the wrapper\'s host time), plain {:.4f} ms, cuFFT {:.4f} '
        'ms, bound {:.4f} ms ({})'.format(b, n, bwd_ms, bwd_eager_ms,
                                          bwd_plain_ms, bwd_lib_ms,
                                          bwd_bound, line))
  dc_dft_phase(line)
  gt, mask = fixed_batches(gpu_runner.conf, 1)[0]
  from csmri_refinement_tpu_torch.ops import undersample as us
  tbatch = us.undersample_batch(None, gt.to(DEVICE),
                                fixed_mask=mask.to(DEVICE))
  step_ms = {}
  for tf32 in (False, True):
    torch.backends.cudnn.allow_tf32 = tf32
    step_ms[tf32] = timed_ms(lambda: gpu_runner.train_batch(tbatch),
                            iters=10, warmup=2)
  torch.backends.cudnn.allow_tf32 = False
  for tf32, ms in step_ms.items():
    print('RecNet train step {}^2 f32 B{} TF32 {}: {:.3f} ms, {:.1f} '
          'slices/s; of which K1 {:.3f} ms + K1-bwd {:.3f} ms ({})'.format(
              SIZE, TRAIN_BATCH, 'on' if tf32 else 'off', ms,
              TRAIN_BATCH / ms * 1e3, 3 * dc16_ms,
              3 * bwd_ms, line))

  # Phase 12: the int8 conv kernel (K3) and its requant
  int8_errs = int8_phase(model)

  # Phase 13: the int8 main path
  model8, int8_launches, errs512 = int8_main_path(P, args)
  int8_conv_err = max(int8_errs['conv'], errs512['conv'])
  requant_err = max(int8_errs['requant'], errs512['requant'])

  # Phase 14: int8 quality
  int8_quality_phase(P, line)

  # Phase 15: int8 and probe timings
  k3 = int8_timings(k3_cases(model), line)
  with torch.inference_mode():
    fwd8_ms = timed_ms(lambda: model8(*args), iters=5, warmup=1)
  print('flagship forward {}^2 B{}: int8 {:.3f} ms, {:.1f} slices/s; bf16 '
        '{:.3f} ms, {:.1f} slices/s ({})'.format(
            SIZE, BATCH, fwd8_ms, BATCH / fwd8_ms * 1e3, fwd_ms,
            BATCH / fwd_ms * 1e3, line))
  probe_entries = probe_phase(line)

  # Phase 16: the GAN refinement path
  gan_runner, gan_conf_path, frozen, gan_k1, gan_k2 = gan_cli_phase(runner)
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  _, val_losses, val_metrics = gan_runner.validate(DataLoader(
      load_dataset(gan_runner.conf, None, 'Synthetic', 'val'), GAN_BATCH))
  vals = {k: v.value for k, v in list(val_losses.items()) +
          list(val_metrics.items())}
  print('GAN main path validation: {}'.format(vals))
  require(all(math.isfinite(v) for v in vals.values()) and
          0 < vals['gen_ssim'] <= 1 and vals['gen_psnr'] > 10,
          'GAN validation metrics out of range')
  gan_f32_err, gan_layers = gan_kernel_checks(gan_runner)
  gen_state = gan_runner.gen.state_dict()
  del gan_runner
  gan_parity_phase()
  gan_timing_phase(gan_conf_path, frozen, line)
  f32_layer_table('GAN validation', gan_layers, line)
  up_conv_timings(model, line)

  # Phase 17: segmentation training and the segmentation score
  seg_runner, seg_conf_d, seg_best, seg_k2 = seg_cli_phase()
  score, sis_k1, sis_k2 = sis_gan_phase(gan_conf_path, gen_state,
                                        seg_conf_d, seg_best)
  seg_calls, seg_f32_err = seg_kernel_checks(score)
  seg_parity_phase(seg_conf_d, seg_best)
  f32 = seg_timing_phase(seg_runner, score, seg_calls, line)
  del seg_runner, score, seg_calls, gpu_runner, runner

  # Phase 18: the paper's data and evaluation path at 512²
  scar = scarseg_phase(line)

  kernels = [
      {'name': 'dc', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/dc.cu',
       'replaces': 'csmri_refinement_tpu/ops/dc_pallas.py:36',
       'launches': dc_launches + train_fwd + gan_k1 + sis_k1 + scar['k1'],
       'max_abs_err': max(dc_err, scar['dc_err']),
       'ms': dc_ms,
       'plain_ms': dc_plain_ms, 'bound_ms': dc_bound,
       'bound_by': dc_by,
       'library_ms': dc_lib_ms},
      {'name': 'conv_chain', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_chain.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:247',
       'launches': conv_launches, 'max_abs_err': conv_err,
       'ms': conv_ms,
       'plain_ms': conv_plain_ms, 'bound_ms': conv_bound,
       'bound_by': conv_by,
       'library_ms': conv_lib_ms},
      {'name': 'conv_chain_f32', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_f32.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:247',
       'launches': gan_k2 + seg_k2 + sis_k2 + scar['k2_f32'],
       'max_abs_err': max(gan_f32_err, seg_f32_err, scar['f32_err']),
       'ms': f32['ms'], 'plain_ms': f32['plain_ms'],
       'bound_ms': f32['bound_ms'], 'bound_by': 'operations',
       'library_ms': f32['cudnn_best_ms']},
      {'name': 'dc_bwd', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/dc.cu',
       'replaces': 'csmri_refinement_tpu/ops/dc.py:99',
       'launches': train_bwd + scar['k1_bwd'],
       'max_abs_err': max(bwd_err, scar['dc_bwd_err']), 'ms': bwd_ms,
       'plain_ms': bwd_plain_ms, 'bound_ms': bwd_bound,
       'bound_by': bwd_by,
       'library_ms': bwd_lib_ms},
      {'name': 'conv_int8', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_int8.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:247',
       'launches': int8_launches[0], 'max_abs_err': int8_conv_err,
       'ms': k3['conv'][0], 'plain_ms': k3['conv'][1],
       'bound_ms': k3['conv'][2], 'bound_by': k3['conv'][3],
       'library_ms': None},
      {'name': 'requant_int8', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_int8.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:381',
       'launches': int8_launches[1], 'max_abs_err': requant_err,
       'ms': k3['requant'][0], 'plain_ms': k3['requant'][1],
       'bound_ms': k3['requant'][2], 'bound_by': k3['requant'][3],
       'library_ms': None},
  ] + probe_entries
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
