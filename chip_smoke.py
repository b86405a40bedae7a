#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``csmri_refinement_tpu_torch``).

    python3 chip_smoke.py [--probes-only | --int8-only [--tree DIR] |
                           --f32-only [--tree DIR] | --scarseg-only |
                           --dc-routes-only [--tree DIR] |
                           --dist-export-only | --spatial-only |
                           --uneven-only | --options-only | --bench-only |
                           --large-only]

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
    non-power-of-two routes (``DC_ROUTE_SHAPES``: the mixed-radix route at
    240² with B = 2 and 20, 320², 384², 192² and 256×192, H mixed-radix
    and W on the chirp route at 240×237, the chirp route at 244² and 509²)
    and the sides above 512 (``DC_LARGE_SHAPES``: 640² at B = 4, 768²,
    1024², 640×368, 1021², the chirp route in one block at 1031² and
    2053² and on a cluster of two blocks at 4099², the split route in one
    block at 2048² and 1280², on a cluster of two at 3510 × 2048 and on
    device stages at 16 × 16384, too few rows for a cluster), then the
    radix route at 256², B = 32 and 512², B = 20 (``DC_RADIX_SHAPES``),
    each axis's route and plan (one block, a cluster of C blocks and each
    one's share, or device stages), K1 and K1-bwd against their plain
    versions within 2e-4 and timed beside them, cuFFT's composition and
    the bound; the dense route against the chirp route at the sides around
    ``DENSE_MAX`` (``DC_DENSE_SIDES``); K1 at chirp lengths around each
    side's (``CHIRP_LENGTH_SIDES``) beside ``dc_kernel.plan_cost``; K1 with
    an axis a cluster holds on it and on device stages
    (``CLUSTER_LINES_SHAPES``); the
    train step with TF32 off and on; the phase's wall seconds;
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
    without the profiler, in turns;
20. the training options of the JAX package's recipe on the same tree:
    (a) the three configs as written with ``train_dtype`` bfloat16 through
    the training CLI (2 steps each and phase 18's validation batches),
    counters around each: 1-recnet 12 K1 and 6 K1-bwd, the GAN 12 K1 and
    20 K2 on the bf16 route, segmentation 18 K2 bf16; ms per step, slices/s
    and the step's peak memory beside phase 18's f32 numbers (TF32 off and
    on); the GAN's and segmentation's bf16 step with the model's pad
    (``layers.pad``) and with plain ``F.pad``, in turns; (b) ``train_remat`` on the GAN and 1-recnet, f32 (TF32 off) and
    bf16: after 2 updates every parameter and statistic within 1e-5 of max
    |ref| of the plain run from the same weights and seeds (deterministic
    algorithms on both: ``torch.use_deterministic_algorithms`` and cuDNN's
    deterministic convolutions; the model's reflect and replicate pads have
    a deterministic backward everywhere), ms per step and peak memory of
    both; (c)
    ``steps_per_fetch`` 4 on 1-recnet and the GAN in bf16: 4 updates within
    (b)'s bar of 4 single steps, ms per update of both; (d) every K2 bf16
    launch of one bf16 GAN and one bf16 segmentation eval forward at 512²
    against its plain version at phase 4's bar, each segmentation layer's
    device time beside one cuDNN bf16 call, the K1 and K1-bwd launches
    of one bf16 1-recnet step against theirs (phases 3, 8); (e) one bf16
    update of each runner on the card and on the CPU at 64²: losses and
    outputs within 2e-2; (f) 1-recnet with ``use_scan``: 2 updates within
    (b)'s bar of the unrolled runner's;
21. the data, sampling and metric options on the same tree: (a)
    ``configs/1-recnet.json`` with ``augmentation`` (elastic, shift,
    rotate, scale), radial masks (8 spokes) and the validation metrics
    psnr, ssim, hfen and mutual_information through the training CLI (2
    steps and 2 validation batches at B = 20), counters around it: 12 K1
    and 6 K1-bwd; every K1 and K1-bwd launch of one radial step against its
    plain version (phases 3 and 8's bars) and the step's ms; ``validate``
    on 4 slices on the card and on the CPU (phase 18's bars, HFEN and MI
    within 1e-4 relative); (b) the same with ``native_pipeline`` after the
    host library's ``g++`` build (2 steps, 1 validation batch: 9 K1, 6
    K1-bwd, every batch from the library), then the loader's host ms per
    batch of 20 and the step loop's wait per step for the native path, the
    scipy augmentation and phase 18's unaugmented path, in turns; (c)
    ``configs/3-train-segmentation-unet.json`` with ``augmentation``
    (shift, rotate, scale; 2 steps and 1 validation batch at B = 8): 18 K2
    f32 launches per eval forward, each against its plain version; (d) the
    host ms per 512² slice of each augmentation and of HFEN and MI per
    example, beside (a)'s step; the phase's wall seconds;
22. data parallelism, the serving artifact and the summary on the same
    tree: (a) ``configs/1-recnet.json`` (B = 20, 2 steps and 2 validation
    batches) and ``configs/3-train-segmentation-unet.json`` (B = 8, 2 steps
    and 1 validation batch) through the training CLI without a process
    group and with a one-rank NCCL group from a ``distributed`` section
    (NCCL takes one rank per card), deterministic algorithms on both:
    parameters, losses and metrics within 1e-5 of each value's max |ref|,
    the counters around the group's runs (12 K1 and 6 K1-bwd; 18 K2 f32),
    then ms per train step with the group and without, in turns; (b) the
    export CLI with ``--verify`` on phase 18's GAN checkpoint (the
    generator, B = 5) and (a)'s 1-recnet checkpoint (B = 20), each artifact
    replayed in a fresh process (which imports no model code) on the card
    (one replay counted: K1 3 and K2 f32 10, K1 3) and on the CPU: the card
    replay within 1e-6 of ``runner.predict``'s max |ref|, the CPU replay
    within 5e-4 of the card's, the artifact's KiB and replay ms beside
    predict ms; (c) ``summarize_results`` over phase 18's eval_results CSV;
23. the mesh's spatial axis on the same tree, ``{"data": 1, "spatial":
    2}`` on two processes that share the card (``--spatial-rank`` children
    of this script, each starting a gloo group; each rank holds its rows
    of the images and all rows of its column block of k-space and mask):
    (a) gloo's all_gather, all_to_all (``all_to_all_single``, with equal
    parts and with split sizes), all_reduce and broadcast on CUDA
    tensors, checked, and an all_gather and an
    all_to_all of 20 MiB parts timed; (b) ``configs/1-recnet.json`` (B =
    20, 2 updates), ``configs/2-refinement.json`` (B = 5, 1 update, its
    RecNet from this phase's 1-recnet checkpoint) and
    ``configs/3-train-segmentation-unet.json`` (B = 8, 1 update), each with
    1 validation batch, through the training CLI in this process and on the
    two ranks, deterministic algorithms on all: every rank within the JAX
    suite's spatial bars of the one process (``SPATIAL_BARS``); each rank
    launched each of K1's three passes as often as the one process launched
    K1, each of K1-bwd's as often as K1-bwd, K2 f32 as often, and
    whole-image K1 and K1-bwd never (counted around its CLI run); one train
    step's pass launches and one eval forward's K2 f32 launches (on halo
    tiles) against their plain versions; per rank each pass's device ms
    beside its plain version's, its ``torch.fft`` call's and its bound (the
    ranks in turn), the ms per step, the step's peak GiB and the MB each
    collective call site moves, beside one process's ms (two ranks on one
    card: not a scaling number); (c) the f32 and the int8 eval forward
    (``quantize_inference`` set on every chain) of (b)'s one-process
    2-refinement generator, its state loaded on the two ranks and in this
    process, on one validation batch: the int8 output within
    ``SPATIAL_INT8_REL``, every K3 and requant launch against its plain
    version, the ranks' scales equal at every quantization and their
    tiles' halo rows each other's rows exactly, and the int8 mode's steps
    against this process's, the first that differs marked; then phase 26;
26. (run inside phase 18, after 23) spatial meshes whose per-rank rows a
    stride or a pool splits, as JAX's GSPMD runs them: (a) K1's and
    K1-bwd's three passes on (2, 240, 237) and (2, 240, 240) as two ranks
    run them (rows 0-119 and 120-239, column blocks of 119 and 118, and of
    120) against the whole-image K1 and K1-bwd, bit for bit; (b) phase 23
    (b)'s three configs, runs, checks and launch holds on a ScarSeg-format
    tree at 240² (BraTS's slice matrix: 120 rows a rank, which the
    discriminator's fourth stride and the segmentation U-Net's fourth pool
    split), with per rank the rows its conv tiles held; each of the one
    process's K1 and K1-bwd launches on the mixed-radix route; (c) phase 23 (c)
    on 244 × 256 images (the generator U-Net's second pool splits 61 rows
    a rank; 256 columns let the int8 mode quantize, which 244 would not),
    the ranks' scales equal and their K3 tiles' halo rows each other's;
24. the U-Net's remaining options of the JAX package, at full width:
    (a) ``configs/2-refinement.json``'s generator (seeded) with its
    U-Net's ``upsampling_mode`` set to ``nn-biresize-conv`` and to
    ``bilinear`` as ``train.py --conf`` sets it, 256², B = 32, bf16, three
    forwards with the counters around them (3 K1 and one K2 bf16 launch
    per chain layer each), every K2 launch of one forward against its
    plain version, the f32 forward at B = 2 against the CPU (phase 6's
    bars), ms per forward beside ``nn-resize-conv`` in turns, and the
    bilinear up-sample (a two-tap stencil) at the decoders' shapes as
    device time beside ``F.interpolate``; (b) phase 16 (b)'s full-width
    card-against-CPU GAN updates with ``nn-biresize-conv``, two card
    updates under deterministic algorithms that raise on an op without a
    deterministic implementation (bit-equal), and ms per GAN step at 512²,
    B = 5, f32 and bf16, beside ``nn-resize-conv`` in turns; (c)
    ``configs/3-train-segmentation-unet.json``'s U-Net with
    ``use_refinement`` and ``encoder_features`` [0, 2, 4], eval f32 at
    256², B = 8: its K2 f32 launches counted and held to their plain
    versions, ``pred`` and the features against the CPU within 5e-4 of
    max |ref|; (d) the nn-biresize-conv GAN (Synthetic 256², one update and
    one validation batch) on two spatial gloo ranks sharing the card
    against one process at ``SPATIAL_BARS['2-refinement']``, per rank the
    ms per step and the bytes of the bilinear up-sample's halo; (e) the
    noisy DC, ``fft2c``/``ifft2c`` and ``center_crop_in_kspace`` at 512²,
    B = 4, card against CPU within 2e-4, the noisy DC's device time beside
    K1's;
25. the port's benchmark command, ``python -m
    csmri_refinement_tpu_torch.bench``: (a) its ``build_forward`` at 256²,
    B = 4, in bf16, f32 and int8 (and at 48², a side that is no power of
    two, in bf16 and f32), one forward each with the counters set to 0
    just before and read just after (K1 3 and K2 bf16 10; K1 3 and K2 f32
    10; K1 3, K2 bf16 3, K3 7 and requant 2), ``pred`` bit-equal to
    ``build_flagship``'s on the same batch and seed, and every launch of a
    second forward against its plain version (K1 at F32_ATOL, K2 at phase
    4's and 17's bars, K3 at ``int8_gate``'s, the requant within one int8
    step); then the 512², B = 128 forward of the default 512² row in bf16,
    int8 and f32 with its peak memory, and K2 bf16 and f32 on the widest
    layer there ((128, 512, 512, 64), 2^31 elements), its first and last
    two images against the plain version; (b) the command as a subprocess:
    the default run (B = 128 at 256², the 512² row) with ``--latency
    --components --train --train-steps 4``, then ``--dtype int8`` and
    ``--dtype f32``, each at ``--iters 4``, and ``--image-size 48
    --batch-size 4 --extra-sizes``,
    each with exactly one bare JSON line (value > 0) in its merged output
    and no ``extra:`` row carrying an error, every row printed; (c)
    ``--budget 2`` gives ``budget_exceeded``;
27. sides above 512 on the main paths: (a) the training CLI on
    ``configs/synthetic-recnet.json`` with ``synthetic.image_size`` 640
    (3 steps of B = 16 and a validation batch), K1 and K1-bwd counted
    (3 a step each, 3 K1 a validation batch), the validation loss finite,
    then one step's K1 and K1-bwd launches against their plain versions
    and the step timed; (b) ``build_flagship(1024, bf16)`` at B = 2 and
    ``build_flagship(2048, bf16)`` at B = 1 (the split route) as phase 25
    (a) holds the bench's forward (K1 3, K2 bf16 10 counted, every launch
    of a second forward against its plain version); (c) the bench command
    with ``--extra-sizes 640 1024``, both rows read; (d) RecNet train
    steps at 1031², B = 2 and 2053², B = 1 (the chirp route in one block,
    ``block_lines``), 2311², B = 1 (on a cluster of two blocks,
    ``cluster_lines``) and 3510 × 2048, B = 1 (H on the split route on a
    cluster of two), K1 and K1-bwd counted (3 each) and held to their
    plain versions, each step timed.

``--scarseg-only`` runs phases 1, 2 and 18-23 alone (no result line).
``--options-only`` runs phases 1, 2 and 24 alone (no result line; a JSON
line of phase 24's launches and errors).
``--bench-only`` runs phases 1, 2 and 25 alone (no result line; a JSON
line of phase 25's launches and errors).
``--large-only`` runs phases 1, 2 and 27 alone (no result line; a JSON
line of phase 27's launches and errors).
``--spatial-only`` runs phases 1, 2, phase 18's tree, phase 23 and phase
26 alone (no result line). ``--uneven-only`` runs phases 1, 2, phase 23
(a)'s gloo probe and phase 26 alone (no result line; a JSON line of phase
26's launches and errors).
``--dist-export-only`` runs phases 1, 2, phase 18's tree and phase 22
alone (no result line): the generator is exported from its seeded init on
(a)'s RecNet, and (c) reads the eval_results CSV of 4 slices of (a)'s
1-recnet checkpoint.
``--f32-only`` runs phases 1 and 2 for the conv sources and times K2's f32
route on the 18 segmentation layer shapes (seeded weights) after holding
each to its plain version (no result line); with ``--tree DIR`` an earlier
tree times its own f32 route on the same layers in the same call.
``--dc-routes-only`` runs phases 1 and 2 for ``csrc/dc.cu`` and phase
11's table of K1's routes and passes alone (no result line); ``--tree
DIR`` as for ``--int8-only`` times an earlier tree's routes on the same
shapes, skipping those it has no route for: the A/B run of a change to
K1, parent and change in turns in one call.
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

import contextlib
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
SEG_CONFIG = os.path.join(REPO, 'configs', '3-train-segmentation-unet.json')
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
  if DEVICE != 'cpu':     # a rehearsal on the CPU has nothing to wait for
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


# Phase 11's shapes for K1's non-power-of-two routes, (B, H, W): the
# mixed-radix route at BraTS's 240² (B = 2, and 20 as 1-recnet's batch),
# fastMRI's 320² crops and 384², 192², a non-square image whose
# power-of-two H takes the mixed-radix route beside W's, one with H on the
# mixed-radix route and W on the chirp route, and the chirp route at 244²
# and 509² (the dense route's sides until the chirp route came);
# then the sides above 512 (``DC_LARGE_SHAPES``).
DC_ROUTE_SHAPES = ((2, 240, 240), (20, 240, 240), (2, 320, 320),
                   (2, 384, 384), (2, 192, 192), (2, 256, 192),
                   (2, 240, 237), (2, 244, 244), (2, 509, 509))
# Sides above 512 on each route: 640² (mixed-radix) at B = 4, 768²
# (mixed-radix), 1024² (radix), fastMRI's 640 × 368 knee k-space (H
# mixed-radix, W chirp in one block, m = 792), 1021² and 1031² (chirp in
# one block, m = 2112; 1031² the RecNet step of phase 27 (d)),
# 2053² (chirp in one block, m = 4160), 4099² (chirp on a cluster of two
# blocks, m = 8320), 2048² (split in one block, phase 27 (b)'s flagship),
# 1280² (split in one block), 3510 × 2048 (H split on a cluster of two)
# and a long thin image whose W of 16384 a cluster of eight holds, on
# device stages with its 16 rows (``dc_kernel.cluster_lines``).
DC_LARGE_SHAPES = ((4, 640, 640), (2, 768, 768), (2, 1024, 1024),
                   (2, 640, 368), (2, 1021, 1021), (2, 1031, 1031),
                   (1, 2053, 2053), (1, 4099, 4099), (1, 2048, 2048),
                   (1, 1280, 1280), (1, 3510, 2048), (1, 16, 16384))
# Sides with a prime factor above 13 timed on the dense and the chirp
# routes (B = 2 and 32): the evidence for ``dc_kernel.DENSE_MAX``.
DC_DENSE_SIDES = (17, 31, 61, 67, 79, 89, 97, 109, 127)


# The passes' shapes on a rank of two at 240², B = 20 (1-recnet in phase
# 26): rows (20, 120, 240) for passes 1 and 3, columns (20, 240, 120)
DC_PASS_SHAPES = ((20, 120, 240), (20, 240, 120))
# The radix route's shapes that a change to the other routes must not move
DC_RADIX_SHAPES = ((32, 256, 256), (20, 512, 512))


def route_plan(dc_kernel, route, n, lines=None, cols=False):
  """An axis's route and the plan it launches with, as phase 11 prints
  them: on the chirp and split routes the transform's length, whether a
  block, a cluster (its size and each block's share) or device stages run
  it for images of ``lines`` lines of the axis (``cols``: the axis is H),
  and the radices (an earlier tree's by its own functions)."""
  if route == 'fft':
    return 'fft {}'.format(dc_kernel.FFT_PLANS[n])
  if route == 'mixed':
    return 'mixed {}'.format(dc_kernel.mixed_plan(n))
  if route not in ('chirp', 'split'):
    return route
  head = 'chirp m={}'.format(dc_kernel.chirp_length(n)) if route == 'chirp' \
      else 'split {}'.format(n)
  if not hasattr(dc_kernel, 'axis_plan'):
    return '{} on {}'.format(head, dc_kernel.axis_stages(route, n))
  staged = lines is not None and hasattr(dc_kernel, 'axis_staged') and \
      dc_kernel.axis_staged(route, n, lines, cols)
  kind, c, plan = dc_kernel.axis_plan(route, n, *([True] if staged else []))
  length = dc_kernel.axis_length(route, n)
  if kind == 'block':
    return '{} block {}'.format(head, plan)
  if kind == 'cluster':
    return '{} cluster of {} x {} {}'.format(head, c, length // c, plan)
  return '{} stages {}{}'.format(head, plan, ' (few lines)' if staged else '')


def axis_kind(dc_kernel, route, n, lines, cols):
  """'block', 'cluster' or 'stages': how an axis of n points on the chirp
  or split route runs for images of ``lines`` lines of it."""
  return dc_kernel.axis_plan(
      route, n, dc_kernel.axis_staged(route, n, lines, cols))[0]


def dc_routes_phase(line, skip_refused=False):
  """Phase 11, K1's non-power-of-two routes, the sides above 512 and the
  radix route (``DC_ROUTE_SHAPES``, ``DC_LARGE_SHAPES``,
  ``DC_RADIX_SHAPES``): at each shape each axis's route and plan (in one
  block, on a cluster or on device stages), K1 with k0 against
  ``dc_plain`` and K1-bwd against ``dc_plain_vjp`` (``F32_ATOL``), then
  each as device time beside its plain version, cuFFT's composition and
  the DC's bound; then ``dc_pass_table`` and, in this tree,
  ``dense_chirp_table``, ``chirp_length_table`` and
  ``cluster_lines_table``. With
  ``skip_refused`` (an earlier tree, ``--tree``) a shape the tree's
  ``dc_route`` refuses is named and skipped. Prints its wall seconds.
  Returns {'K1', 'K1-bwd': {'err': the largest error where an axis takes
  the mixed-radix route, 'large_err': the largest at a side above 512,
  'chirp_err', 'split_err' on those routes, 'cluster_err' and
  'split_cluster_err' on a cluster, 'times': the (20, 240, 240) times,
  'chirp_times' at (2, 1031, 1031), 'cluster_times' at (1, 4099, 4099),
  'split_times' at (1, 2048, 2048) and 'split_cluster_times' at (1, 3510,
  2048)}}."""
  from csmri_refinement_tpu_torch.ops import dc_kernel, fft, masks
  t0 = time.perf_counter()
  out = {name: {'err': 0.0, 'large_err': 0.0, 'chirp_err': 0.0,
                'split_err': 0.0, 'cluster_err': 0.0,
                'split_cluster_err': 0.0, 'times': None, 'chirp_times': None,
                'split_times': None, 'cluster_times': None,
                'split_cluster_times': None}
         for name in ('K1', 'K1-bwd')}
  for b, h, w in DC_ROUTE_SHAPES + DC_LARGE_SHAPES + DC_RADIX_SHAPES:
    if skip_refused and dc_kernel.dc_route(h, w) is None:
      print('K1 dc B{} {}x{}: no route in this tree, skipped'.format(b, h, w))
      continue
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + b + h + w)
    x = torch.randn(b, h, w, 2, device=DEVICE, generator=gen)
    k0 = torch.randn(b, h, w, 2, device=DEVICE, generator=gen)
    mask = masks.cartesian_mask(gen, (b, h, w), 8, device=DEVICE)
    m = mask[..., None].contiguous()
    routes = dc_kernel.dc_route(h, w)
    plans = '{}, {}'.format(route_plan(dc_kernel, routes[0], h, w, True),
                            route_plan(dc_kernel, routes[1], w, h))
    fwd = dc_kernel.dc_cuda(x, k0, m)
    bwd = dc_kernel.dc_bwd_cuda(x, m)
    sync()
    errs = ((fwd - dc_kernel.dc_plain(x, k0, m)).abs().max().item(),
            (bwd - dc_kernel.dc_plain_vjp(x, m, False)[0]).abs().max().item())
    del fwd, bwd
    xc, k0c = fft.unpack_complex(x), fft.unpack_complex(k0)
    flops = 10 * b * h * w * math.log2(h * w)
    calls = 5 if b * h * w > 2 ** 21 else 20
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
      t = {'ms': graph_ms(kern, calls), 'plain_ms': graph_ms(plain, calls),
           'library_ms': graph_ms(lib, calls), 'bound_ms': b_ms,
           'bound_by': by}
      print('{} dc B{} {}x{}, routes (H, W) {}: max|kernel-plain| {:.3e} '
            '(tol {}); kernel {:.4f} ms, plain {:.4f} ms, cuFFT {:.4f} ms, '
            'bound {:.4f} ms ({}) ({})'.format(
                name, b, h, w, plans, err, F32_ATOL, t['ms'], t['plain_ms'],
                t['library_ms'], b_ms, by, line))
      if 'mixed' in routes:
        out[name]['err'] = max(out[name]['err'], err)
      for route in ('chirp', 'split'):
        if route in routes:
          out[name][route + '_err'] = max(out[name][route + '_err'], err)
      if 'chirp m=' in plans and 'cluster' in plans:
        out[name]['cluster_err'] = max(out[name]['cluster_err'], err)
      if 'split' in plans and 'cluster' in plans:
        out[name]['split_cluster_err'] = max(
            out[name]['split_cluster_err'], err)
      key = {(20, 240, 240): 'times', (2, 1031, 1031): 'chirp_times',
             (1, 4099, 4099): 'cluster_times',
             (1, 2048, 2048): 'split_times',
             (1, 3510, 2048): 'split_cluster_times'}.get((b, h, w))
      if key:
        out[name][key] = t
    require(max(errs) <= F32_ATOL,
            'DC kernel differs from its plain version at {}x{} (routes '
            '{})'.format(h, w, routes))
    if max(h, w) > 512:
      for name, err in zip(('K1', 'K1-bwd'), errs):
        out[name]['large_err'] = max(out[name]['large_err'], err)
  dc_pass_table(line)
  if not skip_refused:
    dense_chirp_table(line)
    chirp_length_table(line)
    cluster_lines_table(line)
  print('phase 11, K1\'s routes: {:.1f} s wall'.format(
      time.perf_counter() - t0))
  return out


@contextlib.contextmanager
def named_route(dc_kernel, route):
  """``dc_kernel``'s launches of both axes on ``route`` (its ``dc_route``
  replaced for the duration)."""
  saved = dc_kernel.dc_route
  dc_kernel.dc_route = lambda h, w: (route, route)
  try:
    yield
  finally:
    dc_kernel.dc_route = saved


def dense_chirp_table(line):
  """K1 and K1-bwd at ``DC_DENSE_SIDES``² on the dense route and on the
  chirp route (the wrapper's launch on a named route, uncounted), each
  against its plain version (``F32_ATOL``) and as device time, B = 2 and
  32: where the dense route is faster, ``dc_kernel.DENSE_MAX`` gives it
  the side."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  route_taken = dc_kernel.axis_route
  for b in (2, 32):
    for n in DC_DENSE_SIDES:
      gen = torch.Generator(device=DEVICE).manual_seed(SEED + b + n)
      x = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
      k0 = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
      m = (torch.rand(b, n, n, 1, device=DEVICE, generator=gen) > 0.6).float()
      want = (dc_kernel.dc_plain(x, k0, m),
              dc_kernel.dc_plain_vjp(x, m, False)[0])
      cells = []
      for route in ('dft', 'chirp'):
        runs = (lambda: dc_kernel._launch('dc', x, k0, m),
                lambda: dc_kernel._launch('dc_bwd', x, None, m))
        with named_route(dc_kernel, route):
          for run, ref in zip(runs, want):
            err = (run() - ref).abs().max().item()
            require(err <= F32_ATOL, 'K1 on the {} route at {}^2 differs '
                    'from its plain version ({:.3e})'.format(route, n, err))
            cells.append(graph_ms(run))
      print('dense vs chirp B{} {}^2 (route taken: {}): K1 {:.4f} / {:.4f} '
            'ms, K1-bwd {:.4f} / {:.4f} ms ({})'.format(
                b, n, route_taken(n), cells[0], cells[2], cells[1],
                cells[3], line))


# (B, side) at which ``chirp_length_table`` times K1 on the chirp route
# at chirp lengths around the side's
CHIRP_LENGTH_SIDES = ((2, 89), (32, 127), (2, 237), (2, 244), (2, 368),
                      (2, 509), (2, 1021), (2, 1031), (1, 2053), (1, 2311))


def chirp_length_table(line):
  """K1 at B × side² of ``CHIRP_LENGTH_SIDES`` on the chirp route at each
  length m from 2·side − 1 to an eighth more whose prime factors are at
  most 13 and that the same launch holds (one block or a cluster), its
  plan (``dc_kernel.line_plan``) beside its ``plan_cost``, as device time
  (the launch with ``dc_kernel.chirp_length`` replaced, uncounted), each
  against its plain version (``F32_ATOL``): the readings that
  ``dc_kernel.RADIX_COST`` is fitted to."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  taken = dc_kernel.chirp_length
  try:
    for b, n in CHIRP_LENGTH_SIDES:
      gen = torch.Generator(device=DEVICE).manual_seed(SEED + b + n)
      x = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
      k0 = torch.randn(b, n, n, 2, device=DEVICE, generator=gen)
      m = (torch.rand(b, n, n, 1, device=DEVICE, generator=gen) > 0.6).float()
      want = dc_kernel.dc_plain(x, k0, m)
      kind = dc_kernel.line_plan(taken(n), n)[0] == 1
      cells = []
      for length in range(2 * n - 1, (2 * n - 1) * 9 // 8 + 1):
        held = dc_kernel._prime_counts(length)[1] == 1 and \
            dc_kernel.line_plan(length, n)
        if not held or (held[0] == 1) != kind:
          continue
        dc_kernel.chirp_length = lambda side, length=length: length
        dc_kernel._tables.cache_clear()
        run = lambda: dc_kernel._launch('dc', x, k0, m)
        err = (run() - want).abs().max().item()
        require(err <= F32_ATOL, 'K1 at {}^2 with m = {} differs from its '
                'plain version ({:.3e})'.format(n, length, err))
        cells.append('{} {} cost {:.0f}: {:.4f}'.format(
            length, held, dc_kernel.plan_cost(length, held[1]),
            graph_ms(run, 5)))
      print('chirp lengths B{} {}^2 (taken: m = {}), ms: {} ({})'.format(
          b, n, taken(n), '; '.join(cells), line))
  finally:
    dc_kernel.chirp_length = taken
    dc_kernel._tables.cache_clear()


# (B, H, W) at which ``cluster_lines_table`` times an axis a cluster holds
# on the cluster and on device stages, few and many lines of it an image:
# the chirp's 4099 as W beside 16 and 64 rows and as H beside 128 and 256
# columns, the split's 16384 beside 16, 1024 and 2048 rows, 3510 as H
# beside 1024 and 2048 columns
CLUSTER_LINES_SHAPES = ((1, 16, 4099), (1, 64, 4099), (1, 4099, 128),
                        (1, 4099, 256), (1, 16, 16384), (1, 1024, 16384),
                        (1, 2048, 16384), (1, 3510, 1024), (1, 3510, 2048))


def cluster_lines_table(line):
  """K1 at ``CLUSTER_LINES_SHAPES`` with the chirp or split axis on its
  cluster and on device stages (``dc_kernel.axis_staged`` replaced,
  uncounted), in turns (cluster, stages, stages, cluster), as device time,
  each against its plain version (``F32_ATOL``): where the stages are
  faster, ``dc_kernel.cluster_lines`` sends that many lines an image to
  them."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  taken = dc_kernel.axis_staged
  try:
    for b, h, w in CLUSTER_LINES_SHAPES:
      gen = torch.Generator(device=DEVICE).manual_seed(SEED + b + h + w)
      x = torch.randn(b, h, w, 2, device=DEVICE, generator=gen)
      k0 = torch.randn(b, h, w, 2, device=DEVICE, generator=gen)
      m = (torch.rand(b, h, w, 1, device=DEVICE, generator=gen) > 0.6).float()
      want = dc_kernel.dc_plain(x, k0, m)
      rule = ['stages' if taken(r, n, o, c) else 'cluster'
              for r, n, o, c in zip(dc_kernel.dc_route(h, w), (h, w), (w, h),
                                    (True, False))
              if r in ('chirp', 'split') and
              dc_kernel.axis_plan(r, n)[0] == 'cluster']
      ms = {False: [], True: []}
      for staged in (False, True, True, False):
        dc_kernel.axis_staged = lambda route, n, lines, cols, s=staged: \
            s and route in ('chirp', 'split') and \
            dc_kernel.axis_plan(route, n)[0] == 'cluster'
        run = lambda: dc_kernel._launch('dc', x, k0, m)
        err = (run() - want).abs().max().item()
        require(err <= F32_ATOL, 'K1 at {}x{} on {} differs from its plain '
                'version ({:.3e})'.format(h, w, 'device stages' if staged
                                          else 'a cluster', err))
        ms[staged].append(graph_ms(run, 5))
      print('cluster vs stages B{} {}x{} (taken: {}): cluster {:.4f} / '
            '{:.4f} ms, stages {:.4f} / {:.4f} ms (in turns) ({})'.format(
                b, h, w, rule[0], *ms[False], *ms[True], line))
  finally:
    dc_kernel.axis_staged = taken


def dc_pass_table(line):
  """K1's and K1-bwd's passes at ``DC_PASS_SHAPES`` (a rank of two at
  240², B = 20), each against its plain version (``PASS_REL``) and as
  device time beside it, one ``torch.fft`` call (the row passes) and its
  bound."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  (b, hr, w), (_, h, wc) = DC_PASS_SHAPES
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
  x = torch.randn(b, hr, w, 2, device=DEVICE, generator=gen)
  t = torch.randn(b, h, wc, 2, device=DEVICE, generator=gen)
  k0 = torch.randn(b, h, wc, 2, device=DEVICE, generator=gen)
  m = (torch.rand(b, h, wc, 1, device=DEVICE, generator=gen) > 0.6).float()
  for name, (label, _, bwd) in DC_PASSES.items():
    args = ((t, m, w) if bwd else (t, k0, m, w)) if 'cols' in name else \
        (x, h)
    fn = getattr(dc_kernel, name)
    y = fn(*args)
    sync()
    want = pass_plain(name, args)
    rel = (y - want).abs().max().item() / want.abs().max().item()
    require(rel <= PASS_REL, '{} at {} differs from its plain version by '
            '{:.3e} of its max |value|'.format(label, tuple(args[0].shape),
                                              rel))
    ops, nbytes = pass_cost(name, args)
    b_ms, by = bound(ops, nbytes, F32_FLOPS)
    lib = pass_library_call(name, args)
    print('{} on {}: {:.3e} of max |plain|; kernel {:.4f} ms, plain {:.4f} '
          'ms, torch.fft {}, bound {:.4f} ms ({}) ({})'.format(
              label, tuple(args[0].shape), rel, graph_ms(lambda: fn(*args)),
              graph_ms(lambda: pass_plain(name, args)),
              'none' if lib is None else '{:.4f} ms'.format(graph_ms(lib)),
              b_ms, by, line))


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


def gan_parity_phase(mode=None):
  """Phase 16 (b): card against CPU, TF32 off, dropout off, the pool in
  its fill phase, the same weights and Synthetic batches. Full widths at
  128² (the smallest side whose discriminator keeps its 4×4 head): the
  discriminator's gradients on the same inputs within GAN_GRAD_REL, the
  first update's losses and the second's gen_loss within LOSS_RTOL, the
  rest printed (GAN_GRAD_REL's comment says why). The narrow widths at
  64²: every loss of three updates within LOSS_RTOL. Phase 24 (b): with
  the generator's up-sampling ``mode``, the full widths alone."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  size = GAN_PARITY_SIZE
  conf_d = synthetic_refinement_conf(
      size, GAN_PARITY_STEPS * GAN_BATCH, GAN_BATCH, GAN_BATCH,
      dropout=False)
  label = '{}^2'.format(size)
  if mode is not None:
    conf_d = with_upsampling(conf_d, mode)
    label += ' ' + mode
  conf, cpu, gpu = gan_runner_pair(conf_d)
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
  print('GAN parity {}: discriminator gradients on the same inputs, worst '
        'max|diff| / max|grad|: card vs CPU {:.2e} ({}) (tol {}); card vs '
        'f64 {:.2e}, CPU vs f64 {:.2e}; the CPU\'s own under 1e-5 relative '
        'input noise {:.2e} ({})'.format(
            label, err[0], err[1], GAN_GRAD_REL, worst('card', 'f64')[0],
            worst('cpu', 'f64')[0], *worst('noisy', 'cpu')))
  require(err[0] <= GAN_GRAD_REL, 'card and CPU discriminator gradients '
          'differ')
  gan_updates(label, cpu, gpu, batches,
              lambda step, name: step == 0 or (step == 1 and
                                               name == 'gen_loss'))
  if mode is not None:
    return
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
  pre-hook), then its layers are launched on it in turn, in the unit's
  compute dtype (f32, or bf16 for a bf16 network). Returns [(x, layer, pad,
  y)], in the forward's order."""
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
      xi = xi.to(unit.dtype or torch.float32).contiguous()
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


def hold_launches(label, calls, expected, batch, size=None):
  """Phases 18, 20, 24: ``calls`` ([(x, layer, pad, y)], ``chain_launches``)
  are ``expected`` K2 launches of a forward at ``size``² (SCAR_SIZE by
  default), each within its route's bar of its plain version: F32_ATOL of
  max(1, max |ref|) in f32, phase 4's BF16_REL_TOL of max |ref| in bf16.
  Returns the largest |kernel - plain|."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  require(len(calls) == expected, 'expected {} K2 launches per {} forward, '
          'got {}'.format(expected, label, len(calls)))
  bf16 = calls[0][0].dtype == torch.bfloat16
  worst = 0.0
  for xi, layer, pad, y in calls:
    want = conv_chain.conv_layer_plain(xi, layer, pad)
    err = (y.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = BF16_REL_TOL * scale if bf16 else F32_ATOL * max(1.0, scale)
    require(y.dtype == xi.dtype and err <= tol,
            'K2 {} layer {} differs from its plain version ({:.3e} > {:.3e})'
            .format(label, tuple(xi.shape), err, tol))
    worst = max(worst, err)
  print('K2 {} {} forward {}^2 B{}: {} launches, max|kernel-plain| {:.3e} '
        '(tol {} of {})'.format('bf16' if bf16 else 'f32', label,
                                size or SCAR_SIZE,
                                batch, expected, worst,
                                BF16_REL_TOL if bf16 else F32_ATOL,
                                'max|ref|' if bf16 else 'max(1, max|ref|)'))
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
  overrides = ['num_train_subset_samples=16', 'num_validation_subset_samples=8']
  sync()
  conv_chain.conv_layer_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([SEG_CONFIG, '--data-dir', data_dir, '--log-dir',
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
  metrics = validate.main([SEG_CONFIG, best[0], '--data-dir', data_dir, '-b',
                           str(SEG_BATCH), '--device', DEVICE, '--conf']
                          + overrides)['ScarSeg']['metrics']
  print('validate of the segmentation U-Net: {}'.format(metrics))
  require(all(0 <= metrics[k] <= 1 for k in ('dice_class_0',
                                                'dice_class_1')),
          'segmentation dice out of range')
  return runner, k2, worst


def step_peak_gib(runner, batch):
  """GiB that one train step allocates on the card above what was
  allocated before it (activations, gradients, workspaces: the memory
  that remat trades for time)."""
  sync()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  runner.train_batch(batch)
  sync()
  return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def step_times(label, runner, batch, batch_size, line):
  """ms per train step, TF32 off and on, CUDA events around whole steps on
  one prepared batch after warm-up, and the step's peak memory. Returns
  {TF32 on: ms} and the peak."""
  step_ms = {}
  for tf32 in (False, True):
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    step_ms[tf32] = timed_ms(lambda: runner.train_batch(batch), iters=5,
                            warmup=2)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  peak = step_peak_gib(runner, batch)
  for tf32, ms in step_ms.items():
    print('{} train step {}^2 f32 B{} TF32 {}: {:.3f} ms, {:.1f} slices/s '
          '({})'.format(label, SCAR_SIZE, batch_size, 'on' if tf32 else 'off',
                        ms, batch_size / ms * 1e3, line))
  print('{} train step {}^2 f32 B{}: peak {:.3f} GiB above the resident '
        'state ({})'.format(label, SCAR_SIZE, batch_size, peak, line))
  return step_ms, peak


def scarseg_timings(data_dir, rec_runner, gan_runner, seg_runner, line):
  """Phase 18 (6): train steps of the three configs at 512², TF32 off and
  on; the loader's host ms per batch without prefetch and the step loop's
  wait for a batch with it; the RecNet's validation forward at B = 1 and
  20. Returns {config: ({TF32 on: ms per step}, peak GiB)}."""
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
  f32 = {'1-recnet': step_times('1-recnet', rec_runner, batch, REC_BATCH,
                                line)}
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
  f32['2-refinement'] = step_times(
      '2-refinement', gan_runner, gan_runner.preparer.prepare_train(
          gen, host), GAN_BATCH, line)
  host = next(iter(DataLoader(load_dataset(seg_runner.conf, data_dir,
                                           'ScarSeg', 'train'), SEG_BATCH)))
  f32['segmentation'] = step_times(
      'segmentation', seg_runner, seg_runner.preparer.prepare_train(
          gen, host), SEG_BATCH, line)
  return f32


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


# Phase 20: the training options of the JAX recipe (train_dtype,
# train_remat, steps_per_fetch, use_scan) on the paper's configs at 512².
# The remat, steps_per_fetch and use_scan runs against the plain run after
# the same updates, each tensor's max |Δ| over its max |ref| (deterministic
# algorithms on both sides).
OPTION_REL = 1e-5
OPTION_STEPS = 2
SPF = 4                 # steps_per_fetch of (c)
OPTION_SMALL = 64       # (e)'s side
OPTION_CLI = ['num_epochs=1', 'train_dtype=bfloat16']


@contextlib.contextmanager
def recorded_launches(module, names, order=None, copy=False):
  """Wrap the named kernel wrappers of ``module`` so that each launch's
  arguments and result are kept, {name: [(args, result)]}, and (name,
  index) appended to ``order`` where given; with ``copy``, copies of their
  tensors, where the caller may change them in place after. The ops look
  the wrappers up by their module-level names at call time, and each
  wrapper counts through that name, so the counts carry over."""
  calls = {name: [] for name in names}
  saved = {name: getattr(module, name) for name in names}

  def kept(v):               # the arguments, or a result or tuple of them
    if not copy:
      return v
    if isinstance(v, torch.Tensor):
      return v.clone()
    return tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in v)

  def wrap(name, fn):
    def record(*args):
      out = fn(*args)
      calls[name].append((kept(args), kept(out)))
      if order is not None:
        order.append((name, len(calls[name]) - 1))
      return out
    record.launches = fn.launches
    return record

  wrapped = {name: wrap(name, fn) for name, fn in saved.items()}
  for name, fn in wrapped.items():
    setattr(module, name, fn)
  try:
    yield calls
    sync()
  finally:
    for name, fn in saved.items():
      fn.launches = wrapped[name].launches
      setattr(module, name, fn)


def record_dc_launches(fn):
  """Run ``fn()`` with K1's and K1-bwd's wrappers recorded: {'K1': [(x, k0,
  mask, y)], 'K1-bwd': [(g, mask, y)]}."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  with recorded_launches(dc_kernel, ('dc_cuda', 'dc_bwd_cuda')) as calls:
    fn()
  return {key: [args + (y,) for args, y in calls[name]]
          for key, name in (('K1', 'dc_cuda'), ('K1-bwd', 'dc_bwd_cuda'))}


def option_conf(path, **overrides):
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_json(path)
  for key, value in dict(vgg_random_init=True, **overrides).items():
    setattr(conf, key, value)
  return conf


def option_hosts(conf, data_dir, batch, n):
  """The train fold's first n host batches, unshuffled."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  it = iter(DataLoader(load_dataset(conf, data_dir, 'ScarSeg', 'train'),
                       batch, shuffle=False))
  return [next(it) for _ in range(n)]


def option_runner(conf):
  from csmri_refinement_tpu_torch.training import build_runner
  return build_runner(conf, conf.runner_type, 'train', DEVICE)


@contextlib.contextmanager
def deterministic():
  """Deterministic algorithms (``torch.use_deterministic_algorithms``, a
  warning for an op that has none; cuDNN's deterministic convolutions):
  two runs then compare as their arithmetic does, not as the order of
  atomic additions falls."""
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic = True
  try:
    yield
  finally:
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


def deterministic_updates(conf, hosts, per_fetch=1):
  """A runner of ``conf`` after ``_train_step`` over ``hosts`` (each call
  taking ``per_fetch`` batches), under ``deterministic()``."""
  runner = option_runner(conf)
  with deterministic():
    it = iter(hosts)
    for _ in range(len(hosts) // per_fetch):
      runner._train_step(it)
    sync()
  return runner


def state_rel(got, want):
  """The largest max |Δ| / max |ref| over every float tensor (parameters
  and BN statistics) of the runners' networks."""
  from csmri_refinement_tpu_torch.utils.diagnostics import runner_networks
  worst = 0.0
  for name, net in runner_networks(want).items():
    ref = net.state_dict()
    for key, value in runner_networks(got)[name].state_dict().items():
      if value.is_floating_point():
        scale = max(ref[key].abs().max().item(), 1e-30)
        worst = max(worst, (value - ref[key]).abs().max().item() / scale)
  return worst


def option_step_cost(runner, batch):
  """(ms per train step, CUDA events after warm-up; the step's peak GiB
  above the resident state)."""
  ms = timed_ms(lambda: runner.train_batch(batch), iters=5, warmup=2)
  return ms, step_peak_gib(runner, batch)


@contextlib.contextmanager
def plain_f_pad():
  """The model's reflect and replicate pads as plain ``F.pad`` (whose CUDA
  backward accumulates with atomics), for timing against ``layers.pad``."""
  from csmri_refinement_tpu_torch.models import layers

  class FPad:
    apply = staticmethod(lambda x, pads, mode: F.pad(x, pads, mode=mode))
  saved, layers._Pad = layers._Pad, FPad
  try:
    yield
  finally:
    layers._Pad = saved


def pad_cost(name, runner, prepared, line):
  """ms per bf16 train step with ``layers.pad`` and with plain ``F.pad``,
  two turns each (pad, F.pad, F.pad, pad)."""
  ms = {'pad': [], 'F.pad': []}
  for which in ('pad', 'F.pad', 'F.pad', 'pad'):
    with plain_f_pad() if which == 'F.pad' else contextlib.nullcontext():
      ms[which].append(timed_ms(lambda: runner.train_batch(prepared),
                                iters=5, warmup=2))
  mean = {k: sum(v) / len(v) for k, v in ms.items()}
  print('bf16 {} train step {}^2, reflect pads: layers.pad {:.3f} / {:.3f} '
        'ms, F.pad {:.3f} / {:.3f} ms ({:+.2f}% for layers.pad) ({})'.format(
            name, SCAR_SIZE, *ms['pad'], *ms['F.pad'],
            100 * (mean['pad'] / mean['F.pad'] - 1), line))


def bf16_cli_phase(data_dir, gan_conf, work, f32, line):
  """Phase 20 (a): the three configs as written with train_dtype bfloat16
  through the training CLI at 512², 2 steps and phase 18's validation
  batches, counters around each; ms per step, slices/s and peak beside
  phase 18's f32 numbers; the reflect-padded GAN and segmentation steps
  with ``layers.pad`` and with ``F.pad``. Returns ({config: runner}, K1, K1-bwd and K2
  bf16 launches)."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  runs = (('1-recnet', RECNET_CONFIG, REC_BATCH,
           ['num_train_subset_samples=40'], (3 * (2 + REC_VAL_BATCHES),
                                             3 * 2, 0)),
          ('2-refinement', gan_conf, GAN_BATCH,
           ['vgg_random_init=true', 'num_train_subset_samples=10',
            'num_validation_subset_samples=10'], (3 * (2 + 2), 0, 10 * 2)),
          ('segmentation', SEG_CONFIG, SEG_BATCH,
           ['num_train_subset_samples=16', 'num_validation_subset_samples=8'],
           (0, 0, SEG_CHAIN_LAYERS)))
  runners, totals = {}, [0, 0, 0]
  for name, config, batch, overrides, expected in runs:
    sync()
    dc_kernel.dc_cuda.launches = dc_kernel.dc_bwd_cuda.launches = 0
    conv_chain.conv_layer_cuda.launches = 0
    conv_chain.conv_layer_f32_cuda.launches = 0
    runner = train.main([config, '--data-dir', data_dir, '--log-dir',
                         os.path.join(work, 'bf16_runs'), '--device', DEVICE,
                         '--conf'] + OPTION_CLI + overrides)
    sync()
    k2_bf16 = conv_chain.conv_layer_cuda.launches - \
        conv_chain.conv_layer_f32_cuda.launches
    got = (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches,
           k2_bf16)
    print('bf16 {} CLI at {}^2 B{}: {} steps, K1 {}, K1-bwd {}, K2 bf16 {} '
          '(f32 route {})'.format(name, SCAR_SIZE, batch, runner.step,
                                  *got, conv_chain.conv_layer_f32_cuda
                                  .launches))
    require(runner.step == 2 and got == expected and
            conv_chain.conv_layer_f32_cuda.launches == 0,
            'bf16 {}: expected 2 steps and launches {}'.format(name,
                                                                expected))
    totals = [a + b for a, b in zip(totals, got)]
    host = option_hosts(runner.conf, data_dir, batch, 1)[0]
    prepared = runner.preparer.prepare_train(
        torch.Generator(device=DEVICE).manual_seed(SEED), host)
    ms, peak = option_step_cost(runner, prepared)
    f32_ms, f32_peak = f32[name]
    print('bf16 {} train step {}^2 B{}: {:.3f} ms, {:.1f} slices/s, peak '
          '{:.3f} GiB; f32 TF32 off {:.3f} ms ({:.2f}x), TF32 on {:.3f} ms '
          '({:.2f}x), peak {:.3f} GiB ({})'.format(
              name, SCAR_SIZE, batch, ms, batch / ms * 1e3, peak,
              f32_ms[False], f32_ms[False] / ms, f32_ms[True],
              f32_ms[True] / ms, f32_peak, line))
    if name != '1-recnet':
      pad_cost(name, runner, prepared, line)
    runners[name] = (runner, prepared)
  return runners, totals


def remat_phase(data_dir, gan_conf, line):
  """Phase 20 (b): train_remat on the GAN and on 1-recnet, f32 (TF32 off)
  and bf16: the remat run's parameters and statistics after 2 updates
  within OPTION_REL of the plain run's from the same weights and seeds;
  ms per step and peak, plain and remat."""
  for name, config, batch in (('1-recnet', RECNET_CONFIG, REC_BATCH),
                              ('2-refinement', gan_conf, GAN_BATCH)):
    for dtype in (None, 'bfloat16'):
      conf = option_conf(config, train_dtype=dtype)
      hosts = option_hosts(conf, data_dir, batch, OPTION_STEPS)
      runners = {remat: deterministic_updates(option_conf(
          config, train_dtype=dtype, train_remat=remat), hosts)
                 for remat in (False, True)}
      rel = state_rel(runners[True], runners[False])
      prepared = runners[False].preparer.prepare_train(
          torch.Generator(device=DEVICE).manual_seed(SEED), hosts[0])
      cost = {remat: option_step_cost(runner, prepared)
              for remat, runner in runners.items()}
      del runners
      label = dtype or 'f32 TF32 off'
      print('{} {} at {}^2 B{}: remat after {} updates within {:.2e} of '
            'max|ref| of the plain run (tol {}); step {:.3f} ms plain, '
            '{:.3f} ms remat ({:+.1f}%), peak {:.3f} / {:.3f} GiB '
            '({:+.1f}%) ({})'.format(
                name, label, SCAR_SIZE, batch, OPTION_STEPS, rel, OPTION_REL,
                cost[False][0], cost[True][0],
                100 * (cost[True][0] / cost[False][0] - 1), cost[False][1],
                cost[True][1], 100 * (cost[True][1] / cost[False][1] - 1),
                line))
      require(rel <= OPTION_REL, '{} {}: the remat run parts from the plain '
              'run'.format(name, label))


def steps_per_fetch_phase(data_dir, gan_conf, line):
  """Phase 20 (c): steps_per_fetch 4 on 1-recnet and the GAN in bf16:
  after 4 updates within OPTION_REL of 4 single steps; ms per update of
  each (the steps with their host batch preparation and loss fetches)."""
  for name, config, batch in (('1-recnet', RECNET_CONFIG, REC_BATCH),
                              ('2-refinement', gan_conf, GAN_BATCH)):
    conf = option_conf(config, train_dtype='bfloat16')
    hosts = option_hosts(conf, data_dir, batch, SPF)
    runners = {k: deterministic_updates(option_conf(
        config, train_dtype='bfloat16', steps_per_fetch=k), hosts, k)
               for k in (1, SPF)}
    rel = state_rel(runners[SPF], runners[1])
    ms = {}
    for k in (1, SPF, SPF, 1):
      def steps(runner=runners[k], k=k):
        it = iter(hosts)
        for _ in range(SPF // k):
          runner._train_step(it)
      ms.setdefault(k, []).append(timed_ms(steps, iters=2, warmup=1) / SPF)
    one, spf = (sum(ms[k]) / 2 for k in (1, SPF))
    print('{} bf16 at {}^2 B{}: steps_per_fetch {} after {} updates within '
          '{:.2e} of max|ref| of single steps (tol {}); {:.3f} ms per update '
          'with a fetch each, {:.3f} ms with one fetch per {} ({:+.2f}%) '
          '({})'.format(name, SCAR_SIZE, batch, SPF, SPF, rel, OPTION_REL,
                        one, spf, SPF, 100 * (spf / one - 1), line))
    require(rel <= OPTION_REL, name + ': steps_per_fetch parts from single '
            'steps')
    del runners


def bf16_layer_table(label, calls, line):
  """K2's bf16 route on each layer of ``calls`` (``chain_launches``) as
  device time (``graph_ms``) beside the same layer as one cuDNN bf16 call
  (channels-last, ``F.pad`` + ``F.conv2d``): route, TFLOP/s, share of the
  layer's bound, and the sums."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  totals = [0.0, 0.0, 0.0]
  for xi, layer, pad, _ in calls:
    b, h, w, cin = xi.shape
    k, _, _, cout = layer.kernel.shape
    x_cl = xi.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    ms = graph_ms(lambda: conv_chain.conv_layer_cuda(xi, layer, pad),
                  calls=5, replays=2)
    lib_ms = graph_ms(lambda: library_chain(x_cl, [layer], pad), calls=5,
                      replays=2)
    flops = 2 * b * h * w * k * k * cin * cout
    b_ms, by = bound(flops, 2 * (b * h * w * (cin + cout) + k * k * cin * cout)
                     + 4 * cout, BF16_FLOPS)
    print('K2 bf16 {} B{} {}^2 {}->{} k{}: route {}, {:.4f} ms, {:.1f} '
          'TFLOP/s, {:.1%} of its bound {:.4f} ms ({}); cuDNN bf16 {:.4f} '
          'ms ({})'.format(label, b, h, cin, cout, k,
                           conv_chain.conv_route(cin, cout, xi.dtype), ms,
                           flops / ms / 1e9, b_ms / ms, b_ms, by, lib_ms,
                           line))
    totals = [t + v for t, v in zip(totals, (ms, lib_ms, b_ms))]
  print('K2 bf16 {}: {} layers {:.3f} ms, cuDNN bf16 {:.3f} ms, bound {:.3f} '
        'ms ({})'.format(label, len(calls), *totals, line))


def bf16_kernel_checks(runners, data_dir, line):
  """Phase 20 (d): every K2 bf16 launch of one bf16 GAN and one bf16
  segmentation eval forward at 512² against its plain version (phase 4's
  bar), the segmentation layers timed; the K1 and K1-bwd launches of one
  bf16 1-recnet step against theirs (phases 3 and 8). Returns the largest
  errors (K2, K1, K1-bwd)."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.ops import dc_kernel
  k2 = 0.0
  for name, batch, expected in (('2-refinement', GAN_BATCH, 10),
                                ('segmentation', SEG_BATCH,
                                 SEG_CHAIN_LAYERS)):
    runner = runners[name][0]
    net = runner.gen if name == '2-refinement' else runner.model
    keys = runner.gen_input_keys if name == '2-refinement' else ('inp',)
    host = next(iter(DataLoader(load_dataset(runner.conf, data_dir, 'ScarSeg',
                                             'val'), batch)))
    vbatch = runner.preparer.prepare_val(host)
    net.eval()
    calls = chain_launches(net, *[vbatch[k] for k in keys])
    require(all(c[0].dtype == torch.bfloat16 for c in calls),
            name + ': the bf16 eval forward left the bf16 route')
    k2 = max(k2, hold_launches(name + ' eval', calls, expected,
                               batch))
    if name == 'segmentation':
      bf16_layer_table('segmentation eval', calls, line)
    del calls
  runner, batch = runners['1-recnet']
  calls = record_dc_launches(lambda: runner.train_batch(batch))
  require(len(calls['K1']) == len(calls['K1-bwd']) == 3,
          'expected 3 K1 and 3 K1-bwd launches per bf16 1-recnet step')
  k1 = max((y - dc_kernel.dc_plain(x, k0, m)).abs().max().item()
           for x, k0, m, y in calls['K1'])
  k1_bwd = max((y - dc_kernel.dc_plain_vjp(g, m, False)[0]).abs().max()
               .item() for g, m, y in calls['K1-bwd'])
  print('bf16 1-recnet step {}^2 B{}: 3 K1 launches within {:.3e} of plain '
        '(tol {}), 3 K1-bwd within {:.3e} (tol {}), inputs {}'.format(
            SCAR_SIZE, REC_BATCH, k1, F32_ATOL, k1_bwd, GRAD_ATOL,
            calls['K1'][0][0].dtype))
  require(k1 <= F32_ATOL and k1_bwd <= GRAD_ATOL,
          'K1 or K1-bwd differs from its plain version in a bf16 step')
  return k2, k1, k1_bwd


def bf16_parity_phase():
  """Phase 20 (e): one bf16 update of each runner on the card and on the
  CPU from the same weights and batch at 64² (the synthetic RecNet at full
  width; the GAN narrow, dropout off): every loss within BF16_REL_TOL (the
  CPU tests' bf16 bar too), the output within it of its max |ref|."""
  from csmri_refinement_tpu_torch.ops import masks
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  rec = Configuration.from_json(TRAIN_CONFIG)
  rec.train_dtype = 'bfloat16'
  cpu, gpu = Runner(rec, 'train', 'cpu'), Runner(rec, 'train', DEVICE)
  gpu.model.load_state_dict(cpu.model.state_dict())
  gan_d = synthetic_refinement_conf(OPTION_SMALL, 8, 4, 4, dropout=False,
                                    narrow=True)
  gan_d['train_dtype'] = 'bfloat16'
  _, gcpu, ggpu = gan_runner_pair(gan_d)
  gen = torch.Generator().manual_seed(SEED + 20)
  n = OPTION_SMALL
  for label, c, g, b in (('standard', cpu, gpu, 4), ('adversarial', gcpu,
                                                     ggpu, 4)):
    gt = torch.rand(b, n, n, generator=gen)
    mask = masks.cartesian_mask(gen, (b, n, n), 4)
    want, wout = c.train_batch(us.undersample_batch(None, gt,
                                                    fixed_mask=mask))
    got, gout = g.train_batch(us.undersample_batch(
        None, gt.to(DEVICE), fixed_mask=mask.to(DEVICE)))
    loss_rel = max(abs(got[k].item() - v.item()) / abs(v.item())
                   for k, v in want.items())
    if label == 'adversarial':       # (batch, generator output, ...)
      wout, gout = wout[1], gout[1]
    wpred = wout['pred'] if isinstance(wout, dict) else wout
    gpred = gout['pred'] if isinstance(gout, dict) else gout
    out_rel = (gpred.cpu() - wpred).abs().max().item() / \
        wpred.abs().max().item()
    print('bf16 {} update card vs CPU at {}^2 B{}: losses within {:.2e}, '
          'output within {:.2e} of max|ref| (tol {})'.format(
              label, n, b, loss_rel, out_rel, BF16_REL_TOL))
    require(loss_rel <= BF16_REL_TOL and out_rel <= BF16_REL_TOL,
            'bf16 {} update: card and CPU differ'.format(label))


def use_scan_phase(data_dir):
  """Phase 20 (f): 1-recnet with use_scan: its 2 updates from the same
  seeded weights within OPTION_REL of the unrolled runner's."""
  conf = option_conf(RECNET_CONFIG)
  hosts = option_hosts(conf, data_dir, REC_BATCH, OPTION_STEPS)
  plain = deterministic_updates(conf, hosts)
  scan = deterministic_updates(option_conf(RECNET_CONFIG, model=dict(
      conf.model, use_scan=True)), hosts)
  require(scan.model.scan_layout, 'the 1-recnet cascade is homogeneous')
  rel = state_rel(scan, plain)
  print('1-recnet use_scan at {}^2 B{}: after {} updates within {:.2e} of '
        'max|ref| of the unrolled runner (tol {})'.format(
            SCAR_SIZE, REC_BATCH, OPTION_STEPS, rel, OPTION_REL))
  require(rel <= OPTION_REL, 'use_scan parts from the unrolled RecNet')


def options_phase(data_dir, gan_conf, work, f32, line):
  """Phase 20: (a)-(f). Returns the launches and errors for the kernels
  line."""
  runners, (k1, k1_bwd, k2) = bf16_cli_phase(data_dir, gan_conf, work, f32,
                                             line)
  k2_err, k1_err, k1_bwd_err = bf16_kernel_checks(runners, data_dir, line)
  del runners
  remat_phase(data_dir, gan_conf, line)
  steps_per_fetch_phase(data_dir, gan_conf, line)
  bf16_parity_phase()
  use_scan_phase(data_dir)
  return {'k1': k1, 'k1_bwd': k1_bwd, 'k2_bf16': k2, 'k2_err': k2_err,
          'dc_err': k1_err, 'dc_bwd_err': k1_bwd_err}


# Phase 21: the data, sampling and metric options on phase 18's tree. The
# repository names no augmentation values, so these are chosen at 512²:
# an elastic field of alpha 100 px and sigma 10 px, shifts up to 20 px,
# rotations up to 10 degrees and zooms of 0.9-1.1. Radial masks take the
# acceleration factor as their spoke count (configs/1-recnet.json's 8).
DATA_AUG = {'elastic_transform_alpha': 100.0, 'elastic_transform_sigma': 10.0,
            'shift': 20, 'rotate': 10, 'scale': [0.9, 1.1]}
SEG_AUG = {'shift': 20, 'rotate': 10, 'scale': [0.9, 1.1]}
RADIAL = {'sampling_scheme': 'radial', 'acceleration_factor': 8,
          'variable_acceleration': False}
IMAGE_METRICS = ['psnr', 'ssim', 'hfen', 'mutual_information']
HOST_METRIC_REL = 1e-4   # HFEN and MI, validate card vs CPU
LOADER_BATCHES = 4       # batches per loader reading


def radial_overrides(**extra):
  """``--conf`` values of phase 21's radial, augmented 1-recnet."""
  conf = dict(dict(augmentation=DATA_AUG, undersampling=RADIAL,
                   validation_metrics=IMAGE_METRICS), **extra)
  return ['{}={}'.format(k, json.dumps(v)) for k, v in conf.items()]


def radial_cli_phase(data_dir, work, line):
  """Phase 21 (a): configs/1-recnet.json with augmentation, radial masks
  and the four image metrics through the training CLI at 512², 2 steps and
  2 validation batches, counters around it (3 K1 per forward, 3 K1-bwd per
  step); every K1 and K1-bwd launch of one radial step against its plain
  version; the step's ms; then validate on the card and on the CPU on 4
  slices. Returns (the runner, the prepared radial batch, K1 and K1-bwd
  launches, their largest errors, the step's ms)."""
  from csmri_refinement_tpu_torch import train, validate
  from csmri_refinement_tpu_torch.ops import dc_kernel
  overrides = radial_overrides(num_train_subset_samples=40)
  sync()
  dc_kernel.dc_cuda.launches = dc_kernel.dc_bwd_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([RECNET_CONFIG, '--data-dir', data_dir, '--log-dir',
                       os.path.join(work, 'radial_runs'), '--device', DEVICE,
                       '--conf', 'num_epochs=1'] + overrides)
  sync()
  secs = time.perf_counter() - t0
  k1, k1_bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
  print('radial augmented 1-recnet CLI at {}^2 B{}: {} steps + {} validation '
        'batches in {:.1f} s, K1 {}, K1-bwd {}'.format(
            SCAR_SIZE, REC_BATCH, runner.step, REC_VAL_BATCHES, secs, k1,
            k1_bwd))
  require(runner.step == 2 and not runner.preparer.device_pure,
          'expected 2 radial steps')
  require(k1 == 3 * (2 + REC_VAL_BATCHES) and k1_bwd == 3 * 2,
          'expected 3 K1 per forward and 3 K1-bwd per radial step')
  host = option_hosts(runner.conf, data_dir, REC_BATCH, 1)[0]
  batch = runner.preparer.prepare_train(
      torch.Generator(device=DEVICE).manual_seed(SEED + 21), host)
  mask = batch['mask'][..., 0]
  lines = bool((mask == mask[:, :, :1]).all())
  require(not lines, 'a radial mask came out line-structured')
  calls = record_dc_launches(lambda: runner.train_batch(batch))
  require(len(calls['K1']) == len(calls['K1-bwd']) == 3,
          'expected 3 K1 and 3 K1-bwd launches per radial step')
  k1_err = max((y - dc_kernel.dc_plain(x, k0, m)).abs().max().item()
               for x, k0, m, y in calls['K1'])
  k1_bwd_err = max((y - dc_kernel.dc_plain_vjp(g, m, False)[0]).abs().max()
                   .item() for g, m, y in calls['K1-bwd'])
  del calls
  print('radial 1-recnet step {}^2 B{} ({:.2%} of k-space sampled): 3 K1 '
        'within {:.3e} of plain (tol {}), 3 K1-bwd within {:.3e} (tol {})'
        .format(SCAR_SIZE, REC_BATCH, mask.mean().item(), k1_err, F32_ATOL,
                k1_bwd_err, GRAD_ATOL))
  require(k1_err <= F32_ATOL and k1_bwd_err <= GRAD_ATOL,
          'K1 or K1-bwd differs from its plain version on radial masks')
  step_ms = timed_ms(lambda: runner.train_batch(batch), iters=5, warmup=2)
  print('radial 1-recnet train step {}^2 f32 B{} (TF32 off, prepared '
        'batch): {:.3f} ms, {:.1f} slices/s ({})'.format(
            SCAR_SIZE, REC_BATCH, step_ms, REC_BATCH / step_ms * 1e3, line))
  best = glob.glob(os.path.join(work, 'radial_runs', '1-recnet_*',
                                'best_loss_MSE', '*.ckpt'))
  require(len(best) == 1, 'expected one best radial checkpoint')
  res = {}
  for device in (DEVICE, 'cpu'):
    t0 = time.perf_counter()
    res[device] = validate.main(
        [RECNET_CONFIG, best[0], '--data-dir', data_dir, '-b', '4', '--dry',
         '--device', device, '--conf', 'num_validation_subset_samples=4']
        + overrides)['ScarSeg']['metrics']
    print('validate radial 1-recnet on {}, 4 slices: {:.2f} s (host clock), '
          'metrics {}'.format(device, time.perf_counter() - t0, res[device]))
  got, want = res[DEVICE], res['cpu']
  require(set(got) == set(IMAGE_METRICS) and
          abs(got['psnr'] - want['psnr']) <= SCAR_PSNR_DB and
          abs(got['ssim'] - want['ssim']) <= SCAR_SSIM,
          'radial validate: card and CPU PSNR or SSIM differ')
  for name in ('hfen', 'mutual_information'):
    rel = abs(got[name] - want[name]) / abs(want[name])
    print('validate radial {} card vs CPU: {:.6f} / {:.6f}, {:.2e} relative '
          '(tol {})'.format(name, got[name], want[name], rel,
                            HOST_METRIC_REL))
    require(rel <= HOST_METRIC_REL, 'radial validate: card and CPU {} '
            'differ'.format(name))
  return runner, batch, k1, k1_bwd, k1_err, k1_bwd_err, step_ms


@contextlib.contextmanager
def counted_native_batches():
  """Count the host library's batches (``data/native.py::prepare_batch``
  calls) in ``counts['batches']``."""
  from csmri_refinement_tpu_torch.data import native
  counts = {'batches': 0}
  prepare = native.prepare_batch

  def counted(*args, **kwargs):
    counts['batches'] += 1
    return prepare(*args, **kwargs)
  native.prepare_batch = counted
  try:
    yield counts
  finally:
    native.prepare_batch = prepare


def native_cli_phase(data_dir, work):
  """Phase 21 (b): the radial, augmented 1-recnet with native_pipeline
  through the training CLI (2 steps, 1 validation batch), after the host
  library's build: every batch from the library (the validation fold's
  too, unaugmented, as in the JAX package). Returns the K1 and K1-bwd
  launches."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.data import native
  from csmri_refinement_tpu_torch.ops import dc_kernel
  t0 = time.perf_counter()
  path = native.build()
  print('host library {} built in {:.2f} s (g++ {})'.format(
      os.path.basename(path), time.perf_counter() - t0,
      ' '.join(native._flags())))
  sync()
  dc_kernel.dc_cuda.launches = dc_kernel.dc_bwd_cuda.launches = 0
  with counted_native_batches() as counts:
    runner = train.main(
        [RECNET_CONFIG, '--data-dir', data_dir, '--log-dir',
         os.path.join(work, 'native_runs'), '--device', DEVICE, '--conf',
         'num_epochs=1'] + radial_overrides(
             native_pipeline=True, num_train_subset_samples=40,
             num_validation_subset_samples=REC_BATCH,
             validation_metrics=['psnr', 'ssim']))
  sync()
  k1, k1_bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
  print('native radial 1-recnet CLI at {}^2 B{}: {} steps, {} batches from '
        'the host library, K1 {}, K1-bwd {}'.format(
            SCAR_SIZE, REC_BATCH, runner.step, counts['batches'], k1,
            k1_bwd))
  require(runner.step == 2 and counts['batches'] == 2 + 1,
          'expected 2 training and 1 validation batch from the host library')
  require(k1 == 3 * (2 + 1) and k1_bwd == 3 * 2,
          'expected 9 K1 and 6 K1-bwd launches on the native path')
  return k1, k1_bwd


def loader_costs(runner, data_dir, line):
  """Phase 21 (b): the loader's host ms per batch of 20 (no prefetch) and
  the step loop's wait per step (prefetch 2, a train epoch of the radial
  runner) for the native path, the scipy augmentation and phase 18's
  unaugmented path, in turns (native, scipy, plain, plain, scipy, native),
  each over LOADER_BATCHES batches with the config's worker threads."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.utils.config import Configuration
  workers = runner.conf.num_data_workers
  sets = {}
  for name, extra in (('native', dict(augmentation=DATA_AUG,
                                      native_pipeline=True)),
                      ('scipy', dict(augmentation=DATA_AUG)),
                      ('plain', {})):
    conf = Configuration.from_json(RECNET_CONFIG)
    for key, value in extra.items():
      setattr(conf, key, value)
    sets[name] = load_dataset(conf, data_dir, 'ScarSeg', 'train')
  require(sets['native']._native_slices is not None,
          'the native path is off for the 512^2 training fold')
  n = LOADER_BATCHES * REC_BATCH
  readings = {name: [] for name in sets}
  for name in ('native', 'scipy', 'plain', 'plain', 'scipy', 'native'):
    loader = DataLoader(sets[name], REC_BATCH, shuffle=True, seed=SEED,
                        num_workers=workers, prefetch=1, num_samples=n)
    t0 = time.perf_counter()
    hosts = list(loader)
    host_ms = (time.perf_counter() - t0) * 1e3 / len(hosts)
    loader = DataLoader(sets[name], REC_BATCH, shuffle=True, seed=SEED,
                        num_workers=workers, prefetch=2, num_samples=n)
    sync()
    t0 = time.perf_counter()
    runner.train_epoch(loader, 2, steps_per_train_summary=100)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / len(loader)
    readings[name].append((host_ms, loader.wait_s * 1e3 / len(loader),
                           step_ms))
  for name, runs in readings.items():
    print('loader {} at {}^2 B{} ({} threads; two turns): host {} ms per '
          'batch; the step loop waits {} ms per step, {} ms per step in all '
          '({})'.format(name, SCAR_SIZE, REC_BATCH, workers,
                        ' / '.join('{:.2f}'.format(r[0]) for r in runs),
                        ' / '.join('{:.2f}'.format(r[1]) for r in runs),
                        ' / '.join('{:.2f}'.format(r[2]) for r in runs),
                        line))
  return readings


def host_costs(step_ms, line):
  """Phase 21 (d): host ms per 512² slice of each augmentation (scipy) and
  of HFEN and MI per example; the host library's batch of 20 and a radial
  train step's 20 masks; beside the radial step."""
  from csmri_refinement_tpu_torch.data import augment, native
  from csmri_refinement_tpu_torch.metrics import image_metrics
  from csmri_refinement_tpu_torch.ops import masks
  rng = np.random.RandomState(SEED)
  image = rng.rand(SCAR_SIZE, SCAR_SIZE, 1).astype(np.float32)
  label = (rng.rand(SCAR_SIZE, SCAR_SIZE, 1) > 0.7).astype(np.float32)
  pred = np.clip(image + 0.05 * rng.randn(*image.shape), 0, 1).astype(
      np.float32)[None]
  pool = rng.rand(2 * REC_BATCH, SCAR_SIZE, SCAR_SIZE).astype(np.float32)
  cases = (
      ('elastic_transform', lambda r: augment.elastic_transform(
          image, DATA_AUG['elastic_transform_alpha'],
          DATA_AUG['elastic_transform_sigma'], r)),
      ('random_translate', lambda r: augment.random_translate(image, 20, r)),
      ('random_rotate (order 2)', lambda r: augment.random_rotate(
          image, (-10, 10), r)),
      ('random_zoom (order 2)', lambda r: augment.random_zoom(
          image, (0.9, 1.1), r)),
      ('random_rotate_pair', lambda r: augment.random_rotate_pair(
          image, label, (-10, 10), r)),
      ('random_zoom_pair', lambda r: augment.random_zoom_pair(
          image, label, (0.9, 1.1), r)),
      ('compute_hfen', lambda r: image_metrics.compute_hfen(pred,
                                                            image[None])),
      ('compute_mutual_information',
       lambda r: image_metrics.compute_mutual_information(pred,
                                                          image[None])),
      ('native prepare_batch (B 20)', lambda r: native.prepare_batch(
          pool, r.permutation(len(pool))[:REC_BATCH], shift=20,
          max_rotate=10.0, zoom_range=(0.9, 1.1), seed=r.randint(1 << 30))),
      ('radial train masks (B 20)', lambda r: masks.radial_masks_np(
          (REC_BATCH, SCAR_SIZE, SCAR_SIZE), RADIAL['acceleration_factor'],
          r)))
  for name, fn in cases:
    fn(np.random.RandomState(1))
    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
      fn(np.random.RandomState(i))
    ms = (time.perf_counter() - t0) * 1e3 / reps
    print('host {} at {}^2: {:.2f} ms ({:.2f}x the radial step of {:.3f} '
          'ms) ({})'.format(name, SCAR_SIZE, ms, ms / step_ms, step_ms,
                            line))


def aug_seg_phase(data_dir, work):
  """Phase 21 (c): configs/3-train-segmentation-unet.json with augmentation
  through the training CLI, 2 steps and 1 validation batch at 512², B = 8;
  18 K2 f32 launches per validation forward, none in train mode; every
  launch of one eval forward against its plain version. Returns (K2
  launches, the largest |kernel - plain|)."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.ops import conv_chain
  overrides = ['num_train_subset_samples=16',
               'num_validation_subset_samples=8',
               'augmentation=' + json.dumps(SEG_AUG)]
  sync()
  conv_chain.conv_layer_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([SEG_CONFIG, '--data-dir', data_dir, '--log-dir',
                       os.path.join(work, 'aug_seg_runs'), '--device', DEVICE,
                       '--conf', 'num_epochs=1'] + overrides)
  sync()
  secs = time.perf_counter() - t0
  k2, k2_f32 = (conv_chain.conv_layer_cuda.launches,
                conv_chain.conv_layer_f32_cuda.launches)
  print('augmented segmentation CLI at {}^2 B{}: {} steps + 1 validation '
        'batch in {:.1f} s, K2 {} (f32 routes {})'.format(
            SCAR_SIZE, SEG_BATCH, runner.step, secs, k2, k2_f32))
  require(runner.step == 2 and k2 == k2_f32 == SEG_CHAIN_LAYERS,
          'expected 2 steps and 18 K2 f32 launches per eval forward')
  train_set = load_dataset(runner.conf, data_dir, 'ScarSeg', 'train')
  require(train_set.augmentation == SEG_AUG, 'the training fold is not '
          'augmented')
  host = next(iter(DataLoader(load_dataset(runner.conf, data_dir, 'ScarSeg',
                                           'val'), SEG_BATCH)))
  batch = runner.preparer.prepare_val(host)
  runner.model.eval()
  calls = chain_launches(runner.model, batch['inp'])
  worst = hold_launches('augmented segmentation eval', calls,
                        SEG_CHAIN_LAYERS, SEG_BATCH)
  return k2, worst


def data_options_phase(data_dir, work, line):
  """Phase 21: (a)-(d). Returns the launches and errors for the kernels
  line."""
  t0 = time.perf_counter()
  runner, _, k1, k1_bwd, k1_err, k1_bwd_err, step_ms = radial_cli_phase(
      data_dir, work, line)
  nat_k1, nat_k1_bwd = native_cli_phase(data_dir, work)
  loader_costs(runner, data_dir, line)
  del runner
  k2, k2_err = aug_seg_phase(data_dir, work)
  host_costs(step_ms, line)
  print('phase 21: {:.1f} s wall'.format(time.perf_counter() - t0))
  return {'k1': k1 + nat_k1, 'k1_bwd': k1_bwd + nat_k1_bwd, 'k2_f32': k2,
          'dc_err': k1_err, 'dc_bwd_err': k1_bwd_err, 'f32_err': k2_err}


def scarseg_phase(line, dist_export_only=False, spatial_only=False):
  """Phase 18: the paper's three configs on a ScarSeg-format tree at 512²,
  the validate and eval_results CLIs; the tree is removed after. Returns
  the launches and errors for the kernels line. ``dist_export_only``:
  the tree and phase 22 alone; ``spatial_only``: the tree and phase 23
  alone."""
  os.makedirs(GAN_DIR, exist_ok=True)
  work = tempfile.mkdtemp(prefix='scarseg_', dir=GAN_DIR)
  try:
    data_dir = os.path.join(work, 'data')
    scarseg_data_phase(data_dir)
    if dist_export_only:
      return dist_export_phase(data_dir, work, None, None, None, line)
    if spatial_only:
      return merge_spatial(spatial_phase(data_dir, work, line),
                           uneven_phase(line))
    rec_runner, best, k1, k1_bwd = scarseg_recnet_phase(
        data_dir, os.path.join(work, 'runs'))
    dc = scarseg_dc_phase(line)
    scarseg_validate_phase(data_dir, best, os.path.join(work, 'out'), line)
    gan_conf, gan_k1, gan_k2, gan_err, gan_calls, gan_runner = \
        scarseg_gan_phase(data_dir, best, work, line)
    gan_ckpt, = glob.glob(os.path.join(work, 'runs', '2-refinement_*',
                                       'periodic-chkpt_*.ckpt'))
    # the card's records only: the CPU's 4 slices share the run's name
    eval_csvs = glob.glob(os.path.join(work, 'out', 'eval_card', '*.csv'))
    seg_runner, seg_k2, seg_err = scarseg_seg_phase(data_dir, work)
    f32 = scarseg_timings(data_dir, rec_runner, gan_runner, seg_runner, line)
    f32_layer_table('GAN validation {}^2'.format(SCAR_SIZE),
                    [c[:3] for c in gan_calls], line)
    del rec_runner, gan_runner, seg_runner, gan_calls
    # Phase 19: the trainer's surface on the same tree
    surf_k1, surf_k2 = surface_phase(data_dir, gan_conf, work, line)
    # Phase 20: the training options on the same tree
    opt = options_phase(data_dir, gan_conf, work, f32, line)
    # Phase 21: the data, sampling and metric options on the same tree
    data = data_options_phase(data_dir, work, line)
    # Phase 22: data parallelism, the serving artifact, summarize_results
    dist = dist_export_phase(data_dir, work, gan_conf, gan_ckpt, eval_csvs,
                             line)
    # Phase 23: the mesh's spatial axis on the same tree
    spatial = spatial_phase(data_dir, work, line)
    # Phase 26: spatial meshes whose per-rank rows a layer splits
    spatial = merge_spatial(spatial, uneven_phase(line))
  finally:
    shutil.rmtree(work, ignore_errors=True)
  return {'k1': (k1 + gan_k1 + surf_k1 + opt['k1'] + data['k1'] + dist['k1'] +
                 spatial['k1']),
          'k1_bwd': (k1_bwd + opt['k1_bwd'] + data['k1_bwd'] +
                     dist['k1_bwd'] + spatial['k1_bwd']),
          'k2_f32': (gan_k2 + seg_k2 + surf_k2 + data['k2_f32'] +
                     dist['k2_f32'] + spatial['k2_f32']),
          'k2_bf16': opt['k2_bf16'],
          'dc_err': max(dc['K1'][0], opt['dc_err'], data['dc_err'],
                        spatial['dc_err']),
          'dc_bwd_err': max(dc['K1-bwd'][0], opt['dc_bwd_err'],
                            data['dc_bwd_err'], spatial['dc_bwd_err']),
          'f32_err': max(gan_err, seg_err, data['f32_err'],
                         spatial['f32_err']),
          'bf16_err': opt['k2_err'],
          'k1_mixed': spatial['k1_mixed'],
          'k1_bwd_mixed': spatial['k1_bwd_mixed'],
          'passes': spatial['passes'], 'pass_times': spatial['pass_times'],
          'k3': spatial['k3'], 'requant': spatial['requant'],
          'k3_err': spatial['k3_err'], 'requant_err': spatial['requant_err']}


# Phase 22: data parallelism in a one-rank NCCL group, the serving
# artifact replayed through K1 and K2, and summarize_results, on phase 18's
# tree. A card takes one NCCL rank, so a one-card machine runs a world of
# one (two ranks are held to one process by the CPU tests).
DIST_REC = ['num_epochs=1', 'num_train_subset_samples=40']      # 2 steps
DIST_SEG = ['num_epochs=1', 'num_train_subset_samples=16',
            'num_validation_subset_samples=8']                   # 2 + 1
DIST_REL = 1e-5          # with the group against without, each tensor
REPLAY_REL = 1e-6        # the artifact against predict: the same kernels
REPLAY_TIMEOUT_S = 300
REPLAY_CODE = r"""
import json, sys, torch
from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
from csmri_refinement_tpu_torch.utils.export import load_callable
from csmri_refinement_tpu_torch.utils.profiling import timed_ms
torch.backends.cudnn.allow_tf32 = False
out = {'modules': []}
for name, artifact, feed in json.loads(sys.argv[1]):
  batch = torch.load(feed)
  call, _ = load_callable(artifact, 'cuda')
  torch.cuda.synchronize()
  dc_kernel.dc_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  card = call(batch)
  torch.cuda.synchronize()
  launches = (dc_kernel.dc_cuda.launches,
              conv_chain.conv_layer_f32_cuda.launches)
  ms = timed_ms(lambda: call(batch), iters=3, warmup=1)
  cpu_call, _ = load_callable(artifact, 'cpu')
  cpu = cpu_call({k: v.cpu() for k, v in batch.items()})
  to_cpu = lambda t: {k: v.cpu() for k, v in t.items()} \
      if isinstance(t, dict) else {'pred': t.cpu()}
  out[name] = {'card': to_cpu(card), 'cpu': to_cpu(cpu),
               'launches': launches, 'ms': ms}
out['modules'] = sorted(m for m in sys.modules if m.startswith('csmri'))
torch.save(out, sys.argv[2])
"""


def free_port():
  import socket
  s = socket.socket()
  s.bind(('127.0.0.1', 0))
  port = s.getsockname()[1]
  s.close()
  return port


def group_section(port):
  """A one-rank ``distributed`` section, as a JAX config writes it."""
  return {'coordinator_address': 'localhost:{}'.format(port),
          'num_processes': 1, 'process_id': 0}


@contextlib.contextmanager
def recorded_epochs():
  """{'train': [loss values of each epoch], 'val': [...]}: what the runners'
  epoch loops return while the block runs."""
  from csmri_refinement_tpu_torch.training.base_runner import BaseRunner
  seen = {'train': [], 'val': []}
  train_epoch, validate = BaseRunner.train_epoch, BaseRunner.validate

  def record_train(self, *args, **kwargs):
    losses, metrics = train_epoch(self, *args, **kwargs)
    seen['train'].append({k: m.value for k, m in losses.items()})
    return losses, metrics

  def record_val(self, *args, **kwargs):
    data, losses, metrics = validate(self, *args, **kwargs)
    seen['val'].append({k: m.value for k, m in {**losses,
                                                 **metrics}.items()})
    return data, losses, metrics
  BaseRunner.train_epoch, BaseRunner.validate = record_train, record_val
  try:
    yield seen
  finally:
    BaseRunner.train_epoch, BaseRunner.validate = train_epoch, validate


def dist_cli(config, data_dir, run_root, overrides):
  """The training CLI under ``deterministic()``: (runner, recorded)."""
  from csmri_refinement_tpu_torch import train
  with recorded_epochs() as seen, deterministic():
    runner = train.main([config, '--data-dir', data_dir, '--log-dir',
                         run_root, '--device', DEVICE, '--conf'] + overrides)
    sync()
  return runner, seen


def values_rel(got, want):
  """The largest |Δ| / |ref| over the recorded epochs' values."""
  worst = 0.0
  for phase in ('train', 'val'):
    require(len(got[phase]) == len(want[phase]), 'epochs differ')
    for g, w in zip(got[phase], want[phase]):
      require(set(g) == set(w), 'recorded names differ')
      worst = max([worst] + [abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                             for k in w])
  return worst


def dist_phase(data_dir, work, line):
  """Phase 22 (a): 1-recnet (B = 20, 2 steps and 2 validation batches) and
  segmentation (B = 8, 2 steps and 1 validation batch) through the
  training CLI with a one-rank NCCL group (the ``distributed`` section)
  and without one; the counters around the group's runs; losses and
  parameters of the two within ``DIST_REL``; the train step with and
  without the group in turns. Returns (the launches, the 1-recnet
  checkpoint of the run without the group)."""
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  from csmri_refinement_tpu_torch.parallel import distributed
  runs = {}
  launches = {'k1': 0, 'k1_bwd': 0, 'k2_f32': 0}
  for label, config, overrides in (('1-recnet', RECNET_CONFIG, DIST_REC),
                                   ('segmentation', SEG_CONFIG, DIST_SEG)):
    t0 = time.perf_counter()
    plain = dist_cli(config, data_dir, os.path.join(work, 'plain_runs'),
                     overrides)
    sync()
    dc_kernel.dc_cuda.launches = dc_kernel.dc_bwd_cuda.launches = 0
    conv_chain.conv_layer_f32_cuda.launches = 0
    group = dist_cli(config, data_dir, os.path.join(work, 'group_runs'),
                     overrides + ['distributed=' + json.dumps(
                         group_section(free_port()))])
    k1, k1_bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
    k2 = conv_chain.conv_layer_f32_cuda.launches
    secs = time.perf_counter() - t0
    require(not dist.is_initialized(), 'the CLI left its group running')
    require(group[0].mesh is not None and group[0].mesh.world == 1 and
            plain[0].mesh is None, 'expected a mesh of one only with the '
            'group')
    state, values = state_rel(group[0], plain[0]), values_rel(group[1],
                                                              plain[1])
    print('{} CLI with a one-rank NCCL group and without (deterministic): '
          'parameters within {:.3e} of max|ref|, losses and metrics within '
          '{:.3e}; K1 {}, K1-bwd {}, K2 f32 {} with the group; {:.1f} s'
          .format(label, state, values, k1, k1_bwd, k2, secs))
    require(state <= DIST_REL and values <= DIST_REL,
            label + ' with the group differs from without')
    if label == '1-recnet':
      require((k1, k1_bwd, k2) == (3 * (2 + 2), 3 * 2, 0),
              'expected 12 K1 and 6 K1-bwd launches')
    else:
      require((k1, k1_bwd, k2) == (0, 0, SEG_CHAIN_LAYERS),
              'expected 18 K2 f32 launches per eval forward')
    for key, n in zip(('k1', 'k1_bwd', 'k2_f32'), (k1, k1_bwd, k2)):
      launches[key] += n
    runs[label] = plain[0]
  best = glob.glob(os.path.join(work, 'plain_runs', '1-recnet_*',
                                'best_loss_MSE', '*.ckpt'))
  require(len(best) == 1, 'expected one 1-recnet checkpoint')
  dist_timings(data_dir, runs, line)
  return launches, best[0]


def dist_timings(data_dir, runs, line):
  """Phase 22 (a): ms per train step with the one-rank group (the gradient
  and loss all-reduces; BatchNorm keeps its local statistics in a world of
  one) and without, in turns (with, without, without, with)."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.parallel import distributed
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict({'distributed': group_section(free_port())})
  device = distributed.initialize(conf, DEVICE)
  try:
    for label, plain in runs.items():
      conf = copy.deepcopy(plain.conf)
      grouped = build_runner(conf, conf.runner_type, 'train', device)
      require(grouped.mesh is not None and grouped.mesh.group is not None,
              'expected a runner in the group')
      host = next(iter(DataLoader(load_dataset(conf, data_dir, 'ScarSeg',
                                               'train'), conf.batch_size)))
      batch = plain.preparer.prepare_train(
          torch.Generator(device=DEVICE).manual_seed(SEED), host)
      ms = {'with': [], 'without': []}
      for turn in ('with', 'without', 'without', 'with'):
        runner = grouped if turn == 'with' else plain
        ms[turn].append(timed_ms(lambda: runner.train_batch(batch), iters=3,
                                 warmup=1))
      print('{} train step at {}^2 B{} (TF32 off), one-rank NCCL group: '
            'with {:.3f} / {:.3f} ms, without {:.3f} / {:.3f} ms ({:+.2f}%) '
            '({})'.format(label, SCAR_SIZE, conf.batch_size, *ms['with'],
                          *ms['without'], 100 * (sum(ms['with']) /
                                                 sum(ms['without']) - 1),
                          line))
      del grouped
  finally:
    distributed.shutdown()


def export_phase(data_dir, work, gan_conf, gan_ckpt, rec_ckpt, line):
  """Phase 22 (b): the 2-refinement generator (B = 5) and 1-recnet (B =
  20) through the export CLI with --verify, each artifact replayed on the
  card and on the CPU in a fresh process that imports no model code;
  the card replay against ``runner.predict`` within ``REPLAY_REL``, the
  CPU's against the card's within ``E2E_ATOL`` of max |ref|, the launches
  of one card replay (K1 3 and K2 f32 10 for the generator, K1 3 for
  1-recnet), the artifact's KiB and replay ms against predict ms. Returns
  the launches."""
  from csmri_refinement_tpu_torch import export_model
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils.checkpoints import restore_checkpoint
  from csmri_refinement_tpu_torch.utils.config import Configuration
  cases, wants, sizes, predict_ms = [], {}, {}, {}
  for name, conf_path, ckpt, batch_size, expect in (
      ('2-refinement', gan_conf, gan_ckpt, GAN_BATCH, (3, 10)),
      ('1-recnet', RECNET_CONFIG, rec_ckpt, REC_BATCH, (3, 0))):
    artifact = os.path.join(work, name + '.pt2')
    t0 = time.perf_counter()
    rc = export_model.main([conf_path, ckpt, artifact, '-b', str(batch_size),
                            '--data-dir', data_dir, '--device', DEVICE,
                            '--verify'])
    secs = time.perf_counter() - t0
    require(rc == 0, 'export_model failed for ' + name)
    sizes[name] = os.path.getsize(artifact) / 1024.0
    conf = Configuration.from_json(conf_path)
    runner = build_runner(conf, conf.runner_type, 'test', DEVICE)
    if ckpt != 'NONE':
      restore_checkpoint(ckpt, runner)
    host = next(iter(DataLoader(load_dataset(conf, data_dir, 'ScarSeg',
                                             'val'), batch_size)))
    batch = {k: v for k, v in runner.preparer.prepare_val(host).items()
             if isinstance(v, torch.Tensor)}
    want = runner.predict(batch)
    wants[name] = {k: v.cpu() for k, v in want.items()} \
        if isinstance(want, dict) else {'pred': want.cpu()}
    predict_ms[name] = timed_ms(lambda: runner.predict(batch), iters=3,
                                warmup=1)
    feed = os.path.join(work, name + '_feed.pt')
    torch.save(batch, feed)
    cases.append((name, artifact, feed, expect))
    print('export_model {} at {}^2 B{}: {:.1f} KiB, export and verify in '
          '{:.1f} s'.format(name, SCAR_SIZE, batch_size, sizes[name], secs))
    del runner
  out = os.path.join(work, 'replay.pt')
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, '-c', REPLAY_CODE,
       json.dumps([c[:3] for c in cases]), out],
      cwd=REPO, capture_output=True, text=True, timeout=REPLAY_TIMEOUT_S)
  require(proc.returncode == 0, 'the replay process failed:\n' +
          proc.stderr[-3000:])
  replay = torch.load(out)
  print('replay process: {:.1f} s (host clock)'.format(
      time.perf_counter() - t0))
  require(not [m for m in replay['modules'] if m.split('.', 1)[-1].startswith(
      ('models.recnet', 'models.unet', 'training', 'flagship'))],
          'the replay imported model code: {}'.format(replay['modules']))
  launches = {'k1': 0, 'k2_f32': 0}
  for name, _, _, expect in cases:
    got, want = replay[name], wants[name]
    require(sorted(got['card']) == sorted(want), name + ': output keys')
    card_rel = max(output_rel(got['card'][k], want[k]) for k in want)
    cpu_rel = max(output_rel(got['cpu'][k], got['card'][k]) for k in want)
    print('artifact {} replayed on the card: K1 {}, K2 f32 {}; within {:.3e} '
          'of max|predict| (bar {}), the CPU replay within {:.3e} of the '
          'card (bar {}); replay {:.3f} ms, predict {:.3f} ms, {:.1f} KiB '
          '({})'.format(name, *got['launches'], card_rel, REPLAY_REL,
                        cpu_rel, E2E_ATOL, got['ms'], predict_ms[name],
                        sizes[name], line))
    require(tuple(got['launches']) == expect,
            '{}: expected K1 {} and K2 f32 {} per replay'.format(name,
                                                                 *expect))
    require(card_rel <= REPLAY_REL, name + ': replay differs from predict')
    require(cpu_rel <= E2E_ATOL, name + ': CPU replay differs from card')
    launches['k1'] += got['launches'][0]
    launches['k2_f32'] += got['launches'][1]
  return launches


def output_rel(got, ref):
  """max |got − ref| over max |ref|, or over 1 for an all-zero output (a
  refinement scale still at 0)."""
  scale = ref.abs().max().item() or 1.0
  return (got - ref).abs().max().item() / scale


def summarize_phase(csvs):
  """Phase 22 (c): the port's summarize_results over eval_results CSVs."""
  import io
  from csmri_refinement_tpu_torch import summarize_results
  require(csvs, 'no eval_results CSV to summarize')
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    summarize_results.main(csvs + ['--metric-name', 'psnr,ssim'])
  print('summarize_results over {} CSV(s):\n{}'.format(len(csvs),
                                                       out.getvalue()))
  require('psnr' in out.getvalue(), 'summarize_results printed no table')


def eval_csv(data_dir, ckpt, work):
  """One eval_results CSV: ``validate --raw`` of ``ckpt`` on 4 validation
  slices, then ``eval_results`` over the records."""
  from csmri_refinement_tpu_torch import eval_results, validate
  res = validate.main([RECNET_CONFIG, ckpt, '--data-dir', data_dir, '-b',
                       '1', '--raw', '--device', DEVICE, '--out-dir',
                       os.path.join(work, 'raw'), '--conf',
                       'num_validation_subset_samples=4'])['ScarSeg']
  res_dir = os.path.join(work, 'eval')
  os.makedirs(res_dir)
  path, _ = eval_results.main([
      '--src-path', os.path.join(data_dir, 'scar_segmentation'),
      '--results-path', res_dir, '--device', DEVICE, res['output_dir']])
  return [path]


def dist_export_phase(data_dir, work, gan_conf, gan_ckpt, csvs, line):
  """Phase 22 on phase 18's tree. Without phase 18's runs (``gan_conf``
  None: ``--dist-export-only``) the generator is exported from its seeded
  init on a RecNet from (a)'s checkpoint, and (c) reads the eval_results
  CSV of (a)'s checkpoint. Returns the launches."""
  t0 = time.perf_counter()
  launches, rec_ckpt = dist_phase(data_dir, work, line)
  if gan_conf is None:
    with open(os.path.join(REPO, 'configs', '2-refinement.json')) as f:
      conf_d = json.load(f)
    conf_d['generator_model']['pretrained_model']['pretrained_weights'] = [
        rec_ckpt, 'model']
    gan_conf, gan_ckpt = os.path.join(work, '2-refinement.json'), 'NONE'
    with open(gan_conf, 'w') as f:
      json.dump(conf_d, f)
    csvs = eval_csv(data_dir, rec_ckpt, work)
  exported = export_phase(data_dir, work, gan_conf, gan_ckpt, rec_ckpt, line)
  summarize_phase(csvs)
  print('phase 22: {:.1f} s wall'.format(time.perf_counter() - t0))
  return {'k1': launches['k1'] + exported['k1'],
          'k1_bwd': launches['k1_bwd'],
          'k2_f32': launches['k2_f32'] + exported['k2_f32']}


# Phase 23: the mesh's spatial axis. The three paper configs at 512² with
# each image's rows sharded over two processes that share the one card
# (NCCL takes one rank per card): each child starts a gloo group before it
# builds its runner, and ``parallel/distributed.py::initialize`` accepts the
# running group. Two ranks on one card are not a scaling number: their
# times say what the halos and the DC's all-to-alls cost beside one
# process, not what two cards would do. Each rank holds its rows of the
# images and its column block of k-space and mask; its DC is K1's three
# passes (``ops/dc_kernel.py::dc_distributed``), its int8 chains run layer
# by layer on halo tiles (``ops/quantize.py``).
SPATIAL_MESH = {'data': 1, 'spatial': 2}
# (label, CLI overrides): 1-recnet 2 updates, the GAN and segmentation 1
# update each, then 1 validation batch. At full width a BN network's first
# Adam step is ±lr·sign(g) on every weight, and a near-zero gradient whose
# sign the ranks' summation order flips moves its weight by 2·lr = 4e-4
# (a CPU rehearsal at 128² moved one U-Net weight by 3.998e-4 in the
# generator and in segmentation, the update's losses agreeing to 4e-7 and
# 3e-6 relative); later updates then part as the weights do.
SPATIAL_RUNS = (
    ('1-recnet', ['num_epochs=1', 'num_train_subset_samples=40',
                  'num_validation_subset_samples=20']),
    ('2-refinement', ['num_epochs=1', 'num_train_subset_samples=5',
                      'num_validation_subset_samples=5',
                      'vgg_random_init=true']),
    ('segmentation', ['num_epochs=1', 'num_train_subset_samples=8',
                      'num_validation_subset_samples=8']))
# The JAX suite's spatial bars (tests/test_parallel.py:199-310): (losses,
# parameters); the discriminator's 5e-4 (2·lr and slack, its
# ``test_adversarial_spatial_mesh_matches_single_device``) holds the BN
# networks of the GAN and segmentation, for the reason above. BN
# statistics 5e-5, validation PSNR 1e-3 dB; SSIM and dice (a count of
# pixels on either side of an argmax) 1e-3.
SPATIAL_BARS = {'1-recnet': (1e-5, 5e-5), '2-refinement': (1e-4, 5e-4),
                'segmentation': (1e-5, 5e-4)}
SPATIAL_DISC_ATOL, SPATIAL_BN_ATOL = 5e-4, 5e-5
SPATIAL_PSNR_ATOL, SPATIAL_METRIC_ATOL = 1e-3, 1e-3
SPATIAL_RTOL = 1e-5
SPATIAL_STEPS = 2        # timed train steps per rank
SPATIAL_TIMEOUT_S = 600
GLOO_PROBES = ('all_gather', 'all_to_all', 'all_to_all_v', 'all_reduce',
               'broadcast')
GLOO_TIMED_MB, GLOO_TIMED_CALLS = 20, 5     # MiB of each rank's part
# K1's and K1-bwd's pass wrappers (``ops/dc_kernel.py``): (label, the
# plain version each launch is held against, whether it is K1-bwd's).
DC_PASSES = {
    'dc_rows_fft_cuda': ('K1 pass 1', 'dc_rows_fft_plain', False),
    'dc_cols_cuda': ('K1 pass 2', 'dc_cols_plain', False),
    'dc_rows_ifft_cuda': ('K1 pass 3', 'dc_rows_ifft_plain', False),
    'dc_bwd_rows_fft_cuda': ('K1-bwd pass 1', 'dc_rows_fft_plain', True),
    'dc_bwd_cols_cuda': ('K1-bwd pass 2', 'dc_cols_plain', True),
    'dc_bwd_rows_ifft_cuda': ('K1-bwd pass 3', 'dc_rows_ifft_plain', True)}
# A pass against its plain version, relative to the plain output's max
# |value|: both are f32 FFTs of one length (and the same merge) summed in
# another order; the card reads 1e-7 to 3e-7 at 512² (PERF.md), and a zero
# or wrong output reads 1.
PASS_REL = 1e-5
# The int8 eval forward of the 2-refinement generator on the two ranks
# against one process, on the same weights and batch: max |Δ| over max
# |ref|. Not bit for bit: the first quantized chain's float prefix on a
# halo tile rounds 6e-7 of max |ref| off the whole image's, which moves
# the group's amax by ulps and so a few int8 ties; the card reads 1.5e-6
# (the f32 forward 4.7e-7), the CPU 1.7e-6 at 128² (PERF.md). A tile whose
# halo or scale is wrong moves whole rows by an int8 step or more.
SPATIAL_INT8_REL = 1e-5


def child_group(cfg):
  """Start the two-rank gloo group of a phase-23 child."""
  import torch.distributed as dist
  dist.init_process_group(
      'gloo', init_method='tcp://127.0.0.1:{}'.format(cfg['port']),
      world_size=2, rank=cfg['rank'])


def gloo_probe(cfg):
  """``--gloo-probe JSON``: each of ``GLOO_PROBES`` run by gloo itself on
  CUDA tensors (no host copy of ours) and checked (the all-to-all as
  ``all_to_all_single``, the form ``parallel/mesh.py`` uses, with equal
  parts and with split sizes); prints
  ``GLOO {name: 'ok' | 'wrong' | 'refused: ...'}``."""
  import torch.distributed as dist
  child_group(cfg)
  rank, seen = cfg['rank'], {}
  try:
    for name in GLOO_PROBES:
      t = torch.full((1024,), float(rank + 1), device='cuda')
      try:
        if name == 'all_gather':
          parts = [torch.empty_like(t) for _ in range(2)]
          dist.all_gather(parts, t)
          good = all(bool((p == r + 1).all()) for r, p in enumerate(parts))
        elif name == 'all_to_all':
          # part j of each rank goes to rank j: rank r gets (r, 10 + r)
          t = torch.arange(2, device='cuda', dtype=torch.float32) + \
              10 * rank
          out = torch.empty_like(t)
          dist.all_to_all_single(out, t)
          good = out.tolist() == [float(rank), float(10 + rank)]
        elif name == 'all_to_all_v':
          # split sizes (``mesh.all_to_all``'s uneven blocks): rank 0
          # sends 1 and 2 elements, rank 1 3 and 1
          send = [1, 2] if rank == 0 else [3, 1]
          recv = [1, 3] if rank == 0 else [2, 1]
          t = torch.arange(sum(send), device='cuda',
                           dtype=torch.float32) + 10 * rank
          out = t.new_empty(sum(recv))
          dist.all_to_all_single(out, t, recv, send)
          good = out.tolist() == ([0.0, 10.0, 11.0, 12.0] if rank == 0 else
                                  [1.0, 2.0, 13.0])
        elif name == 'all_reduce':
          dist.all_reduce(t)
          good = bool((t == 3).all())
        else:
          dist.broadcast(t, 0)
          good = bool((t == 1).all())
        seen[name] = 'ok' if good else 'wrong'
      except Exception as e:  # noqa: BLE001 - the probe reports it
        seen[name] = 'refused: {}'.format(str(e).splitlines()[0][:120])
    # the transport's rates: an all_gather of a 1-recnet DC gather's part,
    # an all_to_all of the same bytes
    part = torch.ones(GLOO_TIMED_MB * 2 ** 18, device='cuda')
    parts = [torch.empty_like(part) for _ in range(2)]
    out = torch.empty_like(part)
    for name, call in (('all_gather', lambda: dist.all_gather(parts, part)),
                       ('all_to_all',
                        lambda: dist.all_to_all_single(out, part))):
      call()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      for _ in range(GLOO_TIMED_CALLS):
        call()
      torch.cuda.synchronize()
      seen[name + '_ms'] = (time.perf_counter() - t0) * 1e3 / \
          GLOO_TIMED_CALLS
  finally:
    dist.destroy_process_group()
  print('GLOO ' + json.dumps(seen))


def spawn_ranks(mode, cfg, outs=None):
  """Two children ``chip_smoke.py --<mode> JSON`` in one gloo group; their
  stdout, or a failure naming the rank."""
  cfg = dict(cfg, port=free_port())
  procs = [subprocess.Popen(
      [sys.executable, os.path.realpath(__file__), '--' + mode,
       json.dumps(dict(cfg, rank=r, out=None if outs is None else outs[r]))],
      cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for r in range(2)]
  outputs = []
  try:
    for r, p in enumerate(procs):
      try:
        out, _ = p.communicate(timeout=SPATIAL_TIMEOUT_S)
      except subprocess.TimeoutExpired:
        fail('{} rank {} timed out'.format(mode, r))
      if p.returncode:
        print(out[-6000:], file=sys.stderr)
        fail('{} rank {} exited {}'.format(mode, r, p.returncode))
      outputs.append(out)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()
  return outputs


def gloo_phase(line):
  """Phase 23 (a): gloo runs the mesh's collectives on CUDA tensors itself
  (``parallel/mesh.py`` gives them to it as they are); the host ms of an
  all_gather and of an all_to_all of ``GLOO_TIMED_MB`` MiB parts."""
  seen = [json.loads(ln.split(' ', 1)[1]) for out in spawn_ranks(
      'gloo-probe', {}) for ln in out.splitlines() if ln.startswith('GLOO ')]
  require(len(seen) == 2, 'the gloo probe printed no result')
  for name in GLOO_PROBES:
    print('gloo {} on CUDA tensors: rank 0 {}, rank 1 {}'.format(
        name, seen[0][name], seen[1][name]))
    require(seen[0][name] == seen[1][name] == 'ok',
            'gloo {} fails on CUDA tensors'.format(name))
  for name in ('all_gather', 'all_to_all'):
    ms = max(r[name + '_ms'] for r in seen)
    print('gloo {} of {} MiB CUDA parts between two ranks on one card: '
          '{:.3f} ms, {:.2f} GB/s of each rank\'s part ({})'.format(
              name, GLOO_TIMED_MB, ms, GLOO_TIMED_MB * 2 ** 20 / ms / 1e6,
              line))


def record_k2_launches(fn):
  """Run ``fn()`` with K2's f32 wrapper recorded: [(x, layer, pad, y)]
  (``conv_layer_cuda`` looks it up at call time)."""
  from csmri_refinement_tpu_torch.ops import conv_chain
  with recorded_launches(conv_chain, ('conv_layer_f32_cuda',)) as calls:
    fn()
  return [args + (y,) for args, y in calls['conv_layer_f32_cuda']]


@contextlib.contextmanager
def counted_collectives():
  """{call site: bytes} that ``parallel/mesh.py``'s all_gather, all_to_all
  and all_reduce move for this rank while the block runs (all_gather: the
  rank's part; all_to_all: the parts it sends to the other ranks;
  all_reduce: the tensor), and under 'conv rows' the (largest, smallest)
  row count of a tile any ``F.conv2d`` read."""
  import torch.distributed as dist
  import torch.nn.functional as F
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  moved = {}
  gather, exchange, reduce = (mesh_lib.all_gather, mesh_lib.all_to_all,
                              mesh_lib.all_reduce)
  conv2d = F.conv2d

  def site():   # the caller of ``halo.gather_rows``, ``halo.halo_rows``,
    # ``halo.fetch``, ``layers.pad`` or ``mesh.gather_blocks`` rather than
    # their frames (0 this, 1 count, 2 the counted collective)
    frame = sys._getframe(3)
    while frame.f_back is not None and frame.f_code.co_qualname in (
        'gather_blocks', '_GatherRows.forward', '_HaloRows.forward',
        '_Fetch.forward', 'Function.apply', 'gather_rows', 'halo_rows',
        'fetch', 'tile', 'pad', 'same_pad'):
      frame = frame.f_back
    return frame.f_code.co_qualname

  def count(kind, nbytes):
    key = '{} in {}'.format(kind, site())
    moved[key] = moved.get(key, 0) + nbytes

  def counted_gather(t, group):
    count('all_gather', t.numel() * t.element_size())
    return gather(t, group)

  def counted_exchange(t, group, send_sizes, recv_sizes):
    own = send_sizes[dist.get_rank(group)]
    count('all_to_all', (sum(send_sizes) - own) * t[:1].numel() *
          t.element_size())
    return exchange(t, group, send_sizes, recv_sizes)

  def counted_reduce(t, group, *args):
    count('all_reduce', t.numel() * t.element_size())
    return reduce(t, group, *args)

  def counted_conv2d(x, *args, **kwargs):
    most, least = moved.get('conv rows', (0, None))
    moved['conv rows'] = (max(most, x.shape[2]), x.shape[2] if least is None
                          else min(least, x.shape[2]))
    return conv2d(x, *args, **kwargs)
  mesh_lib.all_gather, mesh_lib.all_to_all, mesh_lib.all_reduce = (
      counted_gather, counted_exchange, counted_reduce)
  F.conv2d = counted_conv2d
  try:
    yield moved
  finally:
    mesh_lib.all_gather, mesh_lib.all_to_all, mesh_lib.all_reduce = (
        gather, exchange, reduce)
    F.conv2d = conv2d


def pass_plain(name, args):
  """The plain version of DC pass ``name`` on the arguments its wrapper
  was given."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  _, plain, bwd = DC_PASSES[name]
  fn = getattr(dc_kernel, plain)
  if 'cols' not in name:
    return fn(args[0])
  return fn(args[0], None, args[1]) if bwd else fn(*args[:3])


def pass_cost(name, args):
  """(operations, bytes) of one DC pass: 5 n log2 n per line transform
  (two in the column pass), each input read and the output written
  once."""
  t = args[0]
  b, rows, cols = t.shape[:3]
  pixels = b * rows * cols
  if 'cols' not in name:
    return 5 * pixels * math.log2(cols), 16 * pixels
  return 10 * pixels * math.log2(rows), (20 if DC_PASSES[name][2] else 28) * \
      pixels


def pass_library_call(name, args):
  """One ``torch.fft`` call that computes a row pass, or None (the column
  pass has none: two transforms and the merge)."""
  if 'cols' in name:
    return None
  xc = torch.view_as_complex(args[0])
  f = torch.fft.ifft if 'ifft' in name else torch.fft.fft
  return lambda: f(xc, dim=2, norm='ortho')


def record_pass_launches(fn):
  """Run ``fn()`` with the DC passes' wrappers recorded: {wrapper: [(args,
  y)]}."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  with recorded_launches(dc_kernel, tuple(DC_PASSES)) as calls:
    fn()
  return calls


def pass_checks(calls):
  """{wrapper: [launches, max |kernel − plain|, that over max |plain|]}:
  every recorded launch against its plain version, within PASS_REL of the
  plain version's max |value| (K1-bwd's inputs are loss gradients near
  1e-6, so no absolute floor)."""
  checked = {}
  for name, launched in calls.items():
    label = DC_PASSES[name][0]
    worst = [len(launched), 0.0, 0.0]
    for args, y in launched:
      want = pass_plain(name, args)
      err = (y - want).abs().max().item()
      rel = err / max(want.abs().max().item(), 1e-30)
      require(rel <= PASS_REL,
              '{} on {} differs from its plain version by {:.3e} of its '
              'max |value| (bar {})'.format(label, tuple(args[0].shape), rel,
                                           PASS_REL))
      worst[1:] = max(worst[1], err), max(worst[2], rel)
    checked[name] = worst
  return checked


def pass_timings(calls, mesh):
  """Each pass's device ms (``graph_ms``: a pass is shorter than its
  wrapper's host cost) on its first recorded launch's inputs, the plain
  version's and the library call's, and its bound: the ranks time in
  turn, the other waiting at a barrier, so that neither shares the card
  with the other's kernels."""
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.ops import dc_kernel
  times = {}
  for turn in range(mesh.spatial):
    dist.barrier()
    if turn != mesh.s:
      continue
    for name, launched in calls.items():
      if not launched:
        continue
      args, _ = launched[0]
      wrapper = getattr(dc_kernel, name)
      ms = graph_ms(lambda: wrapper(*args))
      plain_ms = graph_ms(lambda: pass_plain(name, args))
      lib = pass_library_call(name, args)
      lib_ms = None if lib is None else graph_ms(lib)
      ops, nbytes = pass_cost(name, args)
      b_ms, by = bound(ops, nbytes, F32_FLOPS)
      times[name] = {'shape': list(args[0].shape), 'ms': ms,
                     'plain_ms': plain_ms, 'library_ms': lib_ms,
                     'bound_ms': b_ms, 'bound_by': by}
  dist.barrier()
  return times


def spatial_checks(runner, data_dir):
  """Phase 23, each rank after its CLI run: one train step's DC pass
  launches and one eval forward's K2 f32 launches against their plain
  versions; the passes' times; the bytes each collective site moves in a
  step; ms per step over ``SPATIAL_STEPS`` steps and the step's peak
  GiB."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.ops import conv_chain
  conf = runner.conf
  host = next(iter(DataLoader(load_dataset(
      conf, data_dir, conf.get_attr('train_dataset', default='ScarSeg'),
      'train'), conf.batch_size, process_shard=runner.mesh.shard)))
  batch = runner.preparer.prepare_train(
      torch.Generator(device=DEVICE).manual_seed(SEED), host)
  with deterministic():
    calls = record_pass_launches(lambda: runner.train_batch(batch))
    k2_calls = record_k2_launches(lambda: runner.predict(batch))
  passes = pass_checks(calls)
  f32_err = 0.0
  for x, layer, pad, y in k2_calls:
    want = conv_chain.conv_layer_plain(x, layer, pad)
    err = (y - want).abs().max().item()
    require(err <= F32_ATOL * max(1.0, want.abs().max().item()),
            'K2 f32 on a halo tile {} differs from its plain version'
            .format(tuple(x.shape)))
    f32_err = max(f32_err, err)
  times = pass_timings(calls, runner.mesh) if DEVICE == 'cuda' else {}
  k2_checked = len(k2_calls)
  del calls, k2_calls
  with counted_collectives() as moved:
    runner.train_batch(batch)
    sync()
  result = {'passes': passes, 'times': times, 'f32_err': f32_err,
            'k2_checked': k2_checked,
            'conv_rows': moved.pop('conv rows', (0, 0)),
            'moved': moved, 'ms': step_wall_ms(runner, batch),
            'peak': step_peak_gib(runner, batch) if DEVICE == 'cuda'
            else 0.0}
  return result


def step_wall_ms(runner, batch):
  """ms per train step: the host clock over ``SPATIAL_STEPS`` steps on one
  prepared batch, synchronised, after a warm-up step."""
  runner.train_batch(batch)
  sync()
  t0 = time.perf_counter()
  for _ in range(SPATIAL_STEPS):
    runner.train_batch(batch)
  sync()
  return (time.perf_counter() - t0) * 1e3 / SPATIAL_STEPS


def quantize_generator(runner):
  """Put every chain of the runner's generator in the int8 serving mode."""
  for m in runner.gen.modules():
    if hasattr(m, 'quantize_inference'):
      m.quantize_inference = True


def int8_forward(runner, data_dir, label, size=None, rows=None):
  """The eval forward of the runner's generator on the first validation
  batch (its rank's part under a mesh), in f32 and then in the int8
  serving mode, whose K3 and requant launches are recorded and held
  against their plain versions. Returns {'f32', 'int8': outputs,
  'launches': (K3, requant), 'errs': their max errors, 'steps': the int8
  mode's steps in call order, on the rank's rows, on the host}: each
  quantized chain's float-prefix output, its int8 image and scale
  ('act'); each K3 launch's int8 input, scale and output ('K3'); each
  requant's int8 output and scale ('requant'). ``size``: the side of
  ``data_dir``'s tree, where it is not ``datasets.IMAGE_SIZE``; ``rows``:
  the images' first rows kept (a batch of rows × size)."""
  from csmri_refinement_tpu_torch.data import DataLoader, datasets
  from csmri_refinement_tpu_torch.data import load_dataset
  from csmri_refinement_tpu_torch.models import layers
  from csmri_refinement_tpu_torch.ops import conv_chain, quantize
  from csmri_refinement_tpu_torch.parallel import halo
  conf, mesh = runner.conf, runner.mesh
  side = datasets.IMAGE_SIZE
  datasets.IMAGE_SIZE = size or side
  try:
    host = next(iter(DataLoader(load_dataset(conf, data_dir, 'ScarSeg',
                                             'val'),
                                conf.batch_size, process_shard=None if mesh
                                is None else mesh.shard)))
  finally:
    datasets.IMAGE_SIZE = side
  if rows:
    host = {k: v[:, :rows] if getattr(v, 'ndim', 0) >= 3 else v
            for k, v in host.items()}
  if size and size != side:   # its cached masks are of the run's side
    runner.preparer._val_masks.clear()
  batch = runner.preparer.prepare_val(host)

  def pred():
    with deterministic():
      out = runner.predict(batch)
      sync()
    return (out['pred'] if isinstance(out, dict) else out).float().cpu()
  result = {'f32': pred()}
  quantize_generator(runner)
  order, acts, quantize_act = [], [], quantize.quantize_act

  def record_act(x, *rest):
    xi, scale = quantize_act(x, *rest)
    acts.append((x.float().cpu(), xi.cpu(), scale.cpu()))
    order.append(('act', len(acts) - 1))
    return xi, scale
  names = ('conv_layer_int8_cuda', 'requant_cuda')
  for name in names:
    getattr(conv_chain, name).launches = 0
  quantize.quantize_act = record_act
  try:
    with recorded_launches(conv_chain, names, order, copy=True) as calls:
      result['int8'] = pred()
  finally:
    quantize.quantize_act = quantize_act
  result['launches'] = tuple(getattr(conv_chain, n).launches for n in names)
  result['errs'] = hold_int8_launches(label, calls[names[0]], calls[names[1]])

  def halo_of(layer):       # (rows above, below) of a K3 launch's tile
    if mesh is None:
      return 0, 0
    return halo.taken(mesh, *layers.pad_sizes(layer.kernel.shape[0]))

  def rows(x, layer):       # the rank's rows of a K3 launch's halo tile
    top, bottom = halo_of(layer)
    return x.narrow(1, top, x.shape[1] - top - bottom).cpu()
  steps, result['tiles'] = [], []
  for name, i in order:
    if name == 'act':
      steps.append(('act', acts[i]))
    elif name == names[0]:
      args, (y, _) = calls[name][i]
      steps.append(('K3', (rows(args[0], args[2]), args[1].cpu(),
                           rows(y, args[2]).float())))
      result['tiles'].append((args[0].cpu(),) + tuple(halo_of(args[2])))
    else:
      steps.append(('requant', tuple(t.cpu() for t in calls[name][i][1])))
  result['steps'] = steps
  return result


def spatial_rank(cfg):
  """``--spatial-rank JSON``: one rank of phase 23's two. The training CLI
  on ``cfg['config']`` with the spatial mesh, the launch counters set to
  0 just before and read just after; then ``spatial_checks``, and with
  ``cfg['int8_state']`` the int8 generator forward on those weights.
  Saves the networks' states, the recorded epochs, the counts and the
  checks to ``cfg['out']``."""
  global DEVICE, SCAR_SIZE
  DEVICE, SCAR_SIZE = cfg['device'], cfg['size']
  require(DEVICE == 'cpu' or torch.cuda.is_available(), 'no CUDA device')
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.data import datasets
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  from csmri_refinement_tpu_torch.utils.diagnostics import runner_networks
  datasets.IMAGE_SIZE = SCAR_SIZE
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  child_group(cfg)
  counters = [getattr(dc_kernel, n) for n in ('dc_cuda', 'dc_bwd_cuda') +
              tuple(DC_PASSES)] + [conv_chain.conv_layer_f32_cuda]
  try:
    for fn in counters:
      fn.launches = 0
    runner, seen = dist_cli(cfg['config'], cfg['data_dir'], cfg['run_root'],
                            cfg['overrides'] + ['mesh=' + json.dumps(
                                SPATIAL_MESH)])
    launches = tuple(fn.launches for fn in counters)
    mesh = runner.mesh
    require(mesh is not None and (mesh.world, mesh.spatial, mesh.rank) ==
            (2, 2, cfg['rank']), 'expected rank {} of a (1, 2) mesh'.format(
                cfg['rank']))
    result = {'seen': seen, 'launches': launches,
              'route': dist.get_backend(mesh.group),
              'state': {name: {k: v.detach().cpu().clone() for k, v in
                               net.state_dict().items()}
                        for name, net in runner_networks(runner).items()}}
    result.update(spatial_checks(runner, cfg['data_dir']))
    if cfg.get('int8_state'):
      runner.gen.load_state_dict(torch.load(cfg['int8_state']))
      result['int8'] = int8_forward(
          runner, cfg.get('int8_dir') or cfg['data_dir'],
          '{} rank {}'.format(cfg['label'], cfg['rank']),
          cfg.get('int8_size'), cfg.get('int8_rows'))
    torch.save(result, cfg['out'])
  finally:
    dist.destroy_process_group()


def spatial_compare(label, one, ranks, one_launches):
  """Phase 23: both ranks against the one-process run at
  ``SPATIAL_BARS``; each rank launched each of K1's three passes as often
  as the one process launched K1, each of K1-bwd's as often as K1-bwd, K2
  f32 as often, and whole-image K1 and K1-bwd never."""
  from csmri_refinement_tpu_torch.utils.diagnostics import runner_networks
  loss_atol, param_atol = SPATIAL_BARS[label]
  worst = {'losses': 0.0, 'psnr': 0.0, 'metrics': 0.0, 'params': 0.0,
           'disc': 0.0, 'bn': 0.0}

  def over(got, want, atol, key, what):
    excess = abs(got - want) - SPATIAL_RTOL * abs(want)
    worst[key] = max(worst[key], abs(got - want))
    require(excess <= atol, '{} rank differs from one process in {}: '
            '{:.6g} vs {:.6g} (atol {})'.format(label, what, got, want, atol))

  k1, k1_bwd, k2 = one_launches
  want_launches = (0, 0) + (k1,) * 3 + (k1_bwd,) * 3 + (k2,)
  nets = {name: net.state_dict()
          for name, net in runner_networks(one[0]).items()}
  for rank, got in enumerate(ranks):
    require(got['launches'] == want_launches, '{} rank {} launched K1, '
            'K1-bwd, K1\'s passes, K1-bwd\'s passes, K2 f32 {} times; one '
            'process launched K1, K1-bwd, K2 f32 {} times'.format(
                label, rank, got['launches'], one_launches))
    for phase in ('train', 'val'):
      require(len(got['seen'][phase]) == len(one[1][phase]),
              label + ': epochs differ')
      for g, w in zip(got['seen'][phase], one[1][phase]):
        require(set(g) == set(w), label + ': recorded names differ')
        for k in w:
          if 'psnr' in k:
            over(g[k], w[k], SPATIAL_PSNR_ATOL, 'psnr', k)
          elif 'loss' in k:
            over(g[k], w[k], loss_atol, 'losses', k)
          else:
            over(g[k], w[k], SPATIAL_METRIC_ATOL, 'metrics', k)
    for name, want_state in nets.items():
      for k, w in want_state.items():
        if not w.is_floating_point():
          continue
        key, atol = ('bn', SPATIAL_BN_ATOL) if 'running_' in k else \
            ('disc', SPATIAL_DISC_ATOL) if name == 'discriminator' else \
            ('params', param_atol)
        g = got['state'][name][k].double()
        w = w.detach().cpu().double()
        excess = ((g - w).abs() - SPATIAL_RTOL * w.abs()).max().item()
        worst[key] = max(worst[key], (g - w).abs().max().item())
        require(excess <= atol, '{} rank {} differs from one process in '
                '{}.{} by {:.3e} (max |ref| {:.3e}, atol {})'.format(
                    label, rank, name, k, (g - w).abs().max().item(),
                    w.abs().max().item(), atol))
  return worst


def int8_tiles_check(ranks, spread=0):
  """Exact checks of the two ranks' int8 tiles, whatever float noise came
  before them: at every quantization (each chain's, each requant's) the
  ranks hold one scale, the group's, and each K3 launch's halo rows are
  the other rank's own rows of that launch's input, the ranks' own rows
  differing in count by ``spread`` at most (0: equal blocks). Returns the
  K3 launches checked."""
  a, b = (r['int8'] for r in ranks)
  for i, ((kind, got_a), (_, got_b)) in enumerate(zip(a['steps'],
                                                      b['steps'])):
    at = {'act': 2, 'K3': 1, 'requant': 1}[kind]
    require(torch.equal(got_a[at], got_b[at]), 'int8 step {} ({}): the '
            'ranks quantize with different scales'.format(i, kind))
  for i, ((t0, top0, bottom0), (t1, top1, bottom1)) in enumerate(
      zip(a['tiles'], b['tiles'])):
    h0 = t0.shape[1] - top0 - bottom0
    h1 = t1.shape[1] - top1 - bottom1
    require(top0 == bottom1 == 0 and torch.equal(
        t0.narrow(1, top0 + h0, bottom0), t1.narrow(1, top1, bottom0)) and
            torch.equal(t1.narrow(1, 0, top1), t0.narrow(1, h0 - top1, top1))
            and abs(h0 - h1) <= spread, 'K3 launch {}: a rank\'s halo rows '
            'are not the other rank\'s rows, or the ranks hold {} and {} '
            'rows'.format(i, h0, h1))
  return len(a['tiles'])


def int8_steps_compare(one, ranks):
  """The int8 mode's steps on the ranks against the one process's, step
  by step (``int8_forward``): one line each, and the first step that
  differs. Where a K3 launch's int8 input and scale equal the one
  process's on both ranks, its output must too, bit for bit: a halo or
  scale fault of the tiles shows there, whatever float noise came
  before; where a chain's float-prefix output does, its int8 image and
  the group's scale must."""
  kinds = [k for k, _ in one['steps']]
  for r, got in enumerate(ranks):
    require([k for k, _ in got['int8']['steps']] == kinds,
            'int8 rank {}: its steps {} are not the one process\'s {}'.format(
                r, [k for k, _ in got['int8']['steps']], kinds))
  first, lines = None, []
  for i, (kind, want) in enumerate(one['steps']):
    parts = [[] for _ in want]
    start = [0] * len(want)     # the ranks' rows of a map may differ by one
    for got in ranks:
      for j, t in enumerate(got['int8']['steps'][i][1]):
        w = want[j]
        if t.ndim == 4:         # rows: the rank's of the whole image
          w = w.narrow(1, start[j], t.shape[1])
          start[j] += t.shape[1]
        parts[j].append((t, w))
    same = [all(torch.equal(t, w) for t, w in p) for p in parts]

    def off(p):                 # elements that differ, on both ranks
      return sum(int((t != w).sum().item()) for t, w in p)

    def rel(p):
      return max((t.float() - w.float()).abs().max().item() /
                 max(w.float().abs().max().item(), 1e-30) for t, w in p)
    if kind == 'act':
      desc = ('chain {}\'s float-prefix output max |Δ| {:.3e} of max |ref|, '
              'int8 image {} elements off, scale {}'.format(
                  kinds[:i].count('act'), rel(parts[0]), off(parts[1]),
                  'equal' if same[2] else 'differs'))
      if same[0]:
        require(same[1] and same[2], 'int8: equal float-prefix outputs '
                'quantize differently on the ranks (step {})'.format(i))
    elif kind == 'K3':
      desc = ('K3 launch {}: int8 input {} elements off, scale {}, output '
              'max |Δ| {:.3e} of max |ref|'.format(
                  kinds[:i].count('K3'), off(parts[0]),
                  'equal' if same[1] else 'differs', rel(parts[2])))
      if same[0] and same[1]:
        require(same[2], 'K3 launch {} on halo tiles differs from the whole '
                'image on the same int8 input and scale'.format(
                    kinds[:i].count('K3')))
    else:
      desc = 'requant {}: int8 output {} elements off, scale {}'.format(
          kinds[:i].count('requant'), off(parts[0]),
          'equal' if same[1] else 'differs')
    if first is None and not all(same):
      first = i
    lines.append(('* ' if first == i else '  ') + desc)
  return first, lines


def int8_compare(one_runner, state, data_dir, ranks, line,
                 label='phase 23 (c)', size=None, rows=None):
  """Phase 23 (c): the two ranks' eval forward of the generator, f32 and
  int8, against this process's on the same weights (``state``, which the
  ranks loaded too) and batch, and the int8 mode's steps against each
  other (``int8_steps_compare``). Returns the ranks' K3 and requant
  launches (rank 0's) and the max errors of every K3 and requant launch
  against its plain version."""
  one_runner.gen.load_state_dict(torch.load(state))
  one = int8_forward(one_runner, data_dir, label + ' one process', size,
                     rows)
  for r, rank in enumerate(ranks):
    require(min(rank['int8']['launches']) > 0,
            'int8 rank {}: K3 or requant not launched'.format(r))
  require(min(one['launches']) > 0, 'int8: K3 or requant not launched')
  diffs = {}
  for mode in ('f32', 'int8'):
    got = torch.cat([r['int8'][mode] for r in ranks], dim=1)
    want = one[mode]
    require(got.shape == want.shape, '{} forward shapes {} and {}'.format(
        mode, tuple(got.shape), tuple(want.shape)))
    diffs[mode] = ((got - want).abs().max().item() /
                   want.abs().max().item(), torch.equal(got, want))
  first, lines = int8_steps_compare(one, ranks)
  print('{} eval forward of the 2-refinement generator at {}x{}, B '
        '{}, on two spatial ranks against one process: f32 {}, max |Δ| '
        '{:.3e} of max |ref|; int8 {}, max |Δ| {:.3e} of max |ref| (bar {}); '
        'K3, requant launches per rank {} and {} (one process {}), each '
        'within {:.3e} and {:g} int8 steps of its plain version; the int8 '
        'mode\'s steps against one process, the first that differs marked '
        '{} ({})'.format(
            label, rows or size or SCAR_SIZE, size or SCAR_SIZE,
            one['f32'].shape[0],
            'bit for bit' if diffs['f32'][1] else 'not bit for bit',
            diffs['f32'][0], 'bit for bit' if diffs['int8'][1] else
            'not bit for bit', diffs['int8'][0], SPATIAL_INT8_REL,
            ranks[0]['int8']['launches'], ranks[1]['int8']['launches'],
            one['launches'],
            max(r['int8']['errs'][0] for r in ranks),
            max(r['int8']['errs'][1] for r in ranks),
            '*' if first is not None else '(none differs)', line))
  for ln in lines:
    print('  ' + ln)
  print('  the ranks\' scales equal at every quantization and the halo rows '
        'of {} K3 launches the other rank\'s rows, exactly'.format(
            int8_tiles_check(ranks, 0 if rows is None else 1)))
  require(diffs['int8'][0] <= SPATIAL_INT8_REL,
          'the ranks\' int8 forward differs from one process by {:.3e} of '
          'max |ref| (bar {})'.format(diffs['int8'][0], SPATIAL_INT8_REL))
  errs = [r['int8']['errs'] for r in ranks] + [one['errs']]
  return (ranks[0]['int8']['launches'],
          (max(e[0] for e in errs), max(e[1] for e in errs)))


def dc_exchange_mb(moved):
  """MB the DC's two all-to-alls sent."""
  return sum(v for k, v in moved.items() if k.startswith('all_to_all') and
             k.endswith(('_rows_to_cols', '_cols_to_rows'))) / 1e6


def spatial_phase(data_dir, work, line, phase='phase 23', size=None,
                  int8=None, probe=True):
  """Phase 23: (a) the gloo probe; (b) 1-recnet (B = 20), 2-refinement
  (B = 5, its RecNet from (b)'s one-process checkpoint) and segmentation
  (B = 8) through the training CLI, 2 steps and 1 validation batch, once
  in this process and once on two spatial ranks sharing the card; ranks
  against the one process at ``SPATIAL_BARS``; each rank's DC pass and K2
  f32 launches against the one process's K1, K1-bwd and K2 f32 launches,
  each checked launch within its bar of the plain version; the passes'
  times, ms per step, peak GiB and the bytes each collective site moves,
  per rank; (c) the f32 and int8 eval forwards of the 2-refinement
  generator on the two ranks against one process (``int8_compare``).
  Returns the launches (rank 0's) and errors for the kernels
  line, with 1-recnet's rank-0 pass times. Phase 26 runs the same on a
  tree of ``size`` (``phase``, no probe: phase 23 ran it), with (c) on
  ``int8`` = (tree, its side, the rows kept of each image)."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  t0 = time.perf_counter()
  size = size or SCAR_SIZE
  int8_dir, int8_size, int8_rows = int8 or (data_dir, size, None)
  if probe:
    gloo_phase(line)
  total = {'k1': 0, 'k1_bwd': 0, 'k2_f32': 0, 'k3': 0, 'requant': 0,
           'k3_err': 0.0, 'requant_err': 0.0, 'dc_err': 0.0, 'dc_bwd_err': 0.0, 'f32_err': 0.0,
           'passes': {name: [0, 0.0, 0.0] for name in DC_PASSES},
           'pass_times': {}}
  configs = {'1-recnet': RECNET_CONFIG, 'segmentation': SEG_CONFIG}
  for label, overrides in SPATIAL_RUNS:
    t1 = time.perf_counter()
    if label == '2-refinement':
      best = glob.glob(os.path.join(work, 'spatial_one', '1-recnet_*',
                                    'best_loss_MSE', '*.ckpt'))
      require(len(best) == 1, 'expected one 1-recnet checkpoint')
      with open(os.path.join(REPO, 'configs', '2-refinement.json')) as f:
        conf_d = json.load(f)
      conf_d['generator_model']['pretrained_model']['pretrained_weights'] = \
          [best[0], 'model']
      configs[label] = os.path.join(work, 'spatial_2-refinement.json')
      with open(configs[label], 'w') as f:
        json.dump(conf_d, f)
    sync()
    dc_kernel.dc_cuda.launches = dc_kernel.dc_bwd_cuda.launches = 0
    conv_chain.conv_layer_f32_cuda.launches = 0
    one = dist_cli(configs[label], data_dir, os.path.join(work,
                                                          'spatial_one'),
                   overrides)
    one_launches = (dc_kernel.dc_cuda.launches,
                    dc_kernel.dc_bwd_cuda.launches,
                    conv_chain.conv_layer_f32_cuda.launches)
    outs = [os.path.join(work, 'spatial_{}_rank{}.pt'.format(label, r))
            for r in range(2)]
    int8_state = None
    if label == '2-refinement':    # (c)'s weights: the one process's
      int8_state = os.path.join(work, 'spatial_int8_generator.pt')
      torch.save(one[0].gen.state_dict(), int8_state)
    if DEVICE == 'cuda':      # the ranks share the card with this process
      torch.cuda.empty_cache()
    spawn_ranks('spatial-rank', {
        'config': configs[label], 'data_dir': data_dir, 'device': DEVICE,
        'size': size, 'overrides': overrides,
        'run_root': os.path.join(work, 'spatial_ranks'),
        'int8_state': int8_state, 'label': phase, 'int8_dir': int8_dir,
        'int8_size': int8_size, 'int8_rows': int8_rows},
                outs)
    ranks = [torch.load(o, weights_only=False) for o in outs]
    worst = spatial_compare(label, one, ranks, one_launches)
    k1, k1_bwd, k2 = one_launches
    path = {'1-recnet': (k1, k1_bwd), '2-refinement': (k1, k2),
            'segmentation': (k2,)}[label]
    require(min(path) > 0,
            label + ': a kernel of the path was not launched on the ranks')
    print('{} {} at {}^2, mesh {}, collectives {}: both ranks '
          'against one process: losses within {:.3e}, PSNR {:.3e} dB, other '
          'metrics {:.3e}, parameters {:.3e}, discriminator {:.3e}, BN '
          'statistics {:.3e}; launches per rank: each of K1\'s 3 passes {}, '
          'each of K1-bwd\'s {}, K2 f32 {}, whole-image K1 and K1-bwd 0 '
          '(one process: K1 {}, K1-bwd {}, K2 f32 {}); {:.1f} s'.format(
              phase, label, size, SPATIAL_MESH, ranks[0]['route'],
              worst['losses'], worst['psnr'], worst['metrics'],
              worst['params'], worst['disc'], worst['bn'], k1, k1_bwd, k2,
              k1, k1_bwd, k2, time.perf_counter() - t1))
    for r, got in enumerate(ranks):
      print('  rank {}: checked launches against their plain versions (max '
            '|kernel-plain|, and that over max |plain|, bar {}): {}; K2 f32 '
            '{} launches within {:.3e}; train step {:.3f} ms, peak {:.3f} GiB '
            'above the resident state; the tiles its convs read held {} to {} '
            'rows; per step the DC\'s all-to-alls send '
            '{:.2f} MB and it moves {} ({}; two ranks share one card: not a '
            'scaling number)'.format(
                r, PASS_REL, ', '.join('{} {} launches {:.3e} ({:.3e})'.format(
                    DC_PASSES[n][0], c, e, rel) for n, (c, e, rel) in
                    got['passes'].items()),
                got['k2_checked'], got['f32_err'], got['ms'], got['peak'],
                got['conv_rows'][1], got['conv_rows'][0],
                dc_exchange_mb(got['moved']), ', '.join(
                    '{} {:.2f} MB'.format(k, v / 1e6) for k, v in
                    sorted(got['moved'].items())), line))
      for name, t in got['times'].items():
        print('  rank {} {} on {}: {:.4f} ms, plain {:.4f} ms, library {}, '
              'bound {:.4f} ms ({}) ({})'.format(
                  r, DC_PASSES[name][0], tuple(t['shape']), t['ms'],
                  t['plain_ms'], 'none' if t['library_ms'] is None else
                  '{:.4f} ms'.format(t['library_ms']), t['bound_ms'],
                  t['bound_by'], line))
    host = next(iter(DataLoader(load_dataset(one[0].conf, data_dir,
                                             'ScarSeg', 'train'),
                                one[0].conf.batch_size)))
    one_batch = one[0].preparer.prepare_train(
        torch.Generator(device=DEVICE).manual_seed(SEED), host)
    print('  one process: train step {:.3f} ms, peak {:.3f} GiB ({})'.format(
        step_wall_ms(one[0], one_batch), step_peak_gib(one[0], one_batch)
        if DEVICE == 'cuda' else 0.0, line))
    del one_batch
    if label == '2-refinement':
      (k3, requant), (k3_err, rq_err) = int8_compare(
          one[0], int8_state, int8_dir, ranks, line, phase + ' (c)',
          int8_size, int8_rows)
      total['k3'] += k3
      total['requant'] += requant
      total['k3_err'], total['requant_err'] = k3_err, rq_err
    if label == '1-recnet':
      total['pass_times'] = ranks[0]['times']
    total['k1'] += k1
    total['k1_bwd'] += k1_bwd
    total['k2_f32'] += k2
    total['f32_err'] = max([total['f32_err']] +
                           [got['f32_err'] for got in ranks])
    for name in DC_PASSES:
      count, err, rel = total['passes'][name]
      total['passes'][name] = [
          count + ranks[0]['passes'][name][0],
          max([err] + [got['passes'][name][1] for got in ranks]),
          max([rel] + [got['passes'][name][2] for got in ranks])]
    del one, ranks
  for name, (_, err, _) in total['passes'].items():
    key = 'dc_bwd_err' if DC_PASSES[name][2] else 'dc_err'
    total[key] = max(total[key], err)
  print('{}: {:.1f} s wall'.format(phase, time.perf_counter() - t0))
  return total

# Phase 26: spatial meshes whose per-rank rows a stride or a pool splits,
# as JAX's GSPMD runs them: the paper's three configs at BraTS's 240×240
# slice matrix on the two ranks of phase 23, 120 rows a rank, which the
# discriminator's fourth stride and the segmentation U-Net's fourth pool
# split (15 rows → 8 and 7); the generator's eval forward on images of 244
# rows, whose second pool splits 61 rows a rank, and 256 columns: the int8
# mode quantizes a chain only where W / P is a multiple of 16 (JAX's
# ``layer_fusable``), which no side of 4 · odd rows meets, so at 244² it
# would run every chain in float; and K1's passes on a non-square image
# whose width two ranks split unequally.
UNEVEN_SIZE = 240
UNEVEN_INT8_SIZE, UNEVEN_INT8_ROWS = 256, 244
# K1's passes on two ranks: column blocks of 119 and 118 (H on the
# mixed-radix route, W dense), and of 120 (both axes mixed-radix)
UNEVEN_DC_SHAPES = ((2, 240, 237), (2, 240, 240))


def uneven_dc_check(line):
  """Phase 26 (a): K1's and K1-bwd's passes as two ranks run them on each
  of ``UNEVEN_DC_SHAPES`` (rows 0-119 and 120-239, then column blocks of
  ``mesh.col_bounds``), the exchanges as copies in this process, against
  the whole-image K1 and K1-bwd on the same inputs. Returns the largest
  |Δ| of the forward and of the backward."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  errs = [0.0, 0.0]
  for b, h, w in UNEVEN_DC_SHAPES:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 26 + w)
    x, k0, g = (torch.randn((b, h, w, 2), device=DEVICE, generator=gen)
                for _ in range(3))
    mask = (torch.rand((b, h, w, 1), device=DEVICE, generator=gen) > 0.6)
    mask = mask.float()
    k0 = k0 * mask
    rows = [slice(0, h // 2), slice(h // 2, h)]
    cols = [slice(*mesh_lib.col_bounds(w, 2).block(r)) for r in range(2)]

    def passes(t, fft, col, ifft):
      ranks_rows = torch.cat([fft(t[:, r].contiguous(), h) for r in rows],
                             1)
      ranks_cols = torch.cat([col(ranks_rows[:, :, c].contiguous(), c)
                              for c in cols], 2)
      return torch.cat([ifft(ranks_cols[:, r].contiguous(), h)
                        for r in rows], 1)
    with deterministic():
      got = passes(x, dc_kernel.dc_rows_fft_cuda,
                   lambda t, c: dc_kernel.dc_cols_cuda(
                       t, k0[:, :, c].contiguous(),
                       mask[:, :, c].contiguous(), w),
                   dc_kernel.dc_rows_ifft_cuda)
      want = dc_kernel.dc_cuda(x, k0, mask)
      got_bwd = passes(g, dc_kernel.dc_bwd_rows_fft_cuda,
                       lambda t, c: dc_kernel.dc_bwd_cols_cuda(
                           t, mask[:, :, c].contiguous(), w),
                       dc_kernel.dc_bwd_rows_ifft_cuda)
      want_bwd = dc_kernel.dc_bwd_cuda(g, mask)
      sync()
    for i, (what, a, ref) in enumerate((('K1', got, want),
                                        ('K1-bwd', got_bwd, want_bwd))):
      err = (a - ref).abs().max().item()
      rel = err / max(ref.abs().max().item(), 1e-30)
      require(torch.equal(a, ref), 'phase 26 (a) {}\'s passes on column '
              'blocks {} and {} differ from the whole image by {:.3e} of its '
              'max |value|'.format(what, cols[0].stop, w - cols[0].stop, rel))
      print('phase 26 (a) {}\'s three passes on {} as two ranks run them '
            '(rows {} and {}, column blocks {} and {}; H on the {} route, W '
            'on the {}) against the whole-image {}: {}, max |Δ| {:.3e} '
            '({})'.format(what, (b, h, w), h // 2, h - h // 2, cols[0].stop,
                          w - cols[0].stop, *dc_kernel.dc_route(h, w), what,
                          'bit for bit' if torch.equal(a, ref) else
                          'not bit for bit', err, line))
      errs[i] = max(errs[i], err)
  return errs


def uneven_phase(line, probe=False):
  """Phase 26: (a) ``uneven_dc_check``; (b) phase 23's runs, checks and
  launch holds (``spatial_phase``) on a ScarSeg-format tree at
  ``UNEVEN_SIZE`` on two ranks, and its (c) on the first
  ``UNEVEN_INT8_ROWS`` rows of a tree at ``UNEVEN_INT8_SIZE``. The trees
  are removed after.
  Returns ``spatial_phase``'s totals with (a)'s errors folded in."""
  from csmri_refinement_tpu_torch.data import datasets
  from csmri_refinement_tpu_torch.ops import dc_kernel
  t0 = time.perf_counter()
  os.makedirs(GAN_DIR, exist_ok=True)
  work = tempfile.mkdtemp(prefix='uneven_', dir=GAN_DIR)
  side = datasets.IMAGE_SIZE
  try:
    dc_err, dc_bwd_err = uneven_dc_check(line)
    data_dir, int8_dir = (os.path.join(work, d) for d in ('data', 'int8'))
    datasets.write_scarseg_phantoms(data_dir, UNEVEN_SIZE, SCAR_SLICES,
                                    seed=SEED)
    datasets.write_scarseg_phantoms(int8_dir, UNEVEN_INT8_SIZE, SCAR_SLICES,
                                    seed=SEED)
    datasets.IMAGE_SIZE = UNEVEN_SIZE
    total = spatial_phase(data_dir, work, line, 'phase 26', UNEVEN_SIZE,
                          (int8_dir, UNEVEN_INT8_SIZE, UNEVEN_INT8_ROWS),
                          probe)
  finally:
    datasets.IMAGE_SIZE = side
    shutil.rmtree(work, ignore_errors=True)
  total['dc_err'] = max(total['dc_err'], dc_err)
  total['dc_bwd_err'] = max(total['dc_bwd_err'], dc_bwd_err)
  # the one process's DCs are whole 240² images: a route is a function of
  # the shape, and there both axes take the mixed-radix route
  routes = dc_kernel.dc_route(UNEVEN_SIZE, UNEVEN_SIZE)
  require(routes == ('mixed', 'mixed') and total['k1'] > 0 and
          total['k1_bwd'] > 0,
          'phase 26: K1 {}, K1-bwd {} launches at {}², routes {}: expected '
          'launches on the mixed-radix route'.format(
              total['k1'], total['k1_bwd'], UNEVEN_SIZE, routes))
  total['k1_mixed'], total['k1_bwd_mixed'] = total['k1'], total['k1_bwd']
  print('phase 26 (b): one process launched K1 {} and K1-bwd {} times, all '
        'on the mixed-radix route'.format(total['k1'], total['k1_bwd']))
  print('phase 26 with (a) and its trees: {:.1f} s wall'.format(
      time.perf_counter() - t0))
  return total


def merge_spatial(a, b):
  """Phase 23's and 26's totals for the kernels line: launches added,
  errors the larger, the pass times phase 23's, the mixed-radix route's
  launches phase 26's."""
  out = dict(a)
  for key in ('k1', 'k1_bwd', 'k2_f32', 'k3', 'requant'):
    out[key] = a[key] + b[key]
  out['k1_mixed'], out['k1_bwd_mixed'] = b['k1_mixed'], b['k1_bwd_mixed']
  for key in ('dc_err', 'dc_bwd_err', 'f32_err', 'k3_err', 'requant_err'):
    out[key] = max(a[key], b[key])
  out['passes'] = {name: [a['passes'][name][0] + b['passes'][name][0],
                          max(a['passes'][name][1], b['passes'][name][1]),
                          max(a['passes'][name][2], b['passes'][name][2])]
                   for name in a['passes']}
  return out


# Phase 24: the U-Net's remaining options at full width: the up-sampling
# modes bilinear and nn-biresize-conv (the 2× bilinear up-sample as a
# two-tap stencil, ``models/unet.py::_bilinear_up2``), use_refinement and
# encoder_features, and the noisy DC, centred FFTs and k-space crop.
REFINE_CONFIG = os.path.join(REPO, 'configs', '2-refinement.json')
NEW_MODES = ('nn-biresize-conv', 'bilinear')
OPTION_MODES = ('nn-resize-conv',) + NEW_MODES   # the first: phase 7's mode
OPT_GAN_SIZE = 512       # (b)'s timed steps
OPT_SEG_BATCH = 8        # (c)
OPT_SEG_FEATURES = [0, 2, 4]
OPT_SPATIAL_SIZE = 256   # (d)
OPT_DC_SIZE, OPT_DC_BATCH = 512, 4    # (e)
OPT_NOISE = 0.1


def with_upsampling(conf_d, mode):
  """``conf_d`` with its generator's U-Net in up-sampling ``mode``: the
  whole ``generator_model`` section replaced as ``train.py --conf
  'generator_model={...}'`` replaces it."""
  from csmri_refinement_tpu_torch.utils.config import Configuration
  gen = copy.deepcopy(conf_d['generator_model'])
  gen['learnable_model']['upsampling_mode'] = mode
  conf = Configuration.from_dict(conf_d)
  conf.update({'generator_model': json.dumps(gen)})
  return dict(conf_d, generator_model=conf.generator_model)


def refinement_generator(mode, dtype, device):
  """``configs/2-refinement.json``'s generator with its U-Net in ``mode``,
  seeded weights (the RecNet's too: no checkpoint is read), the wrapper's
  scale at 0.5 (at its zero init the U-Net would not reach the output),
  in eval mode on ``device``."""
  from csmri_refinement_tpu_torch.models import construct_model
  with open(REFINE_CONFIG) as f:
    conf_d = with_upsampling(json.load(f), mode)
  model = construct_model(dict(conf_d['generator_model']), dtype)
  model.init_weights(torch.Generator().manual_seed(SEED))
  with torch.no_grad():
    model.scale.fill_(0.5)
  return model.to(device).eval()


def chain_layer_count(net):
  from csmri_refinement_tpu_torch.models.unet import ConvEncodeUnit
  return sum(m.num_layers for m in net.modules()
             if isinstance(m, ConvEncodeUnit))


def mode_forward_phase(line):
  """Phase 24 (a): the serving forward of each new mode at 256², B = 32,
  bf16, counters around 3 forwards (3 K1 each, K2 bf16 once per chain
  layer), every K2 launch of one forward against its plain version, the
  card's f32 forward at B = 2 against the CPU's (phase 6's bars); ms per
  forward beside nn-resize-conv in turns; the bilinear up-sample's device
  time at the two decoders' shapes beside ``F.interpolate``'s."""
  from csmri_refinement_tpu_torch.models import unet as unet_lib
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  from csmri_refinement_tpu_torch.ops import undersample as us
  out = {'k1': 0, 'k2_bf16': 0, 'k2_err': 0.0}
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
  gt = torch.rand(BATCH, SIZE, SIZE, device=DEVICE, generator=gen)
  batch = us.undersample_batch(gen, gt, 'varden', 8)
  args = [batch[k] for k in ('inp', 'kspace', 'mask')]
  models = {}
  for mode in OPTION_MODES:
    model = refinement_generator(mode, torch.bfloat16, DEVICE)
    models[mode] = model
    if mode not in NEW_MODES:
      continue
    expected = chain_layer_count(model)
    n_forwards = 3
    sync()
    dc_kernel.dc_cuda.launches = 0
    conv_chain.conv_layer_cuda.launches = 0
    with torch.inference_mode():
      for _ in range(n_forwards):
        pred = model(*args)['pred']
        sync()
    k1, k2 = dc_kernel.dc_cuda.launches, conv_chain.conv_layer_cuda.launches
    print('phase 24 (a) {} forward {}^2 bf16 B{}: {} forwards, K1 launches '
          '{}, K2 bf16 launches {} ({} chain layers a forward)'.format(
              mode, SIZE, BATCH, n_forwards, k1, k2, expected))
    require(k1 == 3 * n_forwards, mode + ': expected 3 K1 launches a forward')
    require(k2 == expected * n_forwards, mode + ': expected one K2 launch '
            'per chain layer a forward')
    require(tuple(pred.shape) == (BATCH, SIZE, SIZE, 2) and
            bool(torch.isfinite(pred.float()).all()),
            mode + ': pred is not finite or of the wrong shape')
    calls = chain_launches(model, *args)
    require(all(c[0].dtype == torch.bfloat16 for c in calls),
            mode + ': the bf16 forward left the bf16 route')
    out['k2_err'] = max(out['k2_err'], hold_launches(
        mode + ' eval', calls, expected, BATCH, SIZE))
    del calls
    out['k1'] += k1
    out['k2_bf16'] += k2
    # the f32 forward, card against CPU (phase 6's bars)
    cpu = refinement_generator(mode, torch.float32, 'cpu')
    card = copy.deepcopy(cpu).to(DEVICE)
    cgen = torch.Generator().manual_seed(SEED + 2)
    cbatch = us.undersample_batch(cgen, torch.rand(2, SIZE, SIZE,
                                                   generator=cgen),
                                  'varden', 8)
    cargs = [cbatch[k] for k in ('inp', 'kspace', 'mask')]
    with torch.inference_mode():
      want = cpu(*cargs)
      got = card(*[a.to(DEVICE) for a in cargs])
      sync()
    for key in ('pred', 'prescaled_refinement'):
      err = (got[key].cpu() - want[key]).abs().max().item()
      print('phase 24 (a) {} f32 {}: max|card-CPU| {:.3e} (max|ref| {:.3e}, '
            'tol {})'.format(mode, key, err, want[key].abs().max().item(),
                             E2E_ATOL))
      require(err <= E2E_ATOL, mode + ': the f32 forward differs between '
              'card and CPU in ' + key)
    p_card = psnr(got['pred'].cpu(), cbatch['target'])
    p_cpu = psnr(want['pred'], cbatch['target'])
    print('phase 24 (a) {} f32 PSNR: card {:.4f} dB, CPU {:.4f} dB'.format(
        mode, p_card, p_cpu))
    require(abs(p_card - p_cpu) < PSNR_TOL_DB, mode + ': PSNR differs')
    del cpu, card
  ms = {mode: [] for mode in OPTION_MODES}
  with torch.inference_mode():
    for mode in OPTION_MODES + OPTION_MODES[::-1]:
      ms[mode].append(timed_ms(lambda: models[mode](*args), iters=3,
                               warmup=1))
  for mode in OPTION_MODES:
    print('phase 24 (a) forward {}^2 bf16 B{} {}: {:.3f} / {:.3f} ms, {:.1f} '
          'slices/s (in turns with the other modes; {}: phase 7\'s mode) '
          '({})'.format(SIZE, BATCH, mode, *ms[mode],
                        2 * BATCH / sum(ms[mode]) * 1e3, OPTION_MODES[0],
                        line))
  out['fwd_ms'] = {mode: min(v) for mode, v in ms.items()}
  del models
  # the bilinear up-sample at the decoders' inputs, against the library
  for name, size, cin in (('decode_0', SIZE // 4, 128),
                          ('decode_1', SIZE // 2, 64)):
    x = torch.randn(BATCH, size, size, cin, device=DEVICE,
                    dtype=torch.bfloat16)
    x_cl = x.permute(0, 3, 1, 2)             # NCHW view, channels-last
    lib = lambda: F.interpolate(x_cl, scale_factor=2, mode='bilinear',
                                align_corners=False)
    with torch.inference_mode():
      got = unet_lib._bilinear_up2(x).float()
      want = lib().permute(0, 2, 3, 1).float()
      err = (got - want).abs().max().item()
      ref = want.abs().max().item()
      st_ms = graph_ms(lambda: unet_lib._bilinear_up2(x))
      lib_ms = graph_ms(lib)
    # 6 operations per output (two 2-tap passes), 4 outputs per input;
    # bf16 in once, 4× out once
    b_ms, by = bound(24 * x.numel(), 10 * x.numel(), BF16_FLOPS)
    require(err <= BF16_REL_TOL * ref, 'the bilinear stencil differs from '
            'F.interpolate at ' + name)
    print('phase 24 (a) bilinear up-sample {} {}^2->{}^2 C{} B{} bf16: '
          'stencil {:.4f} ms, F.interpolate {:.4f} ms, bound {:.4f} ms ({}), '
          'max|diff| {:.3e} of max {:.3e} ({})'.format(
              name, size, 2 * size, cin, BATCH, st_ms, lib_ms, b_ms, by, err,
              ref, line))
  return out


def gan_deterministic_phase():
  """Phase 24 (b): two card GAN updates of the nn-biresize-conv generator
  from one seeded state at 256², B = 5, under
  ``torch.use_deterministic_algorithms(True)`` (errors, not warnings) and
  cuDNN's deterministic convolutions: no op raises, and every parameter,
  statistic and loss of the two runs is equal bit for bit."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  from csmri_refinement_tpu_torch.training.adversarial_runner import (
      AdversarialRunner)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  from csmri_refinement_tpu_torch.utils.diagnostics import runner_networks
  conf = Configuration.from_dict(with_upsampling(synthetic_refinement_conf(
      SIZE, GAN_BATCH, GAN_BATCH, GAN_BATCH), 'nn-biresize-conv'))
  gt, mask = gan_batches(conf, 1, SIZE)[0]
  batch = us.undersample_batch(None, gt.to(DEVICE),
                               fixed_mask=mask.to(DEVICE))
  runs = []
  torch.use_deterministic_algorithms(True, warn_only=False)
  torch.backends.cudnn.deterministic = True
  try:
    for _ in range(2):
      runner = AdversarialRunner(conf, 'train', DEVICE)
      losses = runner.train_batch(batch)[0]
      sync()
      runs.append(({k: v.item() for k, v in losses.items()},
                   {'{}.{}'.format(n, k): v.detach().clone() for n, net in
                    runner_networks(runner).items()
                    for k, v in net.state_dict().items()}))
      del runner
  finally:
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
  (loss_a, state_a), (loss_b, state_b) = runs
  differ = [k for k in state_a if not torch.equal(state_a[k], state_b[k])]
  print('phase 24 (b) nn-biresize-conv GAN update {}^2 B{}, deterministic '
        'algorithms (warn_only=False): no op raised; two runs: losses {} and '
        '{}, {} of {} state tensors differ'.format(
            SIZE, GAN_BATCH, loss_a, loss_b, len(differ), len(state_a)))
  require(loss_a == loss_b and not differ,
          'two deterministic GAN updates differ: ' + ', '.join(differ[:5]))


def gan_mode_timings(line):
  """Phase 24 (b): ms per GAN step at 512², B = 5, TF32 off, in f32 and
  with ``train_dtype: bfloat16``, nn-resize-conv (phase 20's mode) and
  nn-biresize-conv in turns."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  from csmri_refinement_tpu_torch.training.adversarial_runner import (
      AdversarialRunner)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  size = OPT_GAN_SIZE
  for dtype in (None, 'bfloat16'):
    runners, batch = {}, None
    for mode in OPTION_MODES[:2]:
      conf_d = with_upsampling(synthetic_refinement_conf(
          size, GAN_BATCH, GAN_BATCH, GAN_BATCH), mode)
      if dtype:
        conf_d['train_dtype'] = dtype
      conf = Configuration.from_dict(conf_d)
      runners[mode] = AdversarialRunner(conf, 'train', DEVICE)
      if batch is None:
        gt, mask = gan_batches(conf, 1, size)[0]
        batch = us.undersample_batch(None, gt.to(DEVICE),
                                     fixed_mask=mask.to(DEVICE))
    ms = {mode: [] for mode in runners}
    for mode in OPTION_MODES[:2] + OPTION_MODES[1::-1]:
      ms[mode].append(timed_ms(lambda: runners[mode].train_batch(batch),
                               iters=3, warmup=1))
    for mode, v in ms.items():
      print('phase 24 (b) GAN step {}^2 B{} {} TF32 off, {}: {:.3f} / {:.3f} '
            'ms, {:.1f} slices/s (in turns) ({})'.format(
                size, GAN_BATCH, dtype or 'f32', mode, *v,
                2 * GAN_BATCH / sum(v) * 1e3, line))
    del runners


def seg_features_phase(line):
  """Phase 24 (c): ``configs/3-train-segmentation-unet.json``'s U-Net with
  ``use_refinement`` and ``encoder_features`` [0, 2, 4], eval f32 at 256²,
  B = 8, seeded weights: the K2 f32 launches of a forward counted (one per
  chain layer), each held to its plain version; ``pred`` and every feature
  on the card within E2E_ATOL of max |ref| of the CPU's."""
  from csmri_refinement_tpu_torch.models import construct_model
  from csmri_refinement_tpu_torch.ops import conv_chain
  with open(SEG_CONFIG) as f:
    section = json.load(f)['model']
  section.update(use_refinement=True, encoder_features=OPT_SEG_FEATURES)
  cpu = construct_model(section)
  cpu.init_weights(torch.Generator().manual_seed(SEED))
  cpu.eval()
  card = copy.deepcopy(cpu).to(DEVICE)
  b = OPT_SEG_BATCH
  x = torch.randn(b, SIZE, SIZE, section['num_inputs'],
                  generator=torch.Generator().manual_seed(SEED + 24))
  xc = x.to(DEVICE)
  expected = chain_layer_count(card)
  sync()
  conv_chain.conv_layer_f32_cuda.launches = 0
  with torch.inference_mode():
    got = card(xc)
    sync()
  k2 = conv_chain.conv_layer_f32_cuda.launches
  require(k2 == expected, 'segmentation U-Net with features: expected {} K2 '
          'f32 launches, got {}'.format(expected, k2))
  with torch.inference_mode():
    want = cpu(x)
  err = hold_launches('segmentation features', chain_launches(card, xc),
                      expected, b, SIZE)
  require(sorted(got) == ['features', 'pred'] and
          len(got['features']) == len(OPT_SEG_FEATURES),
          'expected pred and {} features'.format(len(OPT_SEG_FEATURES)))
  worst = 0.0
  for name, g, w in [('pred', got['pred'], want['pred'])] + [
      ('feature {}'.format(i), gf, wf) for i, gf, wf in zip(
          OPT_SEG_FEATURES, got['features'], want['features'])]:
    rel = (g.cpu() - w).abs().max().item() / w.abs().max().item()
    print('phase 24 (c) segmentation U-Net {} {}: max|card-CPU| / max|ref| '
          '{:.3e} (tol {})'.format(name, tuple(g.shape), rel, E2E_ATOL))
    require(g.shape == w.shape and rel <= E2E_ATOL, 'the card\'s {} differs '
            'from the CPU\'s'.format(name))
    worst = max(worst, rel)
  with torch.inference_mode():
    fwd = timed_ms(lambda: card(xc), iters=3, warmup=1)
  print('phase 24 (c) segmentation U-Net eval f32 {}^2 B{} with '
        'use_refinement and encoder_features {}: {} K2 f32 launches, worst '
        'card-CPU {:.3e}, {:.3f} ms a forward ({})'.format(
            SIZE, b, OPT_SEG_FEATURES, k2, worst, fwd, line))
  return {'k2_f32': k2, 'f32_err': err}


def options_spatial_phase(work, line):
  """Phase 24 (d): the GAN with nn-biresize-conv (Synthetic 256², B = 5,
  one update and one validation batch) through the training CLI in this
  process and on two spatial gloo ranks sharing the card (phase 23's
  ``--spatial-rank`` children): both ranks within
  ``SPATIAL_BARS['2-refinement']`` of the one process, each rank's launches
  equal to its, each checked launch held to its plain version; the ms per
  step per rank and the bytes the bilinear up-sample's halo moves."""
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  size = OPT_SPATIAL_SIZE
  conf_d = with_upsampling(synthetic_refinement_conf(
      size, GAN_BATCH, GAN_BATCH, GAN_BATCH), 'nn-biresize-conv')
  config = os.path.join(work, 'options_spatial.json')
  with open(config, 'w') as f:
    json.dump(conf_d, f)
  overrides = ['num_epochs=1']
  sync()
  dc_kernel.dc_cuda.launches = dc_kernel.dc_bwd_cuda.launches = 0
  conv_chain.conv_layer_f32_cuda.launches = 0
  one = dist_cli(config, work, os.path.join(work, 'options_one'), overrides)
  one_launches = (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches,
                  conv_chain.conv_layer_f32_cuda.launches)
  outs = [os.path.join(work, 'options_rank{}.pt'.format(r)) for r in range(2)]
  if DEVICE == 'cuda':
    torch.cuda.empty_cache()
  spawn_ranks('spatial-rank', {
      'config': config, 'data_dir': work, 'device': DEVICE, 'size': size,
      'overrides': overrides, 'run_root': os.path.join(work, 'options_ranks')},
              outs)
  ranks = [torch.load(o, weights_only=False) for o in outs]
  worst = spatial_compare('2-refinement', one, ranks, one_launches)
  k1, _, k2 = one_launches       # each of K1's passes k1 times per rank
  require(k1 > 0 and k2 > 0, 'nn-biresize-conv GAN: a kernel of the path '
          'was not launched on the ranks')
  print('phase 24 (d) nn-biresize-conv GAN at {}^2, mesh {}: both ranks '
        'against one process: losses within {:.3e}, parameters {:.3e}, '
        'discriminator {:.3e}, BN statistics {:.3e}; launches per rank: '
        'each of K1\'s passes {}, K2 f32 {} (one process: K1 {}, K2 f32 '
        '{})'.format(size, SPATIAL_MESH, worst['losses'], worst['params'],
                     worst['disc'], worst['bn'], k1, k2, k1, k2))
  dc_err = 0.0
  for r, got in enumerate(ranks):
    halo = got['moved'].get('all_gather in _bilinear_up2', 0)
    require(halo > 0, 'rank {}: the bilinear up-sample took no halo'.format(r))
    dc_err = max([dc_err] + [e for n, (_, e, _) in got['passes'].items()
                             if not DC_PASSES[n][2]])
    print('  rank {}: checked launches {} (max |kernel-plain| of K1\'s '
          'passes {:.3e}, each within {} of max |plain|; K2 f32 {} launches '
          '{:.3e}); '
          'train step {:.3f} ms, peak {:.3f} GiB; the bilinear up-sample\'s '
          'halo moves {:.3f} MB a step forward (its backward the same, '
          'within _HaloRows.backward); all sites: {} ({}; two ranks share '
          'one card)'.format(
              r, {DC_PASSES[n][0]: c for n, (c, _, _) in
                  got['passes'].items()},
              dc_err, PASS_REL, got['k2_checked'], got['f32_err'], got['ms'],
              got['peak'], halo / 1e6,
              ', '.join('{} {:.2f} MB'.format(k, v / 1e6) for k, v in
                        sorted(got['moved'].items())), line))
  return {'k1': k1, 'k2_f32': k2, 'dc_err': dc_err,
          'f32_err': max(r['f32_err'] for r in ranks)}


def kspace_utils_phase(line):
  """Phase 24 (e): at 512², B = 4, the noisy DC, ``fft2c``/``ifft2c`` and
  ``center_crop_in_kspace`` on the card against the CPU within F32_ATOL;
  the noisy DC's device time beside K1's on the same inputs."""
  from csmri_refinement_tpu_torch.ops import dc, dc_kernel, fft, masks
  from csmri_refinement_tpu_torch.ops import undersample as us
  b, n = OPT_DC_BATCH, OPT_DC_SIZE
  gen = torch.Generator().manual_seed(SEED + 25)
  x = torch.randn(b, n, n, 2, generator=gen)
  mask = masks.cartesian_mask(gen, (b, n, n), 8)[..., None].contiguous()
  k0 = torch.randn(b, n, n, 2, generator=gen) * mask
  img = torch.rand(b, n, n, generator=gen)
  xd, k0d, md = x.to(DEVICE), k0.to(DEVICE), mask.to(DEVICE)
  xc = fft.unpack_complex(x)
  checks = (
      ('noisy DC', lambda *t: dc.data_consistency(*t, noise_lvl=OPT_NOISE),
       (x, k0, mask)),
      ('fft2c', fft.fft2c, (xc,)),
      ('ifft2c', fft.ifft2c, (xc,)),
      ('center_crop_in_kspace', lambda t: torch.stack(
          [us.center_crop_in_kspace(i, n // 2) for i in t]), (img,)))
  for name, fn, args in checks:
    want = fn(*args)
    got = fn(*[a.to(DEVICE) for a in args])
    sync()
    err = (got.cpu() - want).abs().max().item()
    print('phase 24 (e) {} {}x{}^2: max|card-CPU| {:.3e} (max|ref| {:.3e}, '
          'tol {})'.format(name, b, n, err, want.abs().max().item(),
                           F32_ATOL))
    require(err <= F32_ATOL, name + ' differs between card and CPU')
  noisy_ms = graph_ms(lambda: dc.data_consistency(xd, k0d, md,
                                                  noise_lvl=OPT_NOISE))
  k1_ms = graph_ms(lambda: dc_kernel.dc_cuda(xd, k0d, md))
  print('phase 24 (e) DC {}x{}^2: noisy (torch.fft composition) {:.4f} ms, '
        'K1 (noiseless) {:.4f} ms ({})'.format(b, n, noisy_ms, k1_ms, line))


def unet_options_phase(line):
  """Phase 24: (a)-(e). Returns the launches and errors for the kernels
  line."""
  t0 = time.perf_counter()
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  os.makedirs(GAN_DIR, exist_ok=True)
  work = tempfile.mkdtemp(prefix='options_', dir=GAN_DIR)
  try:
    fwd = mode_forward_phase(line)
    t1 = time.perf_counter()
    gan_parity_phase('nn-biresize-conv')
    gan_deterministic_phase()
    gan_mode_timings(line)
    t2 = time.perf_counter()
    seg = seg_features_phase(line)
    t3 = time.perf_counter()
    spatial = options_spatial_phase(work, line)
    t4 = time.perf_counter()
    kspace_utils_phase(line)
  finally:
    shutil.rmtree(work, ignore_errors=True)
  print('phase 24: (a) {:.1f} s, (b) {:.1f} s, (c) {:.1f} s, (d) {:.1f} s, '
        '(e) {:.1f} s; {:.1f} s wall'.format(
            t1 - t0, t2 - t1, t3 - t2, t4 - t3, time.perf_counter() - t4,
            time.perf_counter() - t0))
  return {'k1': fwd['k1'] + spatial['k1'], 'k2_bf16': fwd['k2_bf16'],
          'k2_f32': seg['k2_f32'] + spatial['k2_f32'],
          'k2_err': fwd['k2_err'], 'dc_err': spatial['dc_err'],
          'f32_err': max(seg['f32_err'], spatial['f32_err'])}


# Phase 25: the port's benchmark command (``csmri_refinement_tpu_torch.bench``)
BENCH_SIZE, BENCH_BATCH = 256, 4      # (a)'s in-process forwards
BENCH_SMALL = 48                      # a side that is no power of two
# Launches per bench forward: K1, K2 bf16, K2 f32, K3 conv, K3 requant.
BENCH_LAUNCHES = {'bf16': (3, 10, 0, 0, 0), 'f32': (3, 0, 10, 0, 0),
                  'int8': (3, 3, 0, 7, 2)}
BENCH_BIG, BENCH_BIG_BATCH = 512, 128  # the default 512² row's forward
BENCH_TIMEOUT_S = 600
# The command's runs: (label, arguments, extra rows expected). The default
# run's rows: batch-1 latency at 256² and 512², two rows for each of the
# four training batches, the 512² row. Every run times 2 forwards a pass
# after 1 of warm-up (10 and 3 by default) and the GAN rows 2 steps, to
# keep the phase short.
BENCH_RUNS = (
    ('default', ['--latency', '--components', '--train', '--train-steps',
                 '2', '--iters', '2', '--warmup', '1'], 11),
    ('int8', ['--dtype', 'int8', '--iters', '2', '--warmup', '1'], 1),
    ('f32', ['--dtype', 'f32', '--iters', '2', '--warmup', '1'], 1),
    ('48', ['--image-size', str(BENCH_SMALL), '--batch-size', '4',
            '--extra-sizes'], 0),
)


def hold_int8_launches(label, conv_calls, requant_calls):
  """Each K3 conv launch within ``int8_gate``'s bar of its plain version on
  the same inputs, each requant launch within one int8 step of its plain
  version (a tie may round the other way) at no more than INT8_MAX_SHARE
  of the elements, its scales within float noise. Returns (conv, requant)
  max errors."""
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  conv_err = requant_err = 0.0
  for args, (y, _) in conv_calls:
    want, _ = cc.conv_layer_int8_plain(*args)
    diff = (y.float() - want.float()).abs()
    ref = want.float().abs().max().item()
    off = int((diff > INT8_NOISE * ref).sum().item())
    require(y.shape == want.shape and y.dtype == want.dtype and
            diff.max().item() <= INT8_STEP * ref and
            off <= INT8_MAX_SHARE * diff.numel(),
            'K3 {} launch {} differs from its plain version ({:.3e} of '
            'max|ref| {:.3e}, {} elements off)'.format(
                label, tuple(y.shape), diff.max().item(), ref, off))
    conv_err = max(conv_err, diff.max().item())
  for args, (xi, scale) in requant_calls:
    want_x, want_s = cc.requant_plain(*args)
    steps = (xi.int() - want_x.int()).abs()
    s_rel = ((scale - want_s).abs() / want_s).max().item()
    off = int((steps > 0).sum().item())
    require(steps.max().item() <= 1 and off <= INT8_MAX_SHARE *
            steps.numel() and s_rel <= INT8_NOISE,
            'requant {} launch {} differs from its plain version ({} '
            'elements a step off, scales {:.3e})'.format(
                label, tuple(xi.shape), off, s_rel))
    requant_err = max(requant_err, float(steps.max().item()), s_rel)
  print('K3 {}: {} conv launches within {:.3e} of their plain versions, '
        '{} requant launches within {:g} int8 steps'.format(
            label, len(conv_calls), conv_err, len(requant_calls),
            requant_err))
  return conv_err, requant_err


def bench_forward_phase(P, size, batch, dtypes, out, phase='25 (a)'):
  """Phase 25 (a): one forward of the bench's ``build_forward`` per dtype at
  ``size``², B = ``batch``, with the launch counters set to 0 just before
  and read just after (``BENCH_LAUNCHES``), its ``pred`` bit-equal to
  ``build_flagship``'s on the same batch and seed; then every kernel launch
  of a second forward against its plain version (K1 at F32_ATOL, K2 at
  ``hold_launches``' bars, K3 and the requant at ``hold_int8_launches``').
  Adds the launches and errors to ``out``."""
  from csmri_refinement_tpu_torch import bench
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  from csmri_refinement_tpu_torch.ops import dc_kernel
  counters = (dc_kernel.dc_cuda, cc.conv_layer_cuda, cc.conv_layer_f32_cuda,
              cc.conv_layer_int8_cuda, cc.requant_cuda)
  for dtype_str in dtypes:
    forward, model, batch_for = bench.build_forward(size, dtype_str,
                                                    device=DEVICE)
    inputs = batch_for(batch)
    args = [inputs[k] for k in ('inp', 'kspace', 'mask')]
    sync()
    for c in counters:
      c.launches = 0
    with torch.inference_mode():
      pred = forward(*args)
      sync()
    k1, k2_all, k2_f32, k3, requants = (c.launches for c in counters)
    got = (k1, k2_all - k2_f32, k2_f32, k3, requants)
    print('phase {} bench forward {}^2 {} B{}: launches K1 {}, K2 bf16 '
          '{}, K2 f32 {}, K3 {}, requant {}'.format(phase, size, dtype_str,
                                                    batch, *got))
    require(got == BENCH_LAUNCHES[dtype_str], 'bench forward {}: expected '
            'launches {}'.format(dtype_str, BENCH_LAUNCHES[dtype_str]))
    require(tuple(pred.shape) == (batch, size, size, 2) and
            bool(torch.isfinite(pred.float()).all()),
            'bench pred {} is not finite or of the wrong shape'.format(
                dtype_str))
    for key, n in zip(('k1', 'k2_bf16', 'k2_f32', 'k3', 'requant'), got):
      out[key] += n
    ref_model, _ = P.build_flagship(
        size, torch.float32 if dtype_str == 'f32' else torch.bfloat16,
        DEVICE, 0, quantize_inference=dtype_str == 'int8')
    with torch.inference_mode():
      ref = ref_model(*args)['pred']
      sync()
    require(torch.equal(pred, ref), 'the bench\'s {} pred differs from '
            'build_flagship\'s'.format(dtype_str))
    del ref_model, ref
    label = 'bench {} {}^2'.format(dtype_str, size)
    with torch.inference_mode():
      with recorded_launches(dc_kernel, ('dc_cuda',)) as dc, \
          recorded_launches(cc, ('conv_layer_cuda', 'conv_layer_int8_cuda',
                                 'requant_cuda')) as conv:
        forward(*args)
      k2 = [(a[0], a[1], a[2], y) for a, y in conv['conv_layer_cuda']]
      require(len(dc['dc_cuda']) == k1 and len(k2) == k2_all and
              len(conv['conv_layer_int8_cuda']) == k3 and
              len(conv['requant_cuda']) == requants,
              'the recorded launches of {} differ from the counted'.format(
                  label))
      for (x, k0, m), y in dc['dc_cuda']:
        err = (y - dc_kernel.dc_plain(x, k0, m)).abs().max().item()
        require(err <= F32_ATOL, 'K1 {} differs from its plain version '
                '({:.3e})'.format(label, err))
        out['dc_err'] = max(out['dc_err'], err)
      print('K1 {}: {} launches within {:.3e} of their plain versions (tol '
            '{})'.format(label, k1, out['dc_err'], F32_ATOL))
      key = 'f32_err' if dtype_str == 'f32' else 'k2_err'
      out[key] = max(out[key], hold_launches(label, k2, k2_all, batch, size))
      if k3:
        c_err, r_err = hold_int8_launches(label,
                                          conv['conv_layer_int8_cuda'],
                                          conv['requant_cuda'])
        out['k3_err'] = max(out['k3_err'], c_err)
        out['requant_err'] = max(out['requant_err'], r_err)
    del model, forward, pred, dc, conv, k2


def bench_big_phase(line, out):
  """Phase 25 (a'): the 512², B = 128 forward of the default 512² row in
  each dtype, its peak memory (``max_memory_allocated`` above what was
  held before); and K2 on the flagship's widest layer (decode_1's first:
  (128, 512, 512, 64), 2^31 elements) in bf16 and f32, the first and last
  two images against the plain version."""
  from csmri_refinement_tpu_torch import bench
  from csmri_refinement_tpu_torch.ops import conv_chain as cc
  for dtype_str in ('bf16', 'int8', 'f32'):
    forward, model, batch_for = bench.build_forward(BENCH_BIG, dtype_str,
                                                    device=DEVICE)
    inputs = batch_for(BENCH_BIG_BATCH)
    args = [inputs[k] for k in ('inp', 'kspace', 'mask')]
    sync()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
      pred = forward(*args)
      sync()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(pred.float()).all()),
            'the 512^2 B128 {} pred is not finite'.format(dtype_str))
    print('phase 25 bench forward {}^2 {} B{}: peak {:.3f} GiB allocated, '
          '{:.3f} GiB above the model and batch; first forward {:.3f} s '
          '({})'.format(BENCH_BIG, dtype_str, BENCH_BIG_BATCH, peak / 2 ** 30,
                        (peak - held) / 2 ** 30, secs, line))
    layer = model.learnable_model.decode_1.decode.chain_layers()[0]
    pad = model.learnable_model.decode_1.decode.padding
    del forward, inputs, args, pred, model
    if dtype_str == 'int8':
      torch.cuda.empty_cache()
      continue
    dt = torch.float32 if dtype_str == 'f32' else torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 25)
    x = torch.randn(BENCH_BIG_BATCH, BENCH_BIG, BENCH_BIG, 64, device=DEVICE,
                    generator=gen).to(dt)
    require(x.numel() == 2 ** 31, 'the widest layer has 2^31 elements')
    with torch.inference_mode():
      y = cc.conv_layer_cuda(x, layer, pad)
      sync()
      calls = [(x[i].contiguous(), layer, pad, y[i].contiguous())
               for i in (slice(0, 2), slice(-2, None))]
      del x, y
      key = 'f32_err' if dt == torch.float32 else 'k2_err'
      out[key] = max(out[key], hold_launches(
          'widest layer {}, the first and last 2 images of B{},'.format(
              dtype_str, BENCH_BIG_BATCH), calls, 2, 2, BENCH_BIG))
    del calls
    torch.cuda.empty_cache()


def bench_rows(label, proc):
  """The command's stdout contract on one run: one JSON line on stdout
  with value > 0, one bare JSON line in stdout and stderr merged; returns
  (headline, extra rows, component lines)."""
  def tail():
    return '\n'.join(proc.stderr.splitlines()[-40:])
  lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
  require(proc.returncode == 0 and len(lines) == 1,
          'bench {}: exit {}, stdout {!r}\n{}'.format(
              label, proc.returncode, proc.stdout[-2000:], tail()))
  rec = json.loads(lines[0])
  bare = []
  for ln in (proc.stdout + '\n' + proc.stderr).splitlines():
    try:
      bare.append(json.loads(ln))
    except ValueError:
      pass
  require(bare == [rec], 'bench {}: {} bare JSON lines in the merged '
          'stream'.format(label, len(bare)))
  require('error' not in rec and rec.get('value', 0) > 0,
          'bench {}: headline {}\n{}'.format(label, rec, tail()))
  rows = [json.loads(ln[len('extra: '):]) for ln in proc.stderr.splitlines()
          if ln.startswith('extra: ')]
  components = [ln for ln in proc.stderr.splitlines()
                if ln.startswith('component ')]
  return rec, rows, components


def bench_cli_phase(line, runs=BENCH_RUNS, budget=True, phase='25 (b)'):
  """Phase 25 (b), (c): the command as a subprocess on the card
  (``runs``), every row printed, no row with an error; then, with
  ``budget``, ``--budget 2``."""
  root = os.path.dirname(os.path.dirname(os.path.abspath(
      sys.modules['csmri_refinement_tpu_torch'].__file__)))
  cmd = [sys.executable, '-m', 'csmri_refinement_tpu_torch.bench']
  for label, extra, n_rows in runs:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + extra, cwd=root, capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    rec, rows, components = bench_rows(label, proc)
    print('phase {} bench {} ({:.1f} s): {} ({})'.format(
        phase, ' '.join(extra) or 'default', time.perf_counter() - t0,
        json.dumps(rec), line))
    for ln in components:
      print('phase {}   {}'.format(phase, ln))
    for row in rows:
      print('phase {}   extra: {}'.format(phase, json.dumps(row)))
    require(len(rows) == n_rows, 'bench {}: expected {} extra rows, got '
            '{}'.format(label, n_rows, len(rows)))
    require(all('error' not in r and r.get('value', 0) > 0 for r in rows),
            'bench {}: an extra row failed\n{}'.format(
                label, '\n'.join(proc.stderr.splitlines()[-60:])))
    require(label != 'default' or len(components) == 3,
            'bench default: expected 3 component lines')
  if not budget:
    return
  proc = subprocess.run(cmd + ['--budget', '2'], cwd=root,
                        capture_output=True, text=True, timeout=120)
  lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
  rec = json.loads(lines[0]) if len(lines) == 1 else {}
  print('phase 25 (c) bench --budget 2: exit {}, {}'.format(
      proc.returncode, json.dumps(rec)))
  require(proc.returncode != 0 and rec.get('error') == 'budget_exceeded' and
          'stage' in rec and 'metric' in rec,
          'bench --budget 2 did not give budget_exceeded')


def bench_phase(P, line):
  """Phase 25: (a) the bench's forward in process, (a') the 512², B = 128
  forward's peak memory and the widest layer, (b) the command on the card,
  (c) its budget. Returns the launches and errors for the kernels line."""
  t0 = time.perf_counter()
  out = {'k1': 0, 'k2_bf16': 0, 'k2_f32': 0, 'k3': 0, 'requant': 0,
         'dc_err': 0.0, 'k2_err': 0.0, 'f32_err': 0.0, 'k3_err': 0.0,
         'requant_err': 0.0}
  bench_forward_phase(P, BENCH_SIZE, BENCH_BATCH, ('bf16', 'f32', 'int8'),
                      out)
  bench_forward_phase(P, BENCH_SMALL, BENCH_BATCH, ('bf16', 'f32'), out)
  t1 = time.perf_counter()
  bench_big_phase(line, out)
  t2 = time.perf_counter()
  bench_cli_phase(line)
  print('phase 25: (a) {:.1f} s, (a\') {:.1f} s, (b, c) {:.1f} s; {:.1f} s '
        'wall'.format(t1 - t0, t2 - t1, time.perf_counter() - t2,
                      time.perf_counter() - t0))
  return out


# Phase 27: sides above 512 on the main paths. (a) the training CLI at
# LARGE_TRAIN_SIZE² (3 steps of TRAIN_BATCH, one validation batch), (b)
# the flagship at LARGE_FLAGSHIP_SIZE², (c) the bench's extra sizes.
LARGE_TRAIN_SIZE = 640
LARGE_TRAIN_STEPS = 3
LARGE_FLAGSHIP_SIZE, LARGE_FLAGSHIP_BATCH = 1024, 2
# (b)'s flagship on the split route, and (d)'s RecNet steps on the chirp
# route (primes: 1031 and 2053 in one block, m = 2112 and 4160; 2311, the
# smallest side on a cluster, m = 4802 on two blocks) and with H on the
# split route on a cluster of two (3510 rows, 2048 columns), (H, W, B)
SPLIT_FLAGSHIP_SIZE, SPLIT_FLAGSHIP_BATCH = 2048, 1
CHIRP_STEPS = ((1031, 1031, 2), (2053, 2053, 1), (2311, 2311, 1),
               (3510, 2048, 1))
LARGE_BENCH = ['--image-size', str(BENCH_SMALL), '--batch-size', '4',
               '--iters', '4', '--warmup', '1', '--extra-sizes', '640',
               '1024']


def large_train_phase(line, out):
  """Phase 27 (a): the training CLI at LARGE_TRAIN_SIZE², counters set
  to 0 just before and read just after; one more step's K1 and K1-bwd
  launches against ``dc_plain`` (F32_ATOL) and ``dc_plain_vjp``
  (GRAD_ATOL); the step timed, TF32 off."""
  from csmri_refinement_tpu_torch import train
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.ops import dc_kernel
  from csmri_refinement_tpu_torch.ops import undersample as us
  size, steps = LARGE_TRAIN_SIZE, LARGE_TRAIN_STEPS
  synthetic = {'image_size': size, 'num_train': steps * TRAIN_BATCH,
               'num_val': TRAIN_BATCH}
  sync()
  dc_kernel.dc_cuda.launches = dc_kernel.dc_bwd_cuda.launches = 0
  t0 = time.perf_counter()
  runner = train.main([TRAIN_CONFIG, '--dry', '--conf', 'num_epochs=1',
                       'epochs_per_validation=1',
                       'synthetic=' + json.dumps(synthetic)])
  sync()
  secs = time.perf_counter() - t0
  fwd, bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
  print('phase 27 (a) train CLI {}^2 B{}: {} steps + validation in {:.1f} '
        's, K1 launches {}, K1-bwd launches {}'.format(
            size, TRAIN_BATCH, runner.step, secs, fwd, bwd))
  require(runner.step == steps, 'expected {} train steps'.format(steps))
  require(fwd == 3 * (steps + 1) and bwd == 3 * steps,
          'expected 3 K1 a step and validation batch, 3 K1-bwd a step')
  _, val_losses, _ = runner.validate(DataLoader(
      load_dataset(runner.conf, None, 'Synthetic', 'val'), TRAIN_BATCH))
  loss = {k: v.value for k, v in val_losses.items()}
  require(all(math.isfinite(v) for v in loss.values()),
          'the validation loss at {}^2 is not finite'.format(size))
  gt, mask = fixed_batches(runner.conf, 1)[0]
  batch = us.undersample_batch(None, gt.to(DEVICE), fixed_mask=mask.to(DEVICE))
  step = {}
  calls = record_dc_launches(
      lambda: step.update(runner.train_batch(batch)[0]))
  require(math.isfinite(step['loss'].item()), 'the train loss is not finite')
  require(len(calls['K1']) == 3 and len(calls['K1-bwd']) == 3,
          'expected 3 K1 and 3 K1-bwd launches a step')
  for x, k0, m, y in calls['K1']:
    out['dc_err'] = max(out['dc_err'], (y - dc_kernel.dc_plain(
        x, k0, m)).abs().max().item())
  for g, m, y in calls['K1-bwd']:
    out['dc_bwd_err'] = max(out['dc_bwd_err'], (y - dc_kernel.dc_plain_vjp(
        g, m, False)[0]).abs().max().item())
  require(out['dc_err'] <= F32_ATOL and out['dc_bwd_err'] <= GRAD_ATOL,
          'K1 or K1-bwd at {}^2 differs from its plain version'.format(size))
  ms = timed_ms(lambda: runner.train_batch(batch), iters=5, warmup=1)
  print('phase 27 (a) RecNet {}^2 B{}: validation {}, train loss '
        '{:.6e}; K1 and K1-bwd of a step within {:.3e} / {:.3e} of their '
        'plain versions (tol {} / {}); step {:.3f} ms, {:.1f} slices/s, TF32 '
        'off ({})'.format(size, TRAIN_BATCH, loss, step['loss'].item(),
                          out['dc_err'], out['dc_bwd_err'], F32_ATOL,
                          GRAD_ATOL, ms, TRAIN_BATCH / ms * 1e3, line))
  out['k1'] += fwd + 3
  out['k1_bwd'] += bwd + 3
  del runner, batch, calls


def chirp_step_phase(line, out):
  """Phase 27 (d): at each of CHIRP_STEPS a RecNet train step
  (``TRAIN_CONFIG``'s model and Adam), counters set to 0 just before and
  read just after (3 K1 and 3 K1-bwd with H on the chirp or split route,
  in one block or on a cluster), the loss finite; one more step's launches held to
  ``dc_plain`` (F32_ATOL) and ``dc_plain_vjp`` (GRAD_ATOL); the step timed,
  TF32 off."""
  from csmri_refinement_tpu_torch.ops import dc_kernel, masks
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  for h, w, b in CHIRP_STEPS:
    size = '{}x{}'.format(h, w)
    routes = dc_kernel.dc_route(h, w)
    require(routes[0] in ('chirp', 'split'), 'expected H on the chirp or '
            'split route at {}, got {}'.format(size, routes))
    runner = Runner(Configuration.from_json(TRAIN_CONFIG), 'train', DEVICE)
    gen = torch.Generator().manual_seed(SEED + h + w)
    gt = torch.rand(b, h, w, generator=gen)
    mask = masks.cartesian_mask(gen, (b, h, w), 8)
    batch = us.undersample_batch(None, gt.to(DEVICE),
                                 fixed_mask=mask.to(DEVICE))
    sync()
    dc_kernel.dc_cuda.launches = dc_kernel.dc_bwd_cuda.launches = 0
    loss = runner.train_batch(batch)[0]['loss']
    sync()
    fwd, bwd = dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches
    require((fwd, bwd) == (3, 3), 'expected 3 K1 and 3 K1-bwd launches a '
            'step at {}, got {} and {}'.format(size, fwd, bwd))
    require(math.isfinite(loss.item()), 'the train loss is not finite')
    calls = record_dc_launches(lambda: runner.train_batch(batch))
    errs = [0.0, 0.0]
    for x, k0, m, y in calls['K1']:
      errs[0] = max(errs[0], (y - dc_kernel.dc_plain(x, k0, m)).abs().max()
                    .item())
    for g, m, y in calls['K1-bwd']:
      errs[1] = max(errs[1], (y - dc_kernel.dc_plain_vjp(g, m, False)[0])
                    .abs().max().item())
    require(len(calls['K1']) == 3 and len(calls['K1-bwd']) == 3 and
            errs[0] <= F32_ATOL and errs[1] <= GRAD_ATOL,
            'K1 or K1-bwd at {} differs from its plain version'.format(
                size))
    del calls
    ms = timed_ms(lambda: runner.train_batch(batch), iters=5, warmup=1)
    print('phase 27 (d) RecNet step {} B{}, routes {} ({}, {}): K1 {} and '
          'K1-bwd {} launches, train loss {:.6e}; a step\'s K1 and K1-bwd '
          'within {:.3e} / {:.3e} of their plain versions (tol {} / {}); '
          'step {:.3f} ms, TF32 off ({})'.format(
              size, b, routes, route_plan(dc_kernel, routes[0], h, w, True),
              route_plan(dc_kernel, routes[1], w, h), fwd, bwd, loss.item(),
              errs[0], errs[1], F32_ATOL, GRAD_ATOL, ms, line))
    out['k1'] += fwd + 3
    out['k1_bwd'] += bwd + 3
    kind = axis_kind(dc_kernel, routes[0], h, w, True)
    key = kind if routes[0] == 'chirp' else 'split_' + kind
    out[key + '_k1'] += fwd + 3
    out[key + '_k1_bwd'] += bwd + 3
    out['dc_err'] = max(out['dc_err'], errs[0])
    out['dc_bwd_err'] = max(out['dc_bwd_err'], errs[1])
    del runner, batch


def large_sides_phase(P, line):
  """Phase 27: (a) ``large_train_phase``, (b) ``build_flagship`` at
  LARGE_FLAGSHIP_SIZE², B = LARGE_FLAGSHIP_BATCH, and at
  SPLIT_FLAGSHIP_SIZE², B = SPLIT_FLAGSHIP_BATCH, through
  ``bench_forward_phase`` (counted, bit-equal to the bench's forward, every
  launch held to its plain version), (c) the bench command's extra sizes
  640 and 1024, (d) ``chirp_step_phase``. Returns the launches and errors
  for the kernels line ('split_k1': (b)'s launches at 2048², 'block_k1',
  'block_k1_bwd', 'cluster_k1', 'cluster_k1_bwd': (d)'s on the chirp
  route in one block and on a cluster, 'split_cluster_k1',
  'split_cluster_k1_bwd' on the split route on a cluster)."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  t0 = time.perf_counter()
  out = {'k1': 0, 'k1_bwd': 0, 'k2_bf16': 0, 'k2_f32': 0, 'k3': 0,
         'requant': 0, 'dc_err': 0.0, 'dc_bwd_err': 0.0, 'k2_err': 0.0,
         'f32_err': 0.0, 'k3_err': 0.0, 'requant_err': 0.0, 'split_k1': 0,
         'block_k1': 0, 'block_k1_bwd': 0, 'cluster_k1': 0,
         'cluster_k1_bwd': 0, 'split_cluster_k1': 0,
         'split_cluster_k1_bwd': 0}
  large_train_phase(line, out)
  t1 = time.perf_counter()
  bench_forward_phase(P, LARGE_FLAGSHIP_SIZE, LARGE_FLAGSHIP_BATCH,
                      ('bf16',), out, phase='27 (b)')
  size = SPLIT_FLAGSHIP_SIZE
  require(dc_kernel.dc_route(size, size) == ('split', 'split'),
          'expected the split route at {}^2'.format(size))
  before = out['k1']
  bench_forward_phase(P, size, SPLIT_FLAGSHIP_BATCH, ('bf16',), out,
                      phase='27 (b)')
  out['split_k1'] = out['k1'] - before
  t2 = time.perf_counter()
  bench_cli_phase(line, (('extra sizes', LARGE_BENCH, 2),), budget=False,
                  phase='27 (c)')
  t3 = time.perf_counter()
  chirp_step_phase(line, out)
  print('phase 27: (a) {:.1f} s, (b) {:.1f} s, (c) {:.1f} s, (d) {:.1f} s; '
        '{:.1f} s wall'.format(t1 - t0, t2 - t1, t3 - t2,
                               time.perf_counter() - t3,
                               time.perf_counter() - t0))
  return out


def route_entries(routes, scar, large):
  """The kernels line's entries of K1's and K1-bwd's routes past the
  radix one: the mixed-radix route's whole-image launches in phase 26's
  one-process runs at 240², the largest error of phase 11's shapes on it,
  and phase 11's times at (20, 240, 240); the chirp route's launches in
  one block (``block_lines``) of phase 27 (d) (1031² and 2053²) and on a
  cluster (``cluster_lines``, 2311²), the split route's in one block of
  phase 27 (b) (2048²) and on a cluster of phase 27 (d) (3510 × 2048),
  their largest errors in phase 11 and its times at (2, 1031, 1031), (1,
  4099, 4099), (1, 2048, 2048) and (1, 3510, 2048). 'dc (chirp route)'
  and 'dc (split route)' name the launches in one block, as they did
  before the clusters came."""
  entries = []
  for label, name, launches, err, times in (
      ('K1', 'dc (mixed-radix route)', scar['k1_mixed'], 'err', 'times'),
      ('K1-bwd', 'dc_bwd (mixed-radix route)', scar['k1_bwd_mixed'], 'err',
       'times'),
      ('K1', 'dc (chirp route)', large['block_k1'], 'chirp_err',
       'chirp_times'),
      ('K1-bwd', 'dc_bwd (chirp route)', large['block_k1_bwd'], 'chirp_err',
       'chirp_times'),
      ('K1', 'dc (chirp route, cluster)', large['cluster_k1'],
       'cluster_err', 'cluster_times'),
      ('K1-bwd', 'dc_bwd (chirp route, cluster)', large['cluster_k1_bwd'],
       'cluster_err', 'cluster_times'),
      ('K1', 'dc (split route)', large['split_k1'], 'split_err',
       'split_times'),
      ('K1', 'dc (split route, cluster)', large['split_cluster_k1'],
       'split_cluster_err', 'split_cluster_times'),
      ('K1-bwd', 'dc_bwd (split route, cluster)',
       large['split_cluster_k1_bwd'], 'split_cluster_err',
       'split_cluster_times')):
    t = routes[label][times]
    entries.append({
        'name': name, 'route': 'cuda',
        'source': 'csmri_refinement_tpu_torch/csrc/dc.cu',
        'replaces': 'csmri_refinement_tpu/ops/dc.py:99' if label == 'K1-bwd'
                    else 'csmri_refinement_tpu/ops/dc_pallas.py:36',
        'launches': launches, 'max_abs_err': routes[label][err],
        'ms': t['ms'], 'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': t['bound_by'], 'library_ms': t['library_ms']})
    require(launches > 0, '{} was not launched on the main path'.format(name))
  return entries


def pass_entries(scar):
  """The kernels line's entries of K1's and K1-bwd's passes: phase 23's
  launches (rank 0's) and errors, and the times of 1-recnet's rank 0
  (512², B = 20, S = 2)."""
  entries = []
  for name, (label, _, bwd) in DC_PASSES.items():
    launches, err, _ = scar['passes'][name]
    t = scar['pass_times'][name]
    entries.append({
        'name': label, 'route': 'cuda',
        'source': 'csmri_refinement_tpu_torch/csrc/dc.cu',
        'replaces': 'csmri_refinement_tpu/ops/dc.py:99' if bwd else
                    'csmri_refinement_tpu/ops/dc_pallas.py:36',
        'launches': launches, 'max_abs_err': err, 'ms': t['ms'],
        'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': t['bound_by'], 'library_ms': t['library_ms']})
  return entries


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
  t_start = time.perf_counter()
  argv = sys.argv[1:] if argv is None else argv
  probes_only = '--probes-only' in argv
  int8_only_mode = '--int8-only' in argv
  dc_routes_mode = '--dc-routes-only' in argv
  f32_only_mode = '--f32-only' in argv
  scarseg_only = '--scarseg-only' in argv
  dist_export_only = '--dist-export-only' in argv
  spatial_only = '--spatial-only' in argv
  uneven_only = '--uneven-only' in argv
  options_only = '--options-only' in argv
  bench_only = '--bench-only' in argv
  large_only = '--large-only' in argv
  child = next((a for a in ('--spatial-rank', '--gloo-probe') if a in argv),
               None)
  tree = os.path.realpath(argv[argv.index('--tree') + 1]) if '--tree' in \
      argv else REPO
  require(os.path.commonpath([tree, REPO]) == REPO,
          '--tree must name a directory inside the checkout')
  # graph_ms of a plain version that is a view (the unaligned row read,
  # the mid-dim read) captures an empty graph, which times as ~0
  warnings.filterwarnings('ignore', 'The CUDA Graph is empty')
  if child is not None:   # a rank of phase 23, started by phase 23
    sys.path.insert(0, REPO)
    global timed_ms
    from csmri_refinement_tpu_torch.utils.profiling import timed_ms
    cfg = json.loads(argv[argv.index(child) + 1])
    return (spatial_rank if child == '--spatial-rank' else gloo_probe)(cfg)
  require(torch.cuda.is_available(), 'no CUDA device')
  sys.path.insert(0, os.path.abspath(tree))
  import csmri_refinement_tpu_torch as P
  # CUDA-event timing: utils/profiling.py's timed_ms, for every phase
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
  if dc_routes_mode:   # phases 1, 2 and phase 11's routes alone
    build_phase(('dc',))
    dc_routes_phase(line, skip_refused=tree != REPO)
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
  if options_only:     # phases 1, 2 and 24
    print(json.dumps(unet_options_phase(line)))
    return
  if bench_only:       # phases 1, 2 and 25
    print(json.dumps(bench_phase(P, line)))
    return
  if large_only:       # phases 1, 2 and 27
    print(json.dumps(large_sides_phase(P, line)))
    return
  if uneven_only:      # phases 1, 2, the gloo probe and 26
    print(json.dumps(uneven_phase(line, probe=True)))
    return
  if scarseg_only or dist_export_only or spatial_only:
    # phases 1, 2 and 18-23, or phase 18's tree and 22 or 23
    print(json.dumps(scarseg_phase(line, dist_export_only, spatial_only)))
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
  t11 = time.perf_counter()
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
  routes = dc_routes_phase(line)
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
  print('phase 11: {:.1f} s wall'.format(time.perf_counter() - t11))

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

  # Phase 24: the U-Net options, the noisy DC and the k-space utilities
  opts = unet_options_phase(line)

  # Phase 25: the port's benchmark command
  bench = bench_phase(P, line)

  # Phase 27: sides above 512 on the main paths
  large = large_sides_phase(P, line)

  kernels = [
      {'name': 'dc', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/dc.cu',
       'replaces': 'csmri_refinement_tpu/ops/dc_pallas.py:36',
       'launches': (dc_launches + train_fwd + gan_k1 + sis_k1 + scar['k1'] +
                    opts['k1'] + bench['k1'] + large['k1']),
       'max_abs_err': max(dc_err, scar['dc_err'], opts['dc_err'],
                          bench['dc_err'], routes['K1']['large_err'],
                          large['dc_err']),
       'ms': dc_ms,
       'plain_ms': dc_plain_ms, 'bound_ms': dc_bound,
       'bound_by': dc_by,
       'library_ms': dc_lib_ms},
      {'name': 'conv_chain', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_chain.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:247',
       'launches': (conv_launches + scar['k2_bf16'] + opts['k2_bf16'] +
                    bench['k2_bf16'] + large['k2_bf16']),
       'max_abs_err': max(conv_err, scar['bf16_err'], opts['k2_err'],
                          bench['k2_err'], large['k2_err']),
       'ms': conv_ms,
       'plain_ms': conv_plain_ms, 'bound_ms': conv_bound,
       'bound_by': conv_by,
       'library_ms': conv_lib_ms},
      {'name': 'conv_chain_f32', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_f32.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:247',
       'launches': (gan_k2 + seg_k2 + sis_k2 + scar['k2_f32'] +
                    opts['k2_f32'] + bench['k2_f32']),
       'max_abs_err': max(gan_f32_err, seg_f32_err, scar['f32_err'],
                          opts['f32_err'], bench['f32_err']),
       'ms': f32['ms'], 'plain_ms': f32['plain_ms'],
       'bound_ms': f32['bound_ms'], 'bound_by': 'operations',
       'library_ms': f32['cudnn_best_ms']},
      {'name': 'dc_bwd', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/dc.cu',
       'replaces': 'csmri_refinement_tpu/ops/dc.py:99',
       'launches': train_bwd + scar['k1_bwd'] + large['k1_bwd'],
       'max_abs_err': max(bwd_err, scar['dc_bwd_err'],
                          routes['K1-bwd']['large_err'], large['dc_bwd_err']),
       'ms': bwd_ms,
       'plain_ms': bwd_plain_ms, 'bound_ms': bwd_bound,
       'bound_by': bwd_by,
       'library_ms': bwd_lib_ms},
      {'name': 'conv_int8', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_int8.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:247',
       'launches': int8_launches[0] + bench['k3'] + scar['k3'],
       'max_abs_err': max(int8_conv_err, bench['k3_err'], scar['k3_err']),
       'ms': k3['conv'][0], 'plain_ms': k3['conv'][1],
       'bound_ms': k3['conv'][2], 'bound_by': k3['conv'][3],
       'library_ms': None},
      {'name': 'requant_int8', 'route': 'cuda',
       'source': 'csmri_refinement_tpu_torch/csrc/conv_int8.cu',
       'replaces': 'csmri_refinement_tpu/ops/conv_pallas.py:381',
       'launches': int8_launches[1] + bench['requant'] + scar['requant'],
       'max_abs_err': max(requant_err, bench['requant_err'],
                          scar['requant_err']),
       'ms': k3['requant'][0], 'plain_ms': k3['requant'][1],
       'bound_ms': k3['requant'][2], 'bound_by': k3['requant'][3],
       'library_ms': None},
  ] + route_entries(routes, scar, large) + pass_entries(scar) + probe_entries
  print('chip_smoke: all phases passed in {:.1f} s wall, the kernels\' build '
        'included ({})'.format(time.perf_counter() - t_start, line))
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
