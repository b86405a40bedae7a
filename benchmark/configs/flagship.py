"""The ``flagship`` configuration: the port's serving forward.

``build`` makes ``flagship.flagship_model`` in the compute dtype the
configuration states, in eval mode on the device, loads weights drawn from
the seed (``benchmark/weights.py``) and makes the traffic's pool of
batches (``benchmark/inputs.py``). A call serves one batch: ``model(inp,
kspace, mask)`` under ``torch.inference_mode()``, TF32 off, as the port's
own bench runs it. The outputs of a sample of the window's requests,
drawn from the seed, are kept and compared with ``reference/flagship.py``
after the window, the worst slice of each:

* ``recnet_err``: the cascade's output against the reference cascade on
  the same inputs;
* ``unet_err``: the U-Net's output against the reference U-Net run on the
  program's own cascade output (the stage alone: a random U-Net amplifies
  the cascade's bf16 rounding by a factor that varies with the seed, which
  would swamp the stage's own error), over all the sampled slices at once,
  relative to the magnitude the U-Net's 1 × 1 head sums (|weight| ·
  |features| + |bias|): the head's random signs cancel, by a factor that
  varies with the seed too;
* ``pred_err``: the served prediction against the reference wrapper's,
  from the program's cascade output and the reference U-Net on it (the
  last two stages given the first, for the U-Net's reason above);
* ``pred_e2e_err``: the served prediction against the reference's whole
  forward from the raw inputs (``reference.forward``), nothing of the
  program's handed in, over all the sampled slices at once: ‖got − ref‖
  / ‖ref‖. The random U-Net amplifies the cascade's rounding by a factor
  that its weights, and so the seed, set (1.7-3.5 × ``recnet_err``), so
  its worst slice swings too far to separate the program from the
  control; the whole sample does.

A slice's error in ``recnet_err`` and ``pred_err`` is ‖got − ref‖ over
the larger of its ‖ref‖ and the median slice's ‖ref‖ in its block. The program warms up on the drawn weights; then (``ready``,
after the set-up is stamped and so outside ``setup_s``) the reference
fits the BatchNorm statistics to the first batch
(``reference.fit_batchnorm``) and they are loaded into the program before
the window.

``variant='control'`` (the calibration's only) serves the reference in the
program's place with every conv in float8 e4m3 (activations scaled per
image, weights per output channel), the DC in f32: the precision below the
stated bf16 that Hopper's tensor cores offer.
The program's own int8 mode (``quantize_inference``) is no such control
here: its VMEM-budget trim (``ops/conv_chain.py::int8_suffix_start``)
quantizes 4 of the U-Net's 10 convs at 512² and none at 640 × 368.
"""

import math
import random

import torch

from benchmark import inputs, weights, work
from benchmark.reference import flagship as reference

CHECKS = ('recnet_err', 'unet_err', 'pred_err', 'pred_e2e_err')
KEPT = ('pretrained', 'prescaled_refinement', 'pred')


def _leak(name):
  return 0.01 if name.startswith('pretrained_model.') else 0.1


class Reservoir:
  """A uniform sample of ``size`` of the items offered, drawn from
  ``seed``; an item dropped is freed."""

  def __init__(self, seed, size):
    self.rng = random.Random(seed)
    self.size = size
    self.items = []
    self.seen = 0

  def offer(self, item):
    if len(self.items) < self.size:
      self.items.append(item)
    else:
      j = self.rng.randrange(self.seen + 1)
      if j < self.size:
        self.items[j] = item
    self.seen += 1


def slice_errors(got, ref):
  """Each slice's ‖got − ref‖ over the larger of its ‖ref‖ and the median
  slice's, over its pixels and channels."""
  got, ref = got.double().flatten(1), ref.double().flatten(1)
  norms = ref.norm(dim=1)
  errs = ((got - ref).norm(dim=1) /
          torch.maximum(norms, norms.median())).tolist()
  return [e if math.isfinite(e) else math.inf for e in errs]


class System:

  def __init__(self, conf, traffic, seed, device, variant=None):
    from csmri_refinement_tpu_torch import flagship
    from csmri_refinement_tpu_torch.ops import dc as dc_ops
    bench = conf['bench']
    torch.backends.cudnn.allow_tf32 = bench['cudnn_tf32']
    torch.backends.cuda.matmul.allow_tf32 = bench['matmul_tf32']
    self.conf, self.traffic = conf, traffic
    self.dc_ops = dc_ops
    gen = torch.Generator(device=device).manual_seed(seed)
    self.control = variant == 'control'
    model = flagship.flagship_model(getattr(torch, bench['compute_dtype']))
    model = model.to(device).eval()
    state = model.state_dict()
    expected = reference.param_shapes(conf)
    wrong = {n: (tuple(state[n].shape) if n in state else None, s)
             for n, s in expected.items()
             if n not in state or tuple(state[n].shape) != s}
    if wrong:
      raise ValueError('the program is not the configuration: {}'.format(
          wrong))
    self.weights = weights.draw(state, gen, _leak)
    self.pool = inputs.pool(gen, traffic, ('inp', 'kspace', 'mask'))
    model.load_state_dict(self.weights)
    self.model = model
    self.units = traffic['batch']
    self.kept = Reservoir(seed, traffic['check_calls'])

  def ready(self):
    """Between the warm-up and the window: the reference fits the
    BatchNorm statistics to the first batch, and the program takes them."""
    first = {k: v[:self.traffic['check_block']]
             for k, v in self.pool[0].items()}
    reference.fit_batchnorm(self.conf, self.weights, first['inp'],
                            first['kspace'], first['mask'])
    self.model.load_state_dict(self.weights)
    if self.weights['scale'].is_cuda:
      # the fit is the benchmark's making of weights: the peak that
      # memory_peak_bytes reports is the program's from here on
      torch.cuda.reset_peak_memory_stats()

  def call(self, i):
    batch = self.pool[i % len(self.pool)]
    with torch.inference_mode():
      if self.control:
        ref = reference.forward(self.conf, self.weights, batch['inp'],
                                batch['kspace'], batch['mask'], fp8=True)
        return {'pretrained': ref['pretrained'], 'pred': ref['pred'],
                'prescaled_refinement': ref['refinement']}
      return self.model(batch['inp'], batch['kspace'], batch['mask'])

  def done(self, i, out, warm):
    if not warm:
      self.kept.offer((i, {k: out[k] for k in KEPT}))

  def install(self, ranges):
    ranges.module(self.model.pretrained_model, 'recnet')
    ranges.module(self.model.learnable_model, 'unet')
    ranges.attribute(self.dc_ops, 'data_consistency', 'dc')

  def work(self):
    """Operations and least bytes a request, and a DC range."""
    section = self.conf['generator_model']
    h, w, b = self.traffic['height'], self.traffic['width'], \
        self.traffic['batch']
    rec = sum(work.recnet_convs(reference.recnet.model_conf(
        section['pretrained_model']), h, w))
    unet_conf = section['learnable_model']
    unet = work.unet_macs(unet_conf, h, w)
    dc_flops, dc_bytes = work.dc(h, w)
    n_dc = section['pretrained_model']['num_blocks']
    # bf16 in (2 channels) and out (1), f32 weights read once
    unet_bytes = b * h * w * (unet_conf['num_inputs'] +
                              unet_conf['num_outputs']) * 2 + \
        4 * work.weight_count(unet_conf)
    return {'flops_per_call': b * (2 * (rec + unet) + n_dc * dc_flops),
            'unet_flops': 2 * b * unet, 'unet_bytes': unet_bytes,
            'dc_flops': b * dc_flops, 'dc_bytes': b * dc_bytes}

  def release(self):
    """Free the program; keep the weights, the kept outputs and their
    batches."""
    self.model = None
    self.pool = {i: self.pool[i % len(self.pool)] for i, _ in self.kept.items}

  def check(self):
    """(name, error, limit) of each compared output."""
    limits = self.conf['bench']['limits']
    block = self.traffic['check_block']
    # no request finished: nothing to compare, which no limit passes
    worst = {name: 0.0 if self.kept.items else math.inf for name in CHECKS}
    unet_sq = [0.0, 0.0, 0.0]
    e2e_sq = [0.0, 0.0]
    for i, out in self.kept.items:
      batch = self.pool[i]
      for s in range(0, self.traffic['batch'], block):
        part = slice(s, s + block)
        with torch.no_grad(), reference.recnet.exact_f32():
          ref = reference.recnet.forward(
              self.conf['generator_model']['pretrained_model'], self.weights,
              batch['inp'][part], batch['kspace'][part], batch['mask'][part],
              prefix='pretrained_model.')
        got = {k: out[k][part] for k in KEPT}
        unet, magnitude = reference.refine(self.conf, self.weights,
                                           got['pretrained'])
        pred = reference.wrap(self.weights, got['pretrained'], unet)
        whole, _ = reference.refine(self.conf, self.weights, ref)
        whole = reference.wrap(self.weights, ref, whole)
        errs = {'recnet_err': slice_errors(got['pretrained'], ref),
                'pred_err': slice_errors(got['pred'], pred)}
        for name, values in errs.items():
          worst[name] = max([worst[name]] + values)
        unet_sq[0] += float((got['prescaled_refinement'].double() -
                             unet.double()).square().sum())
        unet_sq[1] += float(magnitude.double().square().sum())
        unet_sq[2] += float(unet.double().square().sum())
        e2e_sq[0] += float((got['pred'].double() - whole.double())
                           .square().sum())
        e2e_sq[1] += float(whole.double().square().sum())
    if self.kept.items:
      self.details = {'unet_over_output': math.sqrt(unet_sq[0] / unet_sq[2])}
      for name, (diff, norm) in (('unet_err', unet_sq[:2]),
                                 ('pred_e2e_err', e2e_sq)):
        ratio = math.sqrt(diff / norm) if norm else math.inf
        worst[name] = ratio if math.isfinite(ratio) else math.inf
    return [(name, worst[name], limits[name]) for name in CHECKS]


def build(conf, traffic, seed, device, variant=None):
  return System(conf, traffic, seed, device, variant)
