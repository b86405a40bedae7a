"""The ``recnet`` configuration: the port's training step of
``configs/1-recnet.json``.

``build`` makes the port's ``Runner`` in mode 'train' from the
configuration as written (``training.build_runner``), loads weights drawn
from the seed into its model before the first step, and makes the
traffic's pool of prepared batches (``inp``, ``kspace``, ``mask``,
``target``: what ``prepare_train`` returns). A call is one
``Runner.train_batch`` and the fetch of its loss, as the training loop's
step with ``steps_per_fetch`` 1 does; a loss that is not finite fails the
call.

The warm-up's calls are the run's first steps, on distinct batches, and
the same runner goes on into the window. Before each of the window's
steps the benchmark copies the state the step starts from (the
parameters and Adam's two moments) into buffers of its own, on the
device, so that after the window it holds the state the window's last
step started from, that step's batch, loss and output, and the
parameters it left. After the window ``reference/recnet.py`` repeats the
first ``warm_calls`` steps from the same weights and batches, and the
check compares:

* ``loss_gap``: the largest |program − reference| / reference over those
  steps' losses;
* ``change_gap``: the parameters' change after those steps, each leaf's
  |‖Δ‖ − ‖Δ_ref‖| over the larger of its ‖Δ_ref‖ and the median leaf's,
  the worst leaf's, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (a smaller one moves under Adam by
  round-off alone);
* ``out_err``: the first step's model output, as ``train_batch`` returned
  it, against the reference forward's: ‖out − ref‖ / ‖ref‖ over the
  batch. Gaps of norms and of means move with the sum of the roundings,
  not with their size, and TF32's truncation moves them about as much as
  bfloat16's rounding, so the bfloat16 control stands above the program
  in none of the other numbers on every seed; this one separates the two;

and ``last_loss_gap``, ``last_change_gap`` and ``last_out_err``, the same
measures of the window's last step, which the reference repeats from the
state the program started it from, as Adam's step count the calls made
before it (every call one step); but ``last_change_gap`` is the median
moved leaf's gap, not the worst's. Some hundreds of steps in, a step's
change follows its gradient more than Adam's moments, and the worst
leaf's gap swings with the gradient's TF32 rounding as ``grad_gap`` does
(0.0013-0.022 over 30 sound runs); the median leaf's is steady, and a
state left unchanged reads 1 on it. The worst leaf's, ``last_change_worst``,
is reported and not compared. The reference can follow the window only
so, from the program's own state: the first steps check the start from
the seed's weights, the last step the window's own path.

``grad_gap``, the first step's gradient as Adam got it (worked out from
its first moment after one step: m / (1 − β1)) by the same measure as
``change_gap`` over every leaf, is reported and not compared: neither the
control nor a fault reads it far enough above the program to set a limit
(``PERF.md`` §6, PR 25: the readings).

``variant`` (the calibration's only): 'control' trains in the program's
bfloat16 compute (``train_dtype``), the precision below the stated float32;
'half_batch' feeds the program the first half of every batch's rows.
"""

import math
import statistics

import torch

from benchmark import inputs, weights, work
from benchmark.reference import recnet as reference

CHECKS = ('loss_gap', 'change_gap', 'out_err', 'last_loss_gap',
          'last_change_gap', 'last_out_err')
# faults the calibration plants in the program (``variant``)
FAULTS = ('half_batch',)
KEEP = 1e-3


def _worst(values):
  """The largest value, a value that is not finite counting as infinite."""
  return max(v if math.isfinite(v) else math.inf for v in values)


def _gaps(got, want, names):
  """Each leaf's |got − want| / max(want, the median leaf's want)."""
  median = statistics.median(want[n] for n in names)
  gaps = [abs(got[n] - want[n]) / max(want[n], median) for n in names]
  return [g if math.isfinite(g) else math.inf for g in gaps]


class System:

  def __init__(self, conf, traffic, seed, device, variant=None):
    from csmri_refinement_tpu_torch.ops import dc as dc_ops
    from csmri_refinement_tpu_torch.training import build_runner
    from csmri_refinement_tpu_torch.utils.config import Configuration
    bench = conf['bench']
    torch.backends.cudnn.allow_tf32 = bench['cudnn_tf32']
    torch.backends.cuda.matmul.allow_tf32 = bench['matmul_tf32']
    if traffic['batch'] != conf['batch_size']:
      raise ValueError('the traffic\'s batch {} is not the configuration\'s '
                       '{}'.format(traffic['batch'], conf['batch_size']))
    self.conf, self.traffic = conf, traffic
    self.dc_ops = dc_ops
    run_conf = {k: v for k, v in conf.items() if k != 'bench'}
    if variant == 'control':
      run_conf['train_dtype'] = 'bfloat16'
    self.half = variant == 'half_batch'
    runner = build_runner(Configuration.from_dict(run_conf),
                          run_conf['runner_type'], mode='train',
                          device=device)
    state = runner.model.state_dict()
    expected = reference.param_shapes(conf['model'])
    if {n: tuple(t.shape) for n, t in state.items()} != expected:
      raise ValueError('the program is not the configuration')
    gen = torch.Generator(device=device).manual_seed(seed)
    self.weights = weights.draw(state, gen, lambda name: reference.LEAK)
    runner.model.load_state_dict(self.weights)
    self.runner = runner
    self.pool = inputs.pool(gen, traffic,
                            ('inp', 'kspace', 'mask', 'target'))
    self.units = traffic['batch']
    self.first = {'loss': []}
    self.snap = None     # the state the latest window step started from
    self.snap_call = None
    self.last = None     # (call, loss, output) of the latest window step

  def _batch(self, i):
    batch = self.pool[i % len(self.pool)]
    if self.half:
      batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
    return batch

  def _snapshot(self, i):
    """Copy the parameters and Adam's moments that step ``i`` starts
    from into the benchmark's buffers (one copy of all, on the device)."""
    if self.snap is None:
      self.params = [p for _, p in self.runner.model.named_parameters()]
    state = self.runner.optimizer.state
    live = self.params + [state[p]['exp_avg'] for p in self.params] + \
        [state[p]['exp_avg_sq'] for p in self.params]
    if self.snap is None:
      self.snap = [torch.empty_like(t) for t in live]
    with torch.no_grad():
      torch._foreach_copy_(self.snap, live)
    self.snap_call = i

  def call(self, i):
    if i >= self.traffic['warm_calls']:
      self._snapshot(i)
    losses, out = self.runner.train_batch(self._batch(i))
    loss = float(losses['loss'])
    if not math.isfinite(loss):
      raise FloatingPointError('step {} loss {}'.format(i, loss))
    return loss, out

  def _named(self):
    return dict(self.runner.model.named_parameters())

  def done(self, i, out, warm):
    """Record the first steps: their losses, the first gradient as the
    optimizer holds it, the change after the last of them; of the
    window's steps, the latest."""
    loss, output = out
    if not warm:
      self.last = (i, loss, output)
      return
    self.first['loss'].append(loss)
    if i == 0:
      self.first['out'] = output
      opt = self.runner.optimizer
      beta1 = opt.param_groups[0]['betas'][0]
      self.first['grad'] = {
          n: float((opt.state[p]['exp_avg'] / (1 - beta1)).double().norm())
          for n, p in self._named().items()}
    self.first['change'] = {
        n: float((p.detach() - self.weights[n]).double().norm())
        for n, p in self._named().items()}

  def install(self, ranges):
    ranges.attribute(self.dc_ops, 'data_consistency', 'dc')

  def work(self):
    """Operations a step, and operations and least bytes a forward DC."""
    h, w, b = self.traffic['height'], self.traffic['width'], \
        self.traffic['batch']
    model = reference.model_conf(self.conf['model'])
    convs = work.recnet_convs(model, h, w)
    dc_flops, dc_bytes = work.dc(h, w)
    n_dc = model['num_blocks']
    # forward, weight and input gradients; the first conv has no input
    # gradient; each DC forward and its adjoint
    step = 2 * (3 * sum(convs) - convs[0]) + 2 * n_dc * dc_flops
    return {'flops_per_call': b * step, 'dc_flops': b * dc_flops,
            'dc_bytes': b * dc_bytes}

  def release(self):
    """Free the program; keep the weights, the state the last step
    started from and the parameters it left, and the batches of the
    first steps and of the last."""
    named = self._named()
    self.after = {n: p.detach().clone() for n, p in named.items()}
    if self.snap is not None:
      k = len(named)
      self.before = {key: dict(zip(named, self.snap[j * k:(j + 1) * k]))
                     for j, key in enumerate(('params', 'exp_avg',
                                              'exp_avg_sq'))}
    self.runner = None
    n = self.traffic['warm_calls']
    calls = list(range(n)) + ([self.last[0]] if self.last else [])
    self.pool = {i: self.pool[i % len(self.pool)] for i in calls}

  def check(self):
    limits = self.conf['bench']['limits']
    n = self.traffic['warm_calls']
    worst = dict.fromkeys(CHECKS, math.inf)
    if len(self.first['loss']) == n and 'grad' in self.first:
      ref = reference.train_steps(self.conf, self.weights,
                                  [self.pool[i] for i in range(n)])
      first = _compare(self.first, ref)
      worst.update(loss_gap=first['loss'], change_gap=first['change'],
                   out_err=first['out'])
      grad = _gaps(self.first['grad'], ref['grad'], sorted(ref['grad']))
      self.reported = {'grad_gap': max(grad)}
      self.details = {'grad_median': statistics.median(grad),
                      'change_median': first['change_median']}
      self.details.update({key: {'program': self.first[key],
                                 'reference': ref[key]}
                           for key in ('loss', 'grad', 'change')})
    # the window's last step, from the state the program started it from;
    # a step whose state was not kept is no answer
    if self.last is not None and self.snap_call == self.last[0]:
      i, loss, output = self.last
      before = self.before['params']
      ref = reference.train_steps(self.conf, before, [self.pool[i]],
                                  moments=self.before, steps=i)
      change = {name: float((self.after[name] - p).double().norm())
                for name, p in before.items()}
      last = _compare({'loss': [loss], 'out': output, 'change': change}, ref)
      worst.update(last_loss_gap=last['loss'],
                   last_change_gap=last['change_median'],
                   last_out_err=last['out'])
      self.reported = dict(getattr(self, 'reported', {}),
                           last_change_worst=last['change'])
      self.details = dict(getattr(self, 'details', {}), last_call=i)
    return [(name, worst[name], limits[name]) for name in CHECKS]


def _compare(got, ref):
  """The worst loss gap, the worst moved leaf's change gap (leaves whose
  reference gradient is at least ``KEEP`` of the median leaf's), and the
  first step's output error, of ``got`` against ``ref`` (both as
  ``reference.train_steps`` returns them; ``got`` needs no 'grad')."""
  loss = _worst(abs(a - b) / b for a, b in zip(got['loss'], ref['loss']))
  if len(got['loss']) != len(ref['loss']):
    loss = math.inf
  names = sorted(ref['grad'])
  median = statistics.median(ref['grad'][n] for n in names)
  moved = [n for n in names if ref['grad'][n] >= KEEP * median]
  change = _gaps(got['change'], ref['change'], moved)
  out = math.inf   # an output of another shape is no answer
  if got['out'].shape == ref['out'].shape:
    out = float((got['out'].double() - ref['out'].double()).norm() /
                ref['out'].double().norm())
  return {'loss': loss, 'change': max(change),
          'change_median': statistics.median(change),
          'out': out if math.isfinite(out) else math.inf}


def build(conf, traffic, seed, device, variant=None):
  return System(conf, traffic, seed, device, variant)
