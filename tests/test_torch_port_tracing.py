"""The port's spans (``utils/profiling.py::span``): where they sit, how
they nest, the DC's span names by route, and that they cost nothing but a
check with no profiler recording.

CPU tests run in the Tier-1 suite. Those marked ``cuda`` need the card
(skipped without one, decided in their fixture) and run there with

    python -m pytest --noconftest -m cuda tests/test_torch_port_tracing.py

(this file imports torch and the port only).
"""

import copy
import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from csmri_refinement_tpu_torch import build_flagship
from csmri_refinement_tpu_torch import profile_flagship
from csmri_refinement_tpu_torch.ops import dc as dc_ops
from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.ops.undersample import undersample_batch
from csmri_refinement_tpu_torch.training.runner import Runner
from csmri_refinement_tpu_torch.utils.config import Configuration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')


def _trace(prof, tmp_path):
  """The profile's Chrome trace events, as a reader of the exported file
  sees them."""
  path = str(tmp_path / 'trace.json')
  prof.export_chrome_trace(path)
  with open(path) as f:
    return [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']


def _spans(events):
  """{name: [(start, end, tid)]} of the port's spans, in start order."""
  out = {}
  for e in sorted(events, key=lambda e: float(e['ts'])):
    if e.get('cat') == 'user_annotation' and e['name'].startswith('csmri.'):
      start = float(e['ts'])
      out.setdefault(e['name'], []).append(
          (start, start + float(e['dur']), e.get('tid')))
  return out


def _inside(inner, outer):
  return outer[0] <= inner[0] and inner[1] <= outer[1] and \
      inner[2] == outer[2]


def _flagship_batch(h, w, device='cpu'):
  gen = torch.Generator(device=device).manual_seed(h * w)
  gt = torch.rand(2, h, w, generator=gen, device=device)
  return undersample_batch(gen, gt, 'varden', 8)


def _serve(model, batch):
  with torch.inference_mode():
    return model(batch['inp'], batch['kspace'], batch['mask'])


def _runner(device='cpu'):
  conf = Configuration.from_json(os.path.join(REPO, 'configs',
                                              'synthetic-recnet.json'))
  return Runner(conf, 'train', device)


def _train_batch(h, w, device='cpu'):
  gen = torch.Generator(device=device).manual_seed(3)
  return undersample_batch(gen, torch.rand(2, h, w, generator=gen,
                                           device=device), 'varden', 8)


@pytest.mark.parametrize('h, w', [(32, 32), (40, 24)])
def test_flagship_forward_spans_nest_in_the_refinement(tmp_path, h, w):
  model, _ = build_flagship(32, torch.bfloat16, 'cpu')
  batch = _flagship_batch(h, w)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    _serve(model, batch)
  spans = _spans(_trace(prof, tmp_path))
  assert len(spans['csmri.refinement']) == 1
  assert len(spans['csmri.recnet.block']) == 3
  # the DC of a CPU tensor runs the plain version, outside the blocks
  assert len(spans['csmri.dc.plain']) == 3
  assert len(spans['csmri.unet.upconv']) == 2
  # BN folded for 3 encoders and 2 decoders, and each up-conv's phases
  assert len(spans['csmri.unet.prepare']) == 7
  assert set(spans) == {'csmri.refinement', 'csmri.recnet.block',
                        'csmri.dc.plain', 'csmri.unet.upconv',
                        'csmri.unet.prepare'}
  whole = spans['csmri.refinement'][0]
  for name, found in spans.items():
    for span in found:
      assert _inside(span, whole), name
  for dc in spans['csmri.dc.plain']:
    assert not any(_inside(dc, block)
                   for block in spans['csmri.recnet.block'])
  # the phase weights are prepared inside their up-conv
  inside = [p for p in spans['csmri.unet.prepare']
            if any(_inside(p, up) for up in spans['csmri.unet.upconv'])]
  assert len(inside) == 2


@pytest.mark.parametrize('h, w, routes', [
    (512, 512, 'fft.fft'), (640, 368, 'mixed.chirp'),
    (40, 24, 'mixed.mixed')])
@pytest.mark.parametrize('kind', ['dc', 'dc_bwd'])
def test_dc_span_names_carry_the_routes(kind, h, w, routes):
  assert dc_kernel.span_name(kind, 'cuda', h, w) == \
      'csmri.{}.{}'.format(kind, routes)
  assert dc_kernel.span_name(kind, 'cpu', h, w) == \
      'csmri.{}.plain'.format(kind)
  # the route of each axis as the kernel takes it
  assert routes.split('.') == list(dc_kernel.dc_route(h, w))


def test_noisy_and_backward_dc_spans_on_the_cpu(tmp_path):
  batch = _flagship_batch(16, 24)
  x = batch['inp'].clone().requires_grad_(True)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    dc_ops.data_consistency(batch['inp'], batch['kspace'], batch['mask'],
                            noise_lvl=0.1)
    y = dc_kernel._DCFunction.apply(x, batch['kspace'], batch['mask'])
    y.sum().backward()
  spans = _spans(_trace(prof, tmp_path))
  assert len(spans['csmri.dc.noisy']) == 1
  assert len(spans['csmri.dc_bwd.plain']) == 1


def test_train_step_spans_nest_in_the_step(tmp_path):
  runner = _runner()
  batch = _train_batch(32, 32)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    runner.train_batch(batch)
  spans = _spans(_trace(prof, tmp_path))
  assert len(spans['csmri.train.step']) == 1
  step = spans['csmri.train.step'][0]
  for name, count in (('csmri.recnet.block', 3), ('csmri.dc.plain', 3),
                      ('csmri.train.backward', 1),
                      ('csmri.train.optimizer', 1)):
    assert len(spans[name]) == count, name
    assert all(_inside(s, step) for s in spans[name]), name
  backward = spans['csmri.train.backward'][0]
  optimizer = spans['csmri.train.optimizer'][0]
  assert backward[1] <= optimizer[0]
  assert all(block[1] <= backward[0] for block in spans['csmri.recnet.block'])


class _Counting:
  """``torch.profiler.record_function`` that counts the ranges opened."""

  def __init__(self, original):
    self.original = original
    self.opened = 0

  def __call__(self, *args, **kwargs):
    self.opened += 1
    return self.original(*args, **kwargs)


def test_tracing_off_opens_no_range_and_changes_no_output(monkeypatch):
  counting = _Counting(torch.profiler.record_function)
  monkeypatch.setattr(torch.profiler, 'record_function', counting)
  model, _ = build_flagship(32, torch.bfloat16, 'cpu')
  serve = _flagship_batch(32, 24)
  runners = [_runner(), _runner()]
  batch = _train_batch(32, 32)

  off = _serve(model, serve)
  off_step = runners[0].train_batch(batch)
  assert counting.opened == 0

  with profile(activities=[ProfilerActivity.CPU]):
    on = _serve(model, serve)
    on_step = runners[1].train_batch(batch)
  # the program's spans go through the name patched above
  assert counting.opened >= 1 + 3 + 3 + 2 + 7 + 1 + 3 + 3 + 2
  for key in off:
    assert torch.equal(off[key], on[key]), key
  assert torch.equal(off_step[0]['loss'], on_step[0]['loss'])
  assert torch.equal(off_step[1], on_step[1])
  for (name, a), b in zip(runners[0].model.state_dict().items(),
                          runners[1].model.state_dict().values()):
    assert torch.equal(a, b), name


def test_span_names_are_made_only_while_recording():
  from csmri_refinement_tpu_torch.utils import profiling
  made = []
  with profiling.span(lambda: made.append(1) or 'csmri.x'):
    pass
  assert not made
  with profile(activities=[ProfilerActivity.CPU]):
    with profiling.span(lambda: made.append(1) or 'csmri.x'):
      pass
  assert made == [1]


def _averaged(key, device_type, self_device_us, annotation=False):
  """A ``key_averages()`` entry of three calls."""
  return SimpleNamespace(key=key, device_type=device_type, count=3,
                         self_device_time_total=self_device_us,
                         is_user_annotation=annotation)


def test_profile_report_leaves_the_spans_out_of_device_time(capsys):
  """The device-side entry of a ``csmri.*`` range spans the kernels it
  holds: counting it would count them again."""
  cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
  prof = SimpleNamespace(key_averages=lambda: [
      _averaged('csmri.refinement', cuda, 1000.0, annotation=True),
      _averaged('conv_kernel', cuda, 600.0),
      _averaged('csmri.recnet.block', cuda, 700.0, annotation=True),
      _averaged('aten::conv2d', cpu, 0.0),
      _averaged('Memcpy DtoD (Device -> Device)', cuda, 150.0)])
  assert [e.key for e in profile_flagship.device_events(prof)] == [
      'conv_kernel', 'Memcpy DtoD (Device -> Device)']
  profile_flagship.report(prof, 3.0, 3, 'flagship', 'forward')
  out = capsys.readouterr().out
  assert 'device busy 0.250 ms per forward, idle share 75.0%' in out
  assert 'csmri.' not in out


@pytest.mark.cuda
def test_profile_report_sums_the_device_operations_of_the_trace(
    card, tmp_path):
  """``report``'s device time is the summed length of the kernels,
  copies and sets in the exported trace, spans or none."""
  model, _ = build_flagship(64, torch.bfloat16, card)
  batch = _flagship_batch(64, 64, card)
  _serve(model, batch)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    _serve(model, batch)
    torch.cuda.synchronize()
  events = _trace(prof, tmp_path)
  assert _spans(events)['csmri.refinement']
  in_trace = sum(float(e['dur']) for e in events if e.get('cat') in (
      'kernel', 'gpu_memcpy', 'gpu_memset'))
  reported = sum(e.self_device_time_total
                 for e in profile_flagship.device_events(prof))
  assert reported == pytest.approx(in_trace, rel=1e-3)


@pytest.mark.cuda
def test_dc_bwd_spans_on_the_autograd_thread_launch_k1_bwd(card, tmp_path):
  runner = _runner(card)
  batch = _train_batch(64, 64, card)
  runner.train_batch(batch)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    runner.train_batch(batch)
    torch.cuda.synchronize()
  events = _trace(prof, tmp_path)
  spans = _spans(events)
  step = spans['csmri.train.step'][0]
  assert len(spans['csmri.dc.fft.fft']) == 3
  bwd = spans['csmri.dc_bwd.fft.fft']
  assert len(bwd) == 3
  # the autograd engine's device thread, not the caller's
  assert all(s[2] != step[2] for s in bwd)
  launches = {(e.get('args') or {}).get('correlation'): float(e['ts'])
              for e in events if e.get('cat') in ('cuda_runtime',
                                                  'cuda_driver')}
  ops = [e for e in events if e.get('cat') == 'kernel' and any(
      s[0] <= launches.get((e.get('args') or {}).get('correlation'), -1.0)
      <= s[1] for s in bwd)]
  assert len(ops) >= 3
  backward = spans['csmri.train.backward'][0]
  assert all(backward[0] <= s[0] and s[1] <= backward[1] for s in bwd)
