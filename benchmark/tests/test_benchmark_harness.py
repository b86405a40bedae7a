"""The harness on the CPU: the result line, BENCHMARK.json's names, the
work arithmetic, the references against the port's plain path, and the
check that no JAX module is loaded."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import harness, weights, work
from benchmark.reference import flagship as ref_flagship

ROOT = harness.ROOT
SPEC = harness.load_json(ROOT, 'BENCHMARK.json')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
CELLS = [w['name'] for w in SPEC['workloads']]


def test_benchmark_json_keeps_to_its_contract():
  assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                       'workloads', 'end_to_end', 'per_layer'}
  assert SPEC['command'] == ['python3', 'benchmark/run.py']
  assert SPEC['paths'] == ['benchmark']
  assert 1 <= SPEC['run_seconds'] <= 51
  metrics = SPEC['end_to_end'] + SPEC['per_layer']
  names = [c['name'] for c in SPEC['configs']] + CELLS + \
      [m['name'] for m in metrics]
  assert len(set(names)) == len(names)
  for name in names:
    assert NAME.match(name), name
  for c in SPEC['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    assert c['file'] == 'benchmark/configs/{}.json'.format(c['name'])
    assert os.path.exists(os.path.join(ROOT, c['file']))
    assert os.path.exists(os.path.join(ROOT, 'benchmark', 'configs',
                                       c['name'] + '.py'))
  for w in SPEC['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(w['traffic']) and w['chips'] == 1
    assert os.path.exists(os.path.join(ROOT, 'benchmark', 'traffic',
                                       w['traffic'] + '.json'))
  for text in [c['why'] for c in SPEC['configs'] + SPEC['workloads']] + \
      [m['layer'] for m in SPEC['per_layer']]:
    assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text
  for m in metrics:
    assert UNIT.match(m['unit']), m
    assert m['better'] in ('lower', 'higher')
    assert os.path.exists(os.path.join(ROOT, 'benchmark', 'metrics',
                                       m['name'] + '.py'))
  for m in SPEC['end_to_end']:
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= m['bound'] <= 0.25
  assert {m['name'] for m in SPEC['end_to_end']} >= {'setup_s'}
  for cell in CELLS:
    e2e = harness.Cell(SPEC, cell).metrics(False)
    assert 'setup_s' in dict(e2e) and len(e2e) >= 2
    assert harness.Cell(SPEC, cell).metrics(True)
  for m in SPEC['per_layer']:
    for cell in m['workloads']:
      assert m['moves'] in dict(harness.Cell(SPEC, cell).metrics(False))


def test_work_against_hand_counts():
  block = {'num_blocks': 1, 'num_convs': 3, 'num_filters': 32,
           'kernel_size': 3}
  # 2 -> 32 -> 32 -> 2 channels, 3 x 3, on 8 x 8
  assert work.recnet_convs(block, 8, 8) == [
      8 * 8 * 2 * 32 * 9, 8 * 8 * 32 * 32 * 9, 8 * 8 * 32 * 2 * 9]
  scale = {'num_inputs': 2, 'num_outputs': 1, 'num_layers_per_scale': 2,
           'encode_filters': [4], 'decode_filters': [], 'kernel_size': 4,
           'upsampling_mode': 'nn-resize-conv'}
  # two k4 convs 2 -> 4 -> 4 on 8 x 8, then the 1 x 1 head 4 -> 1
  assert work.unet_macs(scale, 8, 8) == 8 * 8 * (2 * 4 * 16 + 4 * 4 * 16 + 4)
  # nearest-up-2 then k4: 3 and 2 distinct taps a row, 6.25 a pixel
  assert work.resize_conv_macs(8, 8, 4, 2, 4) == 8 * 8 * 4 * 2 * 6.25
  assert work.fft2_flops(8, 8) == 5 * 64 * 6
  assert work.dc(8, 8) == (2 * 5 * 64 * 6, 28 * 64)
  conf = harness.load_json(ROOT, 'benchmark', 'configs', 'flagship.json')
  unet = conf['generator_model']['learnable_model']
  # per pixel of a 512 x 512 slice, worked by hand scale by scale
  assert work.unet_macs(unet, 512, 512) == 512 * 512 * (
      17408 + 24576 + 24576 + 12800 + 49152 + 12800 + 49152 + 32)


@pytest.mark.parametrize('workload', CELLS)
def test_last_line_keys(tiny_cell, workload):
  line = harness.execute(tiny_cell(workload), 2 ** 31 + 11, 1.0, False,
                         device='cpu')
  assert list(line) == ['correct', 'attempted', 'failed', 'metrics',
                        'device', 'checks']
  assert isinstance(line['correct'], bool)
  assert line['attempted'] > 0 and line['failed'] == 0
  assert set(line['device']) == {'platform', 'kind', 'count',
                                 'memory_peak_bytes'}
  units = {m['name']: m['unit'] for m in SPEC['end_to_end']}
  assert set(line['metrics']) == {n for n, _ in
                                  harness.Cell(SPEC, workload).metrics(False)}
  for name, got in line['metrics'].items():
    assert got['unit'] == units[name] and got['value'] > 0
  for got in line['checks'].values():
    assert set(got) == {'value', 'limit'}
  json.dumps(line)


def test_flagship_reference_matches_the_ports_plain_path():
  """The port's f32 forward on the CPU (its kernels' plain versions) and
  the reference, on the benchmark's weights and inputs."""
  from csmri_refinement_tpu_torch import flagship
  from benchmark import inputs
  conf = harness.load_json(ROOT, 'benchmark', 'configs', 'flagship.json')
  model = flagship.flagship_model(torch.float32).eval()
  gen = torch.Generator().manual_seed(5)
  w = weights.draw(model.state_dict(), gen, lambda n: 0.1)
  model.load_state_dict(w)
  traffic = {'height': 32, 'width': 24, 'batch': 3, 'sampling': 'varden',
             'acceleration': 8, 'centre_lines': 8, 'ellipses': 8}
  batch = inputs.batch(gen, traffic, ('inp', 'kspace', 'mask'))
  with torch.no_grad():
    got = model(batch['inp'], batch['kspace'], batch['mask'])
  ref = ref_flagship.forward(conf, w, batch['inp'], batch['kspace'],
                             batch['mask'])
  for mine, theirs in (('pretrained', 'pretrained'),
                       ('prescaled_refinement', 'refinement'),
                       ('pred', 'pred')):
    err = (got[mine] - ref[theirs]).norm() / ref[theirs].norm()
    assert err < 1e-5, (mine, float(err))


def test_recnet_reference_matches_the_ports_runner(tiny_cell):
  """Three Adam steps of the port's Runner on the CPU and of the
  reference, from the same weights and batches; then two steps of the
  window, the last of which the reference repeats from the state the
  program started it from."""
  cell = tiny_cell('recnet.train.512.b20')
  config = harness.load_module('configs', 'recnet')
  system = config.build(cell.conf, cell.traffic, 7, 'cpu')
  warm = cell.traffic['warm_calls']
  for i in range(warm + 2):
    system.done(i, system.call(i), warm=i < warm)
  system.release()
  system.conf['bench']['limits'] = dict.fromkeys(config.CHECKS, 1.0)
  checks = system.check()
  assert [name for name, _, _ in checks] == list(config.CHECKS)
  for name, value, _ in checks:
    assert value < 1e-5, (name, value)
  assert system.details['last_call'] == warm + 1


def test_forbidden_modules_compare_whole_names():
  assert harness.forbidden_modules(
      ['csmri_refinement_tpu_torch', 'csmri_refinement_tpu_torch.ops.dc',
       'jaxtyping', 'flaxen', 'torch']) == []
  assert harness.forbidden_modules(
      ['csmri_refinement_tpu.ops', 'jax', 'jaxlib.xla_client',
       'flax.linen']) == ['csmri_refinement_tpu', 'flax', 'jax', 'jaxlib']


def _imports(path):
  tree = ast.parse(open(path).read())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
  here = os.path.join(ROOT, 'benchmark')
  for folder, _, files in os.walk(here):
    for f in files:
      if not f.endswith('.py'):
        continue
      path = os.path.join(folder, f)
      tops = {m.split('.')[0] for m in _imports(path)}
      assert not tops & set(harness.FORBIDDEN), path
      if os.path.basename(folder) == 'reference':
        assert 'csmri_refinement_tpu_torch' not in tops, path


def test_a_run_loads_no_jax_module():
  """A whole tiny run of each configuration in a fresh interpreter."""
  code = (
      'import sys; sys.path.insert(0, {root!r})\n'
      'from benchmark import harness\n'
      'from benchmark.tests.conftest import TINY\n'
      'spec = harness.load_json({root!r}, "BENCHMARK.json")\n'
      'for name in ("flagship.512.b32", "recnet.train.512.b20"):\n'
      '  cell = harness.Cell(spec, name)\n'
      '  cell.traffic.update(TINY)\n'
      '  cell.conf["batch_size"] = TINY["batch"]\n'
      '  harness.execute(cell, 3, 0.2, False, device="cpu")\n'
      'print(harness.forbidden_modules())\n').format(root=ROOT)
  env = dict(os.environ)
  env.pop('JAX_PLATFORMS', None)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
  assert out.returncode == 0, out.stderr[-2000:]
  assert out.stdout.strip().splitlines()[-1] == '[]'


def test_run_without_a_card_exits_without_a_result():
  out = subprocess.run(
      [sys.executable, 'benchmark/run.py', '--workload', CELLS[0], '--seed',
       '1', '--seconds', '1', '--trace', '0'], capture_output=True,
      text=True, timeout=300, cwd=ROOT)
  if torch.cuda.is_available():
    pytest.skip('a card is here')
  assert out.returncode != 0
  assert out.stdout.strip() == ''


def test_trace_reduction_attributes_device_time_by_launch():
  from benchmark import tracing

  def x(cat, name, ts, dur, tid, corr=None):
    event = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
             'tid': tid, 'pid': 1}
    if corr is not None:
      event['args'] = {'correlation': corr}
    return event

  events = [
      x('user_annotation', 'bench.window', 0, 1000, 1),
      x('user_annotation', 'bench.dc', 100, 50, 1),
      x('cpu_op', 'aten::add', 110, 20, 1),
      x('cuda_runtime', 'cudaLaunchKernel', 115, 5, 1, 7),
      x('cuda_driver', 'cuLaunchKernelEx', 300, 5, 1, 8),
      x('cuda_runtime', 'cudaLaunchKernel', 320, 5, 1, 9),
      # the DC's kernel runs after its range closed on the host
      x('kernel', 'dc_kernel', 200, 100, 7, 7),
      x('kernel', 'other', 350, 100, 7, 8),
      x('gpu_memcpy', 'copy', 400, 100, 8, 9),
      x('cpu_op', 'aten::wait', 480, 400, 1),
  ]
  got = tracing.reduce_trace(events)
  assert got['window_s'] == pytest.approx(1e-3)
  # kernels 200-300 and 350-500 (the copy overlaps the second)
  assert got['busy_s'] == pytest.approx(250e-6)
  assert got['ranges'] == {'bench.dc': {'count': 1,
                                        'device_s': pytest.approx(1e-4)}}
  assert got['device_ops'][0] == ['dc_kernel', pytest.approx(1e-4)]
  # 0-200 under the window range, 300-350 in the driver call, 500-1000
  # from inside aten::wait
  gaps = dict(got['idle_gaps'])
  assert gaps['aten::wait'] == pytest.approx(500e-6)
  assert gaps['bench.window'] == pytest.approx(200e-6)
  assert gaps['cuLaunchKernelEx'] == pytest.approx(50e-6)
