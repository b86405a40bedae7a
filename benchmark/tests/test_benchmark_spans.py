"""The reduction of the program's spans (``benchmark/spans.py``) on
synthetic Chrome traces, ``tracing.reduce_trace`` beside them, and the
rules of the metrics that read the spans."""

import pytest

from benchmark import harness, spans, tracing


def x(cat, name, ts, dur, tid, corr=None):
  event = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
           'tid': tid, 'pid': 1}
  if corr is not None:
    event['args'] = {'correlation': corr}
  return event


# the caller's thread (1) waits in the backward while the autograd
# engine's thread (2) runs two K1-bwd spans of two routes
BACKWARD = [
    x('user_annotation', 'bench.window', 0, 1000, 1),
    x('user_annotation', 'csmri.train.step', 10, 600, 1),
    x('user_annotation', 'csmri.train.backward', 100, 300, 1),
    x('user_annotation', 'csmri.dc_bwd.fft.fft', 120, 20, 2),
    x('cuda_runtime', 'cudaLaunchKernel', 125, 5, 2, 1),
    x('kernel', 'k1_bwd', 150, 20, 7, 1),
    x('user_annotation', 'csmri.dc_bwd.mixed.chirp', 300, 20, 2),
    x('cuda_runtime', 'cudaLaunchKernel', 305, 5, 2, 3),
    x('cuda_runtime', 'cudaMemcpyAsync', 310, 5, 2, 4),
    x('kernel', 'k1_bwd_chirp', 330, 10, 7, 3),
    x('gpu_memcpy', 'copy', 335, 15, 8, 4),
    # launched after the backward, inside the step
    x('cuda_runtime', 'cudaLaunchKernel', 420, 5, 1, 2),
    x('kernel', 'adam', 430, 40, 7, 2),
    # a launch in no span
    x('cuda_runtime', 'cudaLaunchKernel', 700, 5, 1, 5),
    x('kernel', 'fetch', 710, 10, 7, 5),
]


def test_reduce_spans_attributes_launches_on_any_thread():
  got = spans.reduce_spans(BACKWARD)
  assert set(got) == {'csmri.train.step', 'csmri.train.backward',
                      'csmri.dc_bwd.fft.fft', 'csmri.dc_bwd.mixed.chirp'}
  # the backward's launches are the autograd thread's
  assert got['csmri.train.backward'] == {
      'count': 1, 'device_s': pytest.approx(40e-6), 'ops': 3,
      'host_s': pytest.approx(300e-6)}
  assert got['csmri.dc_bwd.fft.fft'] == {
      'count': 1, 'device_s': pytest.approx(20e-6), 'ops': 1,
      'host_s': pytest.approx(20e-6)}
  # a kernel and a copy that overlap: two operations, their union
  assert got['csmri.dc_bwd.mixed.chirp']['ops'] == 2
  assert got['csmri.dc_bwd.mixed.chirp']['device_s'] == \
      pytest.approx(20e-6)
  assert got['csmri.train.step']['ops'] == 4
  assert got['csmri.train.step']['device_s'] == pytest.approx(80e-6)


def test_reduce_spans_counts_every_span_of_a_name():
  events = [x('user_annotation', 'csmri.dc.fft.fft', 100 * i, 10, 1)
            for i in range(3)]
  events += [x('cuda_runtime', 'cudaLaunchKernel', 100 * i + 5, 1, 1, i)
             for i in range(3)]
  events += [x('kernel', 'k1', 100 * i + 50, 30, 7, i) for i in range(3)]
  got = spans.reduce_spans(events)['csmri.dc.fft.fft']
  assert got['count'] == 3 and got['ops'] == 3
  assert got['device_s'] == pytest.approx(90e-6)
  assert got['host_s'] == pytest.approx(30e-6)


def test_total_sums_the_names_under_a_prefix():
  got = spans.reduce_spans(BACKWARD)
  both = spans.total(got, 'csmri.dc_bwd.')
  assert both['count'] == 2 and both['ops'] == 3
  assert both['device_s'] == pytest.approx(40e-6)
  assert both['host_s'] == pytest.approx(40e-6)
  assert spans.total(got, 'csmri.dc.') is None
  assert spans.reduce_spans([e for e in BACKWARD
                             if not e['name'].startswith('csmri.')]) == {}


def test_log_lines_give_each_name_a_call():
  lines = spans.log_lines(spans.reduce_spans(BACKWARD))
  assert len(lines) == 4
  assert 'span csmri.dc_bwd.mixed.chirp: 1 calls, 0.0200 ms device, ' \
      '2.0 ops, 0.0200 ms host a call' in lines


# ``reduce_trace``'s own test trace (test_benchmark_harness.py)
PLAIN = [
    x('user_annotation', 'bench.window', 0, 1000, 1),
    x('user_annotation', 'bench.dc', 100, 50, 1),
    x('cpu_op', 'aten::add', 110, 20, 1),
    x('cuda_runtime', 'cudaLaunchKernel', 115, 5, 1, 7),
    x('cuda_driver', 'cuLaunchKernelEx', 300, 5, 1, 8),
    x('cuda_runtime', 'cudaLaunchKernel', 320, 5, 1, 9),
    x('kernel', 'dc_kernel', 200, 100, 7, 7),
    x('kernel', 'other', 350, 100, 7, 8),
    x('gpu_memcpy', 'copy', 400, 100, 8, 9),
    x('cpu_op', 'aten::wait', 480, 400, 1),
]


def test_reduce_trace_reads_the_same_beside_the_programs_spans():
  """Spans around the host's work, as the program's are: every key and
  value of ``reduce_trace`` as without them."""
  with_spans = PLAIN + [
      x('user_annotation', 'csmri.refinement', 1, 998, 1),
      x('user_annotation', 'csmri.dc.fft.fft', 105, 40, 1),
      x('user_annotation', 'csmri.recnet.block', 290, 40, 1),
  ]
  assert tracing.reduce_trace(with_spans) == tracing.reduce_trace(PLAIN)


def test_an_idle_gap_inside_a_span_is_filed_under_it():
  """The caller waiting in the backward with no host operation of its
  own: the device's idle time from then on goes to the span."""
  got = tracing.reduce_trace(BACKWARD)
  gaps = dict(got['idle_gaps'])
  # 170-330 and 350-430 begin inside the backward, 470-710 inside the
  # step after it
  assert gaps['csmri.train.backward'] == pytest.approx(240e-6)
  assert gaps['csmri.train.step'] == pytest.approx(240e-6)
  assert got['ranges'] == {}


SPEC = harness.load_json(harness.ROOT, 'BENCHMARK.json')
PEAKS = harness.load_json(harness.HERE, 'peaks.json')


def _run(workload):
  return harness.Run(harness.Cell(SPEC, workload), None, 0.0, None, None,
                     PEAKS)


def _logged(**calls):
  """The spans of a run's log lines: {name: (calls, device ms a call, ops
  a call)}, keyword names with '__' for '.'."""
  return {'csmri.' + name.replace('__', '.'): {
      'count': n, 'device_s': n * ms * 1e-3, 'ops': n * ops, 'host_s': 0.0}
          for name, (n, ms, ops) in calls.items()}


# The spans tables of traced runs on an NVIDIA H100 80GB HBM3 at 700 W,
# and what each metric read from the unrounded spans.
LOGGED = {
    'flagship.512.b32': (_logged(
        dc__fft__fft=(1131, 0.2704, 4.0),
        recnet__block=(1131, 5.4384, 25.3),
        refinement=(377, 38.6567, 298.0),
        unet__prepare=(6409, 0.0109, 6.6),
        unet__upconv=(754, 3.0820, 32.0)), {
            'recnet_roofline.serve': 3.2340762347537204,
            'upconv_roofline.serve': 7.045430306227286,
            'unet_prep_ms.serve': 0.1848562225422745,
            'device_ops_per_request.serve': 298.0}),
    'flagship.640x368.b32': (_logged(
        dc__mixed__chirp=(1167, 0.8524, 4.0),
        recnet__block=(1167, 4.9029, 25.3),
        refinement=(389, 37.4260, 298.0),
        unet__prepare=(6613, 0.0109, 6.6),
        unet__upconv=(778, 2.8087, 32.0)), {
            'recnet_roofline.serve': 3.2229633032951486,
            'upconv_roofline.serve': 6.9458119254479165,
            'unet_prep_ms.serve': 0.185456077281491,
            'device_ops_per_request.serve': 298.0}),
    'recnet.train.512.b20': (_logged(
        dc__fft__fft=(834, 0.1343, 3.0),
        dc_bwd__fft__fft=(834, 0.1123, 3.0),
        recnet__block=(834, 4.3833, 18.0),
        train__backward=(278, 38.8096, 126.0),
        train__optimizer=(278, 0.0221, 7.0),
        train__step=(278, 52.4807, 202.0)), {
            'backward_ms.train': 38.80961728761522,
            'dc_bwd_roofline.train': 27.869051963508284,
            'optimizer_ms.train': 0.02213575711696268}),
    'recnet.train.640x368.b20': (_logged(
        dc__mixed__chirp=(876, 0.5019, 3.0),
        dc_bwd__mixed__chirp=(876, 0.5010, 3.0),
        recnet__block=(876, 3.8960, 18.0),
        train__backward=(292, 36.7300, 126.0),
        train__optimizer=(292, 0.0222, 7.0),
        train__step=(292, 50.0323, 202.0)), {
            'backward_ms.train': 36.72995169527236,
            'dc_bwd_roofline.train': 5.613092967076354,
            'optimizer_ms.train': 0.0221539632718857}),
}


@pytest.mark.parametrize('workload', sorted(LOGGED))
def test_span_metrics_read_the_logged_spans(workload):
  """Each metric from the spans a run's log printed (four places a call)
  is the reading of the unrounded spans, to the log's rounding."""
  logged, readings = LOGGED[workload]
  run = _run(workload)
  for name, reading in readings.items():
    assert spans.METRICS[name](run, logged) == \
        pytest.approx(reading, rel=5e-3), name


def test_span_metrics_follow_their_rules():
  """The rules at 512² and B = 32 (serving) or B = 20 (training), worked
  by hand: RecNet's convs of 2 → 32 → 32 → 2 channels at 3 × 3, the
  decoders' up-convs of 128 → 64 at 256² and 64 → 32 at 512² (k = 4:
  6.25 of 16 taps a pixel), K1-bwd's two FFTs of 5·n·log2(n), n = 512²."""
  px, bf16, f32 = 512 * 512, 989e12, 67e12
  serve = _run('flagship.512.b32')
  got = _logged(recnet__block=(6, 2.0, 25.0), unet__upconv=(4, 0.5, 32.0),
                unet__prepare=(14, 0.01, 6.0), refinement=(2, 40.0, 300.0))
  block_s = 2 * 32 * px * 9 * (2 * 32 + 32 * 32 + 32 * 2) / bf16
  assert spans.recnet_roofline_serve(serve, got) == \
      pytest.approx(100 * block_s / 2e-3)
  upconv_s = 2 * 32 * 6.25 * (px / 4 * 128 * 64 + px * 64 * 32) / bf16
  assert spans.upconv_roofline_serve(serve, got) == \
      pytest.approx(100 * upconv_s * 2 / 2e-3)
  assert spans.unet_prep_ms_serve(serve, got) == pytest.approx(0.07)
  assert spans.device_ops_per_request_serve(serve, got) == 300.0

  train = _run('recnet.train.512.b20')
  got = _logged(train__backward=(3, 30.0, 120.0),
                train__optimizer=(3, 0.02, 7.0),
                dc_bwd__fft__fft=(6, 0.1, 3.0),
                dc_bwd__mixed__chirp=(3, 0.4, 3.0))
  assert spans.backward_ms_train(train, got) == pytest.approx(30.0)
  assert spans.optimizer_ms_train(train, got) == pytest.approx(0.02)
  dc_bwd_s = max(20 * 2 * 5 * px * 18 / f32, 20 * 20 * px / 3.35e12)
  assert spans.dc_bwd_roofline_train(train, got) == \
      pytest.approx(100 * dc_bwd_s * 9 / 1.8e-3)


# the span (or name prefix) each metric reads
READS = {
    'recnet_roofline.serve': 'csmri.recnet.block',
    'upconv_roofline.serve': 'csmri.unet.upconv',
    'unet_prep_ms.serve': 'csmri.unet.prepare',
    'device_ops_per_request.serve': 'csmri.refinement',
    'backward_ms.train': 'csmri.train.backward',
    'dc_bwd_roofline.train': 'csmri.dc_bwd.',
    'optimizer_ms.train': 'csmri.train.optimizer',
}


@pytest.mark.parametrize('name', sorted(spans.METRICS))
def test_span_metrics_are_none_without_their_span(name):
  """No spans, every span of the cell's log but the one the metric
  reads, or spans that ran nothing on the device."""
  assert set(READS) == set(spans.METRICS)
  workload = 'flagship.512.b32' if name.endswith('.serve') else \
      'recnet.train.512.b20'
  run, logged = _run(workload), LOGGED[workload][0]
  assert spans.METRICS[name](run, None) is None
  assert spans.METRICS[name](run, {}) is None
  others = {key: value for key, value in logged.items()
            if not key.startswith(READS[name])}
  assert len(others) < len(logged)
  assert spans.METRICS[name](run, others) is None
  idle = {key: dict(value, device_s=0.0) for key, value in logged.items()}
  assert spans.METRICS[name](run, idle) is None
