"""Port parity for the int8 serving mode (``ops/quantize.py``, the int8
mode of ``ops/conv_chain.py``) on the CPU.

The same seeded numpy inputs go through the JAX package (jitted; its Pallas
chain kernel in interpret mode) and the port (the kernels' plain versions).
Bars, with their reasons:

* weight and activation quantization: identical int8 values and equal
  scales (the same f32 division and half-to-even rounding);
* which layers are quantized: identical (the same rule);
* a quantized chain: max |Δ| within one int8 step (max|ref| / 127), and at
  most 1e-3 of the elements off by more than 1e-5·max|ref|. The int32 sums
  are exact on both sides and the epilogues round alike (one FMA), so only
  a requant tie that rounds the other way, after float rounding elsewhere
  differs by an ulp, can move a value;
* a U-Net or the flagship: max |Δ| ≤ 2e-2·max|ref|, and closer to the JAX
  int8 output than to the float one. The float layers before each
  quantization (the 2→32 stem, the up-convs, BN) sum in another order than
  XLA's, by ~1e-7 relative; a value that close to a rounding boundary
  quantizes one step the other way, and later layers carry the flip
  through the U-Net. The witness: given the JAX package's float input to
  each quantized suffix, the port's U-Net lands within 1e-5·max|ref| of the
  JAX output (the chains are then bit-exact; only float rounding after
  them remains). ``tests/int8_parity_readings.py`` prints both gaps. PSNR
  within 0.1 dB (tests/test_forward_parity.py:8-11); int8 against f32
  within the JAX suite's 0.05 and not equal
  (tests/test_conv_pallas.py:153-169).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.models import unet as junet
from csmri_refinement_tpu.ops import conv_pallas as jconv
from csmri_refinement_tpu.ops import quantize as jquant
from csmri_refinement_tpu_torch import build_flagship
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models import unet as tunet
from csmri_refinement_tpu_torch.ops import conv_chain as tconv
from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.ops import quantize as tquant
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

torch.set_num_threads(1)

FLAGSHIP_UNET = dict(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
                     encode_filters=[32, 64, 128], decode_filters=[64, 32],
                     kernel_size=4, upsampling_mode='nn-resize-conv',
                     output_activation='none', padding='reflection',
                     decoder_act_upsampling_only=True)


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _assert_int8_close(got, want):
  """One int8 step at most, and a 1e-3 share of elements beyond float
  rounding."""
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  assert got.shape == want.shape
  scale = np.abs(want).max()
  diff = np.abs(got - want)
  assert diff.max() <= scale / 127, diff.max() / scale
  assert (diff > 1e-5 * scale).mean() <= 1e-3, (diff > 1e-5 * scale).mean()


def _with_ties(x, scale):
  """Put exact .5 quotients into x: the values that round half to even."""
  x = x.copy()
  flat = x.reshape(-1)
  flat[:7] = np.float32(scale) * np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                           126.5], np.float32)
  return x


@pytest.mark.parametrize('case', ['random', 'ties', 'zero_channel'])
def test_quantize_weight_matches_jax(case):
  rng = np.random.RandomState(0)
  w = (rng.randn(4, 4, 32, 16) * 0.2).astype(np.float32)
  if case == 'ties':
    # amax = 127 · 2^-4 on every channel, so w / scale is exact
    w = np.round(w * 16 * 4) / 64
    w[0, 0, 0] = 127 / 16
    w[0, 0, 1, :4] = np.array([0.5, 1.5, -2.5, 3.5]) / 16
  elif case == 'zero_channel':
    w[..., 3] = 0            # amax floored at 1e-12
  want_w, want_s = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
  got_w, got_s = tquant.quantize_weight(torch.from_numpy(w))
  assert got_w.dtype == torch.int8
  np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
  np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize('case', ['random', 'ties', 'bf16'])
def test_quantize_act_matches_jax(case):
  rng = np.random.RandomState(1)
  x = rng.randn(3, 8, 8, 32).astype(np.float32)
  if case == 'ties':
    x = np.clip(x, -127 / 8, 127 / 8)
    x[:, 7, 7, 31] = 127 / 8         # amax: scale = f32(127/8 · 1/127) = 1/8
    x = _with_ties(x, 1 / 8)
  jx = jnp.asarray(x)
  tx = torch.from_numpy(x)
  if case == 'bf16':
    jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
  want_x, want_s = jax.jit(jquant.quantize_act)(jx)
  got_x, got_s = tquant.quantize_act(tx)
  np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
  np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
  if case == 'ties':
    assert list(got_x.numpy().reshape(-1)[:7]) == [0, 2, 2, 0, -2, -2, 126]


def _jax_suffix_start(shapes, h, w):
  """The JAX package's rule (``quantize.py:88-99``) on chain shapes."""
  layers = [jconv.ChainLayer(jnp.zeros(s)) for s in shapes]
  n = start = len(layers)
  for i in range(n - 1, -1, -1):
    k, _, cin, cout = shapes[i]
    if not jconv.layer_fusable(cin, cout, k, w, h):
      break
    start = i
  while start < n and jconv._vmem_estimate(
      layers[start:], w, h, 'reflection', 1) > jconv._VMEM_BUDGET:
    start += 1
  return start


# (H divisor, layer widths) of the flagship U-Net's five eval chains
FLAGSHIP_CHAINS = {'encode_0': (1, (2, 32, 32)), 'encode_1': (2, (32, 64, 64)),
                   'encode_2': (4, (64, 128, 128)),
                   'decode_0.decode': (2, (128, 64, 64)),
                   'decode_1.decode': (1, (64, 32, 32))}
QUANTIZED = {64: (1, 1, 1, 1, 1), 256: (1, 2, 2, 1, 1), 512: (0, 1, 2, 1, 0)}


@pytest.mark.parametrize('size', sorted(QUANTIZED))
def test_int8_suffix_policy_on_flagship_chains(size):
  counts = []
  for div, widths in FLAGSHIP_CHAINS.values():
    shapes = [(4, 4, a, b) for a, b in zip(widths[:-1], widths[1:])]
    chain = [tconv.ChainLayer(torch.zeros(s)) for s in shapes]
    h = size // div
    start = tconv.int8_suffix_start(chain, h, h)
    assert start == _jax_suffix_start(shapes, h, h)
    counts.append(len(chain) - start)
  assert tuple(counts) == QUANTIZED[size]


def test_int8_suffix_policy_grid():
  widths = (2, 16, 32, 48, 64, 96, 128, 256)
  sizes = ((8, 8), (16, 16), (17, 32), (32, 48), (64, 64), (128, 96),
           (256, 256), (384, 384))
  for k in (3, 4, 5):
    for cin in widths:
      for cout in widths:
        for h, w in sizes:
          assert tconv.layer_fusable(cin, cout, k, w, h) == \
              jconv.layer_fusable(cin, cout, k, w, h), (k, cin, cout, h, w)
  for h, w in sizes[2:]:
    for chain in ((32, 32, 32), (64, 32, 32), (32, 64, 128, 128),
                  (128, 128, 64), (16, 32, 32), (256, 256, 256)):
      shapes = [(4, 4, a, b) for a, b in zip(chain[:-1], chain[1:])]
      start = tconv.int8_suffix_start(
          [tconv.ChainLayer(torch.zeros(s)) for s in shapes], h, w)
      assert start == _jax_suffix_start(shapes, h, w), (chain, h, w)


def _chain(rng, specs, leak=0.2):
  out = []
  for k, cin, cout in specs:
    out.append(((rng.randn(k, k, cin, cout) * 0.2).astype(np.float32),
                rng.randn(cout).astype(np.float32), leak))
  return out


CHAIN_CASES = {   # input shape, (k, Cin, Cout) per layer, pad mode
    'quality_k4_reflect': ((2, 16, 64, 32), ((4, 32, 32), (4, 32, 32)),
                           'reflection'),
    'k4_zero': ((2, 16, 64, 32), ((4, 32, 32), (4, 32, 64)), 'zero'),
    'k4_replicate': ((2, 16, 64, 32), ((4, 32, 32), (4, 32, 32)),
                     'replication'),
    'k3_three_layers': ((2, 16, 32, 64), ((3, 64, 64), (3, 64, 128),
                                          (3, 128, 128)), 'reflection'),
    'cin2_prefix': ((2, 16, 64, 2), ((4, 2, 32), (4, 32, 32)), 'reflection'),
}


@pytest.mark.parametrize('case', sorted(CHAIN_CASES))
def test_chain_forward_int8_matches_jax(case):
  shape, specs, pad = CHAIN_CASES[case]
  rng = np.random.RandomState(11)
  layers = _chain(rng, specs)
  x = rng.randn(*shape).astype(np.float32)
  jlayers = [jconv.ChainLayer(jnp.asarray(w), jnp.asarray(b), l)
             for w, b, l in layers]
  jquant.reset_trace_log()
  want = jax.jit(lambda v: jquant.chain_forward_int8(
      v, jlayers, pad_mode=pad, interpret=True))(jnp.asarray(x))
  tlayers = [tconv.ChainLayer(torch.from_numpy(w), torch.from_numpy(b), l)
             for w, b, l in layers]
  tquant.reset_trace_log()
  got = tquant.chain_forward_int8(torch.from_numpy(x), tlayers, pad_mode=pad)
  assert got.dtype == torch.float32
  _assert_int8_close(got.numpy(), want)
  assert tquant._TRACE_LOG == set(jquant._TRACE_LOG)
  # the quantization ran: int8 differs from the float chain
  ref = tconv.chain_forward(torch.from_numpy(x), tlayers, pad_mode=pad)
  assert (got - ref).abs().max().item() > 0


def test_chain_with_no_quantized_layer_reports_fallback():
  """A chain none of whose layers qualifies runs in float, unquantized,
  and ``fell_back_to_bf16`` says so (as in the JAX package)."""
  rng = np.random.RandomState(2)
  layers = _chain(rng, ((3, 2, 16), (3, 16, 16)))
  x = rng.randn(1, 16, 16, 2).astype(np.float32)
  tlayers = [tconv.ChainLayer(torch.from_numpy(w), torch.from_numpy(b), l)
             for w, b, l in layers]
  tquant.reset_trace_log()
  got = tquant.chain_forward_int8(torch.from_numpy(x), tlayers)
  assert tquant.fell_back_to_bf16()
  want = tconv.chain_forward(torch.from_numpy(x), tlayers)
  assert torch.equal(got, want)
  tquant.reset_trace_log()
  assert not tquant.fell_back_to_bf16()


def test_requant_plain_ties_and_floor():
  y = torch.zeros(3, 2, 2, 4)
  y[0] = torch.tensor([0.5, 1.5, 2.5, -3.5]).view(1, 1, 4) * 0.25
  y[0, 0, 0, 0] = 127 * 0.25            # amax: s = 4, y·s exact
  y[1] = -2.0
  amax = y.abs().amax(dim=(1, 2, 3))    # image 2 all zeros: the 1e-8 floor
  xi, scale = tconv.requant_plain(y, amax)
  assert xi.dtype == torch.int8
  assert xi[0, 1, 1].tolist() == [0, 2, 2, -4]
  assert xi[0, 0, 0, 0].item() == 127
  assert bool((xi[1] == -127).all()) and bool((xi[2] == 0).all())
  np.testing.assert_array_equal(
      scale.numpy(), np.float32([127 * 0.25, 2.0, 1e-8]) * np.float32(1 / 127))


def test_conv_layer_int8_plain_is_exact():
  """The plain conv's sums are exact integers even where f32's are not
  (|sum| up to 127² · 16 · 128 > 2^24)."""
  x = torch.full((1, 4, 4, 128), 127, dtype=torch.int8)
  w = torch.full((4, 4, 128, 16), 127, dtype=torch.int8)
  w[0, 0, 0, 1] = 126
  layer = tconv.ChainLayer(w, None, None, torch.ones(16))
  y, amax = tconv.conv_layer_int8_plain(x, torch.ones(1), layer, 'replication',
                                        want_amax=True)
  full = 127 * 127 * 16 * 128
  assert y[0, 0, 0, 0].item() == np.float32(full)
  assert y[0, 0, 0, 1].item() == np.float32(full - 127)
  assert amax.item() == np.float32(full)


def test_fused_conv_chain_int8_checks_its_inputs():
  x = torch.zeros(1, 8, 8, 32, dtype=torch.int8)
  layer = tconv.ChainLayer(torch.zeros(3, 3, 32, 32, dtype=torch.int8), None,
                           0.1, torch.ones(32))
  with pytest.raises(ValueError, match='w_scale'):
    tconv.fused_conv_chain_int8(x, torch.ones(1), [layer._replace(
        w_scale=None)])
  with pytest.raises(ValueError, match='channels'):
    tconv.fused_conv_chain_int8(x[..., :16].contiguous(), torch.ones(1),
                                [layer])
  with pytest.raises(ValueError, match='pad mode'):
    tconv.fused_conv_chain_int8(x, torch.ones(1), [layer], pad_mode='wrap')
  out = tconv.fused_conv_chain_int8(x, torch.ones(1), [layer, layer],
                                    out_dtype=torch.bfloat16)
  assert out.dtype == torch.bfloat16 and out.shape == (1, 8, 8, 32)


UNET_INT8_CASES = {
    # tests/test_conv_pallas.py:157-160
    'jax_suite': dict(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
                      encode_filters=[32, 64], decode_filters=[32],
                      kernel_size=4, upsampling_mode='nn-resize-conv',
                      output_activation='none', padding='reflection',
                      decoder_act_upsampling_only=True),
    'flagship_widths': FLAGSHIP_UNET,
}


def jax_unet_int8(kw, seed, x):
  """(variables, output, suffix inputs) of the JAX int8 U-Net at PRNG
  ``seed`` on ``x``; the suffix inputs are the float tensors each chain's
  quantized suffix quantizes (``quantize_act``'s argument), in call order."""
  model = junet.UNET(quantize_inference=True, **kw)
  variables = jax.jit(functools.partial(model.init, train=False))(
      jax.random.PRNGKey(seed), jnp.asarray(x))
  seen = []
  quantize_act = jquant.quantize_act

  def spy(v):
    seen.append(v)
    return quantize_act(v)

  def apply(variables, x):
    seen.clear()
    return model.apply(variables, x, train=False), list(seen)

  jquant.reset_trace_log()
  with mock.patch.object(jquant, 'quantize_act', spy):
    out, inputs = jax.jit(apply)(variables, jnp.asarray(x))
  return variables, np.asarray(out), [np.asarray(v) for v in inputs]


def port_unet_int8(port, x, suffix_inputs=None):
  """(output, own suffix inputs) of the port's int8 ``port`` on ``x``;
  given ``suffix_inputs``, each quantized suffix quantizes the next of them
  instead of its own input."""
  seen = []
  given = iter(suffix_inputs or ())
  quantize_act = tquant.quantize_act

  def spy(v):
    seen.append(v.numpy())
    if suffix_inputs is not None:
      v = torch.from_numpy(next(given).copy())
    return quantize_act(v)

  with mock.patch.object(tquant, 'quantize_act', spy), torch.no_grad():
    out = port(torch.from_numpy(x)).numpy()
  if suffix_inputs is not None:
    assert next(given, None) is None
  return out, seen


@pytest.mark.parametrize('case', sorted(UNET_INT8_CASES))
def test_unet_int8_matches_jax(case):
  kw = UNET_INT8_CASES[case]
  x = np.random.RandomState(4).randn(2, 64, 64, 2).astype(np.float32)
  variables, want, jax_inputs = jax_unet_int8(kw, 0, x)
  port = tunet.UNET(quantize_inference=True, **kw)
  load_flax_variables(port, _np(variables))
  port.eval()
  tquant.reset_trace_log()
  got, own_inputs = port_unet_int8(port, x)
  with torch.no_grad():
    ref = tunet.UNET(**kw)
    ref.load_state_dict(port.state_dict())
    f32 = ref.eval()(torch.from_numpy(x)).numpy()
  assert tquant._TRACE_LOG == set(jquant._TRACE_LOG)
  assert any(q > 0 for _, q in tquant._TRACE_LOG)
  scale = np.abs(want).max()
  err = np.abs(got - want).max()
  assert err <= 2e-2 * scale
  assert err < np.abs(got - f32).max()
  rel = np.abs(got - f32).max() / np.abs(f32).max()
  assert 0 < rel < 0.05, rel
  # The witness for the 2e-2 bar: the first quantized suffix's input
  # differs from JAX's by float rounding only, and with JAX's input to every
  # suffix the port's chains are exact, so the gap closes to float rounding.
  assert len(own_inputs) == len(jax_inputs)
  first = jax_inputs[0]
  assert np.abs(own_inputs[0] - first).max() <= 1e-5 * np.abs(first).max()
  pinned, _ = port_unet_int8(port, x, jax_inputs)
  assert np.abs(pinned - want).max() <= 1e-5 * scale


def test_unet_train_mode_ignores_int8():
  kw = UNET_INT8_CASES['jax_suite']
  gen = torch.Generator().manual_seed(0)
  port = tunet.UNET(quantize_inference=True, fused_inference=True, **kw)
  port.init_weights(gen)
  ref = tunet.UNET(**kw)
  ref.load_state_dict(port.state_dict())
  x = torch.randn(2, 32, 32, 2, generator=gen)
  tquant.reset_trace_log()
  torch.testing.assert_close(port.train()(x), ref.train()(x), rtol=0, atol=0)
  assert not tquant._TRACE_LOG


def test_construct_model_takes_inference_keys():
  """docs/CONFIG.md's quantize_inference and fused_inference keys are
  accepted; quantize_inference reaches all the UNET's chains
  (fused_inference has no effect in the port)."""
  section = dict(FLAGSHIP_UNET, name='UNET', quantize_inference=True,
                 fused_inference=True)
  model = construct_model(section)
  units = [m for m in model.modules() if isinstance(m, tunet.ConvEncodeUnit)]
  assert len(units) == 5
  assert all(u.quantize_inference for u in units)
  plain = construct_model(dict(FLAGSHIP_UNET, name='UNET'))
  assert not any(m.quantize_inference for m in plain.modules()
                 if isinstance(m, tunet.ConvEncodeUnit))


def test_build_flagship_int8_cpu_matches_jax():
  """The int8 flagship forward at 64², f32 compute, against the JAX
  package's flagship wrapper in int8 mode on the same weights and batch."""
  from csmri_refinement_tpu.models.recnet import RecNet as JRecNet
  from csmri_refinement_tpu.models.refinement_wrapper import (
      RefinementWrapper as JWrapper)
  from csmri_refinement_tpu.ops import masks as jmasks
  from csmri_refinement_tpu.ops import undersample as jus
  rng = np.random.RandomState(0)
  gt = rng.rand(2, 64, 64).astype(np.float32)
  mask = jmasks.cartesian_mask_np((2, 64, 64), 8, 8,
                                  rng=np.random.RandomState(1))
  batch = {k: np.asarray(v) for k, v in jus.undersample_batch(
      None, jnp.asarray(gt), fixed_mask=mask).items()}
  args = [batch[k] for k in ('inp', 'kspace', 'mask')]
  outs = {}
  for quantized in (True, False):
    jmodel = JWrapper(
        pretrained_model=JRecNet(num_blocks=3, num_convs=3, num_filters=32),
        learnable_model=junet.UNET(quantize_inference=quantized,
                                   **FLAGSHIP_UNET),
        mode='real-penalty-add', input_mode='output')
    if quantized:
      variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), *args)
      variables['params']['scale'] = jnp.full((1,), 0.5)
    outs[quantized] = {k: np.asarray(v) for k, v in
                       jax.jit(jmodel.apply)(variables, *args).items()}
  want = outs[True]['pred']

  model, _ = build_flagship(64, torch.float32, 'cpu', seed=0,
                            quantize_inference=True)
  load_flax_variables(model, _np(variables))
  f32, _ = build_flagship(64, torch.float32, 'cpu', seed=0)
  f32.load_state_dict(model.state_dict())
  dc_kernel.dc_cuda.launches = 0
  tconv.conv_layer_cuda.launches = 0
  tconv.conv_layer_int8_cuda.launches = 0
  tconv.requant_cuda.launches = 0
  with torch.inference_mode():
    targs = [torch.from_numpy(np.array(a)) for a in args]
    out = {k: v.numpy() for k, v in model(*targs).items()}
    ref = f32(*targs)['prescaled_refinement'].numpy()
  got = out['pred']
  assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
  # int8 against f32 on the U-Net's output reads as the JAX package's does
  # (the reading chip_smoke.py holds the card to, at 256²)
  key = 'prescaled_refinement'

  def rel_err(a, b):
    return np.abs(a - b).max() / np.abs(b).max()

  want_rel = rel_err(outs[True][key], outs[False][key])
  assert abs(rel_err(out[key], ref) - want_rel) <= 0.1 * want_rel

  def psnr(pred):
    mag = lambda a: np.sqrt(a[..., 0] ** 2 + a[..., 1] ** 2)
    return 10 * np.log10(1.0 / np.mean((mag(pred) - mag(batch['target']))
                                       ** 2))
  assert abs(psnr(got) - psnr(want)) < 0.1
  assert (dc_kernel.dc_cuda.launches, tconv.conv_layer_cuda.launches,
          tconv.conv_layer_int8_cuda.launches,
          tconv.requant_cuda.launches) == (0, 0, 0, 0)


def test_quality_dtype_table_cli_int8_row():
  """The CLI's default refinement scale lets the U-Net reach the output, so
  int8 differs from bf16; at the init's scale 0 the two rows are equal."""
  from csmri_refinement_tpu_torch import quality_dtype_table as qt
  argv = ['--device', 'cpu', '--sizes', '64', '--batch', '2']
  rows = {r[1]: r[2:] for r in qt.main(argv)}
  assert set(rows) == {'f32', 'bf16', 'int8'}
  assert rows['int8'] != rows['bf16']
  rows = {r[1]: r[2:] for r in qt.main(argv + ['--refinement-scale', '0'])}
  assert rows['int8'] == rows['bf16']
