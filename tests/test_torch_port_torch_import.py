"""The port's importer of reference (PyTorch) checkpoints and torchvision
VGG19 weights against the JAX package's.

Reference-layout twins (``tests/torch_twins.py``: RecNet, UNET in each
up-sampling mode the port has, the discriminator, the refinement wrapper,
the VGG19 feature stack) with seeded weights and BN statistics go through
the port's converters: the trees must equal the JAX converters' exactly,
and the port's modules, loaded from them, must give the twin's forward
within UNET_ATOL. The config-driven CLI runs on
``configs/2-refinement.json`` at its full widths.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import torch_twins
from csmri_refinement_tpu.utils import torch_import as jtorch_import
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models.vgg import load_vgg19_params
from csmri_refinement_tpu_torch.ops import undersample as tus
from csmri_refinement_tpu_torch.data import datasets
from csmri_refinement_tpu_torch.utils import checkpoints, torch_import
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET_ATOL = 5e-4        # tests/test_conv_pallas.py:130
SIZE, BATCH = 32, 2


def randomized(module, seed):
  """``module`` (a twin) with seeded weights, biases and BN statistics, in
  eval mode."""
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for name, tensor in list(module.named_parameters()) + \
        list(module.named_buffers()):
      if not tensor.is_floating_point():
        continue
      leaf = name.rsplit('.', 1)[-1]
      if tensor.ndim > 1:
        fan_in = tensor[0].numel()
        tensor.copy_(torch.randn(tensor.shape, generator=gen) / fan_in ** 0.5)
      elif leaf in ('running_var',) or (leaf == 'weight' and tensor.ndim == 1):
        tensor.copy_(0.5 + torch.rand(tensor.shape, generator=gen))
      else:
        tensor.copy_(0.2 * torch.randn(tensor.shape, generator=gen))
  return module.eval()


def assert_trees_equal(got, want, path='root'):
  assert isinstance(got, dict) == isinstance(want, dict), path
  if isinstance(want, dict):
    assert sorted(got) == sorted(want), path
    for key in want:
      assert_trees_equal(got[key], want[key], path + '/' + key)
  else:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def nchw(x):
  return x.permute(0, 3, 1, 2)


def nhwc(x):
  return x.permute(0, 2, 3, 1)


def rec_batch(size=SIZE):
  gt = datasets._make_phantoms(BATCH, size, 4)[0]
  gen = torch.Generator().manual_seed(0)
  return tus.undersample_batch(gen, torch.from_numpy(gt), 'varden', 4)


def test_recnet_converts_as_jax_and_matches_its_twin():
  twin = randomized(torch_twins.TorchRecNet(2, 3, 8), 1)
  sd = twin.state_dict()
  got = torch_import.convert_recnet(sd, num_blocks=2, num_convs=3)
  assert_trees_equal(got, jtorch_import.convert_recnet(sd, 2, 3))
  port = construct_model({'name': 'RecNet', 'num_blocks': 2, 'num_convs': 3,
                          'num_filters': 8})
  load_flax_variables(port, got)
  b = rec_batch()
  with torch.no_grad():
    want = nhwc(twin(nchw(b['inp']), nchw(b['kspace']), nchw(b['mask'])))
    out = port.eval()(b['inp'], b['kspace'], b['mask'])
  np.testing.assert_allclose(out.numpy(), want.numpy(), atol=UNET_ATOL)


# (upsampling mode, kernel size, act_upsampling_only, padding): each mode
# the port's UNET has, the flagship's k4 subpixel one as configured.
UNET_MODES = [('transposed', 3, False, 'zero'),
              ('pixelshuffle', 3, False, 'reflection'),
              ('nn', 3, False, 'zero'),
              ('nn-resize-conv', 4, True, 'reflection')]


def unet_kwargs(mode, kernel_size, act_up_only, padding, filters=(4, 8, 16)):
  return dict(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
              encode_filters=list(filters),
              decode_filters=list(filters[-2::-1]),
              kernel_size=kernel_size, upsampling_mode=mode,
              output_activation='none', padding=padding,
              decoder_act_upsampling_only=act_up_only)


@pytest.mark.parametrize('mode,kernel_size,act_up_only,padding', UNET_MODES,
                         ids=[m[0] for m in UNET_MODES])
def test_unet_converts_as_jax_and_matches_its_twin(mode, kernel_size,
                                                   act_up_only, padding):
  kwargs = unet_kwargs(mode, kernel_size, act_up_only, padding)
  twin = randomized(torch_twins.TorchUNET(**kwargs), 2)
  sd = twin.state_dict()
  conv_kwargs = torch_import._unet_convert_kwargs(kwargs)
  assert conv_kwargs == jtorch_import._unet_convert_kwargs(kwargs)
  got = torch_import.convert_unet(sd, **conv_kwargs)
  assert_trees_equal(got, jtorch_import.convert_unet(sd, **conv_kwargs))
  assert got['batch_stats']
  port = construct_model(dict(kwargs, name='UNET'))
  load_flax_variables(port, got)
  x = torch.from_numpy(np.random.RandomState(3).randn(
      BATCH, SIZE, SIZE, 2).astype(np.float32))
  with torch.no_grad():
    want = nhwc(twin(nchw(x)))
    out = port.eval()(x)
  np.testing.assert_allclose(out.numpy(), want.numpy(), atol=UNET_ATOL)


DISC = dict(num_inputs=1, num_filters_per_layer=[8, 16, 16],
            strides=[2, 2, 1], kernel_sizes=4, final_conv_kernel_size=4,
            padding='reflection', relu_leakiness=0.2,
            use_norm_layers='not-first', norm_layer='batch',
            compute_features=True)


def test_discriminator_converts_as_jax_and_matches_its_twin():
  twin = randomized(torch_twins.TorchCNNDiscriminator(**DISC), 3)
  sd = twin.state_dict()
  kwargs = dict(num_filters_per_layer=DISC['num_filters_per_layer'],
                use_norm_layers='not-first', norm_layer='batch')
  got = torch_import.convert_discriminator(sd, **kwargs)
  assert_trees_equal(got, jtorch_import.convert_discriminator(sd, **kwargs))
  port = construct_model(dict(DISC, name='CNNDiscriminator'))
  load_flax_variables(port, got)
  x = torch.from_numpy(np.random.RandomState(4).rand(
      BATCH, 64, 64, 1).astype(np.float32))
  with torch.no_grad():
    want = twin(nchw(x))
    out = port.eval()(x)
  np.testing.assert_allclose(out['logits'].numpy(),
                             nhwc(want['logits']).numpy(), atol=UNET_ATOL)
  assert len(out['features']) == len(want['features'])
  for got_f, want_f in zip(out['features'], want['features']):
    np.testing.assert_allclose(got_f.numpy(), nhwc(want_f).numpy(),
                               atol=UNET_ATOL)


def wrapper_twin(recnet, unet, seed):
  twin = torch_twins.TorchRefinementWrapper(
      torch_twins.TorchRecNet(**recnet), torch_twins.TorchUNET(**unet),
      mode='real-penalty-add', input_mode='output')
  randomized(twin, seed)
  with torch.no_grad():
    twin.scale.fill_(0.3)
  return twin


def test_refinement_wrapper_converts_as_jax_and_matches_its_twin():
  recnet = dict(num_blocks=1, num_convs=2, num_filters=4)
  unet = unet_kwargs('nn-resize-conv', 4, True, 'reflection', (4, 8))
  twin = wrapper_twin(recnet, unet, 5)
  sd = twin.state_dict()
  rec_kwargs = {'num_blocks': 1, 'num_convs': 2}
  unet_conv = torch_import._unet_convert_kwargs(unet)
  got = torch_import.convert_refinement_wrapper(sd, rec_kwargs, unet_conv)
  assert_trees_equal(got, jtorch_import.convert_refinement_wrapper(
      sd, rec_kwargs, unet_conv))
  port = construct_model({
      'name': 'RefinementWrapper', 'mode': 'real-penalty-add',
      'input_mode': 'output',
      'pretrained_model': dict(recnet, name='RecNet'),
      'learnable_model': dict(unet, name='UNET')})
  load_flax_variables(port, got)
  b = rec_batch()
  with torch.no_grad():
    want = twin(nchw(b['inp']), nchw(b['kspace']), nchw(b['mask']))
    out = port.eval()(b['inp'], b['kspace'], b['mask'])
  np.testing.assert_allclose(out['pred'].numpy(), nhwc(want['pred']).numpy(),
                             atol=UNET_ATOL)


def test_vgg19_converts_as_jax_and_matches_its_twin(tmp_path, capsys):
  """``convert_vgg19`` writes the npz (its content hash included) the
  JAX converter writes, which the port's loader accepts; the loaded VGG19
  gives the twin's block outputs."""
  twin = randomized(torch_twins.TorchVGG19Features(), 6)
  path, jpath = str(tmp_path / 'vgg19.npz'), str(tmp_path / 'jax.npz')
  keys = torch_import.convert_vgg19(twin.state_dict(), path)
  assert keys == jtorch_import.convert_vgg19(twin.state_dict(), jpath)
  with np.load(path) as got, np.load(jpath) as want:
    assert_trees_equal(dict(got), dict(want))
  assert 'sha256' in capsys.readouterr().out
  vgg = load_vgg19_params(path, output_blocks=(0, 1, 2, 3, 4))
  x = torch.from_numpy(np.random.RandomState(7).rand(
      BATCH, SIZE, SIZE, 3).astype(np.float32))
  mean = torch.tensor((0.485, 0.456, 0.406)).reshape(1, 3, 1, 1)
  std = torch.tensor((0.229, 0.224, 0.225)).reshape(1, 3, 1, 1)
  with torch.no_grad():
    want = twin.block_outputs(nchw(x), mean, std)[:5]
    out = vgg(x)
  assert len(out) == 5
  for got_b, want_b in zip(out, want):
    scale = max(1.0, float(want_b.abs().max()))
    np.testing.assert_allclose(got_b.numpy(), want_b.numpy(),
                               atol=UNET_ATOL * scale)
  torch.save(twin.state_dict(), str(tmp_path / 'vgg19.pth'))
  torch_import.main(['--vgg19', str(tmp_path / 'vgg19.pth'),
                     str(tmp_path / 'cli.npz')])
  with np.load(str(tmp_path / 'cli.npz')) as cli, np.load(path) as got:
    assert_trees_equal(dict(cli), dict(got))


def test_checkpoint_cli_on_the_paper_gan_config(tmp_path, capsys):
  """``--checkpoint configs/2-refinement.json IN OUT`` on a reference-
  layout GAN checkpoint at the config's full widths: a port checkpoint
  whose generator and discriminator trees equal the JAX CLI's, and whose
  networks, loaded into the port's modules, give the twins' forwards; a
  deployed (generator-only) file converts with the discriminator
  skipped."""
  config = os.path.join(REPO, 'configs', '2-refinement.json')
  with open(config) as f:
    conf_d = json.load(f)
  gen_d, disc_d = conf_d['generator_model'], conf_d['discriminator_model']
  rec_d = dict(gen_d['pretrained_model'])
  rec_d.pop('pretrained_weights', None)
  unet_d = dict(gen_d['learnable_model'])
  gen = wrapper_twin({k: rec_d[k] for k in ('num_blocks', 'num_convs',
                                            'num_filters')},
                     {k: v for k, v in unet_d.items() if k in inspect.signature(
                         torch_twins.TorchUNET).parameters}, 8)
  disc_kw = {k: disc_d[k] for k in (
      'num_inputs', 'num_filters_per_layer', 'strides', 'kernel_sizes',
      'final_conv_kernel_size', 'padding', 'act_fn', 'relu_leakiness',
      'dropout_after', 'use_norm_layers', 'norm_layer', 'compute_features')}
  disc = randomized(torch_twins.TorchCNNDiscriminator(**disc_kw), 9)
  src = str(tmp_path / 'reference.pth')
  torch.save({'runner': {'generator': gen.state_dict(),
                         'discriminator': disc.state_dict()}, 'epoch': 5},
             src)
  out, jout = str(tmp_path / 'port.ckpt'), str(tmp_path / 'jax.ckpt')
  torch_import.main(['--checkpoint', config, src, out])
  jtorch_import.main(['--checkpoint', config, src, jout])
  got = torch.load(out, weights_only=True)
  want = checkpoints.load_checkpoint(jout)
  assert got['epoch'] == want['epoch'] == 5
  assert set(got['runner']) == {'generator', 'discriminator'}
  for key in got['runner']:
    assert_trees_equal(_numpy(got['runner'][key]), want['runner'][key], key)

  port_gen = construct_model(dict(gen_d, pretrained_model=rec_d))
  checkpoints.load_network_state(port_gen, got['runner']['generator'])
  b = rec_batch()
  with torch.no_grad():
    want_pred = gen(nchw(b['inp']), nchw(b['kspace']), nchw(b['mask']))
    pred = port_gen.eval()(b['inp'], b['kspace'], b['mask'])['pred']
  np.testing.assert_allclose(pred.numpy(), nhwc(want_pred['pred']).numpy(),
                             atol=UNET_ATOL)
  port_disc = construct_model(dict(disc_d, name='CNNDiscriminator'))
  checkpoints.load_network_state(port_disc, got['runner']['discriminator'])
  x = torch.from_numpy(np.random.RandomState(8).rand(
      1, 128, 128, 1).astype(np.float32))
  with torch.no_grad():
    logits = port_disc.eval()(x)['logits']
    want_logits = nhwc(disc(nchw(x))['logits'])
  scale = max(1.0, float(want_logits.abs().max()))
  np.testing.assert_allclose(logits.numpy(), want_logits.numpy(),
                             atol=UNET_ATOL * scale)

  deployed = str(tmp_path / 'deployed.pth')
  torch.save({'runner': {'generator': gen.state_dict()}, 'epoch': 9},
             deployed)
  capsys.readouterr()
  torch_import.main(['--checkpoint', config, deployed, out])
  assert 'skipped' in capsys.readouterr().out
  assert set(torch.load(out, weights_only=True)['runner']) == {'generator'}


def _numpy(tree):
  if isinstance(tree, dict):
    return {k: _numpy(v) for k, v in tree.items()}
  return tree.numpy()
