"""Child process of tests/test_torch_port_parallel.py and
tests/test_torch_port_spatial.py: the port's data-parallel and spatial
training on the CPU.

Runs tiny synthetic scenarios (JAX's ``tests/_dist_child.py`` configs in
the port's runners) either as one process (world 1, no process group) or as
one rank of a gloo group started by the production
``parallel.distributed.initialize`` from the config's ``distributed``
section. Each scenario trains two epochs on a process-sharded loader and
validates; the child prints one ``DISTRESULT <scenario> {json}`` line per
scenario (per-epoch train losses, validation losses and metrics) and saves
the runner's networks' state dicts after the first update and at the end to
``<out>/<scenario>_rank<r>.pt``.

The ``standard_jax`` scenario replays the JAX package's run: its initial
weights and its train and validation masks come from ``<out>/jax.npz`` and
``<out>/jax_init.pt``, written by the parent; ``unet_jax`` likewise
(``<out>/unet_jax.npz``, ``<out>/unet_jax_init.pt``) for the standard
config with an ``nn-biresize-conv`` U-Net in RecNet's place. ``bn`` runs
the synced ``BatchNorm2d`` on the rank's rows of ``bn_inputs()`` and saves
its output, gradients and statistics; ``cli`` runs the training CLI for one epoch and
lists the files this rank wrote; ``validate_cli`` runs the validate CLI
(``-i``, the seeded init) and prints its metrics and the files this rank
wrote.

A ``mesh`` entry of the child's config replaces every scenario's ``mesh``
section (e.g. ``{"data": -1, "spatial": 2}``), and an ``epochs`` entry
({scenario: count}) a scenario's two epochs. ``units`` holds the spatial
layers on the rank's rows (a spatial group of the whole world) against
the whole image, which every rank computes too, and prints one
``DISTRESULT units`` line of {case: [output error, input-gradient error,
parameter-gradient error]}, each the largest |Δ| over max |ref| (the
parameter gradients summed over the ranks first; ``EXACT_CASES``: 0.0
when equal bit for bit, else 1.0; the int8 U-Net's: ``_int8_unet_case``),
and under ``dc_moved`` the bytes each collective sends off the rank in one
DC, over the image's. Each scenario's result records the shapes of its
first prepared train batch (``shapes``), and those of ``WIDTHS`` save
their first validation batch as the metrics' gather gave it
(``<name>_val_rank<r>.npz``); ``int8_validate`` validates the
int8 U-Net from the parent's weights (``run_int8_validate``). The
scenarios of ``UNEVEN_SIDES`` run at sides whose rows per spatial rank a
stride or a pool splits (those of ``WIDTHS`` on images cut to fewer
columns); ``adversarial_jax36`` replays the JAX package's
spatial GAN update (``<out>/adversarial_jax36_init.pt``, ``.npz``), and
``uneven_units`` is ``tests/_torch_uneven_child.py``'s.
"""

import json
import os
import sys

import numpy as np


def bn_inputs():
  """The global batch (NCHW), the output cotangent, BN scale and bias."""
  rng = np.random.RandomState(11)
  x = (2.0 * rng.randn(4, 3, 5, 5) + 1.0).astype(np.float32)
  c = rng.randn(4, 3, 5, 5).astype(np.float32)
  return (x, c, rng.uniform(0.5, 1.5, 3).astype(np.float32),
          rng.randn(3).astype(np.float32))


def _standard_conf():
  return {
      'seed': 3,
      'train_dataset': 'Synthetic',
      'validation_dataset': 'Synthetic',
      'synthetic': {'image_size': 32, 'num_train': 16, 'num_val': 8},
      'undersampling': {'sampling_scheme': 'varden',
                        'acceleration_factor': 2,
                        'variable_acceleration': False},
      'runner_type': 'standard',
      'application': 'reconstruction',
      'model': {'name': 'RecNet', 'num_blocks': 2, 'num_convs': 2,
                'num_filters': 8},
      'loss_name': 'MSE',
      'optimizer': {'name': 'Adam', 'learning_rate': 0.001},
      'batch_size': 8,
      'validation_metrics': ['psnr'],
      'mesh': {'data': -1},
  }


def _adversarial_conf():
  return {
      'seed': 4,
      'train_dataset': 'Synthetic',
      'validation_dataset': 'Synthetic',
      'synthetic': {'image_size': 32, 'num_train': 16, 'num_val': 8},
      'undersampling': {'sampling_scheme': 'varden',
                        'acceleration_factor': 2,
                        'variable_acceleration': False},
      'runner_type': 'adversarial',
      'vgg_random_init': True,
      'application': 'reconstruction',
      'generator_model': {
          'name': 'RefinementWrapper',
          'mode': 'real-penalty-add',
          'input_mode': 'output',
          'pretrained_model': {'name': 'RecNet', 'num_blocks': 1,
                               'num_convs': 2, 'num_filters': 4},
          'learnable_model': {
              'name': 'UNET', 'num_inputs': 2, 'num_outputs': 1,
              'num_layers_per_scale': 1, 'encode_filters': [4, 8],
              'decode_filters': [4], 'kernel_size': 4,
              'upsampling_mode': 'nn-resize-conv',
              'output_activation': 'none', 'padding': 'reflection',
              'decoder_act_upsampling_only': True},
      },
      'discriminator_model': {
          'num_inputs': 1, 'input_method': 'simple-magnitude',
          'num_filters_per_layer': [8, 16], 'strides': [2, 2],
          'kernel_sizes': 4, 'final_conv_kernel_size': 4,
          'padding': 'reflection', 'use_norm_layers': 'not-first',
          'norm_layer': 'batch', 'compute_features': True,
          'use_image_pool': True, 'image_pool_size': 16,
          'dropout_after': [0], 'dropout_prob': 0.25,
      },
      'generator_adversarial_losses': ['gan', 'FeatureMatching'],
      'generator_losses': ['VGG19', 'FeaturePenalty'],
      'generator_loss_weights': {'gan': 0.5, 'VGG19': 10,
                                 'FeaturePenalty': 2},
      'discriminator_losses': ['gan'],
      'discriminator_label_smoothing': 0.1,
      'feature_penalty': {'criterion': 'L1',
                          'input_key': 'prescaled_refinement'},
      'generator_optimizer': {'name': 'Adam', 'learning_rate': 2e-4,
                              'beta1': 0.5},
      'discriminator_optimizer': {'name': 'Adam', 'learning_rate': 2e-4,
                                  'beta1': 0.5},
      'batch_size': 8,
      'validation_metrics': ['psnr'],
      'mesh': {'data': -1},
  }


def _segmentation_conf(repo):
  with open(os.path.join(repo, 'configs',
                         '3-train-segmentation-unet.json')) as f:
    conf = json.load(f)
  conf['model'].update(encode_filters=[8, 16, 32], decode_filters=[16, 8])
  conf.update(seed=5, train_dataset='Synthetic',
              validation_dataset='Synthetic',
              synthetic={'image_size': 32, 'num_train': 16, 'num_val': 8},
              num_data_workers=0, use_tensorboard=False,
              mesh={'data': -1})
  return conf


# a reconstruction U-Net whose decoders up-sample bilinearly (no BN: the
# JAX replay carries parameters only)
UNET_RECONSTRUCTION = {
    'name': 'UNET', 'num_inputs': 2, 'num_outputs': 2,
    'num_layers_per_scale': 1, 'encode_filters': [4, 8],
    'decode_filters': [4], 'upsampling_mode': 'nn-biresize-conv',
    'output_activation': 'none', 'padding': 'reflection',
    'decoder_act_upsampling_only': True, 'use_bn': False}


def jax_prefix(name):
  """The file prefix of a JAX replay scenario's initial weights and
  masks."""
  return 'jax' if name == 'standard_jax' else name


# Sides whose rows per spatial rank a stride or a pool splits: the GAN's
# discriminator and VGG19 at 36² (18 rows a rank on two), a 2-scale
# segmentation U-Net at 34² (17).
UNEVEN_SIDES = {'adversarial36': 36, 'adversarial_jax36': 36,
                'adversarial36x35': 36, 'segmentation2_34': 34}
# Scenarios whose images are cut to fewer columns (the Synthetic phantoms
# are square): the GAN at 36 × 35, whose k-space and mask split into column
# blocks of 18 and 17 on two spatial ranks.
WIDTHS = {'adversarial36x35': 35}


def _conf_dict(name, repo):
  if name.startswith('adversarial'):
    conf = _adversarial_conf()
    if name == 'adversarial_jax36':
      # JAX's ``tests/test_parallel.py::_adv_conf``: no dropout, one update
      # of 8 images, whose pool of 16 hands the fakes back as they come
      del conf['discriminator_model']['dropout_after']
      del conf['discriminator_model']['dropout_prob']
      conf['synthetic'] = {'image_size': 36, 'num_train': 8, 'num_val': 8}
    elif name in UNEVEN_SIDES:
      conf['synthetic'] = dict(conf['synthetic'],
                               image_size=UNEVEN_SIDES[name])
    return conf
  if name.startswith('segmentation'):
    conf = _segmentation_conf(repo)
    conf['train_remat'] = name == 'segmentation_remat'
    if name.startswith('segmentation2'):     # two scales
      conf['model'].update(encode_filters=[8, 16], decode_filters=[8])
    if name in UNEVEN_SIDES:
      conf['synthetic'] = dict(conf['synthetic'],
                               image_size=UNEVEN_SIDES[name])
    return conf
  conf = _standard_conf()
  if name == 'standard_spf2':
    conf['steps_per_fetch'] = 2
  if name == 'unet_jax':
    conf['model'] = dict(UNET_RECONSTRUCTION)
  return conf


def _replay_jax(runner, out_dir, name):
  """Give the runner the JAX run's initial weights and masks."""
  import torch
  from csmri_refinement_tpu_torch.ops import undersample as us
  prefix = os.path.join(out_dir, jax_prefix(name))
  runner.model.load_state_dict(torch.load(prefix + '_init.pt'))
  masks = np.load(prefix + '.npz')
  prep = runner.preparer

  def prepare_train(generator, host_batch):
    mask = masks['train'][runner.step][runner.mesh.rows(8)] \
        if runner.mesh is not None else masks['train'][runner.step]
    return prep._passthrough(us.undersample_batch(
        None, prep._gt(host_batch), fixed_mask=torch.from_numpy(mask)),
                             host_batch)

  prep.prepare_train = prepare_train
  prep._val_mask = lambda index, h, w: torch.from_numpy(masks['val'][index])


def _replay_jax_gan(runner, out_dir):
  """Give the GAN runner the JAX run's initial generator, discriminator
  and VGG19 weights and its train masks (``adversarial_jax36``)."""
  import torch
  from csmri_refinement_tpu_torch.ops import undersample as us
  prefix = os.path.join(out_dir, jax_prefix('adversarial_jax36'))
  init = torch.load(prefix + '_init.pt')
  runner.gen.load_state_dict(init['generator'])
  runner.disc.load_state_dict(init['discriminator'])
  runner.gen_criteria['VGG19'].criterion.vgg.load_state_dict(init['vgg'])
  masks = np.load(prefix + '.npz')
  prep = runner.preparer

  def prepare_train(generator, host_batch):
    mask = masks['train'][runner.step][runner.mesh.rows(8)] \
        if runner.mesh is not None else masks['train'][runner.step]
    return prep._passthrough(us.undersample_batch(
        None, prep._gt(host_batch), fixed_mask=torch.from_numpy(mask)),
                             host_batch)

  prep.prepare_train = prepare_train


def _crop_columns(prep, width):
  """Hand the preparer every host batch's images cut to their first
  ``width`` columns."""
  def crop(host):
    return {k: v[:, :, :width] if getattr(v, 'ndim', 0) >= 3 else v
            for k, v in host.items()}
  train, val = prep.prepare_train, prep.prepare_val
  prep.prepare_train = lambda generator, host: train(generator, crop(host))
  prep.prepare_val = lambda host: val(crop(host))


def _networks(runner):
  if hasattr(runner, 'gen'):
    return {'generator': runner.gen.state_dict(),
            'discriminator': runner.disc.state_dict()}
  return {'model': runner.model.state_dict()}


def run_bn(cfg):
  import torch
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.models.unet import BatchNorm2d
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  mesh = mesh_lib.Mesh(cfg['world'], cfg['rank'], torch.device('cpu'),
                       dist.group.WORLD)
  x, c, scale, bias = (torch.from_numpy(a) for a in bn_inputs())
  bn = mesh_lib.sync_batchnorm(BatchNorm2d(3, eps=1e-5, momentum=0.1), mesh)
  with torch.no_grad():
    bn.weight.copy_(scale)
    bn.bias.copy_(bias)
  rows = mesh.rows(x.shape[0])
  xl = x[rows].clone().requires_grad_()
  y = bn(xl)
  (y * c[rows]).sum().backward()
  grads = [bn.weight.grad, bn.bias.grad]     # the rank's share: summed
  for g in grads:
    dist.all_reduce(g)
  torch.save({'y': y.detach(), 'grad_x': xl.grad, 'grad_weight': grads[0],
              'grad_bias': grads[1], 'running_mean': bn.running_mean,
              'running_var': bn.running_var},
             os.path.join(cfg['out'], 'bn_rank{}.pt'.format(cfg['rank'])))
  print('DISTRESULT bn {}')


def run_cli(cfg):
  from csmri_refinement_tpu_torch import train
  conf = _standard_conf()
  conf.update(num_epochs=1, epochs_per_validation=1, epochs_per_checkpoint=1,
              num_data_workers=0, validation_checkpoint_metrics=['psnr'],
              run_name='cli')
  conf_path = os.path.join(cfg['out'], 'cli_rank{}.json'.format(cfg['rank']))
  with open(conf_path, 'w') as f:
    json.dump(conf, f)
  log_dir = os.path.join(cfg['out'], 'cli_rank{}'.format(cfg['rank']))
  runner = train.main([conf_path, '--device', 'cpu', '--log-dir', log_dir])
  files = sorted(os.path.relpath(os.path.join(d, f), log_dir)
                 for d, _, fs in os.walk(log_dir) for f in fs)
  params = float(sum(p.double().abs().sum()
                     for p in runner.model.parameters()))
  print('DISTRESULT cli {}'.format(json.dumps({'files': files,
                                               'val': params})))


def _rel(got, want):
  got, want = got.detach(), want.detach()
  return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


UNETS = ('unet nn-resize-conv k4 reflection', 'unet pixelshuffle k3 reflection',
         'unet transposed k4 zero', 'unet nn-resize-conv k3 replication',
         'unet nn-biresize-conv k3 reflection')
DISCRIMINATORS = ('batch patchgan', 'instance fc', 'batch average')
UNIT_CASES = tuple(
    ['same_conv {} k{} s{}'.format(mode, k, stride)
     for mode in ('zero', 'reflection', 'replication') for k in (3, 4)
     for stride in (1, 2)] + ['instance_norm'] +
    ['{} {}'.format(net, mode) for net in UNETS for mode in ('train', 'eval')] +
    ['discriminator ' + d for d in DISCRIMINATORS] +
    ['vgg19 blocks 1 2', 'refinement scale', 'bilinear up2', 'dc noisy',
     'dc', 'dc dft', 'int8 chain', 'unet int8 eval'])
# The cases whose rank rows must equal the whole image's bit for bit (each
# error 0.0 when equal, else 1.0): the DC on K1's passes (output, input
# gradient, k0 gradient) on the radix route's square power-of-two side and
# on a non-square image of the dense-DFT route; a chain of quantized layers
# (int32 sums, the group's amax before each requant).
EXACT_CASES = ('dc', 'dc dft', 'int8 chain')
# (B, H, W) of each DC case; every side divides by 4 ranks
DC_SHAPES = {'dc': (2, 16, 16), 'dc dft': (2, 24, 20)}
# a U-Net whose chains quantize (the JAX suite's int8 U-Net,
# ``tests/test_torch_port_quant.py``), with an output per packed channel
UNET_INT8 = dict(num_inputs=2, num_outputs=2, num_layers_per_scale=2,
                 encode_filters=[32, 64], decode_filters=[32], kernel_size=4,
                 upsampling_mode='nn-resize-conv', output_activation='none',
                 padding='reflection', decoder_act_upsampling_only=True)
INT8_SIZE = 64      # the quantized layers' width rule needs a multiple of 64


def _unit_cases():
  """{case: (layout, fn(x) → output, parameters)}: the layers the spatial
  runs go through, each on an NCHW or NHWC input of 32 rows. A train-mode
  U-Net's BatchNorm takes the group's statistics under the spatial mesh
  (its rows) and the local ones on the whole image."""
  import torch
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.models import construct_model, layers
  from csmri_refinement_tpu_torch.models.unet import (BatchNorm2d,
                                                      _bilinear_up2)
  from csmri_refinement_tpu_torch.ops import dc as dc_ops
  from csmri_refinement_tpu_torch.parallel import halo
  from csmri_refinement_tpu_torch.models.refinement_wrapper import _scale
  from csmri_refinement_tpu_torch.models.vgg import VGG19
  cases = {}
  gen = torch.Generator().manual_seed(5)
  for mode in ('zero', 'reflection', 'replication'):
    for k in (3, 4):
      for stride in (1, 2):
        w = torch.randn(5, 3, k, k, generator=gen).requires_grad_()
        b = torch.randn(5, generator=gen).requires_grad_()
        cases['same_conv {} k{} s{}'.format(mode, k, stride)] = (
            'nchw', lambda x, w=w, b=b, m=mode, s=stride: layers.same_conv(
                x, w, b, m, stride=s), [w, b])
  norm = layers.InstanceNorm(3, affine=True)
  with torch.no_grad():
    norm.scale.uniform_(0.5, 1.5, generator=gen)
    norm.bias.normal_(generator=gen)
  cases['instance_norm'] = ('nchw', norm, list(norm.parameters()))

  def train_unet(x, net):
    for m in net.modules():
      if isinstance(m, BatchNorm2d):
        m.process_group = dist.group.WORLD if halo.current() else None
    return net.train()(x)
  unets = {
      'unet nn-resize-conv k4 reflection': dict(
          num_inputs=3, num_outputs=2, num_layers_per_scale=1,
          encode_filters=[4, 8], decode_filters=[4], kernel_size=4,
          upsampling_mode='nn-resize-conv', padding='reflection',
          decoder_act_upsampling_only=True),
      'unet pixelshuffle k3 reflection': dict(
          num_inputs=3, num_outputs=2, num_layers_per_scale=2,
          encode_filters=[4, 8, 8], decode_filters=[8, 4],
          upsampling_mode='pixelshuffle', padding='reflection'),
      'unet transposed k4 zero': dict(
          num_inputs=3, num_outputs=2, num_layers_per_scale=1,
          encode_filters=[4, 8], decode_filters=[4],
          transposed_kernel_size=4),
      'unet nn-resize-conv k3 replication': dict(
          num_inputs=3, num_outputs=2, num_layers_per_scale=1,
          encode_filters=[4, 8], decode_filters=[4],
          upsampling_mode='nn-resize-conv', padding='replication'),
      'unet nn-biresize-conv k3 reflection': dict(
          num_inputs=3, num_outputs=2, num_layers_per_scale=1,
          encode_filters=[4, 8, 8], decode_filters=[8, 4],
          upsampling_mode='nn-biresize-conv', padding='reflection',
          decoder_act_upsampling_only=True),
  }
  assert tuple(unets) == UNETS
  for name, section in unets.items():
    net = construct_model(dict(section, name='UNET', output_activation='none'))
    net.init_weights(torch.Generator().manual_seed(6))
    params = list(net.parameters())
    cases[name + ' train'] = ('nhwc', lambda x, m=net: train_unet(x, m),
                              params)
    cases[name + ' eval'] = ('nhwc', lambda x, m=net: m.eval()(x), [])
  discriminators = (('batch patchgan', {}),
                    ('instance fc', {'norm_layer': 'instance-affine',
                                     'fc_layers': [6, 1],
                                     'spatial_shape': [32, 12]}),
                    ('batch average', {'final_conv_kernel_size': 1,
                                       'final_average_pooling': True}))
  assert tuple(d for d, _ in discriminators) == DISCRIMINATORS
  for name, extra in discriminators:
    section = dict(
        name='CNNDiscriminator', num_inputs=3, num_filters_per_layer=[4, 8],
        strides=[2, 1], kernel_sizes=4, final_conv_kernel_size=3,
        padding='reflection', use_norm_layers='not-first',
        compute_features=True)
    disc = construct_model(dict(section, **extra))
    disc.init_weights(torch.Generator().manual_seed(7))
    cases['discriminator ' + name] = (
        'nhwc', lambda x, d=disc: d.eval()(x)['logits'],
        list(disc.parameters()))
  vgg = VGG19((1, 2))
  for conv in vgg.children():
    torch.nn.init.normal_(conv.weight, 0.0, 0.1, generator=gen)
    torch.nn.init.normal_(conv.bias, 0.0, 0.1, generator=gen)
  cases['vgg19 blocks 1 2'] = ('nhwc>nchw', lambda x: vgg(x.sigmoid())[1],
                               list(vgg.parameters()))
  cases['refinement scale'] = ('nhwc', lambda x: _scale(x)[0], [])
  cases['bilinear up2'] = ('nhwc', _bilinear_up2, [])
  # the noisy DC: the plain passes with the noisy merge, exchanged between
  # rows and columns; k0 and the mask are the rank's columns on the mesh
  k0 = torch.randn(2, 32, 12, 2, generator=gen)
  mask = (torch.rand(2, 32, 12, 1, generator=gen) > 0.5).float()
  cases['dc noisy'] = ('nhwc', lambda x: dc_ops.data_consistency(
      x[..., :2], *own_cols(k0 * mask, mask), noise_lvl=0.1), [])
  return cases


def own_cols(*tensors):
  """The rank's column blocks (axis 2) of whole tensors under the spatial
  mesh (the layout of ``kspace`` and ``mask``); the tensors without one."""
  from csmri_refinement_tpu_torch.parallel import halo
  mesh = halo.current()
  if mesh is None:
    return tensors
  return tuple(t[:, :, mesh.image_cols(t.shape[2])] for t in tensors)


def _dc_case(mesh, shape):
  """The DC on K1's passes on the rank's rows and columns against the
  whole image: [output (with and without a gradient), input gradient, k0
  gradient], each 0.0 when equal bit for bit; and the bytes each
  collective moved in the forward, over the image's."""
  import torch
  from csmri_refinement_tpu_torch.ops import dc as dc_ops
  from csmri_refinement_tpu_torch.parallel import halo
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  gen = torch.Generator().manual_seed(9)
  xi, k0, g = (torch.randn(shape + (2,), generator=gen) for _ in range(3))
  mask = (torch.rand(shape + (1,), generator=gen) > 0.5).float()
  xw, kw = xi.clone().requires_grad_(), k0.clone().requires_grad_()
  want = dc_ops.data_consistency(xw, kw, mask)
  want_grads = torch.autograd.grad((want * g).sum(), [xw, kw])
  rows = lambda t: halo.local_rows(t, mesh, 1)
  xl = rows(xi).clone().requires_grad_()
  moved = {}
  exchange, gather = mesh_lib.all_to_all, mesh_lib.all_gather

  def counted(fn, name):
    def run(t, group, *sizes):
      # what leaves this rank: all parts but its own
      share = 1.0 if name == 'all_gather' else \
          1 - sizes[0][mesh.s] / sum(sizes[0])
      moved[name] = moved.get(name, 0) + share * t.numel() * t.element_size()
      return fn(t, group, *sizes)
    return run
  with halo.sharded_rows(mesh):
    kl, ml = own_cols(k0, mask)
    kl = kl.clone().requires_grad_()
    got = dc_ops.data_consistency(xl, kl, ml)
    mesh_lib.all_to_all = counted(exchange, 'all_to_all')
    mesh_lib.all_gather = counted(gather, 'all_gather')
    try:
      with torch.no_grad():
        got_eval = dc_ops.data_consistency(xl.detach(), kl.detach(), ml)
    finally:
      mesh_lib.all_to_all, mesh_lib.all_gather = exchange, gather
  got_grads = torch.autograd.grad((got * rows(g)).sum(), [xl, kl])
  with halo.sharded_rows(mesh):
    want_k0_grad, = own_cols(want_grads[1])
  same = lambda a, b: 0.0 if torch.equal(a, b) else 1.0
  image = xi.numel() * xi.element_size()
  return ([max(same(got, rows(want)), same(got_eval, rows(want))),
           same(got_grads[0], rows(want_grads[0])),
           same(got_grads[1], want_k0_grad)],
          {k: v / image for k, v in moved.items()})


def _int8_chain_case(mesh):
  """Three quantized k4 layers (two requants) on the rank's rows against
  the whole image: [0.0 when equal bit for bit, else 1.0, 0.0, 0.0]."""
  import torch
  from csmri_refinement_tpu_torch.ops import conv_chain, quantize
  from csmri_refinement_tpu_torch.parallel import halo
  gen = torch.Generator().manual_seed(12)
  chain = [conv_chain.ChainLayer(0.1 * torch.randn(4, 4, 32, 32,
                                                   generator=gen),
                                 torch.randn(32, generator=gen), 0.2)
           for _ in range(3)]
  x = torch.randn(2, INT8_SIZE, INT8_SIZE, 32, generator=gen)
  quantize.reset_trace_log()
  want = quantize.chain_forward_int8(x, chain)
  got = quantize.chain_forward_int8(halo.local_rows(x, mesh, 1).contiguous(),
                                    chain, mesh=mesh)
  exact = quantize._TRACE_LOG == {(3, 3)} and torch.equal(
      got, halo.local_rows(want, mesh, 1))
  return [0.0 if exact else 1.0, 0.0, 0.0]


def _int8_unet_case(mesh):
  """The int8 U-Net (eval, ``quantize_inference``) on the rank's rows
  against the whole image: [max |Δ| over max |ref|, the share of elements
  that differ by more than 1e-5 of max |ref|, 0.0 if some chain quantized
  else 1.0]."""
  import torch
  from csmri_refinement_tpu_torch.models import construct_model
  from csmri_refinement_tpu_torch.ops import quantize
  from csmri_refinement_tpu_torch.parallel import halo
  net = construct_model(dict(UNET_INT8, name='UNET', quantize_inference=True))
  net.init_weights(torch.Generator().manual_seed(8))
  net.eval()
  x = torch.randn(2, INT8_SIZE, INT8_SIZE, 2,
                  generator=torch.Generator().manual_seed(10))
  quantize.reset_trace_log()
  with torch.no_grad():
    want = halo.local_rows(net(x), mesh, 1)
    with halo.sharded_rows(mesh):
      got = net(halo.local_rows(x, mesh, 1).contiguous())
  scale = want.abs().max()
  diff = (got - want).abs()
  quantized = any(q > 0 for _, q in quantize._TRACE_LOG)
  return [float(diff.max() / scale),
          float((diff > 1e-5 * scale).float().mean()),
          0.0 if quantized else 1.0]


def run_units(cfg):
  import torch
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.parallel import halo
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  world, rank = cfg['world'], cfg['rank']
  mesh = mesh_lib.Mesh(world, rank, torch.device('cpu'), dist.group.WORLD,
                       world, None, dist.group.WORLD)
  errors = {}
  cases = _unit_cases()
  assert tuple(cases) + EXACT_CASES + ('unet int8 eval',) == UNIT_CASES
  for name, (layout, fn, params) in cases.items():
    dim = 2 if layout.startswith('nchw') else 1
    out_dim = 2 if layout.endswith('nchw') else 1
    gen = torch.Generator().manual_seed(len(name))
    x = torch.randn((2, 3, 32, 12) if dim == 2 else (2, 32, 12, 3),
                    generator=gen)
    xw = x.clone().requires_grad_()
    want = fn(xw)
    c = torch.randn(want.shape, generator=gen)
    want_grads = torch.autograd.grad((want * c).sum(), [xw] + params,
                                     allow_unused=True,
                                     materialize_grads=True)
    xl = halo.local_rows(x, mesh, dim).clone().requires_grad_()
    with halo.sharded_rows(mesh):
      got = fn(xl)
    held_whole = name.startswith('discriminator')   # the head's outputs
    cl = c if held_whole else halo.local_rows(c, mesh, out_dim)
    # each rank's loss is its share: of a whole output, 1/S of it
    scale = 1.0 / world if held_whole else 1.0
    grads = torch.autograd.grad((got * cl).sum() * scale, [xl] + params,
                                allow_unused=True, materialize_grads=True)
    param_grads = [g.clone() for g in grads[1:]]
    for g in param_grads:
      dist.all_reduce(g)
    ref = want if held_whole else halo.local_rows(want, mesh, out_dim)
    errors[name] = [
        _rel(got, ref), _rel(grads[0], halo.local_rows(want_grads[0], mesh,
                                                       dim)),
        max([0.0] + [_rel(g, w) for g, w in zip(param_grads,
                                                 want_grads[1:])])]
  moved = {}
  for name, shape in DC_SHAPES.items():
    errors[name], moved[name] = _dc_case(mesh, shape)
  errors['int8 chain'] = _int8_chain_case(mesh)
  errors['unet int8 eval'] = _int8_unet_case(mesh)
  print('DISTRESULT units {}'.format(json.dumps(dict(errors,
                                                     dc_moved=moved))))
  sys.stdout.flush()


def run_validate_cli(cfg):
  from csmri_refinement_tpu_torch import validate
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils.checkpoints import save_checkpoint
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = _standard_conf()
  conf['mesh'] = cfg.get('mesh') or conf['mesh']
  out_dir = os.path.join(cfg['out'], 'validate_rank{}'.format(cfg['rank']))
  os.makedirs(out_dir)
  conf_path = os.path.join(out_dir, 'conf.json')
  with open(conf_path, 'w') as f:
    json.dump(conf, f)
  ckpt = os.path.join(out_dir, 'init.ckpt')     # the seeded init
  conf_obj = Configuration.from_dict(conf)
  save_checkpoint(ckpt, conf_obj, build_runner(conf_obj, 'standard', 'test',
                                               'cpu'), 1, {})
  results = validate.main([conf_path, ckpt, '--device', 'cpu', '-i', '-b',
                           '4', '--out-dir', os.path.join(out_dir, 'out')])
  out_dir = os.path.join(out_dir, 'out')
  files = sorted(os.path.basename(f) for d, _, fs in os.walk(out_dir)
                 for f in fs)
  print('DISTRESULT validate_cli {}'.format(json.dumps({
      'files': files, 'metrics': results['Synthetic']['metrics']})))


def int8_conf(mesh=None):
  """The standard config with the int8 U-Net (``UNET_INT8``,
  ``quantize_inference``) in RecNet's place, on images of ``INT8_SIZE``."""
  conf = _standard_conf()
  conf['model'] = dict(UNET_INT8, name='UNET', quantize_inference=True)
  conf['synthetic'] = {'image_size': INT8_SIZE, 'num_train': 8,
                       'num_val': 8}
  conf['mesh'] = mesh or conf['mesh']
  return conf


def run_int8_validate(cfg):
  """``int8_conf`` validated in mode 'test' from the weights in
  ``<out>/int8_init.pt`` (the JAX package's init, written by the parent):
  saves the first validation batch's gathered ``inp`` and prediction to
  ``<out>/int8_validate_rank<r>.pt`` and prints the metrics."""
  import torch
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict(int8_conf(cfg.get('mesh')))
  runner = build_runner(conf, 'standard', 'test', 'cpu')
  runner.model.load_state_dict(torch.load(os.path.join(cfg['out'],
                                                       'int8_init.pt')))
  shard = None if runner.mesh is None else runner.mesh.shard
  loader = DataLoader(load_dataset(conf, None, 'Synthetic', 'val'),
                      conf.batch_size, process_shard=shard)
  data, _, metrics = runner.validate(loader, num_batches_to_return=1)
  batch, out = data[0][0], data[0][1]
  torch.save({'inp': batch['inp'], 'pred': out},
             os.path.join(cfg['out'], 'int8_validate_rank{}.pt'.format(
                 cfg['rank'])))
  print('DISTRESULT int8_validate {}'.format(json.dumps(
      {k: float(m.value) for k, m in metrics.items()})))
  sys.stdout.flush()


def run(name, cfg):
  import torch
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils.config import Configuration

  from _torch_uneven_child import run_uneven_units
  extra = {'bn': run_bn, 'cli': run_cli, 'units': run_units,
           'validate_cli': run_validate_cli,
           'int8_validate': run_int8_validate,
           'uneven_units': run_uneven_units}
  if name in extra:
    return extra[name](cfg)
  conf_d = _conf_dict(name, cfg['repo'])
  if cfg.get('mesh'):
    conf_d['mesh'] = cfg['mesh']
  conf = Configuration.from_dict(conf_d)
  device = torch.device('cpu')
  runner = build_runner(conf, conf.runner_type, 'train', device)
  if name in ('standard_jax', 'unet_jax'):
    _replay_jax(runner, cfg['out'], name)
  if name == 'adversarial_jax36':
    _replay_jax_gan(runner, cfg['out'])
  if name in WIDTHS:
    _crop_columns(runner.preparer, WIDTHS[name])
  shard = None if runner.mesh is None else runner.mesh.shard
  first = {}
  train_batch = runner.train_batch

  def snapshot_first_update(*args, **kwargs):
    out = train_batch(*args, **kwargs)
    if not first:
      first.update({net: {k: v.clone() for k, v in state.items()}
                    for net, state in _networks(runner).items()})
    return out

  runner.train_batch = snapshot_first_update
  prepare_train, shapes = runner.preparer.prepare_train, {}

  def record_shapes(*args):
    batch = prepare_train(*args)
    if not shapes:
      shapes.update({k: list(v.shape) for k, v in batch.items()
                     if getattr(v, 'ndim', 0) >= 3})
    return batch

  runner.preparer.prepare_train = record_shapes
  loader = DataLoader(load_dataset(conf, None, 'Synthetic', 'train'),
                      conf.batch_size, shuffle=True, seed=conf.seed,
                      process_shard=shard)
  result = {'train': []}
  for epoch in range(1, cfg.get('epochs', {}).get(name, 2) + 1):
    runner.epoch_beginning(epoch)
    losses, _ = runner.train_epoch(loader, epoch,
                                   steps_per_train_summary=10 ** 6)
    runner.epoch_finished(epoch)
    result['train'].append({k: float(m.value) for k, m in losses.items()})
  val_loader = DataLoader(load_dataset(conf, None, 'Synthetic', 'val'),
                          conf.batch_size, process_shard=shard)
  val_data, val_losses, val_metrics = runner.validate(
      val_loader, num_batches_to_return=1 if name in WIDTHS else 0)
  if val_data:    # the first validation batch as the metrics saw it
    np.savez(os.path.join(cfg['out'], '{}_val_rank{}.npz'.format(
        name, cfg['rank'])), **{k: v.numpy() for k, v in val_data[0][0].items()
                                if k in ('inp', 'target', 'kspace', 'mask')})
  result['val'] = {k: float(m.value)
                   for k, m in {**val_losses, **val_metrics}.items()}
  result['shapes'] = shapes
  torch.save({'final': _networks(runner), 'first_update': first},
             os.path.join(cfg['out'], '{}_rank{}.pt'.format(name,
                                                            cfg['rank'])))
  print('DISTRESULT {} {}'.format(name, json.dumps(result)))
  sys.stdout.flush()


def main():
  cfg = json.loads(sys.argv[1])
  sys.path.insert(0, cfg['repo'])
  import torch
  torch.set_num_threads(cfg.get('threads', 2))
  from csmri_refinement_tpu_torch.parallel.distributed import (initialize,
                                                                shutdown)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  if cfg['world'] > 1:     # the production entry, from a distributed section
    initialize(Configuration.from_dict({'distributed': {
        'coordinator_address': '127.0.0.1:{}'.format(cfg['port']),
        'num_processes': cfg['world'], 'process_id': cfg['rank']}}), 'cpu')
  try:
    for name in cfg['scenarios']:
      run(name, cfg)
  finally:
    shutdown()


if __name__ == '__main__':
  main()
