"""Spatial-mesh cases whose rows a stride or a pool splits, run in a child
of ``tests/_torch_dist_child.py`` (scenario ``uneven_units``).

Each rank holds ``ROWS_PER_RANK`` (an odd count) of an image's rows, so
the first stride-2 window or pool already splits a rank's rows and the
maps below it are held in unequal blocks (``parallel/halo.py::Rows``),
down to blocks of one row and of none on four ranks. ``run_uneven_units``
prints one ``DISTRESULT uneven_units`` line: {case: [output error,
input-gradient error, parameter-gradient error]}, each the largest |Δ|
over max |ref| of the whole image's (the parameter gradients, summed over
the ranks first: {parameter: [largest |Δ|, its largest |ref|, the largest
|ref| of all of the case's, 1 for a norm layer's scale]}; ``EXACT_CASES``: 0.0 when equal bit for bit,
else 1.0; the
int8 U-Net: [max |Δ| over max |ref|, the share of elements off, 0.0 when
a chain quantized]), ``fetched``: per ``halo.fetch`` call of a U-Net's
train step, [rows received, rows its window lacks], and ``gathered``: the
callers of ``all_gather`` in it, each with the most rows one rank sent.
"""

import json
import sys

import numpy as np

ROWS_PER_RANK = 9
# a U-Net per up-sampling mode, three scales (two pools)
UNETS = {
    'unet nn-resize-conv k4 reflection': dict(
        num_layers_per_scale=1, kernel_size=4, upsampling_mode='nn-resize-conv',
        padding='reflection', decoder_act_upsampling_only=True),
    'unet pixelshuffle k3 reflection': dict(
        num_layers_per_scale=2, upsampling_mode='pixelshuffle',
        padding='reflection'),
    'unet transposed k4 zero': dict(
        num_layers_per_scale=1, transposed_kernel_size=4),
    'unet transposed k2 zero': dict(num_layers_per_scale=1),
    'unet nn-resize-conv k3 replication': dict(
        num_layers_per_scale=1, upsampling_mode='nn-resize-conv',
        padding='replication'),
    'unet nn-biresize-conv k3 reflection': dict(
        num_layers_per_scale=1, upsampling_mode='nn-biresize-conv',
        padding='reflection', decoder_act_upsampling_only=True),
    'unet nn k3 zero': dict(num_layers_per_scale=1, upsampling_mode='nn'),
    'unet bilinear k4 replication': dict(
        num_layers_per_scale=1, kernel_size=4, upsampling_mode='bilinear',
        padding='replication'),
}
DISCRIMINATORS = ('batch patchgan', 'instance fc', 'batch average')
UNIT_CASES = tuple(
    ['same_conv {} k{} s{}'.format(mode, k, stride)
     for mode in ('zero', 'reflection', 'replication') for k in (3, 4)
     for stride in (1, 2)] + ['max_pool2', 'instance_norm'] +
    ['{} {}'.format(net, mode) for net in UNETS for mode in ('train', 'eval')] +
    ['discriminator ' + d for d in DISCRIMINATORS] +
    ['vgg19 blocks 1 2 3', 'vgg19 loss', 'feature matching loss', 'dc',
     'dc noisy', 'int8 chain', 'unet int8 eval'])
# bit for bit against the whole image (each error 0.0 when equal)
EXACT_CASES = ('dc', 'int8 chain')
# (B, H, W) of the DC cases: W = 15 divides by neither 2 nor 4
DC_SHAPE = (2, 16, 15)
UNET_INT8 = dict(num_inputs=2, num_outputs=2, num_layers_per_scale=2,
                 encode_filters=[32, 64], decode_filters=[32], kernel_size=4,
                 upsampling_mode='nn-resize-conv', output_activation='none',
                 padding='reflection', decoder_act_upsampling_only=True)
# 17 rows a rank: the int8 U-Net's pool splits them; the quantized layers'
# width rule needs 64 columns
INT8_ROWS, INT8_WIDTH = 17, 64


def _rel(got, want):
  got, want = got.detach(), want.detach()
  if not want.numel():
    return 0.0
  return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _params_rel(got, want, scales):
  """Per parameter: [its largest |Δ|, its largest |ref|, the largest |ref|
  of all of the case's parameters, 1 for a norm layer's scale else 0]."""
  most = max([float(w.abs().max()) for w in want] or [0.0])
  return [[float((g - w).abs().max()), float(w.abs().max()), most, scale]
          for g, w, scale in zip(got, want, scales)]


def _norm_scales(module):
  """The names of ``module``'s norm-layer scales (BatchNorm ``weight``,
  InstanceNorm ``scale``)."""
  from torch import nn
  from csmri_refinement_tpu_torch.models.layers import InstanceNorm
  names = set()
  for prefix, m in module.named_modules():
    if isinstance(m, (nn.BatchNorm2d, InstanceNorm)):
      names.add((prefix + '.' if prefix else '') +
                ('scale' if isinstance(m, InstanceNorm) else 'weight'))
  return names


def _cases(world):
  """{case: (layout, fn(x) → output, {name: parameter}, output layout,
  names of norm-layer scales)} on an NCHW or NHWC input of
  ``ROWS_PER_RANK`` · world rows; the output layout maps the input's to
  the output's, None where the rows are the input's (or the output is
  whole on every rank)."""
  import torch
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.models import construct_model, layers
  from csmri_refinement_tpu_torch.models.unet import BatchNorm2d
  from csmri_refinement_tpu_torch.models.vgg import VGG19
  from csmri_refinement_tpu_torch.parallel import halo
  height = ROWS_PER_RANK * world
  cases = {}
  gen = torch.Generator().manual_seed(5)
  for mode in ('zero', 'reflection', 'replication'):
    for k in (3, 4):
      for stride in (1, 2):
        w = torch.randn(5, 3, k, k, generator=gen).requires_grad_()
        b = torch.randn(5, generator=gen).requires_grad_()

        def conv(x, w=w, b=b, m=mode, s=stride):
          return layers.same_conv(x, w, b, m, stride=s)
        cases['same_conv {} k{} s{}'.format(mode, k, stride)] = (
            'nchw', conv, {'weight': w, 'bias': b},
            lambda rows, k=k, s=stride: layers.conv_rows(rows, k, stride=s),
            set())
  cases['max_pool2'] = ('nchw', layers.max_pool2, {}, layers.pool_rows,
                        set())
  norm = layers.InstanceNorm(3, affine=True)
  with torch.no_grad():
    norm.scale.uniform_(0.5, 1.5, generator=gen)
    norm.bias.normal_(generator=gen)
  cases['instance_norm'] = ('nchw', norm, dict(norm.named_parameters()),
                            None, _norm_scales(norm))

  def train_unet(x, net):
    for m in net.modules():
      if isinstance(m, BatchNorm2d):
        m.process_group = dist.group.WORLD if halo.current() else None
    return net.train()(x)
  for name, section in UNETS.items():
    net = construct_model(dict(section, name='UNET', num_inputs=3,
                               num_outputs=2, encode_filters=[4, 8, 8],
                               decode_filters=[8, 4],
                               output_activation='none'))
    net.init_weights(torch.Generator().manual_seed(6))
    cases[name + ' train'] = ('nhwc', lambda x, m=net: train_unet(x, m),
                              dict(net.named_parameters()), None,
                              _norm_scales(net))
    cases[name + ' eval'] = ('nhwc', lambda x, m=net: m.eval()(x), {}, None,
                             set())
  discriminators = (('batch patchgan', {}),
                    ('instance fc', {'norm_layer': 'instance-affine',
                                     'fc_layers': [6, 1],
                                     'spatial_shape': [height, 12]}),
                    ('batch average', {'final_conv_kernel_size': 1,
                                       'final_average_pooling': True}))
  for name, extra in discriminators:
    disc = construct_model(dict(dict(
        name='CNNDiscriminator', num_inputs=3, num_filters_per_layer=[4, 8, 8],
        strides=[2, 2, 1], kernel_sizes=4, final_conv_kernel_size=2,
        padding='reflection', use_norm_layers='not-first',
        compute_features=True), **extra))
    disc.init_weights(torch.Generator().manual_seed(7))
    cases['discriminator ' + name] = (
        'nhwc', lambda x, d=disc: d.eval()(x)['logits'],
        dict(disc.named_parameters()), None, _norm_scales(disc))
  vgg = VGG19((1, 2, 3))
  for conv in vgg.children():
    torch.nn.init.normal_(conv.weight, 0.0, 0.1, generator=gen)
    torch.nn.init.normal_(conv.bias, 0.0, 0.1, generator=gen)
  # the deepest block: on two ranks its two rows are one rank's
  cases['vgg19 blocks 1 2 3'] = ('nhwc>nchw', lambda x: vgg(x.sigmoid())[2],
                                 dict(vgg.named_parameters()),
                                 lambda rows: VGG19.block_rows(rows)[3],
                                 set())
  return cases


def _loss_cases(mesh):
  """The VGG19 loss (blocks 1-3) and feature matching (a discriminator of
  two stride-2 layers) on maps whose rows a pool or a stride split: [the
  mean of the ranks' losses against one process's, each rank's input
  gradient of that mean against the whole image's, {} (no parameters)],
  each the largest |Δ| over max |ref|. A rank's loss is S times its share, and the ranks'
  inputs take every rank's loss's gradient through the collectives'
  backward."""
  import torch
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.models import construct_model
  from csmri_refinement_tpu_torch.models.adversarial_loss import (
      FeatureMatchingLoss)
  from csmri_refinement_tpu_torch.models.vgg_loss import VGGLoss
  from csmri_refinement_tpu_torch.parallel import halo
  gen = torch.Generator().manual_seed(13)
  x, target = (torch.randn(2, ROWS_PER_RANK * mesh.spatial, 12, 2,
                           generator=gen) for _ in range(2))
  vgg = VGGLoss('VGG19', blocks=[1, 2, 3], allow_random_init=True, seed=3,
                device='cpu')
  disc = construct_model(dict(
      name='CNNDiscriminator', num_inputs=2, num_filters_per_layer=[4, 8, 8],
      strides=[2, 2, 1], kernel_sizes=4, final_conv_kernel_size=2,
      padding='reflection', use_norm_layers='not-first',
      compute_features=True))
  disc.init_weights(torch.Generator().manual_seed(7))
  disc.eval()
  feature_matching = FeatureMatchingLoss('gen')
  losses = {'vgg19 loss': vgg,
            'feature matching loss': lambda a, t: feature_matching(disc(a),
                                                                   disc(t))}
  rows = lambda t: halo.local_rows(t, mesh, 1)
  errors = {}
  for name, loss in losses.items():
    xw = x.clone().requires_grad_()
    want = loss(xw, target)
    want_grad, = torch.autograd.grad(want, [xw])
    xl = rows(x).clone().requires_grad_()
    with halo.sharded_rows(mesh):
      got = loss(xl, rows(target))
    got_grad, = torch.autograd.grad(got, [xl])
    mean = got.detach().clone()
    dist.all_reduce(mean)
    errors[name] = [_rel(mean / mesh.spatial, want),
                    _rel(got_grad / mesh.spatial, rows(want_grad)), {}]
  return errors


def _dc_cases(mesh):
  """The DC on K1's passes and the noisy DC (plain passes, autodiffed) on
  a width that S does not divide: [output, input gradient, k0 gradient],
  each 0.0 when equal to one process's bit for bit (the noisy DC: the
  largest |Δ| over max |ref|); and the DC against the 2D ``torch.fft``
  formula."""
  import torch
  from csmri_refinement_tpu_torch.ops import dc as dc_ops
  from csmri_refinement_tpu_torch.ops import dc_kernel, fft
  from csmri_refinement_tpu_torch.parallel import halo
  gen = torch.Generator().manual_seed(9)
  xi, k0, g = (torch.randn(DC_SHAPE + (2,), generator=gen) for _ in range(3))
  mask = (torch.rand(DC_SHAPE + (1,), generator=gen) > 0.5).float()
  cols = lambda t: t[:, :, mesh.image_cols(t.shape[2])]
  rows = lambda t: halo.local_rows(t, mesh, 1)
  same = lambda a, b: 0.0 if torch.equal(a, b) else 1.0
  errors = {}
  for name, noise in (('dc', None), ('dc noisy', 0.1)):
    xw, kw = xi.clone().requires_grad_(), k0.clone().requires_grad_()
    want = dc_ops.data_consistency(xw, kw, mask, noise)
    want_grads = torch.autograd.grad((want * g).sum(), [xw, kw])
    xl = rows(xi).clone().requires_grad_()
    kl = cols(k0).clone().requires_grad_()
    with halo.sharded_rows(mesh):
      got = dc_ops.data_consistency(xl, kl, cols(mask), noise)
    got_grads = torch.autograd.grad((got * rows(g)).sum(), [xl, kl])
    pairs = ((got, rows(want)), (got_grads[0], rows(want_grads[0])),
             (got_grads[1], cols(want_grads[1])))
    errors[name] = [same(a, b) if noise is None else _rel(a, b)
                    for a, b in pairs]
  formula = fft.pack_complex(fft.ifft2(dc_kernel.kspace_merge_reference(
      fft.fft2(fft.unpack_complex(xi)), fft.unpack_complex(k0),
      mask[..., 0])))
  with torch.no_grad(), halo.sharded_rows(mesh):
    got = dc_ops.data_consistency(rows(xi), cols(k0), cols(mask))
  errors['dc formula'] = _rel(got, rows(formula))
  return errors


def _int8_cases(mesh):
  """A chain of quantized layers on a map of unequal blocks (a pool's
  layout) and the int8 U-Net whose pool splits the ranks' rows, each
  against the whole image."""
  import torch
  from csmri_refinement_tpu_torch.models import construct_model, layers
  from csmri_refinement_tpu_torch.ops import conv_chain, quantize
  from csmri_refinement_tpu_torch.parallel import halo
  gen = torch.Generator().manual_seed(12)
  chain = [conv_chain.ChainLayer(0.1 * torch.randn(4, 4, 32, 32,
                                                   generator=gen),
                                 torch.randn(32, generator=gen), 0.2)
           for _ in range(3)]
  rows = layers.pool_rows(halo.Rows.equal(2 * INT8_ROWS, mesh.spatial))
  x = torch.randn(2, rows.height, INT8_WIDTH, 32, generator=gen)
  quantize.reset_trace_log()
  want = quantize.chain_forward_int8(x, chain)
  got = quantize.chain_forward_int8(
      halo.local_rows(x, mesh, 1, rows).contiguous(), chain, mesh=mesh,
      rows=rows)
  exact = quantize._TRACE_LOG == {(3, 3)} and torch.equal(
      got, halo.local_rows(want, mesh, 1, rows))
  errors = {'int8 chain': [0.0 if exact else 1.0, 0.0, 0.0]}
  net = construct_model(dict(UNET_INT8, name='UNET', quantize_inference=True))
  net.init_weights(torch.Generator().manual_seed(8))
  net.eval()
  x = torch.randn(2, INT8_ROWS * mesh.spatial, INT8_WIDTH, 2,
                  generator=torch.Generator().manual_seed(10))
  quantize.reset_trace_log()
  with torch.no_grad():
    want = halo.local_rows(net(x), mesh, 1)
    with halo.sharded_rows(mesh):
      got = net(halo.local_rows(x, mesh, 1).contiguous())
  scale = want.abs().max()
  diff = (got - want).abs()
  errors['unet int8 eval'] = [
      float(diff.max() / scale), float((diff > 1e-5 * scale).float().mean()),
      0.0 if any(q > 0 for _, q in quantize._TRACE_LOG) else 1.0]
  return errors


def _traffic(mesh):
  """One train step of the reflection k4 U-Net on the rank's rows with
  ``halo.fetch`` and the collectives recorded: per fetch, [rows received,
  rows the window lacks] (the distinct rows of other ranks the window's
  rows read, reflections resolved); the callers of ``all_gather`` with
  the most rows a rank sent in one call."""
  import torch
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.models import construct_model
  from csmri_refinement_tpu_torch.models.unet import BatchNorm2d
  from csmri_refinement_tpu_torch.parallel import halo
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  net = construct_model(dict(UNETS['unet nn-resize-conv k4 reflection'],
                             name='UNET', num_inputs=3, num_outputs=2,
                             encode_filters=[4, 8, 8], decode_filters=[8, 4],
                             output_activation='none'))
  net.init_weights(torch.Generator().manual_seed(6))
  for m in net.modules():
    if isinstance(m, BatchNorm2d):
      m.process_group = dist.group.WORLD
  fetched, gathered, pending = [], {}, []
  fetch, exchange, gather = halo.fetch, mesh_lib.all_to_all, \
      mesh_lib.all_gather

  def lacking(rows, windows, mode):
    window = windows[mesh.s]
    if window is None:
      return 0
    a, b = rows.block(mesh.s)
    need = set()
    for i in range(*window):
      if i < 0 or i >= rows.height:
        if mode in (None, 'constant'):
          continue
        i = min(max(i, 0), rows.height - 1) if mode == 'replicate' else \
            -i if i < 0 else 2 * (rows.height - 1) - i
      if not a <= i < b:
        need.add(i)
    return len(need)

  def recorded_fetch(x, m, rows, windows, mode=None, dim=2):
    pending.append(lacking(rows, windows, mode))
    out = fetch(x, m, rows, windows, mode, dim)
    fetched.append([pending.pop() if pending else 0, 0])
    return out

  def recorded_exchange(t, group, send_sizes, recv_sizes):
    if pending:
      fetched.append([sum(recv_sizes), pending.pop()])
    return exchange(t, group, send_sizes, recv_sizes)

  def recorded_gather(t, group):
    caller = sys._getframe(1).f_code.co_qualname
    gathered[caller] = max(gathered.get(caller, 0), t.shape[1] if t.ndim == 4
                           and caller == 'gather_blocks' else
                           t.shape[2] if t.ndim == 4 else t.numel())
    return gather(t, group)
  halo.fetch, mesh_lib.all_to_all, mesh_lib.all_gather = (
      recorded_fetch, recorded_exchange, recorded_gather)
  try:
    x = torch.randn(2, ROWS_PER_RANK, 12, 3,
                    generator=torch.Generator().manual_seed(mesh.s))
    with halo.sharded_rows(mesh):
      net.train()(x.requires_grad_()).sum().backward()
  finally:
    halo.fetch, mesh_lib.all_to_all, mesh_lib.all_gather = (
        fetch, exchange, gather)
  # a fetch whose plan moved nothing left [0, rows it lacked]: none
  return [f for f in fetched if f != [0, 0]], gathered


def run_uneven_units(cfg):
  import torch
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.parallel import halo
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  world, rank = cfg['world'], cfg['rank']
  mesh = mesh_lib.Mesh(world, rank, torch.device('cpu'), dist.group.WORLD,
                       world, None, dist.group.WORLD)
  errors = {}
  rows = halo.Rows.equal(ROWS_PER_RANK, world)
  for name, (layout, fn, named, rows_out, scales) in _cases(world).items():
    params = list(named.values())
    dim = 2 if layout.startswith('nchw') else 1
    out_dim = 2 if layout.endswith('nchw') else 1
    gen = torch.Generator().manual_seed(len(name))
    shape = (2, 3, rows.height, 12) if dim == 2 else (2, rows.height, 12, 3)
    x = torch.randn(shape, generator=gen)
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
    out_rows = None if rows_out is None else rows_out(rows)
    part = (lambda t: t) if held_whole else \
        (lambda t: halo.local_rows(t, mesh, out_dim, out_rows))
    scale = 1.0 / world if held_whole else 1.0
    grads = torch.autograd.grad((got * part(c)).sum() * scale, [xl] + params,
                                allow_unused=True, materialize_grads=True)
    param_grads = [g.clone() for g in grads[1:]]
    for g in param_grads:
      dist.all_reduce(g)
    errors[name] = [
        _rel(got, part(want)),
        _rel(grads[0], halo.local_rows(want_grads[0], mesh, dim)),
        dict(zip(named, _params_rel(param_grads, want_grads[1:],
                                    [int(n in scales) for n in named])))]
  errors.update(_loss_cases(mesh))
  errors.update(_dc_cases(mesh))
  errors.update(_int8_cases(mesh))
  fetched, gathered = _traffic(mesh)
  print('DISTRESULT uneven_units {}'.format(json.dumps(dict(
      errors, fetched=fetched, gathered=gathered))))
  sys.stdout.flush()
