"""Adversarial runner: generator and discriminator trained together.

Port of ``csmri_refinement_tpu/training/adversarial_runner.py``. One
update (``train_batch``, JAX ``:325-467``):

1. the generator runs once in train mode; its output, detached, feeds the
   discriminator phase (JAX runs it a second time inside the generator
   loss; the values are the same and the BN statistics move once);
2. discriminator phase, when the discriminator is updated: the detached
   fakes through the image pool, then the reals, the discriminator losses
   and their gradients;
3. generator phase, when the generator is updated: the discriminator on
   the fakes with the graph kept (and on the detached reals when feature
   matching needs them and no discriminator phase ran), the adversarial and
   plain generator losses, and their gradients over the generator's
   trainable parameters only (``torch.autograd.grad``: nothing reaches the
   discriminator's ``.grad``);
4. then both optimizers step, so each loss saw the other network's
   pre-step weights.

The discriminator's BatchNorm statistics move in the reference's order
(pool fakes, reals, generator fakes, then the extra real pass). An update
that leaves the generator alone (discriminator pretraining, the
discriminator updates of ``updates_per_step``) keeps the generator's BN
statistics as they were, as JAX throws that forward's updates away
(``:392``). A frozen pretrained model (``RefinementWrapper``) records no
graph, takes no optimizer step and stays bit-identical.

Randomness: masks from a generator seeded with the seed and the update
count (as ``Runner``), dropout from a device ``torch.Generator``, the
pool's decisions from a host one, all seeded from ``conf.seed``; JAX's
streams differ.

Validation (``:589-636``): the generator in eval mode (its U-Net through
the conv-chain kernel), the discriminator on fakes and reals without the
pool, the plain generator losses, in full f32; the inference loop's step
(``compute_metrics=False``) runs the generator alone. ``predict`` and
``get_named_outputs`` (``:720-756``, ``disc_fake`` included) serve the
validate CLI.

The training options, as in the standard runner (``runner.py``), in mode
``'train'`` only: ``train_dtype`` is the compute dtype of the generator
(and through a ``RefinementWrapper`` of both its models) and of the
discriminator, unless a model section names its own (JAX ``:85-90``,
``:118-122``); the image pool stays f32 (the generator's outputs are cast
at the loss boundary) and the discriminator casts what it is given.
``train_remat`` recomputes the generator forward and each discriminator
apply in the backward (JAX ``:326-350``), the discriminator's dropout
masks replayed from the same generator state. ``steps_per_fetch`` = k runs
k full D-then-G updates per fetch, when ``updates_per_step`` is 1 on both
optimizers, the generator is enabled and the preparer is ``device_pure``
(not with radial masks; JAX ``:540-548``).

In a data-parallel run (``base_runner``'s docstring) both networks'
gradients are averaged over the group in one all-reduce before the
optimizer steps, and the image pool sees the global batch: the detached
fakes are gathered in rank order, every rank queries its own copy of the
pool with the same decisions (the pool generator is seeded alike) and keeps
its rows, so that the pools stay equal to each other and to a single
process's. The discriminator's dropout decisions are drawn for the global
batch (``batch_shard``). Under a spatial mesh the update and the
validation step run on the rank's image rows
(``parallel/halo.py::sharded_rows``): each rank's pool stores its rows,
the discriminator's head outputs are whole on every rank of a spatial
group, and the metrics' data gathers the rows and the batch of the
generator's output and the batch of the head outputs (the feature maps
are left out).
"""

import logging

import torch

from csmri_refinement_tpu_torch.metrics import (accumulate_metric,
                                                get_loss_metric,
                                                get_metric_fn)
from csmri_refinement_tpu_torch.models import (construct_model,
                                               get_input_keys, remat)
from csmri_refinement_tpu_torch.models.adversarial_loss import (
    FeatureMatchingLoss)
from csmri_refinement_tpu_torch.models.criteria import get_criterion
from csmri_refinement_tpu_torch.parallel import halo
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
from csmri_refinement_tpu_torch.training.adversarial_training import (
    get_discriminator_input_fn)
from csmri_refinement_tpu_torch.training.base_runner import (
    BaseRunner, cast_outputs_f32, detach, mean_losses)
from csmri_refinement_tpu_torch.training.image_pool import (
    ImagePool, pool_size_from_conf)
from csmri_refinement_tpu_torch.training.lr_schedulers import (
    get_lr_scheduler)
from csmri_refinement_tpu_torch.training.model_setup import (
    apply_pretrained_weights)
from csmri_refinement_tpu_torch.training.optimizers import (get_optimizer,
                                                            set_learning_rate)
from csmri_refinement_tpu_torch.training.prep import get_batch_preparer
from csmri_refinement_tpu_torch.utils.checkpoints import (
    load_network_state, load_optimizer_state)
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.precision import full_f32


def _get_pretraining_schedule(epochs):
  """(start, end) epoch interval (JAX ``:63-71``)."""
  if epochs is None:
    return (-1, -1)
  if isinstance(epochs, int):
    return (1, epochs + 1)
  if not epochs[0] < epochs[1]:
    raise ValueError('Starting epoch must be smaller than ending epoch')
  return tuple(epochs)


def _loss_metrics(updates, mesh=None):
  """{name: MinMetric} of the updates' mean losses (over the mesh's ranks
  too), in one host fetch."""
  return {name: get_loss_metric(value)
          for name, value in mean_losses(updates, mesh).items()}


def _weighted(losses, weights):
  return sum(weights[name] * loss for name, loss in losses.items())


class AdversarialRunner(BaseRunner):
  """Generator + discriminator on ``device`` (the card unless the caller
  asks for the CPU)."""

  def __init__(self, conf, mode='train', device='cuda'):
    super().__init__(conf, mode)
    self.device = torch.device(device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError('AdversarialRunner: no CUDA device; pass '
                         'device="cpu" to run the plain versions on the CPU')
    gen_conf = self._train_dtype(dict(conf.generator_model))
    if conf.has_attr('undersampling'):
      gen_conf.setdefault('undersampling', conf.undersampling)
    self.gen = construct_model(gen_conf)
    self.gen.init_weights(torch.Generator().manual_seed(conf.seed))
    apply_pretrained_weights(self.gen, gen_conf, conf.file)
    self.gen.to(self.device)
    self.gen_input_keys = get_input_keys(self.gen)
    self.preparer = get_batch_preparer(conf, self.device)
    self.val_metric_fns = {
        name: get_metric_fn(conf, name)
        for name in conf.get_attr('validation_metrics', default=[])}
    self.step = 0
    self.generator_enabled = True
    self.discriminator_enabled = True
    self.disc = None
    self.pool = None
    self.gen_criteria = {}
    self.gen_optimizer = self.disc_optimizer = None
    self.gen_lr_scheduler = self.disc_lr_scheduler = None
    self.gen_updates_per_step = self.disc_updates_per_step = 1
    self.train_gen_metric_fns = {}
    self.train_disc_metric_fns = {}
    self.val_disc_metric_fns = {}
    self.steps_per_fetch = 1
    self.train_remat = False
    if mode == 'train':
      self._build_training(conf)
      self._setup_mesh(self.preparer, self.gen, self.disc)
      if self.mesh is not None:
        self.disc.batch_shard = self.mesh.shard
    else:
      self._setup_mesh(self.preparer, self.gen)

  def _build_training(self, conf):
    self.steps_per_fetch = conf.get_attr('steps_per_fetch', default=1)
    self.train_remat = conf.get_attr('train_remat', default=False)
    disc_conf = dict(conf.discriminator_model)
    self.disc = construct_model(self._train_dtype(
        dict(disc_conf, name='CNNDiscriminator')))
    self.disc.init_weights(torch.Generator().manual_seed(conf.seed + 1))
    apply_pretrained_weights(self.disc, disc_conf, conf.file)
    self.disc.to(self.device)

    def criteria(names, **kwargs):
      return {name: get_criterion(conf, name, device=self.device, **kwargs)
              for name in names}
    self.gen_adv_criteria = criteria(conf.generator_adversarial_losses,
                                     loss_type='gen')
    self.gen_criteria = criteria(conf.generator_losses)
    self.disc_adv_criteria = criteria(conf.discriminator_losses,
                                      loss_type='disc')
    self.gen_loss_weights = self._loss_weights(
        conf.get_attr('generator_loss_weights', default={}),
        self.gen_adv_criteria, self.gen_criteria)
    self.disc_loss_weights = self._loss_weights(
        conf.get_attr('discriminator_loss_weights', default={}),
        self.disc_adv_criteria)
    self.needs_real = any(isinstance(c, FeatureMatchingLoss)
                          for c in self.gen_adv_criteria.values())

    self.gen_params = [p for p in self.gen.parameters() if p.requires_grad]
    self.disc_params = list(self.disc.parameters())
    gen_opt = Configuration.from_dict(conf.generator_optimizer, conf)
    disc_opt = Configuration.from_dict(conf.discriminator_optimizer, conf)
    self.gen_optimizer = get_optimizer(gen_opt, gen_opt.name, self.gen_params)
    self.disc_optimizer = get_optimizer(disc_opt, disc_opt.name,
                                        self.disc_params)
    if gen_opt.has_attr('lr_scheduler'):
      self.gen_lr_scheduler = get_lr_scheduler(gen_opt, gen_opt.lr_scheduler)
    if disc_opt.has_attr('lr_scheduler'):
      self.disc_lr_scheduler = get_lr_scheduler(disc_opt,
                                                disc_opt.lr_scheduler)
    self.gen_updates_per_step = gen_opt.get_attr('updates_per_step',
                                                 default=1)
    self.disc_updates_per_step = disc_opt.get_attr('updates_per_step',
                                                   default=1)

    def metric_fns(key):
      return {name: get_metric_fn(conf, name)
              for name in conf.get_attr(key, default=[])}
    self.train_gen_metric_fns = metric_fns('train_generator_metrics')
    self.train_disc_metric_fns = metric_fns('train_discriminator_metrics')
    self.val_disc_metric_fns = metric_fns('validation_discriminator_metrics')

    self.disc_input_fn = get_discriminator_input_fn(disc_conf)
    self.val_disc_input_fn = get_discriminator_input_fn(disc_conf,
                                                        no_pool=True)
    self.pool_size = pool_size_from_conf(conf, disc_conf)
    self.pool_generator = torch.Generator().manual_seed(conf.seed)
    self.dropout_generator = torch.Generator(
        device=self.device).manual_seed(conf.seed)
    self.generator_pretraining_schedule = _get_pretraining_schedule(
        conf.get_attr('pretrain_generator_epochs'))
    self.discriminator_pretraining_schedule = _get_pretraining_schedule(
        conf.get_attr('pretrain_discriminator_epochs'))

  # -- steps ------------------------------------------------------------------

  def _gen_inputs(self, batch):
    return [batch[k] for k in self.gen_input_keys]

  def _disc(self, x):
    if self.train_remat and torch.is_grad_enabled():
      out = remat.checkpoint(self.disc, x, self.dropout_generator,
                             generators=(self.dropout_generator,))
    else:
      out = self.disc(x, self.dropout_generator)
    return cast_outputs_f32(out)

  def _gen_forward(self, inputs, update_gen):
    """The train-mode generator output; without a generator update it
    records no graph and leaves the BN statistics as they were."""
    if update_gen:
      return cast_outputs_f32(remat.checkpoint(self.gen, *inputs)
                              if self.train_remat else self.gen(*inputs))
    saved = [b.clone() for b in self.gen.buffers()]
    with torch.no_grad():
      out = cast_outputs_f32(self.gen(*inputs))
      for b, s in zip(self.gen.buffers(), saved):
        b.copy_(s)
    return out

  def _pool_for(self, out_gen):
    """The image pool, made at the first discriminator phase to the
    shape of the discriminator's input (None without a pool)."""
    if self.pool_size and self.pool is None:
      shape = self.disc_input_fn.build(out_gen).shape[1:]
      self.pool = ImagePool(self.pool_size, shape, self.device)
    return self.pool

  def train_batch(self, batch, update_gen=True, update_disc=True):
    """One update on a prepared batch; returns (losses, detached data for
    the train metrics: batch, generator output, discriminator outputs on
    fakes and reals or None)."""
    with halo.sharded_rows(self.mesh):
      return self._train_batch(batch, update_gen, update_disc)

  def _train_batch(self, batch, update_gen, update_disc):
    use_disc = self.discriminator_enabled
    update_gen = update_gen and self.generator_enabled
    update_disc = update_disc and use_disc
    self.gen.train()
    self.disc.train()
    inputs = self._gen_inputs(batch)
    out_gen = self._gen_forward(inputs, update_gen)
    out_gen_d = detach(out_gen)
    losses = {}
    out_fake = out_real = None

    if update_disc:
      fake_in = self.disc_input_fn(
          out_gen_d, is_real_input=False, detach=True,
          pool=self._pool_for(out_gen_d),
          generator=self.pool_generator, mesh=self.mesh)
      out_fake = self._disc(fake_in)
      out_real = self._disc(self.disc_input_fn(
          batch['target'], is_real_input=True, detach=True))
      dlosses = {name: crit(out_fake, out_real)
                 for name, crit in self.disc_adv_criteria.items()}
      d_total = _weighted(dlosses, self.disc_loss_weights)
      d_grads = list(torch.autograd.grad(
          d_total, self.disc_params, allow_unused=True,
          materialize_grads=True))
      losses.update(('disc_loss_' + n, v.detach()) for n, v in dlosses.items())
      losses['disc_loss'] = d_total.detach()

    if update_gen:
      glosses = {}
      if use_disc:
        out_fake = self._disc(self.disc_input_fn(
            out_gen, is_real_input=False, detach=False))
        if self.needs_real and out_real is None:
          with torch.no_grad():
            out_real = self._disc(self.disc_input_fn(
                batch['target'], is_real_input=True, detach=True))
        glosses.update((name, crit(out_fake, out_real))
                       for name, crit in self.gen_adv_criteria.items())
      glosses.update((name, crit(out_gen, batch))
                     for name, crit in self.gen_criteria.items())
      g_total = _weighted(glosses, self.gen_loss_weights)
      g_grads = list(torch.autograd.grad(
          g_total, self.gen_params, allow_unused=True,
          materialize_grads=True))
      losses.update(('gen_loss_' + n, v.detach()) for n, v in glosses.items())
      losses['gen_loss'] = g_total.detach()

    mesh_lib.average_((d_grads if update_disc else []) +
                      (g_grads if update_gen else []), self.mesh)
    if update_disc:
      for p, g in zip(self.disc_params, d_grads):
        p.grad = g
      self.disc_optimizer.step()
    if update_gen:
      for p, g in zip(self.gen_params, g_grads):
        p.grad = g
      self.gen_optimizer.step()
    self.step += 1
    return losses, (batch, out_gen_d, detach(out_fake), detach(out_real))

  def _mask_generator(self):
    return torch.Generator(device=self.device).manual_seed(
        self.conf.seed * 2 ** 32 + self.step)

  def _update(self, host_batch, update_gen, update_disc):
    batch = self.preparer.prepare_train(self._mask_generator(), host_batch)
    return self.train_batch(batch, update_gen, update_disc)

  def _train_step(self, batch_iter):
    if self.gen_updates_per_step == 1 and self.disc_updates_per_step == 1:
      k = self.steps_per_fetch if (self.generator_enabled and
                                   self.preparer.device_pure) else 1
      host_batches = self._collect_stackable_batches(batch_iter, k)
      updates, data = [], None
      for host_batch in host_batches:
        losses, data = self._update(host_batch, True, True)
        updates.append(losses)
      if k > 1:
        data = None
      return len(host_batches), _loss_metrics(updates, self.mesh), data

    # Several updates per step (JAX :540-587): max(gen, disc) batches,
    # the discriminator's updates first, then the generator's.
    batches = []
    for _ in range(max(self.disc_updates_per_step,
                       self.gen_updates_per_step)):
      host_batch = next(batch_iter, None)
      if host_batch is None:
        break
      batches.append(host_batch)
    if not batches:
      return 0, None, None
    loss_metrics = {}
    data = None
    updates = []
    if self.discriminator_enabled:
      updates += [(b, False, True)
                  for b in batches[:self.disc_updates_per_step]]
    if self.generator_enabled:
      updates += [(b, True, False)
                  for b in batches[:self.gen_updates_per_step]]
    for host_batch, update_gen, update_disc in updates:
      losses, data = self._update(host_batch, update_gen, update_disc)
      for name, metric in _loss_metrics([losses], self.mesh).items():
        accumulate_metric(loss_metrics, name, metric)
    return len(batches), {name: metric.average()
                          for name, metric in loss_metrics.items()}, data

  def _val_step(self, host_batch, compute_metrics=True):
    batch = self.preparer.prepare_val(host_batch)
    out_gen = cast_outputs_f32(self.predict(batch))
    if not compute_metrics:
      return {}, (batch, out_gen)
    out_fake = out_real = None
    with torch.no_grad(), full_f32(), halo.sharded_rows(self.mesh):
      if self.disc is not None:
        self.disc.eval()
        out_fake = cast_outputs_f32(self.disc(self.val_disc_input_fn(
            out_gen, is_real_input=False, detach=True)))
        out_real = cast_outputs_f32(self.disc(self.val_disc_input_fn(
            batch['target'], is_real_input=True, detach=True)))
      losses = {'gen_loss_' + name: crit(out_gen, batch)
                for name, crit in self.gen_criteria.items()}
    return _loss_metrics([losses], self.mesh), (batch, out_gen, out_fake,
                                                out_real)

  def predict(self, batch):
    """The generator's eval-mode output on a prepared batch, in full
    f32."""
    self.gen.eval()
    with torch.no_grad(), full_f32(), halo.sharded_rows(self.mesh):
      return self.gen(*self._gen_inputs(batch))

  def export_predict_parts(self):
    """(network, input keys) of ``predict``, for ``utils/export.py``."""
    return self.gen, self.gen_input_keys

  def get_named_outputs(self, data):
    """The base runner's names, and ``disc_fake`` (None without a
    discriminator pass)."""
    named = super().get_named_outputs(data)
    named['disc_fake'] = data[2] if len(data) > 2 else None
    return named

  # -- metrics ----------------------------------------------------------------

  @staticmethod
  def _metrics(data, gen_fns, disc_fns):
    if data is None:
      return {}
    batch, out_gen, out_fake, out_real = data
    metrics = {'gen_' + name: fn(out_gen, batch)
               for name, fn in gen_fns.items()}
    if out_fake is not None and out_real is not None:
      metrics.update(('disc_' + name, fn(out_fake['prob'], out_real['prob'],
                                         transform=False))
                     for name, fn in disc_fns.items())
    return metrics

  def _compute_train_metrics(self, data):
    if data is None or not (self.train_gen_metric_fns or
                            self.train_disc_metric_fns):
      return {}
    return self._metrics(self._gather(data), self.train_gen_metric_fns,
                         self.train_disc_metric_fns)

  def _gather(self, data):
    """The base runner's gather; under a spatial mesh the discriminator's
    outputs keep their whole head outputs only."""
    if self.mesh is not None and self.mesh.spatial > 1 and len(data) > 2:
      data = data[:2] + tuple(
          None if out is None else {k: out[k] for k in ('prob', 'logits')}
          for out in data[2:])
    return super()._gather(data)

  def _compute_test_metrics(self, data):
    return self._metrics(data, self.val_metric_fns, self.val_disc_metric_fns)

  # -- bookkeeping ------------------------------------------------------------

  def __str__(self):
    s = 'Generator:\n{}'.format(self.gen)
    if self.disc is not None:
      s += '\nDiscriminator:\n{}'.format(self.disc)
    return s

  def epoch_beginning(self, epoch):
    for name, scheduler, optimizer in (
        ('generator', self.gen_lr_scheduler, self.gen_optimizer),
        ('discriminator', self.disc_lr_scheduler, self.disc_optimizer)):
      if scheduler is not None:
        lr = scheduler(epoch - 1)
        logging.info('Epoch %d %s learning rate: %g', epoch, name, lr)
        set_learning_rate(optimizer, lr)
    if self.mode != 'train':
      return
    start, end = self.generator_pretraining_schedule
    self.discriminator_enabled = not start <= epoch < end
    if start == epoch:
      logging.info('Start pretraining generator in epoch %s', epoch)
    elif end == epoch:
      logging.info('Stop pretraining generator before epoch %s', epoch)
    start, end = self.discriminator_pretraining_schedule
    if start <= epoch < end:
      self.discriminator_enabled = True
      self.generator_enabled = False
    else:
      self.generator_enabled = True
    if start == epoch:
      logging.info('Start pretraining discriminator in epoch %s', epoch)
    elif end == epoch:
      logging.info('Stop pretraining discriminator before epoch %s', epoch)

  def state_dict(self):
    out = {'generator': self.gen.state_dict(), 'step': self.step}
    if self.gen_optimizer is not None:
      out['gen_optimizer'] = self.gen_optimizer.state_dict()
    if self.disc is not None:
      out['discriminator'] = self.disc.state_dict()
      out['disc_optimizer'] = self.disc_optimizer.state_dict()
    return out

  def load_state_dict(self, state_dict):
    """Restore from a runner state of either package (each network a port
    state dict or a flax tree)."""
    load_network_state(self.gen, state_dict['generator'])
    self.step = int(state_dict.get('step', 0))
    if 'gen_optimizer' in state_dict and self.gen_optimizer is not None:
      load_optimizer_state(self.gen_optimizer, self.gen,
                           state_dict['gen_optimizer'])
    if self.disc is not None:
      if 'discriminator' not in state_dict:
        raise ValueError('Incompatible checkpoint: no discriminator')
      load_network_state(self.disc, state_dict['discriminator'])
      if 'disc_optimizer' in state_dict:
        load_optimizer_state(self.disc_optimizer, self.disc,
                             state_dict['disc_optimizer'])
    logging.debug('Restored adversarial runner state')
