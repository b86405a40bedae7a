"""BaseRunner: the epoch loop over a runner's train and validation steps.

Port of ``csmri_refinement_tpu/training/base_runner.py``: the epoch loop,
metric accumulation, the validation loop (which returns its first
``num_batches_to_return`` batches, moved to the host) and the inference
loop (every batch, no losses or metrics) are the same; a subclass supplies
the steps. With ``steps_per_fetch`` = k a runner's step runs k updates
and fetches their mean losses once (``mean_losses``), on up to k batches
of one size that ``_collect_stackable_batches`` takes from the loader (JAX
``:45-70``: a batch of another size is held back for the next step, never
dropped); such a step returns no data, so it has no train metrics. With a
summary writer
``train_epoch`` adds each summarised step's losses and metrics as
``train/<name>`` scalars at the JAX package's global step, ``n · (epoch −
1) + batch`` for n batches per epoch; they are the values the step already
fetched for its log line.

Data parallelism (``parallel/``): a runner of mode ``'train'`` takes the
run's mesh (``mesh_from_conf``: a process group started by
``parallel.distributed.initialize``, or a ``mesh`` section). Each process
then trains on its rows of every global batch: the runner averages the
gradients over the group before each optimizer step (``average_gradients``:
one flat all-reduce, not ``DistributedDataParallel``, which refuses the
GAN step's discriminator called on fakes and reals before one backward),
averages the fetched losses (``mean_losses``), gathers the train and
validation data before the metrics (``gather_to_replicated``), so that
every rank logs and checks the global batch's numbers, and its BatchNorm
layers take the global batch's statistics. Every loss of the port is a mean
over equally many rows per rank, so the mean of the ranks' losses (and of
their gradients) is the global batch's.

A spatial mesh (``{"data": D, "spatial": S}``) shards each image's rows
over the S ranks of a spatial group as well: the preparer cuts its batch
to the rank's rows, the steps run inside ``parallel/halo.py::sharded_rows``
(the layers' halos, the DC's row gathers), and the metrics' data gathers
the rows, then the batch (``_gather``). The loss of a rank is then S times
its share (a mean over its rows, a feature map's weighted by the rank's
part of its rows where a stride split them, or a value every rank of the
group holds whole), so the same world averages give the global batch's
losses and gradients (``parallel/mesh.py``). The first batch whose image
rows do not divide by S raises, as JAX's ``shard_batch`` does.
"""

import logging
from itertools import chain

import torch

from csmri_refinement_tpu_torch.data.transform_wrappers import (
    get_input_batch_transform, get_output_transform)
from csmri_refinement_tpu_torch.metrics import accumulate_metric
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib


def _map(fn, tree):
  if isinstance(tree, dict):
    return {k: _map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, v) for v in tree)
  return fn(tree) if isinstance(tree, torch.Tensor) else tree


def cast_outputs_f32(tree):
  """Float tensors of a network's output as float32: the loss boundary of
  mixed-precision training (``train_dtype``), so that every criterion
  reduces in f32 (JAX ``:27-40``). A no-op for f32 outputs."""
  return _map(lambda t: t.float() if t.is_floating_point() else t, tree)


def detach(tree):
  return _map(torch.Tensor.detach, tree)


def to_host(tree):
  """``tree`` with every tensor moved to the CPU, bf16 as f32 (numpy has
  no bf16)."""
  return _map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t).cpu(),
              tree)


def mean_losses(updates, mesh=None):
  """{name: float} of a list of updates' loss dicts (the same names in
  each), each loss's mean over the updates and the mesh's ranks, in one
  host fetch."""
  if not updates or not updates[0]:
    return {}
  names = list(updates[0])
  values = torch.stack([torch.stack([u[n].float() for n in names])
                        for u in updates])
  mesh_lib.average_([values], mesh)
  return dict(zip(names, values.mean(0).tolist()))


class BaseRunner:

  def __init__(self, conf, mode):
    self.conf = conf
    self.mode = mode
    self.epoch = 0
    application = conf.get_attr('application', default='reconstruction')
    self.output_transform = get_output_transform(application)
    get_input_batch_transform(conf, application, 'test')
    self._pending_host_batch = None
    self.mesh = None

  def _setup_mesh(self, preparer, *models):
    """Take the run's mesh in mode 'train', and in mode 'test' under a
    process group (the validate CLI under torchrun): the models' states
    broadcast from rank 0, their BatchNorm statistics over the group, the
    preparer's draws and rows sharded. A single process in mode 'test'
    evaluates whole images."""
    if self.mode != 'train' and not mesh_lib.multiprocess():
      if (self.conf.get_attr('mesh', default=None) or {}).get(
          mesh_lib.SPATIAL_AXIS, 1) not in (1, None):
        logging.warning('mesh: one process evaluates whole images; start '
                        'the processes of the spatial axis to shard rows')
      return
    self.mesh = mesh_lib.mesh_from_conf(self.conf, self.device)
    if self.mesh is None:
      return
    for model in models:
      mesh_lib.replicate(model, self.mesh)
      mesh_lib.sync_batchnorm(model, self.mesh)
    preparer.shard = self.mesh.shard
    preparer.mesh = self.mesh

  def _gather(self, data):
    """A step's data for the metrics: the global batch's whole images."""
    return mesh_lib.gather_to_replicated(data, self.mesh)

  def _train_dtype(self, section):
    """A model section with the run's ``train_dtype`` as its ``dtype``, in
    mode 'train' and where the section names no ``dtype`` of its own (JAX
    ``runner.py:54-61``, ``adversarial_runner.py:85-90``)."""
    if self.mode == 'train' and self.conf.get_attr('train_dtype') and \
        'dtype' not in section:
      section['dtype'] = self.conf.train_dtype
    return section

  def _collect_stackable_batches(self, batch_iter, k):
    """Up to k host batches of one size: the held-back batch first, then
    the loader's; a batch of another size ends the list and is held back
    for the next call."""

    def size(host_batch):
      return len(next(iter(host_batch.values())))

    host_batches = []
    while len(host_batches) < k:
      host_batch, self._pending_host_batch = self._pending_host_batch, None
      if host_batch is None:
        host_batch = next(batch_iter, None)
      if host_batch is None:
        break
      if host_batches and size(host_batch) != size(host_batches[0]):
        self._pending_host_batch = host_batch
        break
      host_batches.append(host_batch)
    return host_batches

  # -- subclass hooks ---------------------------------------------------------

  def _train_step(self, batch_iter):
    """Consume a batch from ``batch_iter`` and update; returns
    (num_batches_consumed, loss_metrics, data for _compute_train_metrics)."""
    raise NotImplementedError

  def _val_step(self, batch, compute_metrics=True):
    """Returns (loss metrics, or {} without ``compute_metrics``; data for
    _compute_test_metrics and get_named_outputs)."""
    raise NotImplementedError

  def _compute_train_metrics(self, data):
    raise NotImplementedError

  def _compute_test_metrics(self, data):
    raise NotImplementedError

  def epoch_beginning(self, epoch):
    pass

  def epoch_finished(self, epoch):
    pass

  # -- engine -----------------------------------------------------------------

  def train_epoch(self, loader, epoch, summary_writer=None,
                  steps_per_train_summary=1, verbose=False):
    self.epoch = epoch
    num_batches_per_epoch = len(loader)
    epoch_loss_metrics = {}
    epoch_metrics = {}

    current_batch = 0
    batch_iter = iter(loader)
    while current_batch < num_batches_per_epoch:
      num_batches, loss_metrics, data = self._train_step(batch_iter)
      if num_batches == 0:
        break
      current_batch += num_batches
      metrics = self._compute_train_metrics(data)
      del data

      for name, loss_metric in loss_metrics.items():
        accumulate_metric(epoch_loss_metrics, name, loss_metric)
      for name, metric in metrics.items():
        accumulate_metric(epoch_metrics, name, metric)

      if current_batch % steps_per_train_summary == 0:
        s = '===> Epoch[{}]({}/{}): '.format(epoch, current_batch,
                                             num_batches_per_epoch)
        s += ', '.join('{}: {}'.format(name, metric)
                       for name, metric in loss_metrics.items())
        if verbose:
          s += '\n' + '\n'.join('     {}: {}'.format(name, metric)
                                for name, metric in metrics.items())
        logging.info(s)
        if summary_writer is not None:
          global_step = num_batches_per_epoch * (epoch - 1) + current_batch
          for name, metric in chain(loss_metrics.items(), metrics.items()):
            summary_writer.add_scalar('train/{}'.format(name), metric.value,
                                      global_step)

    value_by_loss = {name: m.average()
                     for name, m in epoch_loss_metrics.items()}
    value_by_metric = {name: m.average() for name, m in epoch_metrics.items()}
    return value_by_loss, value_by_metric

  def validate(self, loader, num_batches_to_return=0):
    """Returns (the first ``num_batches_to_return`` batches' data on the
    host, {loss name: metric}, {metric name: metric}) averaged over the
    loader."""
    epoch_data = []
    epoch_loss_metrics = {}
    epoch_metrics = {}
    for batch in loader:
      loss_metrics, data = self._val_step(batch)
      data = self._gather(data)
      if len(epoch_data) < num_batches_to_return:
        epoch_data.append(to_host(data))
      metrics = self._compute_test_metrics(data)
      del data
      for name, loss_metric in loss_metrics.items():
        accumulate_metric(epoch_loss_metrics, name, loss_metric)
      for name, metric in metrics.items():
        accumulate_metric(epoch_metrics, name, metric)

    value_by_loss = {name: m.average()
                     for name, m in epoch_loss_metrics.items()}
    value_by_metric = {name: m.average() for name, m in epoch_metrics.items()}
    return epoch_data, value_by_loss, value_by_metric

  def get_named_outputs(self, data):
    """{'input', 'prediction', 'target'} of a validation step's data
    (batch, model output, ...), the prediction and target through the
    application's output transform."""
    batch, out = data[0], data[1]
    prediction = out['pred'] if isinstance(out, dict) else out
    target = batch['target']
    if self.output_transform is not None:
      prediction, target = self.output_transform(prediction, target)
    return {'input': batch['inp'], 'prediction': prediction,
            'target': target}

  def infer(self, loader):
    """Every batch's data on the host, without losses or metrics."""
    return [to_host(self._gather(self._val_step(batch,
                                                compute_metrics=False)[1]))
            for batch in loader]

  @staticmethod
  def _loss_weights(weights_by_criterion, *criteria_dicts):
    """Per-criterion weight dict, default 1.0."""
    weights = {}
    for criteria in criteria_dicts:
      for name in criteria:
        weights[name] = float(weights_by_criterion.get(name, 1.0))
    return weights
