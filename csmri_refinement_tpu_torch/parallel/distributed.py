"""Multi-process initialization: one process per card.

Port of ``csmri_refinement_tpu/parallel/distributed.py``. Each process of a
data-parallel run calls :func:`initialize` once at start (the training CLI
does so before it builds its runner). It reads the same keys as the JAX
package, so a JAX config and a JAX launch run unchanged:

* the config's ``distributed`` section: ``coordinator_address``
  (``host:port``), ``num_processes``, ``process_id``;
* else the JAX cluster environment: ``JAX_COORDINATOR_ADDRESS``,
  ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``;
* else torchrun's: ``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``.

With none of them it is a no-op, as in JAX: no process group is started.
Otherwise it starts ``torch.distributed``'s default group over TCP at the
coordinator's address: NCCL when the run is on the card, gloo on the CPU.
On the card each process takes ``cuda:LOCAL_RANK`` (torchrun's), or
``cuda:(process_id mod the visible card count)`` without it. NCCL takes
one process per card, so a one-card machine runs a group of one; a group
the caller started already (two gloo ranks that share one card, say) is
accepted as it is.
"""

import logging
import os

import torch
import torch.distributed as dist


def _setting(section, key, env_key, fallback=None):
  if key in section:
    return section[key]
  value = os.environ.get(env_key)
  return fallback if value is None else value


def _torchrun_address():
  addr, port = os.environ.get('MASTER_ADDR'), os.environ.get('MASTER_PORT')
  return '{}:{}'.format(addr, port) if addr and port else None


def initialize(conf=None, device='cuda'):
  """Start the process group from the config or the environment; returns
  the device this process computes on (``device`` itself when the run is
  a single process)."""
  section = {}
  if conf is not None:
    section = conf.get_attr('distributed', default={}) or {}
  coordinator = _setting(section, 'coordinator_address',
                         'JAX_COORDINATOR_ADDRESS', _torchrun_address())
  num_processes = _setting(section, 'num_processes', 'JAX_NUM_PROCESSES',
                           os.environ.get('WORLD_SIZE'))
  process_id = _setting(section, 'process_id', 'JAX_PROCESS_ID',
                        os.environ.get('RANK'))
  device = torch.device(device)
  if coordinator is None and num_processes is None:
    logging.debug('Single-process run; no process group started')
    return device
  if coordinator is None:
    raise ValueError('distributed: num_processes is set but no coordinator '
                     'address (distributed.coordinator_address, '
                     'JAX_COORDINATOR_ADDRESS or torchrun\'s MASTER_ADDR and '
                     'MASTER_PORT)')
  world = int(num_processes if num_processes is not None else 1)
  if process_id is None and world > 1:
    raise ValueError('distributed: {} processes but no process id '
                     '(distributed.process_id, JAX_PROCESS_ID or RANK)'
                     .format(world))
  rank = int(process_id or 0)
  if not 0 <= rank < world:
    raise ValueError('distributed: process id {} is outside 0 to {}'.format(
        rank, world - 1))
  if device.type == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError('distributed: no CUDA device; pass the CPU device '
                         'to run a gloo group on the CPU')
    local = os.environ.get('LOCAL_RANK')
    index = int(local) if local is not None else \
        rank % torch.cuda.device_count()
    device = torch.device('cuda', index)
    torch.cuda.set_device(device)
  backend = 'nccl' if device.type == 'cuda' else 'gloo'
  if dist.is_initialized():
    if (dist.get_world_size(), dist.get_rank()) != (world, rank):
      raise RuntimeError('distributed: a process group of {} (rank {}) is '
                         'already running'.format(dist.get_world_size(),
                                                  dist.get_rank()))
    return device
  dist.init_process_group(backend, init_method='tcp://' + coordinator,
                          world_size=world, rank=rank)
  logging.info('torch.distributed initialized (%s): process %d of %d on %s',
               backend, rank, world, device)
  return device


def shutdown():
  """Destroy the default process group, where one was started."""
  if dist.is_available() and dist.is_initialized():
    dist.destroy_process_group()
