"""Serving export: the inference network frozen into one file.

Port of ``csmri_refinement_tpu/utils/export.py``. The deployment funnel's
last step: the restored inference network (weights and forward graph) is
written to ONE file that replays without the port's model code, on the
CPU or on the card.

* ``export_predict`` runs ``torch.export.export`` (non-strict) of the
  runner's eval forward (``Runner.predict``, ``AdversarialRunner.predict``)
  at the static shapes of a prepared batch, under ``torch.no_grad()``, with
  the weights in the program. The hand-written kernels are in the graph as
  the custom ops ``csmri::dc``, ``csmri::conv_f32``, ``csmri::conv_bf16``,
  ``csmri::conv_int8`` and ``csmri::requant`` (``ops/dc_kernel.py``,
  ``ops/conv_chain.py``): on the card the replay launches the kernels, on
  the CPU their plain versions.
* Shapes are static, one artifact per (batch, resolution) serving point,
  as in JAX.
* Precision: the replay runs in full f32 (TF32 off, ``utils/precision.py``),
  as ``predict`` does; the cuDNN convolutions follow a process-wide flag the
  graph does not hold, so the header records it and ``load_callable`` sets
  it (JAX pins ``default_matmul_precision('high')`` inside its exported
  function for the same reason).
* Loading imports the kernels' op registrations, not the model code.

Artifact container (one file), JAX's layout with its own magic::

    magic     b"CSMRI-PT2-1\\n"
    4 bytes   big-endian header length
    header    UTF-8 JSON: input keys, shapes, dtypes, platforms, precision,
              torch version, payload length, metadata
    payload   torch.export.save of the ExportedProgram

A JAX artifact (``b"CSMRI-SHLO-1\\n"``) holds StableHLO, which the port
does not replay: ``load_artifact`` refuses it with a message.
"""

import io
import json
import struct

import torch

MAGIC = b'CSMRI-PT2-1\n'
JAX_MAGIC = b'CSMRI-SHLO-1\n'
PLATFORMS = ('cpu', 'cuda')
PRECISION = 'full_f32'


class _Predict(torch.nn.Module):
  """The eval forward on positional inputs (the runner's input keys)."""

  def __init__(self, net):
    super().__init__()
    self.net = net

  def forward(self, *inputs):
    return self.net(*inputs)


def export_predict(runner, host_batch, platforms=PLATFORMS):
  """Freeze ``runner``'s inference network at ``host_batch``'s shapes.

  ``host_batch`` is a raw loader batch; the runner's preparer builds the
  model's input batch from it, which fixes the artifact's inputs to the
  model's input keys (data preparation stays in the pipeline). Returns
  ``(torch.export.ExportedProgram, header dict)``.
  """
  unknown = set(platforms) - set(PLATFORMS)
  if unknown:
    raise ValueError('platforms {} are not among {}'.format(
        sorted(unknown), list(PLATFORMS)))
  from csmri_refinement_tpu_torch.utils.precision import full_f32
  batch = runner.preparer.prepare_val(host_batch)
  net, input_keys = runner.export_predict_parts()
  feed = tuple(batch[k] for k in input_keys)
  net.eval()
  with torch.no_grad(), full_f32():
    exported = torch.export.export(_Predict(net), feed, strict=False)
  # The example batch is no part of the artifact (at 512², B = 20 it is
  # ~100 MB against the network's few).
  exported.example_inputs = None
  header = {
      'format': 1,
      'platforms': list(platforms),
      'input_keys': list(input_keys),
      'input_shapes': {k: list(v.shape) for k, v in zip(input_keys, feed)},
      'input_dtypes': {k: str(v.dtype).replace('torch.', '')
                       for k, v in zip(input_keys, feed)},
      'device': str(feed[0].device),
      'precision': PRECISION,
      'torch_version': torch.__version__,
  }
  return exported, header


def save_artifact(path, exported, header, extra_meta=None):
  """Write the one-file artifact container (see the module docstring)."""
  header = dict(header)
  if extra_meta:
    header['meta'] = extra_meta
  buffer = io.BytesIO()
  torch.export.save(exported, buffer)
  payload = buffer.getvalue()
  header['payload_bytes'] = len(payload)
  blob = json.dumps(header, sort_keys=True).encode('utf-8')
  with open(path, 'wb') as f:
    f.write(MAGIC)
    f.write(struct.pack('>I', len(blob)))
    f.write(blob)
    f.write(payload)


def load_artifact(path):
  """Read an artifact container → ``(ExportedProgram, header dict)``."""
  # The graph's csmri::* nodes need the ops registered before loading.
  from csmri_refinement_tpu_torch.ops import conv_chain, dc_kernel  # noqa
  with open(path, 'rb') as f:
    head = f.read(len(JAX_MAGIC))
    if head == JAX_MAGIC:
      raise ValueError('{}: a JAX StableHLO artifact; replay it with the JAX '
                       'package (csmri_refinement_tpu/utils/export.py)'
                       .format(path))
    if head[:len(MAGIC)] != MAGIC:
      raise ValueError('{}: not a csmri serving artifact (bad magic '
                       '{!r})'.format(path, head[:len(MAGIC)]))
    f.seek(len(MAGIC))
    (hlen,) = struct.unpack('>I', f.read(4))
    header = json.loads(f.read(hlen).decode('utf-8'))
    payload = f.read()
  if header.get('payload_bytes') not in (None, len(payload)):
    raise ValueError('{}: truncated artifact ({} payload bytes, header '
                     'says {})'.format(path, len(payload),
                                       header['payload_bytes']))
  return torch.export.load(io.BytesIO(payload)), header


def load_callable(path, device='cuda'):
  """Load an artifact as ``fn(batch dict) -> model outputs`` on ``device``
  (the program and its weights moved there), replayed under the header's
  precision. Extra batch keys are ignored; a missing input key raises
  KeyError."""
  from torch.export.passes import move_to_device_pass
  from csmri_refinement_tpu_torch.utils.precision import full_f32
  exported, header = load_artifact(path)
  device = torch.device(device)
  if header.get('device') != str(device):
    exported = move_to_device_pass(exported, device)
  module = exported.module()
  keys = header['input_keys']
  if header.get('precision') != PRECISION:
    raise ValueError('{}: unknown precision {!r}'.format(
        path, header.get('precision')))

  def call(batch):
    with torch.no_grad(), full_f32():
      return module(*(torch.as_tensor(batch[k]).to(device) for k in keys))

  return call, header


def _leaves(tree):
  if isinstance(tree, dict):
    return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
  if isinstance(tree, (list, tuple)):
    return [leaf for v in tree for leaf in _leaves(v)]
  return [tree]


def verify_artifact(path, runner, host_batch):
  """Replay the artifact against ``runner.predict`` on one batch, on the
  runner's device; returns the max abs difference over all outputs."""
  call, _ = load_callable(path, runner.device)
  batch = runner.preparer.prepare_val(host_batch)
  want, got = _leaves(runner.predict(batch)), _leaves(call(batch))
  if len(want) != len(got):
    raise ValueError('the artifact returns {} outputs, predict {}'.format(
        len(got), len(want)))
  return max(float((w.float() - g.float()).abs().max())
             for w, g in zip(want, got))
