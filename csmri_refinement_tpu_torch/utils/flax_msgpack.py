"""A msgpack decoder for the JAX package's checkpoint files.

The JAX package writes its checkpoints with
``flax.serialization.msgpack_serialize``; ``msgpack_restore`` below reads
them back as that package's ``flax.serialization.msgpack_restore`` does,
in pure Python (no flax and no ``msgpack`` package):

* maps come back as dicts (flax keys are ``str``; a list or tuple was
  saved as a dict with keys ``'0'``, ``'1'``, ...), arrays as lists, str as
  ``str``, bin as ``bytes``, ints as Python ints, floats as Python floats,
  nil and bool as ``None``, ``True``, ``False``;
* flax's ext types: 1, an ndarray, a nested msgpack of ``(shape, dtype
  name, C-order bytes)``; 2, a native complex ``(real, imag)``; 3, a numpy
  scalar (an ndarray of shape ``()``, returned as the numpy scalar);
* dicts marked ``__msgpack_chunked_array__`` (arrays above flax's
  ``MAX_CHUNK_SIZE`` bytes, saved flattened in chunks) are reassembled.

Arrays are numpy and writable. ``bfloat16``, which numpy does not have,
comes back as a ``torch.bfloat16`` tensor. Any other ext type, a truncated
buffer or trailing bytes raise ``ValueError``.
"""

import struct

import numpy as np
import torch

_CHUNKED = '__msgpack_chunked_array__'


class _Reader:

  def __init__(self, data):
    self.data = memoryview(data)
    self.pos = 0

  def take(self, n):
    end = self.pos + n
    if end > len(self.data):
      raise ValueError('msgpack data ends early at byte {}'.format(self.pos))
    out = self.data[self.pos:end]
    self.pos = end
    return out

  def unpack(self, fmt):
    return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

  def value(self):
    code = self.unpack('>B')
    if code <= 0x7f:
      return code
    if code >= 0xe0:
      return code - 0x100
    if 0x80 <= code <= 0x8f:
      return self.map(code & 0x0f)
    if 0x90 <= code <= 0x9f:
      return [self.value() for _ in range(code & 0x0f)]
    if 0xa0 <= code <= 0xbf:
      return str(self.take(code & 0x1f), 'utf-8')
    if code in _FIXED:
      return _FIXED[code](self)
    raise ValueError('msgpack type byte 0x{:02x} is not valid'.format(code))

  def map(self, n):
    out = {}
    for _ in range(n):
      key = self.value()
      out[key] = self.value()
    return out

  def ext(self, n):
    kind = self.unpack('>b')
    return _ext(kind, bytes(self.take(n)))


def _length(fmt, read):
  return lambda r: read(r, r.unpack(fmt))


_FIXED = {
    0xc0: lambda r: None,
    0xc2: lambda r: False,
    0xc3: lambda r: True,
    0xc4: _length('>B', lambda r, n: bytes(r.take(n))),
    0xc5: _length('>H', lambda r, n: bytes(r.take(n))),
    0xc6: _length('>I', lambda r, n: bytes(r.take(n))),
    0xc7: _length('>B', _Reader.ext),
    0xc8: _length('>H', _Reader.ext),
    0xc9: _length('>I', _Reader.ext),
    0xca: lambda r: r.unpack('>f'),
    0xcb: lambda r: r.unpack('>d'),
    0xcc: lambda r: r.unpack('>B'),
    0xcd: lambda r: r.unpack('>H'),
    0xce: lambda r: r.unpack('>I'),
    0xcf: lambda r: r.unpack('>Q'),
    0xd0: lambda r: r.unpack('>b'),
    0xd1: lambda r: r.unpack('>h'),
    0xd2: lambda r: r.unpack('>i'),
    0xd3: lambda r: r.unpack('>q'),
    0xd4: lambda r: r.ext(1),
    0xd5: lambda r: r.ext(2),
    0xd6: lambda r: r.ext(4),
    0xd7: lambda r: r.ext(8),
    0xd8: lambda r: r.ext(16),
    0xd9: _length('>B', lambda r, n: str(r.take(n), 'utf-8')),
    0xda: _length('>H', lambda r, n: str(r.take(n), 'utf-8')),
    0xdb: _length('>I', lambda r, n: str(r.take(n), 'utf-8')),
    0xdc: _length('>H', lambda r, n: [r.value() for _ in range(n)]),
    0xdd: _length('>I', lambda r, n: [r.value() for _ in range(n)]),
    0xde: _length('>H', _Reader.map),
    0xdf: _length('>I', _Reader.map),
}


def _unpackb(data):
  reader = _Reader(data)
  out = reader.value()
  if reader.pos != len(reader.data):
    raise ValueError('{} bytes after the msgpack object'.format(
        len(reader.data) - reader.pos))
  return out


def _ndarray(payload):
  shape, dtype_name, buffer = _unpackb(payload)
  if isinstance(dtype_name, bytes):
    dtype_name = dtype_name.decode()
  if dtype_name == 'bfloat16':
    bits = np.frombuffer(buffer, np.int16).copy().reshape(shape)
    return torch.from_numpy(bits).view(torch.bfloat16)
  return np.frombuffer(buffer, np.dtype(dtype_name)).copy().reshape(shape)


def _ext(kind, payload):
  if kind == 1:
    return _ndarray(payload)
  if kind == 2:
    real, imag = _unpackb(payload)
    return complex(real, imag)
  if kind == 3:
    array = _ndarray(payload)
    return array if isinstance(array, torch.Tensor) else array[()]
  raise ValueError('msgpack ext type {} is not a flax type'.format(kind))


def _unchunk(tree):
  shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
  chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
  if isinstance(chunks[0], torch.Tensor):
    return torch.cat(chunks).reshape(shape)
  return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
  if not isinstance(tree, dict):
    return tree
  if _CHUNKED in tree:
    return _unchunk(tree)
  return {key: _unchunk_leaves(value) for key, value in tree.items()}


def msgpack_restore(data):
  """The tree ``flax.serialization.msgpack_serialize`` encoded in
  ``data`` (bytes)."""
  return _unchunk_leaves(_unpackb(data))
