"""Analyze 7.5 (.hdr/.img) volumes: reader and writer.

The reader is a copy (pure ``struct`` and numpy, so the port imports
nothing of the JAX package) of ``csmri_refinement_tpu/data/analyze_io.py``:
the header's first field (348) gives the byte order, ``dim`` the shape,
``datatype`` the element type, the SPM scale at offset 112 multiplies the
data unless it is 0 or 1; the data is in Fortran order and comes back
squeezed, as ``np.squeeze(nibabel.load(p).get_data())`` gives it.

``save_analyze`` writes the same fields, which is all a ScarSeg-format
tree needs (``data/datasets.py::write_scarseg_phantoms``).
"""

import os
import struct

import numpy as np

HEADER_SIZE = 348

# Analyze 7.5 datatype codes → numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    132: np.int16,  # DT_SIGNED_SHORT variants seen in the wild
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4,
          np.dtype(np.int32): 8, np.dtype(np.float32): 16,
          np.dtype(np.float64): 64, np.dtype(np.int8): 256,
          np.dtype(np.uint16): 512, np.dtype(np.uint32): 768}


def _paths(path):
  base = os.path.splitext(path)[0]
  return base + '.hdr', base + '.img'


def load_analyze(path):
  """The volume of an Analyze pair, given its .img or .hdr path, shaped
  (dim1, ..., dimN) and squeezed of singleton dims."""
  hdr_path, img_path = _paths(path)
  if not os.path.exists(hdr_path):
    raise FileNotFoundError(hdr_path)
  with open(hdr_path, 'rb') as f:
    header = f.read(HEADER_SIZE)

  sizeof_hdr = struct.unpack('<i', header[0:4])[0]
  endian = '<' if sizeof_hdr == HEADER_SIZE else '>'
  dims = struct.unpack(endian + '8h', header[40:56])
  shape = tuple(dims[1:1 + dims[0]])
  datatype = struct.unpack(endian + 'h', header[70:72])[0]
  if datatype not in _DTYPES:
    raise ValueError('Unsupported Analyze datatype {}'.format(datatype))
  dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
  scale = struct.unpack(endian + 'f', header[112:116])[0]

  with open(img_path, 'rb') as f:
    data = np.frombuffer(f.read(), dtype=dtype)
  data = data[:int(np.prod(shape))].reshape(shape, order='F')
  if scale not in (0.0, 1.0) and np.isfinite(scale):
    data = data * scale
  return np.squeeze(np.asarray(data))


def save_analyze(path, volume, scale=0.0, big_endian=False):
  """Write ``volume`` (up to 7 dims, a dtype of the datatype table) as an
  Analyze pair at ``path`` (.img or .hdr), Fortran order."""
  volume = np.asarray(volume)
  if volume.dtype not in _CODES or not 1 <= volume.ndim <= 7:
    raise ValueError('Cannot write a {} volume of {} dims'.format(
        volume.dtype, volume.ndim))
  endian = '>' if big_endian else '<'
  header = bytearray(HEADER_SIZE)
  struct.pack_into(endian + 'i', header, 0, HEADER_SIZE)
  dims = (volume.ndim,) + volume.shape + (0,) * (7 - volume.ndim)
  struct.pack_into(endian + '8h', header, 40, *dims)
  struct.pack_into(endian + 'h', header, 70, _CODES[volume.dtype])
  struct.pack_into(endian + 'h', header, 72, 8 * volume.dtype.itemsize)
  struct.pack_into(endian + 'f', header, 112, scale)
  hdr_path, img_path = _paths(path)
  with open(hdr_path, 'wb') as f:
    f.write(header)
  with open(img_path, 'wb') as f:
    f.write(volume.astype(volume.dtype.newbyteorder(endian)).tobytes(
        order='F'))
