"""Float32 precision control on the card.

PyTorch runs f32 cuDNN convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``); TF32 keeps about three decimal
digits. ``full_f32`` turns TF32 off for convolutions and matmuls inside a
block and restores the caller's settings after it: the counterpart of the
JAX package's ``jax.default_matmul_precision('high')`` around evaluation.
On CPU tensors it changes nothing.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
