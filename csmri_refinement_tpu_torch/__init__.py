"""PyTorch + CUDA port of ``csmri_refinement_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference each module here is held
against. Module names mirror it (``ops/fft.py`` ↔ ``ops/fft.py`` and so on);
the TPU kernels on the flagship serving path and on RecNet training are
rewritten by hand in CUDA C++ under ``csrc/``:

* ``ops/dc_kernel.py`` + ``csrc/dc.cu`` — the fused k-space data
  consistency (JAX ``ops/dc_pallas.py``) and, in its no-k0 mode, its
  backward (the JAX custom VJP ``ops/dc.py:99-111``), joined in the
  autograd Function ``_DCFunction``;
* ``ops/conv_chain.py`` + ``csrc/conv_chain.cu`` — the SAME-conv chain with
  folded BN (JAX ``ops/conv_pallas.py``, float mode).

Entry points: ``build_flagship`` (serving forward) and the CLIs
``python -m csmri_refinement_tpu_torch.train`` (the standard and
adversarial runners), ``.validate`` (metrics, PNGs or ``.mat`` records of
a checkpoint of either package) and ``.eval_results`` (per-slice tables of
those records).
Public functions keep the JAX layout: NHWC, packed complex as a trailing dim
of 2, masks ``(B, H, W, 1)`` float. Entry points run on the card unless the
caller asks for the CPU; a CPU tensor takes each kernel's plain PyTorch
version, a CUDA tensor takes the kernel or raises.

This package never imports ``jax``, ``flax`` or ``csmri_refinement_tpu``.
"""

__all__ = ['build_flagship']


def __getattr__(name):
  # Imported on first use, so that loading a serving artifact
  # (``utils/export.py``) imports the kernels' op registrations only.
  if name == 'build_flagship':
    from csmri_refinement_tpu_torch.flagship import build_flagship
    return build_flagship
  raise AttributeError('module {!r} has no attribute {!r}'.format(__name__,
                                                                  name))
