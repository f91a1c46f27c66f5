"""CRIS in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``cris_tpu`` (JAX on a TPU), which stays in the repository as
the reference. Module names follow ``cris_tpu`` so that each counterpart
is easy to find. This package imports ``torch`` and never ``jax``,
``flax``, ``cv2``, ``yaml``, ``regex`` or ``PIL``, nor any ``cris_tpu``
module.
"""
