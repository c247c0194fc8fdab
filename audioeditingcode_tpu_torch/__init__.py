"""PyTorch/CUDA port of the zero-shot audio-editing system.

A package beside ``audioeditingcode_tpu`` (the JAX reference), mirroring
its module names; it imports torch, numpy and scipy, never JAX or the JAX
package. Its CUDA kernels live in ``csrc/`` and build at first use.
"""
