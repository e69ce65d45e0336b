"""PyTorch/CUDA port of the stencil DSL and the FV3-lite dynamical core.

The reference package ``repro`` (JAX + Pallas on a TPU) stays beside it;
this package imports neither it nor JAX.  Its entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
