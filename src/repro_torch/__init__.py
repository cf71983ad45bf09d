"""PyTorch/CUDA port of the distributed GAN training protocol.

Mirrors the JAX package `repro` module for module (`repro_torch/core/
protocol.py` is the port of `repro/core/protocol.py`) and imports none of
it. Parameters keep the JAX package's layout (HWIO convolution weights,
NHWC activations, the same nested dict/list trees), so `interop` carries
weights across unchanged. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; Algorithm 2 on a CUDA tensor runs through
the hand-written kernel in `kernels/wavg`.
"""
