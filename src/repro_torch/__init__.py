"""Federated Forest (arXiv:1905.10053) on PyTorch and CUDA.

A port of the JAX package ``repro`` to an NVIDIA H100: the same modules,
with the party axis as an explicit tensor dimension and the TPU's Pallas
histogram kernel rewritten by hand in CUDA C++ for Hopper
(kernels/csrc/histogram.cu).  Entry points run on the card unless the
caller passes ``device="cpu"``.  Imports neither JAX nor the JAX package.
"""
