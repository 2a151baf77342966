"""CUTEv2 reproduction, ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``repro_torch.core.fusion`` <-> ``repro.core.fusion``, ...) and
never imports it or JAX.  Each Pallas kernel on the ported path is a
hand-written CUDA kernel under ``kernels/csrc``, built with ``nvcc`` on
first use, with a plain PyTorch version beside it.
"""
