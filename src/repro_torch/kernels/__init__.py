"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``matmul``    — K1, the fused GEMM + epilogue (every projection).
* ``attention`` — K2, flash attention (prefill), plus decode attention
  as plain tensor code.

``build`` compiles ``csrc/*.cu`` with ``nvcc`` on first use.
"""
