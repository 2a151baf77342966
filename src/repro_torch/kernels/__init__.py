"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``matmul``    — K1, the fused GEMM + epilogue (every projection).
* ``attention`` — K2, flash attention (prefill), plus decode attention
  as plain tensor code.
* ``quant``     — K3, per-row int8 quantisation (the W8A8 prologue).
* ``moe``       — K4, the grouped per-expert GEMM (every expert MLP).

``build`` compiles ``csrc/*.cu`` with ``nvcc`` on first use.
"""
