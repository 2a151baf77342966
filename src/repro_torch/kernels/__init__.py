"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``matmul``    — K1, the fused GEMM + epilogue (every projection).
* ``attention`` — K2, flash attention (prefill), plus decode attention
  as plain tensor code.
* ``quant``     — K3, per-row int8 quantisation (the W8A8 prologue).
* ``moe``       — K4, the grouped per-expert GEMM (every expert MLP).
* ``rglru``     — K5, the RG-LRU scan (RecurrentGemma's recurrent blocks),
  plus its one-token decode step as plain tensor code.
* ``rwkv6``     — K6, the chunked RWKV-6 WKV (every time-mix block), plus
  the per-token oracle that also serves as the decode step.

``build`` compiles ``csrc/*.cu`` with ``nvcc`` on first use.
"""
