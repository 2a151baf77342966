"""CUTEv2 core, ported to PyTorch.

Public surface:
  * ``MatrixUnitConfig`` / presets — paper Table 2 + Eq. 1.
  * ``MatMulTask`` / ``BiasType`` — paper Table 1 interface registers.
  * ``AsyncMatmulEngine`` / ``pipelined_fused_matmul`` — asyncMatMul /
    checkMatmul programming model (Listing 1), asynchronous on CUDA.
  * ``cute_matmul`` / ``linear`` / ``Epilogue`` — the unified fused-matmul
    API every model routes through.
"""

from repro_torch.core.config import (CASE_STUDY, PLATFORM_2TOPS,
                                     MatrixUnitConfig)
from repro_torch.core.engine import (AsyncMatmulEngine, Handle,
                                     pipelined_fused_matmul)
from repro_torch.core.fusion import (ACTIVATIONS, NO_EPILOGUE, NO_OPERANDS,
                                     Epilogue, EpilogueOperands,
                                     apply_epilogue, cute_matmul, linear)
from repro_torch.core.precision import (BF16, FP8, FP16, FP32, INT8, TF32,
                                        DataType, PrecisionPolicy, policy)
from repro_torch.core.task import BiasType, MatMulTask, Status, tile_tasks

__all__ = [
    "CASE_STUDY", "PLATFORM_2TOPS", "MatrixUnitConfig", "AsyncMatmulEngine",
    "Handle", "pipelined_fused_matmul", "ACTIVATIONS", "Epilogue",
    "EpilogueOperands", "NO_EPILOGUE", "NO_OPERANDS", "apply_epilogue",
    "cute_matmul", "linear", "BF16", "DataType", "FP8", "FP16", "FP32",
    "INT8", "PrecisionPolicy", "TF32", "policy", "BiasType", "MatMulTask",
    "Status", "tile_tasks",
]
