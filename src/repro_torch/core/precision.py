"""Mixed-precision policies (paper §4.1: TF32 / BF16 / FP16 / INT8 / FP8).

The PE in CUTEv2 multiplies in the input format and accumulates after
aligning to a common exponent, i.e. a wide accumulator.  The port keeps
the same contract on the GPU: bf16/fp16/fp8 inputs accumulate in fp32,
int8 inputs accumulate in int32.  ``DataType`` mirrors the paper's
interface-register enum (Table 1), and ``PrecisionPolicy`` carries
everything a kernel or a layer needs to know.

TF32 note: the reference maps TF32 to fp32 data at XLA ``HIGHEST``
precision.  The port maps it to plain fp32 and keeps the GPU's TF32
tensor-core mode off (``allow_tf32``), which is the same arithmetic.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class DataType(str, enum.Enum):
    """Paper Table 1 ``DataType`` interface register."""

    INT8 = "int8"
    FP8_E4M3 = "fp8_e4m3"
    FP8_E5M2 = "fp8_e5m2"
    FP16 = "fp16"
    BF16 = "bf16"
    TF32 = "tf32"
    FP32 = "fp32"     # escape hatch for references / tests


_TORCH = {
    DataType.INT8: torch.int8,
    DataType.FP8_E4M3: torch.float8_e4m3fn,
    DataType.FP8_E5M2: torch.float8_e5m2,
    DataType.FP16: torch.float16,
    DataType.BF16: torch.bfloat16,
    DataType.TF32: torch.float32,   # see module docstring
    DataType.FP32: torch.float32,
}

_ACCUM = {
    DataType.INT8: torch.int32,
    DataType.FP8_E4M3: torch.float32,
    DataType.FP8_E5M2: torch.float32,
    DataType.FP16: torch.float32,
    DataType.BF16: torch.float32,
    DataType.TF32: torch.float32,
    DataType.FP32: torch.float32,
}

_BITS = {
    DataType.INT8: 8,
    DataType.FP8_E4M3: 8,
    DataType.FP8_E5M2: 8,
    DataType.FP16: 16,
    DataType.BF16: 16,
    DataType.TF32: 32,   # stored as fp32
    DataType.FP32: 32,
}


def disable_tf32() -> None:
    """Keep fp32 matmuls and convolutions in full fp32 on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Input/accumulate/output dtypes for one matmul."""

    data_type: DataType
    out_dtype: object = None          # default: accum dtype

    @property
    def in_dtype(self) -> torch.dtype:
        return _TORCH[self.data_type]

    @property
    def accum_dtype(self) -> torch.dtype:
        return _ACCUM[self.data_type]

    @property
    def bits(self) -> int:
        return _BITS[self.data_type]

    @property
    def bytes_per_elem(self) -> float:
        return self.bits / 8

    @property
    def output_dtype(self) -> torch.dtype:
        return self.out_dtype if self.out_dtype is not None else self.accum_dtype

    def preferred_element_type(self) -> torch.dtype:
        return self.accum_dtype


def policy(dt: "DataType | str", out_dtype=None) -> PrecisionPolicy:
    if isinstance(dt, str):
        dt = DataType(dt)
    return PrecisionPolicy(dt, out_dtype)


BF16 = policy(DataType.BF16)
INT8 = policy(DataType.INT8)
FP8 = policy(DataType.FP8_E4M3)
FP16 = policy(DataType.FP16)
TF32 = policy(DataType.TF32)
FP32 = policy(DataType.FP32)
