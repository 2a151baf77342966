"""The asynchronous matmul task descriptor — paper Table 1, verbatim.

The entire ISA surface of CUTEv2 is: write these interface registers,
fire ``asyncMatMul``, poll ``Status`` with ``checkMatmul``.  We keep the
exact field set so the RTL-world simulator, the XLA backend and the
Pallas backend all speak one vocabulary.  Base addresses and strides are
symbolic in the JAX world (arrays are values, not pointers) but are kept
because the simulator's memory-loader model and the reproduction
benchmarks consume them (stride patterns drive DRAM efficiency, §5.4).
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.precision import DataType, policy


class BiasType(str, enum.Enum):
    """Paper Table 1: Zero, Row-Repeat, Full."""

    ZERO = "zero"
    ROW = "row"      # (N,) broadcast over rows — "Row-Repeat"
    FULL = "full"    # (M, N)


class Status(enum.IntEnum):
    IDLE = 0
    RUNNING = 1
    DONE = 2


@dataclasses.dataclass
class MatMulTask:
    """One asyncMatMul: C[M,N] (+)= A[M,K] @ B[K,N] + bias."""

    m: int
    n: int
    k: int
    data_type: DataType = DataType.INT8
    bias_type: BiasType = BiasType.ZERO
    transpose: bool = False          # result transpose flag
    accumulate: bool = False         # C += vs C =
    # Memory descriptors (symbolic under JAX; used by the simulator).
    base_a: int = 0
    base_b: int = 0
    base_bias: int = 0
    base_c: int = 0
    stride_a: int = 0                # row strides in elements; 0 = dense
    stride_b: int = 0
    stride_bias: int = 0
    stride_c: int = 0
    status: Status = Status.IDLE

    def __post_init__(self):
        if min(self.m, self.n, self.k) <= 0:
            raise ValueError(f"degenerate task {self.m}x{self.n}x{self.k}")
        if self.stride_a == 0:
            self.stride_a = self.k
        if self.stride_b == 0:
            self.stride_b = self.n
        if self.stride_c == 0:
            self.stride_c = self.n

    # ----- cost metadata ---------------------------------------------------
    @property
    def macs(self) -> int:
        return self.m * self.n * self.k

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def in_bytes(self) -> float:
        eb = policy(self.data_type).bytes_per_elem
        bias = 0.0
        if self.bias_type == BiasType.ROW:
            bias = self.n * 4.0
        elif self.bias_type == BiasType.FULL:
            bias = self.m * self.n * 4.0
        return (self.m * self.k + self.k * self.n) * eb + bias

    def out_bytes(self, out_elem_bytes: float = 4.0) -> float:
        return self.m * self.n * out_elem_bytes

    def arithmetic_intensity(self) -> float:
        return self.flops / (self.in_bytes + self.out_bytes())


def tile_tasks(task: MatMulTask, tile_m: int, tile_n: int) -> "list[MatMulTask]":
    """Split one logical matmul into scratchpad-tile-granularity tasks.

    This is what the ``asyncMatMul`` *macro* of Listing 1 does: "dispatches
    a task per tile, with tile size determined by shared storage capacity".
    Edge tiles keep their true (smaller) extents.
    """
    out = []
    for m0 in range(0, task.m, tile_m):
        for n0 in range(0, task.n, tile_n):
            out.append(dataclasses.replace(
                task,
                m=min(tile_m, task.m - m0),
                n=min(tile_n, task.n - n0),
                base_a=task.base_a + m0 * task.stride_a,
                base_b=task.base_b + n0,
                base_c=task.base_c + m0 * task.stride_c + n0,
                status=Status.IDLE,
            ))
    return out
