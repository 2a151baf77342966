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

A CUDA launch writes into a tensor the wrapper allocated, so its result
has no ``grad_fn``.  K1 runs under autograd through the op
``matmul.ops.FUSED_MATMUL_OP``; the other wrappers have no backward yet
and refuse a call that autograd would track (``refuse_autograd``), on
every device, rather than return a result that silently drops the gradient.

Every CUDA launcher makes its operands' card current in the calling
thread first (``bind_device``): a launch may come from any host thread
(autograd's backward thread, a rank's worker, a test's thread).

On ``meta`` tensors (a dry run, ``core.hlo_cost``) each wrapper takes the
card's path, allocations, copies and tile choice included, up to the
launch, which it skips (``launcher``, ``stream``): the result is an
empty tensor of the card's shape and dtype.  The plain version does not
run there.  Each wrapper records its launch's cost in an active counter
(``hlo_cost.count``) on every device.
"""

import torch

from repro_torch import NotPorted


def refuse_autograd(kernel: str, roadmap_item: str, *tensors) -> None:
    """Raise ``NotPorted`` if grad mode is on and a tensor of
    ``tensors`` requires grad: ``kernel`` has no backward, and
    ``roadmap_item`` is the ROADMAP item that will give it one."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise NotPorted(
            f"{kernel} has no backward: its result would carry no gradient "
            f"(ROADMAP {roadmap_item}); call it under torch.no_grad() or "
            f"with inputs that do not require grad")


def bind_device(t: torch.Tensor) -> None:
    """Make ``t``'s card current in the calling thread.  On an H100 the
    tensor-core tiles' first launch from a thread that has not set its
    device (a ``threading.Thread``, autograd's backward thread) fails
    with CUDA error 1 (invalid value); ``torch.cuda.set_device`` makes the
    card's context current in the thread."""
    if t.is_cuda:
        torch.cuda.set_device(t.device)


def _no_launch(*args) -> int:
    return 0


def launcher(get, t: torch.Tensor):
    """The C entry point ``get()`` returns (built on first use), to launch
    on ``t``'s card; on a ``meta`` tensor, one that launches nothing and
    reports success."""
    return _no_launch if t.is_meta else get()


def stream(t: torch.Tensor):
    """The handle of the current CUDA stream of ``t``'s card; None for a
    ``meta`` tensor."""
    return (None if t.is_meta
            else torch.cuda.current_stream(t.device).cuda_stream)
