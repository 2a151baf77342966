"""CUTEv2 reproduction, ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``repro_torch.core.fusion`` <-> ``repro.core.fusion``, ...) and
never imports it or JAX.  Each Pallas kernel on the ported path is a
hand-written CUDA kernel under ``kernels/csrc``, built with ``nvcc`` on
first use, with a plain PyTorch version beside it.
"""


class NotPorted(NotImplementedError):
    """What the reference does and the port does not yet: the refusal
    names the ROADMAP item that will port it.  A dry run records a cell
    that raises it as ``not_ported``; any other error fails the cell."""
