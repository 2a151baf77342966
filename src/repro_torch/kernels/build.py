"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by its own ``nvcc`` into a shared
library with a plain C interface (``nvcc -shared``), and loaded with
``ctypes``.  All compilers start together, so a cold build takes as long
as the slowest source.  Libraries land in ``build/kernels/`` at the root
of the checkout, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", *ARCH_FLAGS]

NVCC_TIMEOUT_S = 600

# Sources only a Hopper card can run: their PTX (TMA, wgmma, mbarriers)
# and driver types (CUtensorMap) have no CPU stand-in, so the emulated
# tests (tests/test_torch_kernels_emulated.py) leave them out.
CARD_ONLY = frozenset({"fused_matmul_sm90", "grouped_matmul_sm90",
                       "flash_attention_sm90", "rwkv6_wkv_sm90"})

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL]" = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def sources() -> "list[Path]":
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha1()
    h.update(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all() -> "dict[str, Path]":
    """Compile every source whose library is missing; returns
    ``{source stem: library path}``.  ``nvcc``'s ``-Xptxas -v`` report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sources()}
    todo = {stem: st for stem, st in targets.items() if not st[1].exists()}
    procs = {}
    for stem, (src, out) in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p, _, _ in procs.values():
                p.kill()
                p.communicate()
            raise RuntimeError(f"nvcc took over {NVCC_TIMEOUT_S} s on "
                               f"{stem}.cu") from None
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use, together with every other source)."""
    with _lock:
        if stem not in _libs:
            for name, path in build_all().items():
                if name not in _libs:
                    _libs[name] = ctypes.CDLL(str(path))
        return _libs[stem]
