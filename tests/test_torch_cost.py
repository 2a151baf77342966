"""The port's cost counter (``repro_torch.core.hlo_cost``) against the
reference's ``repro.core.hlo_cost``.

* Each kernel K1–K6 counts the same launch on ``meta`` tensors (the dry
  run: the card's path without the launch) as on CPU tensors (its plain
  version, whose own aten ops go uncounted).
* Each kernel's counted FLOPs equal ``repro.core.hlo_cost.analyze`` of
  the reference's jitted ``xla`` route of the same call (seeded numpy
  inputs): its dots.
* A whole reduced yi-6b or OLMoE prefill or decode step counts the
  reference's ``hlo_cost`` FLOPs exactly (the tolerance is 0), at 64
  keys and at the serve traffic's 221.  The port counts each kernel by
  its formula, which equals the reference's ``xla`` route (K2's chunked
  attention included: its keys are padded to whole KV blocks of the
  model's ``attn_chunk``, 32 in the reduced configs, so 221 keys count
  as 224), and the other matmuls (the router, decode attention's two
  einsums) by ``torch.utils.flop_counter``, as the reference's HLO counts
  their dots.  Bytes are not compared: XLA counts fusion boundaries, the
  port every aten op.
* Autograd on ``meta``: a train step counts K1's backward launches (the
  accumulator recompute) and dA, dB as aten matmuls, as on the CPU.
* Collective bytes by kind in a gloo world of 2 ranks equal the
  reference's on 2 host devices.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.core import fusion as rfusion
from repro.core import hlo_cost as rhc
from repro.kernels.moe.ref import grouped_matmul_ref
from repro.kernels.quant.ref import quantize_rowwise_ref
from repro.kernels.rglru.ref import rglru_ref
from repro.models import base as rbase
from repro.models.common import attention_xla_chunked
from repro.models.rwkv6 import rwkv6_chunked_jnp

from repro_torch.configs.registry import get_config
from repro_torch.core import hlo_cost
from repro_torch.core.fusion import Epilogue, EpilogueOperands
from repro_torch.core.task import BiasType
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.matmul.ops import fused_matmul
from repro_torch.kernels.moe.ops import grouped_matmul
from repro_torch.kernels.quant.ops import quantize_rowwise
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rwkv6.ops import rwkv6_scan
from repro_torch.models.base import family_module
from repro_torch.training import train_step as ts

ROOT = Path(__file__).resolve().parents[1]


def _ref_flops(fn, *args) -> float:
    """FLOPs of ``fn(*args)`` jitted, by the reference's ``hlo_cost``."""
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    cost = rhc.analyze(hlo)
    assert cost.unparsed_loops == 0
    return cost.flops


def _rng(seed=0):
    return np.random.default_rng(seed)


def _count(fn, *args, device="cpu"):
    """The counter's cost of ``fn`` on ``args`` moved to ``device``."""
    args = [a.to(device) if torch.is_tensor(a) else a for a in args]
    with torch.no_grad():
        return hlo_cost.analyze(fn, *args)


# ---------------------------------------------------------------------------
# The six kernels: (port call, its tensors, reference xla route, arrays).
# ---------------------------------------------------------------------------

def _k1_case(name):
    r = _rng(1)
    if name == "plain":
        a, b = r.standard_normal((48, 64)), r.standard_normal((64, 96))
        return (lambda a, b: fused_matmul(a, b), [a, b],
                lambda a, b: rfusion.cute_matmul(a, b, backend="xla"))
    if name == "glu":
        a, b = r.standard_normal((40, 64)), r.standard_normal((64, 2, 48))
        return (lambda a, b: fused_matmul(a, b, epilogue=Epilogue(
                    activation="silu", glu=True)), [a, b],
                lambda a, b: rfusion.cute_matmul(a, b, backend="xla",
                                                 epilogue=rfusion.Epilogue(
                                                     activation="silu",
                                                     glu=True)))
    a, b = r.standard_normal((2, 24, 64)), r.standard_normal((64, 80))
    bias, res = r.standard_normal((80,)), r.standard_normal((2, 24, 80))
    return (lambda a, b, bias, res: fused_matmul(
                a, b, epilogue=Epilogue(bias_type=BiasType.ROW,
                                        has_residual=True, softcap=5.0),
                operands=EpilogueOperands(bias=bias, residual=res)),
            [a, b, bias, res],
            lambda a, b, bias, res: rfusion.cute_matmul(
                a, b, backend="xla",
                epilogue=rfusion.Epilogue(bias_type=rfusion.BiasType.ROW,
                                          has_residual=True, softcap=5.0),
                operands=rfusion.EpilogueOperands(bias=bias, residual=res)))


def _k2_case(name):
    """The reference's ``xla`` route pads the keys to whole blocks of its
    ``chunk``; the port counts the same blocks of ``cost_chunk``."""
    b, h, hkv, sq, sk, d, chunk, kw = {
        "causal_gqa": (1, 4, 2, 16, 16, 32, 1024, dict(causal=True)),
        "padded_block": (2, 2, 1, 8, 1500, 16, 1024, dict(causal=False)),
        "window_softcap": (1, 2, 2, 8, 24, 16, 16,
                           dict(causal=True, window=8, softcap=20.0,
                                q_start=16)),
    }[name]
    r = _rng(2)
    q = r.standard_normal((b, h, sq, d))
    k, v = (r.standard_normal((b, hkv, sk, d)) for _ in range(2))
    scale = d ** -0.5
    return (lambda q, k, v: flash_attention(q, k, v, sm_scale=scale,
                                            cost_chunk=chunk, **kw),
            [q, k, v],
            lambda q, k, v: attention_xla_chunked(q, k, v, sm_scale=scale,
                                                  chunk=chunk, **kw))


def _k3_case(name):
    x = _rng(3).standard_normal((16, 64))
    return (quantize_rowwise, [x], quantize_rowwise_ref)


def _k4_case(name):
    r = _rng(4)
    x = r.standard_normal((4, 8, 32))
    if name == "glu":
        w = r.standard_normal((4, 32, 2, 24))
        ep = dict(activation="silu", glu=True)
    else:
        w = r.standard_normal((4, 32, 40))
        ep = dict(activation="gelu")
    return (lambda x, w: grouped_matmul(x, w, epilogue=Epilogue(**ep)),
            [x, w],
            lambda x, w: grouped_matmul_ref(x, w, epilogue=rfusion.Epilogue(
                **ep)))


def _k5_case(name):
    r = _rng(5)
    log_a = -np.abs(r.standard_normal((2, 16, 32)))
    x = r.standard_normal((2, 16, 32))
    return (rglru_scan, [log_a, x],
            lambda la, x: rglru_ref(la, x))


def _k6_case(name):
    r = _rng(6)
    b, h, t, c, chunk = (1, 2, 40, 16, 32) if name == "padded" else \
        (2, 1, 64, 64, 64)
    rr, k, v = (r.standard_normal((b, h, t, c)) * 0.5 for _ in range(3))
    lw = -np.exp(r.standard_normal((b, h, t, c)).clip(-8, 1))
    u = r.standard_normal((h, c))
    s0 = r.standard_normal((b, h, c, c))
    return (lambda r_, k, v, lw, u, s0: rwkv6_scan(
                r_, k, v, lw, u, chunk=chunk, initial_state=s0),
            [rr, k, v, lw, u, s0],
            lambda r_, k, v, lw, u, s0: rwkv6_chunked_jnp(
                r_, k, v, lw, u, chunk=chunk, initial_state=s0))


KERNELS = {
    "fused_matmul": (_k1_case, ("plain", "glu", "bias_residual")),
    "flash_attention": (_k2_case, ("causal_gqa", "padded_block",
                                   "window_softcap")),
    "quantize_rowwise": (_k3_case, ("rows",)),
    "grouped_matmul": (_k4_case, ("glu", "plain")),
    "rglru_scan": (_k5_case, ("scan",)),
    "rwkv6_wkv": (_k6_case, ("padded", "full")),
}
CASES = [(k, c) for k, (_, cs) in KERNELS.items() for c in cs]


def _torch_args(arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("kernel, case", CASES)
def test_meta_counts_the_cpu_call(kernel, case):
    """One launch, of the same FLOPs and bytes, on meta as on the CPU;
    the CPU's plain version counts no aten op of its own, and the meta
    path's own ops are only the card path's (no copy here: contiguous
    fp32 operands)."""
    fn, arrays, _ = KERNELS[kernel][0](case)
    args = _torch_args(arrays)
    cpu = _count(fn, *args)
    meta = _count(fn, *args, device="meta")
    assert list(cpu.kernels) == [kernel]
    assert cpu.kernels == meta.kernels
    assert cpu.kernels[kernel]["calls"] == 1
    # outside the plain version, the wrapper's views only
    assert all(row["bytes"] == row["flops"] == 0 for row in cpu.ops.values())
    assert cpu.flops == meta.flops == cpu.kernels[kernel]["flops"]
    own = sum(row["bytes"] for row in meta.ops.values())
    assert meta.bytes - own == cpu.bytes == cpu.kernels[kernel]["bytes"]
    assert cpu.unparsed_loops == meta.unparsed_loops == 0


@pytest.mark.parametrize("kernel, case", CASES)
def test_kernel_flops_equal_reference_xla_route(kernel, case):
    fn, arrays, ref_fn = KERNELS[kernel][0](case)
    port = _count(fn, *_torch_args(arrays), device="meta").flops
    ref = _ref_flops(ref_fn, *(jnp.asarray(a, jnp.float32) for a in arrays))
    assert port == ref


def test_kernel_bytes_count_operands_and_results():
    """K1's launch: a, b, the fp32 epilogue operands, the output."""
    fn, arrays, _ = _k1_case("bias_residual")
    cost = _count(fn, *_torch_args(arrays), device="meta")
    m, k, n = 48, 64, 80
    assert cost.kernels["fused_matmul"]["bytes"] == 4 * (
        m * k + k * n + n + m * n + m * n)


def test_transposed_b_copy_counts_on_meta():
    """A transposed B is made contiguous before the launch, on the card
    and on meta alike: the copy's bytes count beside the launch's."""
    a, b = _torch_args([_rng(7).standard_normal((32, 64)),
                        _rng(8).standard_normal((96, 64))])
    cost = _count(lambda a, b: fused_matmul(a, b.T), a, b, device="meta")
    assert cost.ops["aten.clone"] == {"calls": 1, "flops": 0.0,
                                      "bytes": 2 * 4 * 64 * 96}
    assert cost.bytes == (cost.kernels["fused_matmul"]["bytes"]
                          + 2 * 4 * 64 * 96)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k1_op_counts_its_launch_and_holds_its_result(device):
    """Under autograd K1 runs inside its op: the counter records the
    launch its body records, as on the untracked path, nothing for the
    op itself, and holds the op's result in the live bytes."""
    a = torch.ones(32, 64, device=device)
    b = torch.ones(64, 48, device=device, requires_grad=True)
    with hlo_cost.counting() as untracked, torch.no_grad():
        fused_matmul(a, b)
    with hlo_cost.counting() as tracked:
        out = fused_matmul(a, b)
        held = tracked._live
    assert out.grad_fn is not None
    assert tracked.cost.kernels == untracked.cost.kernels
    assert tracked.cost.bytes == untracked.cost.bytes
    assert not any(op.startswith("repro_torch") for op in tracked.cost.ops)
    assert held >= 4 * 32 * 48


def test_no_counter_no_cost():
    """Without a counter the wrappers record nothing, and counters do
    not nest."""
    a = torch.randn(8, 16)
    assert hlo_cost.ACTIVE is None
    fused_matmul(a, torch.randn(16, 8))
    with hlo_cost.counting():
        with pytest.raises(RuntimeError, match="already active"):
            with hlo_cost.counting():
                pass
    assert hlo_cost.ACTIVE is None


def test_meta_returns_the_cards_shapes():
    x = torch.empty(4, 8, 32, device="meta", dtype=torch.bfloat16)
    w = torch.empty(4, 32, 2, 24, device="meta", dtype=torch.bfloat16)
    out = grouped_matmul(x, w, epilogue=Epilogue(glu=True,
                                                 activation="silu"))
    assert (out.device.type, out.shape, out.dtype) == (
        "meta", (4, 8, 24), torch.bfloat16)
    q, s = quantize_rowwise(torch.empty(6, 64, device="meta"))
    assert (q.shape, q.dtype, s.shape, s.dtype) == (
        (6, 64), torch.int8, (6,), torch.float32)


# ---------------------------------------------------------------------------
# Whole reduced cells against the reference's hlo_cost.
# ---------------------------------------------------------------------------

def _ref_cell_flops(arch, mode, b, s):
    cfg = rreg.get_config(arch, reduced=True)
    mod = rbase.family_module(cfg)
    params = jax.eval_shape(lambda k: mod.init(cfg, k),
                            jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: mod.init_cache(cfg, b, s))
    if mode == "prefill":
        batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
        return _ref_flops(lambda p, x, c: mod.prefill(cfg, p, x, c),
                          params, batch, cache)
    tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)
    pos = jax.ShapeDtypeStruct((), jnp.int32)
    return _ref_flops(lambda p, t, c, i: mod.decode_step(cfg, p, t, c, i),
                      params, tok, cache, pos)


def _port_cell(arch, mode, b, s, device="meta"):
    cfg = get_config(arch, reduced=True)
    mod = family_module(cfg)
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = mod.init(cfg, gen, device)
    cache = mod.init_cache(cfg, b, s, device=device)
    with torch.no_grad(), hlo_cost.counting() as c:
        if mode == "prefill":
            tokens = torch.zeros((b, s), dtype=torch.int32, device=device)
            mod.prefill(cfg, params, {"tokens": tokens}, cache)
        else:
            tokens = torch.zeros((b, 1), dtype=torch.int32, device=device)
            mod.decode_step(cfg, params, tokens, cache, s - 1)
    return c.cost


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("s", [64, 221])
def test_reduced_cell_flops_agree_with_reference(arch, mode, s):
    b = 2
    port = _port_cell(arch, mode, b, s)
    ref = _ref_cell_flops(arch, mode, b, s)
    assert port.flops == ref
    assert port.unparsed_loops == 0
    kernels = {"fused_matmul"} | ({"flash_attention"} if mode == "prefill"
                                  else set())
    if arch == "olmoe-1b-7b":
        kernels.add("grouped_matmul")
    assert set(port.kernels) == kernels


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_reduced_cell_counts_the_same_on_cpu_and_meta(arch):
    """Launches and FLOPs of a prefill are device-independent; bytes
    differ only by the card path's own copies (the SIMT attention tile
    pads the reduced head dim of 16 to 32)."""
    cpu = _port_cell(arch, "prefill", 2, 64, "cpu")
    meta = _port_cell(arch, "prefill", 2, 64, "meta")
    assert cpu.kernels == meta.kernels
    assert cpu.flops == meta.flops
    assert meta.temp_bytes > 0


# ---------------------------------------------------------------------------
# Autograd on meta.
# ---------------------------------------------------------------------------

def test_train_step_on_meta_counts_the_backward():
    """A yi-6b train step (2 microbatches, 2 loss chunks) counts the same
    K1 launches and the same FLOPs on meta as on the CPU: 13 K1 calls a
    layer and microbatch (6 forward, 6 in remat, the GLU's accumulator
    recompute) and 2 a loss chunk; dA and dB as aten mm."""
    cfg = get_config("yi-6b", reduced=True).with_(backend="torch")
    t = ts.TrainConfig(microbatches=2, loss_chunk=8)
    costs = {}
    for device in ("cpu", "meta"):
        gen = torch.Generator().manual_seed(0) if device == "cpu" else None
        params = family_module(cfg).init(cfg, gen, device)
        from repro_torch.optim import adamw
        opt = adamw.init(t.optimizer, params)
        tokens = torch.zeros((4, 16), dtype=torch.int32, device=device)
        with hlo_cost.counting() as c:
            ts.make_train_step(cfg, t)(params, opt, {"tokens": tokens,
                                                     "labels": tokens})
        costs[device] = c.cost
    cpu, meta = costs["cpu"], costs["meta"]
    assert cpu.kernels == meta.kernels
    assert meta.kernels["fused_matmul"]["calls"] == \
        2 * (cfg.n_layers * 13 + 2 * 2)
    assert cpu.ops["aten.mm"]["flops"] == meta.ops["aten.mm"]["flops"] > 0
    assert cpu.flops == meta.flops


# ---------------------------------------------------------------------------
# Collectives in a gloo world of 2 ranks.
# ---------------------------------------------------------------------------

_WORLD_PROG = textwrap.dedent("""
    import json
    import os
    import sys
    sys.path.insert(0, sys.argv[1])
    import torch

    from repro_torch.launch.mesh import run_world


    def rank_main(world, out_dir):
        torch.set_num_threads(1)
        from repro_torch.core import hlo_cost
        from repro_torch.distributed import collectives
        r, n = world.rank, 2
        with hlo_cost.counting() as c:
            collectives.all_reduce(torch.ones(64, 32))
            collectives.all_gather(torch.ones(8, 16))
            collectives.broadcast(torch.arange(4, dtype=torch.int32), 0)
            recv = torch.empty(16)
            collectives.exchange(torch.full((16,), float(r)), recv,
                                 (r + 1) % n, (r - 1) % n)()
        with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
            json.dump({"per": c.cost.per_collective,
                       "total": c.cost.collective_bytes,
                       "ops": sorted(c.cost.ops),
                       "recv": recv.tolist()}, f)


    if __name__ == "__main__":
        run_world(rank_main, 2, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=120.0)
""")

# The same four collectives on 2 host devices through the reference:
# psum, all_gather, the pipeline's closing psum of a masked array (the
# port's broadcast) and ppermute (the port's exchange), per-shard shapes
# as above, counted by ``repro.core.hlo_cost.analyze`` of the compiled HLO.
_REFERENCE_PROG = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import json
    import sys
    sys.path.insert(0, sys.argv[1])
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core import hlo_cost
    from repro.core.jaxcompat import shard_map
    from repro.launch.mesh import compat_make_mesh


    def body(a, g, b, p):
        r = jax.lax.axis_index("x")
        a = jax.lax.psum(a, "x")
        g = jax.lax.all_gather(g, "x", tiled=True)
        b = jax.lax.psum(jnp.where(r == 0, b, jnp.zeros_like(b)), "x")
        p = jax.lax.ppermute(p, "x", [(0, 1), (1, 0)])
        return a, g, b, p


    mesh = compat_make_mesh((2,), ("x",))
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"),) * 4,
                          out_specs=(P("x"),) * 4, check_vma=False))
    args = (jax.ShapeDtypeStruct((2 * 64, 32), jnp.float32),
            jax.ShapeDtypeStruct((2 * 8, 16), jnp.float32),
            jax.ShapeDtypeStruct((2 * 4,), jnp.int32),
            jax.ShapeDtypeStruct((2 * 16,), jnp.float32))
    c = hlo_cost.analyze(f.lower(*args).compile().as_text())
    with open(os.path.join(sys.argv[2], "reference.json"), "w") as fh:
        json.dump({"per": c.per_collective, "total": c.collective_bytes}, fh)
""")

#: the port's kind -> the reference's HLO op for the same collective
_KIND_IN_REFERENCE = {"all-reduce": "all-reduce", "all-gather": "all-gather",
                      "collective-permute": "collective-permute",
                      "broadcast": "all-reduce"}


def test_collective_bytes_in_a_gloo_world(tmp_path):
    """A gloo world of 2 ranks counts, on each rank, the collective bytes
    by kind that the reference's ``hlo_cost`` counts for the same
    collectives on 2 host devices, under ``_KIND_IN_REFERENCE``: the
    port's ``broadcast`` is the reference's all-reduce of a masked array
    (its pipeline's closing step).  The all-gather is fp32 because the
    reference's CPU compiler widens a bf16 all-gather to fp32 in the HLO
    it counts."""
    progs = {}
    for name, text in (("port", _WORLD_PROG), ("reference", _REFERENCE_PROG)):
        (tmp_path / f"{name}.py").write_text(text)
        progs[name] = subprocess.Popen(
            [sys.executable, str(tmp_path / f"{name}.py"), str(ROOT / "src"),
             str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    try:
        for name, proc in progs.items():
            _, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, (name, err[-3000:])
    finally:
        for proc in progs.values():
            proc.kill()
    ref = json.loads((tmp_path / "reference.json").read_text())
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert set(got["per"]) == set(_KIND_IN_REFERENCE)
        mapped = {}
        for kind, b in got["per"].items():
            k = _KIND_IN_REFERENCE[kind]
            mapped[k] = mapped.get(k, 0.0) + b
        assert mapped == ref["per"]
        assert got["total"] == ref["total"]
        assert not any(op.startswith(("c10d", "_c10d")) for op in got["ops"])
        assert got["recv"] == [float((r - 1) % 2)] * 16


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_temp_bytes_follow_the_storages_autograd_saves(device):
    """``temp_bytes`` follows storages, not tensors: ``exp`` saves its
    result for the backward as another tensor on the same storage, so
    after the caller drops the result it stays live until the backward
    has used it.  Two chained exps of 4 MiB each and a product on top
    peak at 12 MiB; the live bytes fall to the product's once the
    backward ran."""
    from repro_torch.core import hlo_cost
    mib = 1 << 20
    x = torch.ones(mib // 4, device=device, requires_grad=True)
    with hlo_cost.counting() as counter:
        y = x.exp()
        z = y.exp()
        del y
        w = z * 2.0
        del z
        held = counter._live
        w.sum().backward()
        del w
    assert held == 3 * mib and counter.cost.temp_bytes >= 3 * mib
    assert counter._live < held
