"""The port's training slice against the reference's, on the CPU.

The chunked loss, AdamW on identical gradients, int8 gradient compression
and whole train steps are held against ``repro.training`` /
``repro.optim`` on the same inputs (the reference's params carried
across with ``params_from_jax``); K1's autograd Function
(``FusedMatmulFn``) against autograd of its plain version for every
epilogue; and the wrappers of K2-K6, which have no backward, refuse a
call that autograd would track.  On CPU tensors every kernel wrapper
runs its plain version, so K1's backward runs here in full but for the
launch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models.base import family_module as j_family  # noqa: E402
from repro.optim import adamw as j_adamw                 # noqa: E402
from repro.optim import compression as j_compression     # noqa: E402
from repro.training import loss as j_loss                # noqa: E402
from repro.training import train_step as j_train_step    # noqa: E402
from repro_torch.configs.registry import (ALL_ARCHS,    # noqa: E402
                                          get_config)
from repro_torch.core import tree                        # noqa: E402
from repro_torch.core.fusion import (Epilogue,           # noqa: E402
                                     EpilogueOperands)
from repro_torch.core.task import BiasType               # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops     # noqa: E402
from repro_torch.kernels.matmul.ref import fused_matmul_ref  # noqa: E402
from repro_torch.models.base import family_module        # noqa: E402
from repro_torch.models.convert import params_from_jax   # noqa: E402
from repro_torch.optim import adamw, compression         # noqa: E402
from repro_torch.training import loss as loss_lib        # noqa: E402
from repro_torch.training import train_step as ts       # noqa: E402


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(out, ref, tol):
    out, ref = (x.detach() if torch.is_tensor(x) else x for x in (out, ref))
    np.testing.assert_allclose(np.asarray(out, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64),
                               rtol=tol, atol=tol)


def _leaf_close(ours, ref, tol):
    """Every leaf within ``tol`` of that leaf's max |ref|."""
    o_leaves, r_leaves = tree.leaves(ours), jax.tree_util.tree_leaves(ref)
    assert len(o_leaves) == len(r_leaves)
    for o, r in zip(o_leaves, r_leaves):
        o, r = o.double().numpy(), np.asarray(r, dtype=np.float64)
        assert o.shape == r.shape
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(o - r).max() <= tol * scale


# ---------------------------------------------------------------------------
# The loss.
# ---------------------------------------------------------------------------

def _tiny(arch="yi-6b", **kw):
    jcfg = j_get_config(arch, reduced=True).with_(
        remat="none", dtype=jnp.float32, kv_cache_dtype=jnp.float32, **kw)
    tcfg = get_config(arch, reduced=True).with_(
        remat="none", dtype=torch.float32, kv_cache_dtype=torch.float32,
        **kw)
    jparams = j_family(jcfg).init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_jax(_np_tree(jparams))


class TestLoss:
    @pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b"])
    @pytest.mark.parametrize("chunk,s", [(8, 24), (8, 20), (32, 20)])
    @pytest.mark.parametrize("z_loss", [0.0, 1e-4])
    @pytest.mark.parametrize("onehot", [False, True])
    def test_chunked_matches_jax(self, arch, chunk, s, z_loss, onehot):
        """gemma2-2b: tied embedding and final softcap 30."""
        jcfg, tcfg, jparams, tparams = _tiny(arch)
        rng = np.random.default_rng(1)
        h = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
        labels = rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
        labels[0, :5] = -1
        kw = dict(chunk=chunk, z_loss=z_loss, onehot_pick=onehot)
        jl, jm = j_loss.chunked_softmax_xent(jcfg, jparams, jnp.asarray(h),
                                             jnp.asarray(labels), **kw)
        tl, tm = loss_lib.chunked_softmax_xent(
            tcfg, tparams, torch.from_numpy(h), torch.from_numpy(labels),
            **kw)
        _close(tl, jl, 1e-5)
        for k in ("nll", "z", "tokens"):
            _close(tm[k], jm[k], 1e-5)
        assert float(tm["tokens"]) == 2 * s - 5

    def test_masked_labels_excluded(self):
        jcfg, tcfg, jparams, tparams = _tiny()
        rng = np.random.default_rng(2)
        h = torch.from_numpy(rng.standard_normal(
            (2, 16, tcfg.d_model)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 64, (2, 16)))
        masked = labels.clone()
        masked[:, :8] = -1
        l_m, aux = loss_lib.chunked_softmax_xent(tcfg, tparams, h, masked,
                                                 chunk=8, z_loss=0.0)
        assert float(aux["tokens"]) == 16.0
        l_half, _ = loss_lib.chunked_softmax_xent(
            tcfg, tparams, h[:, 8:], labels[:, 8:], chunk=8, z_loss=0.0)
        _close(l_m, l_half, 1e-6)

    @pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b"])
    def test_grads_match_jax(self, arch):
        """d loss / d hidden and d loss / d (lm_head or embedding), through
        the per-chunk remat and K1's Function, against jax.grad."""
        jcfg, tcfg, jparams, tparams = _tiny(arch)
        rng = np.random.default_rng(3)
        h = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
        labels = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
        key = "embedding" if jcfg.tie_embeddings else "lm_head"

        def jf(hh, w):
            return j_loss.chunked_softmax_xent(
                jcfg, dict(jparams, **{key: w}), hh, jnp.asarray(labels),
                chunk=8)[0]
        jg_h, jg_w = jax.grad(jf, argnums=(0, 1))(jnp.asarray(h),
                                                  jparams[key])
        th = torch.from_numpy(h).requires_grad_()
        tw = tparams[key].clone().requires_grad_()
        tl, _ = loss_lib.chunked_softmax_xent(
            tcfg, dict(tparams, **{key: tw}), th, torch.from_numpy(labels),
            chunk=8)
        tg_h, tg_w = torch.autograd.grad(tl, (th, tw))
        _leaf_close([tg_h, tg_w], [jg_h, jg_w], 1e-5)

    def test_shift_labels_masks_the_vision_prefix(self):
        _, tcfg, _, _ = _tiny("internvl2-1b")
        labels = torch.arange(24).reshape(2, 12)
        out = loss_lib.shift_labels(tcfg, None, labels)
        assert (out[:, :tcfg.vision_prefix] == -1).all()
        assert torch.equal(out[:, tcfg.vision_prefix:],
                           labels[:, tcfg.vision_prefix:])
        assert labels.min() == 0                  # the input is untouched


# ---------------------------------------------------------------------------
# K1's autograd Function, and the wrappers that refuse autograd.
# ---------------------------------------------------------------------------

EPILOGUES = {
    "none": dict(),
    "row-bias": dict(bias_type=BiasType.ROW),
    "full-bias": dict(bias_type=BiasType.FULL),
    "softcap": dict(softcap=3.0),
    "silu": dict(activation="silu"),
    "gelu": dict(activation="gelu"),
    "silu-glu": dict(activation="silu", glu=True),
    "gelu-glu": dict(activation="gelu", glu=True),
    "residual": dict(has_residual=True),
    "bias-softcap-gelu-residual": dict(bias_type=BiasType.ROW, softcap=3.0,
                                       activation="gelu", has_residual=True),
}


def _mm_inputs(name, dtype, m=24, k=40, n=32, lead=()):
    ep = Epilogue(**EPILOGUES[name], out_dtype=dtype)
    rng = np.random.default_rng(7)

    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(dtype).requires_grad_()
    a = t(*lead, m, k)
    b = t(k, 2, n // 2, s=k ** -0.5) if ep.glu else t(k, n, s=k ** -0.5)
    n_out = n // 2 if ep.glu else n
    bias = (t(n) if ep.bias_type == BiasType.ROW else
            t(*lead, m, n) if ep.bias_type == BiasType.FULL else None)
    res = t(*lead, m, n_out) if ep.has_residual else None
    return a, b, ep, bias, res


class _Counting:
    """Counts the plain version's calls: on the CPU they stand where K1's
    launches stand on the card."""

    def __init__(self, monkeypatch):
        self.calls = 0
        plain = mm_ops.fused_matmul_plain

        def counted(*a, **kw):
            self.calls += 1
            return plain(*a, **kw)
        monkeypatch.setattr(mm_ops, "fused_matmul_plain", counted)


class TestFusedMatmulFn:
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                           (torch.bfloat16, 3e-2)],
                             ids=["fp32", "bf16"])
    @pytest.mark.parametrize("name", list(EPILOGUES))
    def test_backward_matches_autograd_of_plain(self, name, dtype, tol,
                                                monkeypatch):
        a, b, ep, bias, res = _mm_inputs(name, dtype)
        ops = EpilogueOperands(bias=bias, residual=res)
        count = _Counting(monkeypatch)
        out = mm_ops.fused_matmul(a, b, epilogue=ep, operands=ops)
        assert out.grad_fn is not None and count.calls == 1
        g = torch.from_numpy(np.random.default_rng(8).standard_normal(
            tuple(out.shape)).astype(np.float32)).to(dtype)
        wrt = [x for x in (a, b, bias, res) if x is not None]
        ours = torch.autograd.grad(out, wrt, g)
        linear = ep.activation == "none" and not ep.glu and not ep.softcap
        assert count.calls == (1 if linear else 2)    # the acc recompute
        ref_out = fused_matmul_ref(a, b, epilogue=ep, operands=ops)
        ref = torch.autograd.grad(ref_out, wrt, g)
        _close(out.float(), ref_out.float(),
               tol * ref_out.float().abs().max().item())
        for o, r, x in zip(ours, ref, wrt):
            assert o.dtype == x.dtype and o.shape == x.shape
            _close(o.float(), r.float(), tol * r.float().abs().max().item())

    def test_batched_a_and_partial_grads(self):
        """A (2, 3, M, K) input with a FULL bias; only B requires grad."""
        a, b, ep, bias, _ = _mm_inputs("full-bias", torch.float32,
                                       lead=(2, 3))
        a, bias = a.detach(), bias.detach()
        ops = EpilogueOperands(bias=bias)
        (gb,) = torch.autograd.grad(
            mm_ops.fused_matmul(a, b, epilogue=ep, operands=ops).sum(), b)
        (rb,) = torch.autograd.grad(
            (a @ b + bias).sum(), b)
        _close(gb, rb, 1e-5 * rb.abs().max().item())

    def test_untracked_call_takes_the_plain_path(self):
        a, b, ep, _, _ = _mm_inputs("silu-glu", torch.float32)
        with torch.no_grad():
            out = mm_ops.fused_matmul(a, b, epilogue=ep)
        assert out.grad_fn is None
        out = mm_ops.fused_matmul(a.detach(), b.detach(), epilogue=ep)
        assert out.grad_fn is None

    @pytest.mark.parametrize("scale", ["scale_a", "scale_b"])
    def test_dequant_scales_refuse_autograd(self, scale):
        a, b, _, _, _ = _mm_inputs("none", torch.float32)
        ep = Epilogue(**{f"has_{scale}": True})
        ops = EpilogueOperands(**{scale: torch.ones(
            a.shape[0] if scale == "scale_a" else b.shape[1])})
        with pytest.raises(NotImplementedError, match="item K"):
            mm_ops.fused_matmul(a, b, epilogue=ep, operands=ops)
        with torch.no_grad():
            mm_ops.fused_matmul(a, b, epilogue=ep, operands=ops)


def _refusing_calls():
    """(name, ROADMAP item, call) for each wrapper without a backward,
    on inputs where x requires grad."""
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.moe.ops import grouped_matmul
    from repro_torch.kernels.quant.ops import quantize_rowwise
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    q, kv = r(1, 2, 8, 16), r(1, 2, 8, 16)
    return [
        ("K2", "item F", lambda x: flash_attention(x, kv, kv), q),
        ("K3", "item K", quantize_rowwise, r(4, 16)),
        ("K4", "item G", lambda x: grouped_matmul(x, r(2, 16, 8)),
         r(2, 4, 16)),
        ("K5", "item H", lambda x: rglru_scan(-x.abs(), x), r(1, 8, 4)),
        ("K6", "item I", lambda x: rwkv6_scan(x, x, x, -x.abs(),
                                              r(2, 16)), q),
    ]


@pytest.mark.parametrize("case", range(5),
                         ids=["K2", "K3", "K4", "K5", "K6"])
def test_wrappers_without_backward_refuse_autograd(case):
    name, item, call, x = _refusing_calls()[case]
    with pytest.raises(NotImplementedError, match=item):
        call(x.clone().requires_grad_())
    with torch.no_grad():
        call(x.clone().requires_grad_())
    call(x)                                     # nothing requires grad


# ---------------------------------------------------------------------------
# AdamW and compression on identical inputs.
# ---------------------------------------------------------------------------

def _opt_tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((3, 4, 5)).astype(dtype),
            "b": rng.standard_normal((7,)).astype(dtype),
            "layers": ({"k": rng.standard_normal((2, 6)).astype(dtype)},)}


class TestAdamW:
    @pytest.mark.parametrize("clip", [1.0, 100.0])
    def test_update_matches_jax(self, clip):
        cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
                      clip_norm=clip)
        jcfg, tcfg = j_adamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
        rng = np.random.default_rng(0)
        params = _opt_tree(rng)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        tp = params_from_jax(params)
        js, tst = j_adamw.init(jcfg, jp), adamw.init(tcfg, tp)
        for _ in range(3):
            grads = _opt_tree(rng)
            jp, js, jm = j_adamw.update(
                jcfg, jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
            tp, tst, tm = adamw.update(tcfg, params_from_jax(grads), tst, tp)
            _leaf_close(tp, jp, 1e-6)
            for k in ("mu", "nu", "master"):
                _leaf_close(tst[k], js[k], 1e-6)
            assert int(tst["step"]) == int(js["step"])
            _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
            _close(tm["lr"], jm["lr"], 1e-9)

    def test_schedule_matches_jax(self):
        kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
        for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            ours = adamw.schedule(adamw.AdamWConfig(**kw),
                                  torch.tensor(s, dtype=torch.int32))
            ref = j_adamw.schedule(j_adamw.AdamWConfig(**kw), jnp.int32(s))
            assert ours.dtype == torch.float32
            _close(ours, ref, 1e-10)

    def test_clipping(self):
        cfg = adamw.AdamWConfig(clip_norm=1.0, warmup_steps=0)
        params = {"w": torch.zeros(4)}
        state = adamw.init(cfg, params)
        _, _, m = adamw.update(cfg, {"w": torch.full((4,), 100.0)}, state,
                               params)
        assert float(m["grad_norm"]) == pytest.approx(200.0)

    def test_bf16_params_fp32_master_match_jax(self):
        kw = dict(lr=1e-2, warmup_steps=0, weight_decay=0.1)
        rng = np.random.default_rng(4)
        w = rng.standard_normal((8, 4)).astype(np.float32)
        jp = {"w": jnp.asarray(w, jnp.bfloat16)}
        tp = params_from_jax(_np_tree(jp))
        js = j_adamw.init(j_adamw.AdamWConfig(**kw), jp)
        tst = adamw.init(adamw.AdamWConfig(**kw), tp)
        assert tst["master"]["w"].dtype == torch.float32
        for _ in range(3):
            g = rng.standard_normal((8, 4)).astype(np.float32) * 1e-4
            jp, js, _ = j_adamw.update(j_adamw.AdamWConfig(**kw),
                                       {"w": jnp.asarray(g, jnp.bfloat16)},
                                       js, jp)
            tp, tst, _ = adamw.update(
                adamw.AdamWConfig(**kw),
                {"w": torch.from_numpy(g).to(torch.bfloat16)}, tst, tp)
        assert tp["w"].dtype == torch.bfloat16
        _leaf_close(tst["master"], js["master"], 1e-6)
        # the master tracks sub-bf16 updates
        assert float((tst["master"]["w"] - torch.from_numpy(w)).abs()
                     .max()) > 0
        np.testing.assert_array_equal(
            tp["w"].view(torch.int16).numpy(),
            np.asarray(jp["w"]).view(np.int16))

    def test_slices_of_a_leaf_give_the_whole_leaf(self, monkeypatch):
        """``update`` works on slices of each leaf: one-row slices give
        the same bits as whole leaves."""
        rng = np.random.default_rng(5)
        cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
        outs = []
        for slice_elems in (1, 1 << 24):
            monkeypatch.setattr(adamw, "_SLICE", slice_elems)
            p = params_from_jax(_opt_tree(np.random.default_rng(6)))
            s = adamw.init(cfg, p)
            g = params_from_jax(_opt_tree(rng))
            outs.append(adamw.update(cfg, g, s, p)[:2])
            rng = np.random.default_rng(5)
        for a, b in zip(tree.leaves(outs[0]), tree.leaves(outs[1])):
            assert torch.equal(a, b)


class TestCompression:
    def test_compress_tree_equals_jax(self):
        rng = np.random.default_rng(9)
        grads = _opt_tree(rng)
        grads["zero"] = np.zeros((3, 3), np.float32)   # scale 1
        residual = jax.tree_util.tree_map(
            lambda g: (rng.standard_normal(g.shape) * 1e-3).astype(
                np.float32), grads)
        jq, js, jr = j_compression.compress_tree(
            jax.tree_util.tree_map(jnp.asarray, grads),
            jax.tree_util.tree_map(jnp.asarray, residual))
        tq, tsc, tr = compression.compress_tree(params_from_jax(grads),
                                                params_from_jax(residual))
        for ours, ref in ((tq, jq), (tsc, js), (tr, jr)):
            for o, r in zip(tree.leaves(ours), jax.tree_util.tree_leaves(ref)):
                np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert all(q.dtype == torch.int8 for q in tree.leaves(tq))

    def test_compressed_gradients_equal_jax_over_steps(self):
        """Error feedback over 20 steps of compressed SGD: == the
        reference's, and it tracks exact SGD."""
        w = np.array([4.0, -2.0, 1.0], np.float32)
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        jres = j_compression.init_residual({"w": jw})
        tres = compression.init_residual({"w": tw})
        for _ in range(20):
            jd, jres = j_compression.compressed_gradients({"w": 2 * jw},
                                                          jres)
            td, tres = compression.compressed_gradients({"w": 2 * tw}, tres)
            np.testing.assert_array_equal(td["w"].numpy(),
                                          np.asarray(jd["w"]))
            jw, tw = jw - 0.05 * jd["w"], tw - 0.05 * td["w"]
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# ---------------------------------------------------------------------------
# Whole train steps.
# ---------------------------------------------------------------------------

def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.vision_prefix:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encdec is not None:
        batch["audio_embeds"] = rng.standard_normal(
            (b, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()})


def _train_cfgs(arch, remat="full", **kw):
    jcfg = j_get_config(arch, reduced=True).with_(
        remat=remat, dtype=jnp.float32, kv_cache_dtype=jnp.float32, **kw)
    tcfg = get_config(arch, reduced=True).with_(
        remat=remat, dtype=torch.float32, kv_cache_dtype=torch.float32,
        backend="torch", **kw)
    return jcfg, tcfg


#: RecurrentGemma's RG-LRU decay leaves.  Both packages differentiate
#: beta = sqrt(-expm1(2 log_a)) through expm1's (result + 1), which near
#: -1 holds few bits: an ulp of expm1 moves it by ulp(1) / exp(2 log_a).
#: XLA's expm1 rounds correctly; torch's on the CPU is an ulp off on about
#: 1% of the elements of the reduced step (36 of 3,072), which moves these
#: leaves' gradients by up to 1.44e-4 of their max (their max is 1e-7 to
#: 3e-6, against ~1 for the other leaves); every other leaf holds 1e-4.
EXPM1_LEAVES = ("w_rec_gate", "b_rec_gate", "lambda_p")
TOL_EXPM1_LEAVES = 1e-3


def _steps_match_jax(arch, remat="full", **kw):
    """Three steps from the reference's params on its batches: grads at
    step 1 within 1e-4 of each leaf's max (Griffin's decay leaves within
    TOL_EXPM1_LEAVES), the loss of every step within 1e-5."""
    jcfg, tcfg = _train_cfgs(arch, remat, **kw)
    opt_kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jt = j_train_step.TrainConfig(optimizer=j_adamw.AdamWConfig(**opt_kw),
                                  loss_chunk=16)
    tt = ts.TrainConfig(optimizer=adamw.AdamWConfig(**opt_kw), loss_chunk=16)
    jparams = j_family(jcfg).init(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(_np_tree(jparams))
    jb, tb = _batch(jcfg, 2, 24, 0)

    (jl, _), jg = jax.value_and_grad(
        functools.partial(j_train_step._loss_fn, jcfg, jt), has_aux=True)(
            jparams, jb)
    tl, _, tg = ts.value_and_grad(tcfg, tt, tparams, tb)
    _close(tl, jl, 1e-5)
    paths = [path[-1] for path, _ in tree.flatten_with_path(tg)]
    for name, o, r in zip(paths, tree.leaves(tg),
                          jax.tree_util.tree_leaves(jg)):
        _leaf_close([o], [r], TOL_EXPM1_LEAVES if tcfg.rnn is not None
                    and name in EXPM1_LEAVES else 1e-4)

    jstep = jax.jit(j_train_step.make_train_step(jcfg, jt))
    tstep = ts.make_train_step(tcfg, tt)
    jopt, topt = j_adamw.init(jt.optimizer, jparams), adamw.init(
        tt.optimizer, tparams)
    for i in range(3):
        jb, tb = _batch(jcfg, 2, 24, i)
        jparams, jopt, jm, _ = jstep(jparams, jopt, jb)
        tparams, topt, tm, _ = tstep(tparams, topt, tb)
        _close(tm["loss"], jm["loss"], 1e-5 * abs(float(jm["loss"])))
        _close(tm["lr"], jm["lr"], 1e-9)


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b", "internvl2-1b",
                                  "olmoe-1b-7b", "arctic-480b",
                                  "recurrentgemma-2b", "rwkv6-7b",
                                  "whisper-tiny"])
def test_train_steps_match_jax(arch):
    """Every trainable family against the reference (gemma2-2b: tied
    embedding, final softcap; internvl2-1b: labels masked over the vision
    prefix; olmoe-1b-7b and arctic-480b: routing, dispatch, capacity drop
    and combine, Arctic's dense branch; recurrentgemma-2b: a (rec, rec,
    attn) triple under remat and the tail; rwkv6-7b: the chunked WKV;
    whisper-tiny: the encoder on seeded ``audio_embeds``)."""
    _steps_match_jax(arch)


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-7b"])
def test_remat_dots_matches_jax(arch):
    """``remat="dots"`` against the reference's
    ``checkpoint_dots_with_no_batch_dims``, at the same limits."""
    _steps_match_jax(arch, remat="dots")


def test_attn_pv_bf16_reaches_the_train_step(monkeypatch):
    """``cfg.attn_pv_bf16`` reaches the chunked attention of a train step,
    whose loss matches the reference's with the flag within 1e-5."""
    from repro_torch.models import common as tcm
    jcfg, tcfg = _train_cfgs("yi-6b", attn_pv_bf16=True)
    jt = j_train_step.TrainConfig(loss_chunk=16)
    jparams = j_family(jcfg).init(jcfg, jax.random.PRNGKey(1))
    jb, tb = _batch(jcfg, 2, 24, 0)
    jl, _ = j_train_step._loss_fn(jcfg, jt, jparams, jb)
    seen = []
    chunked = tcm.attention_chunked

    def spy(*a, **kw):
        seen.append(kw["pv_bf16"])
        return chunked(*a, **kw)
    monkeypatch.setattr(tcm, "attention_chunked", spy)
    tl, _, _ = ts.value_and_grad(tcfg, ts.TrainConfig(loss_chunk=16),
                                 params_from_jax(_np_tree(jparams)), tb)
    _close(tl, jl, 1e-5 * abs(float(jl)))
    assert seen and all(seen)


@pytest.mark.parametrize("flags", [dict(causal=True),
                                   dict(causal=True, window=8, softcap=4.0),
                                   dict(causal=False, q_start=3)],
                         ids=["causal", "window-softcap", "q_start"])
def test_attn_pv_bf16_grads_match_jax(flags):
    """The chunked attention with ``pv_bf16`` on the inputs of
    ``test_torch_attention.py``'s pv_bf16 test: output and dq, dk within
    its limit, 1e-5 of max, against the reference's.  Both packages round
    dv to bf16 (the backward of V's cast), so a sum taken in another
    order can move an element of dv by one bf16 rounding: dv is held to
    2^-8 of its max."""
    from repro.models import common as jcm
    from repro_torch.models import common as tcm
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 4, 37, 16), (2, 2, 37, 16), (2, 2, 37, 16)))
    g = np.random.default_rng(13).standard_normal(q.shape).astype(
        np.float32)
    kw = dict(sm_scale=0.25, chunk=16, **flags)

    def jf(q, k, v):
        out = jcm.attention_xla_chunked(q, k, v, pv_bf16=True, **kw)
        return jnp.sum(out * g), out
    (_, jout), (jq, jk, jv) = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tcm.attention_chunked(tq, tk, tv, pv_bf16=True, **kw)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    _leaf_close([out.detach(), dq, dk], [jout, jq, jk], 1e-5)
    _leaf_close([dv], [jv], 2.0 ** -8)
    with torch.no_grad():
        out32 = tcm.attention_chunked(tq, tk, tv, **kw)
        assert float((out - out32).abs().max()) > 1e-4 * float(
            out32.abs().max())


def _chunked_attention_grads(q, k, v, g, chunk):
    from repro_torch.models import common as tcm
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = tcm.attention_chunked(tq, tk, tv, sm_scale=0.25, chunk=chunk,
                                causal=True, window=40, softcap=4.0)
    return [out.detach(), *torch.autograd.grad(out, (tq, tk, tv), g)]


def _no_checkpoint(fn, *args, use_reentrant):
    return fn(*args)


def _qkv_g(sk, seed=14):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((2, 4, 24, 8), (2, 2, sk, 8),
                                   (2, 2, sk, 8)))
    return q, k, v, torch.randn(q.shape, generator=torch.Generator()
                                .manual_seed(seed))


def test_attention_chunk_remat_changes_no_bit(monkeypatch):
    """Each KV chunk step under ``checkpoint`` (as the reference remats its
    scan body): output and gradients equal the step without it, bit for
    bit."""
    from repro_torch.models import common as tcm
    q, k, v, g = _qkv_g(70)
    ours = _chunked_attention_grads(q, k, v, g, chunk=16)
    monkeypatch.setattr(tcm, "checkpoint", _no_checkpoint)
    plain = _chunked_attention_grads(q, k, v, g, chunk=16)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


def test_attention_chunk_remat_saves_no_score_blocks(monkeypatch):
    """What autograd saves for the chunked attention's backward grows with
    the number of KV chunks by each step's carry alone (the running max,
    sum and accumulator, which the checkpointed step keeps as its
    inputs, beside views of K and V): no chunk's (B, H, Sq, chunk) score
    or probability block is kept.  Without the checkpoint each chunk adds
    more than two score blocks.  Bytes of distinct storages, q, k and v's
    own left out."""
    from repro_torch.models import common as tcm

    def saved_bytes(n_chunks):
        q, k, v, _ = _qkv_g(16 * n_chunks)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        own = {x.untyped_storage().data_ptr() for x in (q, k, v)}
        storages = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in own:
                storages[st.data_ptr()] = st.nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tcm.attention_chunked(q, k, v, sm_scale=0.25, chunk=16)
        return sum(storages.values())

    rows = 2 * 24                                 # GQA group x Sq
    carry = 2 * 2 * rows * (1 + 1 + 8) * 4        # m, l, acc: fp32
    block = 2 * 2 * rows * 16 * 4                 # (B, H, Sq, chunk)
    assert saved_bytes(6) - saved_bytes(2) <= 4 * carry
    monkeypatch.setattr(tcm, "checkpoint", _no_checkpoint)
    assert saved_bytes(6) - saved_bytes(2) > 4 * 2 * block


def test_microbatches_equal_one_batch():
    _, tcfg = _train_cfgs("yi-6b", remat="none")
    params = family_module(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    _, batch = _batch(tcfg, 4, 16, 3)
    outs = []
    for n in (1, 4):
        p = tree.tree_map(torch.clone, params)
        t = ts.TrainConfig(microbatches=n, loss_chunk=8,
                           optimizer=adamw.AdamWConfig(warmup_steps=0))
        p, _, m, _ = ts.make_train_step(tcfg, t)(p, adamw.init(t.optimizer, p),
                                                 batch)
        outs.append((m, p))
    (m1, p1), (m4, p4) = outs
    _close(m4["loss"], m1["loss"], 1e-5 * float(m1["loss"]))
    for a, b in zip(tree.leaves(p1), tree.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=1e-5)


def _grads_by_remat(arch, remats, **kw):
    out = []
    for remat in remats:
        _, tcfg = _train_cfgs(arch, remat=remat, **kw)
        params = family_module(tcfg).init(tcfg,
                                          torch.Generator().manual_seed(0))
        _, batch = _batch(tcfg, 2, 20, 4)
        out.append(ts.value_and_grad(tcfg, ts.TrainConfig(loss_chunk=8),
                                     params, batch))
    return out


def _bit_for_bit(a, b):
    (l0, _, g0), (l1, _, g1) = a, b
    assert torch.equal(l0, l1)
    for x, y in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(x, y)


def test_remat_full_gives_the_grads_of_none_bit_for_bit():
    _bit_for_bit(*_grads_by_remat("gemma2-2b", ("none", "full")))


@pytest.mark.parametrize("arch", ["gemma2-2b", "yi-6b", "olmoe-1b-7b",
                                  "recurrentgemma-2b", "rwkv6-7b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("route", ["kernel", "torch"])
def test_remat_dots_gives_the_grads_of_none_bit_for_bit(arch, route):
    """``"dots"`` keeps K1's outputs (the kernel route) or aten's 2-D
    products (the torch route) and recomputes the rest: the gradients of
    ``"none"``, bit for bit, on both matmul routes."""
    from repro_torch import backend
    prev = backend.set_default_matmul_backend(route)
    try:
        _bit_for_bit(*_grads_by_remat(arch, ("none", "dots")))
    finally:
        backend.set_default_matmul_backend(prev)


def test_remat_dots_replays_what_the_forward_kept(monkeypatch):
    """The recompute of a ``"dots"`` block launches no K1 forward: the
    selective checkpoint keeps the op's output (K1's backward still
    recomputes a non-linear epilogue's accumulator), and the gradients
    are those of the block run without remat."""
    _, cfg = _train_cfgs("yi-6b", remat="dots")
    g = torch.Generator().manual_seed(3)
    a = torch.randn(4, 8, generator=g)
    w1 = torch.randn(8, 6, generator=g)
    w2 = torch.randn(6, 5, generator=g)
    from repro_torch.core.fusion import linear
    from repro_torch.models import common as cm

    def block(a, w1, w2):
        return linear(torch.tanh(linear(a, w1, backend="kernel")), w2,
                      activation="silu", backend="kernel")
    count = _Counting(monkeypatch)
    grads = []
    for run in (block, lambda *x: cm.remat(cfg, block, *x)):
        leaves = [t.clone().requires_grad_() for t in (a, w1, w2)]
        before = count.calls
        out = run(*leaves)
        assert count.calls - before == 2
        grads.append(torch.autograd.grad(out.square().sum(), leaves))
        # the silu projection's accumulator recompute, and no forward
        assert count.calls - before == 3
    for x, y in zip(*grads):
        assert torch.equal(x, y)


@pytest.mark.parametrize("remat,per_layer", [("full", 13), ("none", 7),
                                             ("dots", 7)])
def test_k1_calls_in_a_train_step(remat, per_layer, monkeypatch):
    """K1's calls in one step of yi-6b (GLU silu MLP), as ``chip_smoke.py``
    reckons its launches: per layer and microbatch 6 forward, 6 more when
    remat "full" reruns the layer ("dots" keeps them), 1 accumulator
    recompute in the GLU projection's backward (the others' epilogues are
    linear in it); the loss 2 a chunk (its forward and its per-chunk
    remat)."""
    _, tcfg = _train_cfgs("yi-6b", remat=remat)
    params = family_module(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    _, batch = _batch(tcfg, 4, 16, 5)
    t = ts.TrainConfig(microbatches=2, loss_chunk=8)
    step = ts.make_train_step(tcfg, t)
    opt = adamw.init(t.optimizer, params)
    count = _Counting(monkeypatch)
    step(params, opt, batch)
    chunks = 16 // 8
    assert count.calls == 2 * (tcfg.n_layers * per_layer + 2 * chunks)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b", "olmoe-1b-7b",
                                  "arctic-480b", "recurrentgemma-2b",
                                  "rwkv6-7b", "whisper-tiny"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_chip_smoke_reckons_k1_calls_of_every_family(arch, remat,
                                                     monkeypatch):
    """``chip_smoke.py::_train_k1_calls``, the count its train phases hold
    the card's K1 launches to, against K1's calls in one reduced step of
    each family (2 microbatches, 2 loss chunks)."""
    _, tcfg = _train_cfgs(arch, remat=remat)
    params = family_module(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    _, batch = _batch(tcfg, 4, 16, 5)
    t = ts.TrainConfig(microbatches=2, loss_chunk=8)
    step = ts.make_train_step(tcfg, t)
    opt = adamw.init(t.optimizer, params)
    count = _Counting(monkeypatch)
    step(params, opt, batch)
    assert count.calls == 2 * _chip_smoke()._train_k1_calls(tcfg, 2)


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-7b"])
def test_chip_smoke_exact_products_take_the_products_of_linear(arch):
    """``chip_smoke.py::exact_products``, phase train-parity's yardstick:
    under it the torch route takes the products of ``linear`` in fp64
    (a reduced step takes some), the gradients stay within 1e-4 of each
    leaf's max of the fp32 step's, and leaving it restores the fp32
    products."""
    from repro_torch import backend
    from repro_torch.core import fusion
    smoke = _chip_smoke()
    _, tcfg = _train_cfgs(arch, remat="none")
    params = family_module(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    _, batch = _batch(tcfg, 2, 16, 7)
    t = ts.TrainConfig(loss_chunk=8)
    plain = fusion.plain_matmul
    prev = backend.set_default_matmul_backend("torch")
    try:
        _, _, g32 = ts.value_and_grad(tcfg, t, params, batch)
        with smoke.exact_products() as taken:
            _, _, g64 = ts.value_and_grad(tcfg, t, params, batch)
    finally:
        backend.set_default_matmul_backend(prev)
    assert taken[0] > 0 and fusion.plain_matmul is plain
    for a, b in zip(tree.leaves(g32), tree.leaves(g64)):
        _close(a, b, 1e-4 * b.abs().max().item())
    assert any(not torch.equal(a, b)
               for a, b in zip(tree.leaves(g32), tree.leaves(g64)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_arch_takes_a_train_step(arch):
    """``make_train_step`` builds for every arch, and one reduced step
    moves the parameters with a finite loss and gradient norm, as the
    reference's ``tests/test_models.py`` holds its own."""
    _, tcfg = _train_cfgs(arch, remat="none")
    params = family_module(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    before = [x.clone() for x in tree.leaves(params)]
    _, batch = _batch(tcfg, 2, 16, 6)
    t = ts.TrainConfig(loss_chunk=8)
    params, _, metrics, _ = ts.make_train_step(tcfg, t)(
        params, adamw.init(t.optimizer, params), batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert any(not torch.allclose(a, b)
               for a, b in zip(before, tree.leaves(params)))


def test_abstract_state_allocates_nothing():
    tcfg = get_config("yi-6b")
    params, opt = ts.abstract_state(tcfg, ts.TrainConfig())
    leaves = tree.leaves((params, opt))
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in tree.leaves(params)) == 6_061_035_520
    assert opt["master"]["embedding"].dtype == torch.float32
    assert dataclasses.is_dataclass(ts.TrainConfig())
