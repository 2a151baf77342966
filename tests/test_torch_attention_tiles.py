"""K2's tile rule (``kernels/attention/attention.py::select_tile``) on the
served paths' dtypes, head dims, head counts and strides, and the CPU
wrapper, which runs the plain version whatever the rule would pick on a
card.  The tiles themselves run only on the card
(tests/test_torch_kernels_cuda.py) and, the SIMT tile, in the g++
emulation (tests/test_torch_kernels_emulated.py)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.kernels.attention import attention as attn  # noqa: E402
from repro_torch.kernels.attention import ops                # noqa: E402
from repro_torch.models import common as cm                  # noqa: E402

bf16, fp16, f32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("case,tile", [
    ((bf16, 128, True, [221 * 4096, 128, 4096]), "tc"),
    ((fp16, 64, True, [64, 640, 64]), "tc"),
    ((bf16, 256, True, [221 * 2560, 256, 2560]), "tc"),
    ((f32, 128, True, [128]), "simt"),             # fp32 stays off wgmma
    ((bf16, 32, True, [32]), "simt"),              # a head dim it lacks
    ((bf16, 80, True, [80]), "simt"),              # padded by the SIMT tile
    ((bf16, 512, True, [512]), "simt"),
    ((bf16, 128, False, [128]), "simt"),           # unaligned base
    ((bf16, 128, True, [128, 68]), "simt"),        # stride % 8 elements
    ((bf16, 128, True, [128, 0]), "simt"),         # an expanded dim
    ((bf16, 128, True, []), "tc"),                 # every dim of length 1
], ids=lambda v: "-".join(map(str, v)).replace("torch.", "")
    if isinstance(v, tuple) else v)
def test_select_tile_rule(case, tile):
    assert attn.select_tile(*case) == tile


def _qkv(cfg, seq=5):
    """q, k, v of one attention layer of ``cfg`` as the model makes them
    (``qkv_project``: (B, S, H, D) projections seen as (B, H, S, D), then
    the norms and RoPE the config asks for)."""
    gen = torch.Generator().manual_seed(0)
    p = cm.attn_init(cfg, gen)
    x = torch.randn(2, seq, cfg.d_model, generator=gen).to(cfg.dtype)
    return cm.qkv_project(cfg, p, x, torch.arange(seq))


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b",
                                  "recurrentgemma-2b"])
def test_served_paths_take_the_tensor_core_tile(arch):
    """Every served model's prefill attention (bf16, head_dim 128 or 256,
    GQA 32/4, MHA 16/16 and MQA 10/1) takes the tensor-core tile on the
    views ``qkv_project`` hands it, with no copy; in fp32 the SIMT tile."""
    cfg = get_config(arch)
    q, k, v = _qkv(cfg)
    assert q.shape[1] == cfg.n_heads and k.shape[1] == cfg.n_kv_heads
    assert q.shape[-1] == cfg.head_dim in (128, 256)
    # v at least is the projection's (B, S, Hkv * D) output seen through
    # a transpose, not a copy: one position to the next is kv_dim values
    assert v.stride()[2] == cfg.kv_dim
    assert attn.tile_for(q, k, v) == "tc"
    assert attn.tile_for(*(x.float() for x in (q, k, v))) == "simt"


def test_tile_for_reads_views():
    """``tile_for`` reads pointers and strides, ignoring those of dims of
    length 1, which TMA never steps along."""
    g = torch.Generator().manual_seed(1)
    base = torch.randn(1 + 2 * 4 * 10 * 64, generator=g).to(bf16)
    aligned = base[:-1].view(2, 4, 10, 64)
    assert attn.tile_for(aligned, aligned, aligned) == "tc"
    shifted = base[1:].view(2, 4, 10, 64)                # 2 bytes off
    assert attn.tile_for(shifted, aligned, aligned) == "simt"
    odd = torch.randn(2, 4, 10, 68, generator=g).to(bf16)[..., :64]
    assert attn.tile_for(aligned, odd, odd) == "simt"
    one = torch.as_strided(aligned, (1, 4, 10, 64), (7, 640, 64, 1))
    assert attn.tile_for(one, one, one) == "tc"
    expanded = aligned[:, :1].expand(2, 4, 10, 64)
    assert attn.tile_for(aligned, expanded, expanded) == "simt"


@pytest.mark.parametrize("dt", [bf16, f32], ids=["bf16", "fp32"])
def test_cpu_wrapper_runs_the_plain_version(dt):
    """On CPU tensors the wrapper runs the plain version, whichever tile
    the rule would pick on a card, and counts no launch."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, 70, 128, generator=g).to(dt)
    k, v = (torch.randn(2, 2, 70, 128, generator=g).to(dt) for _ in range(2))
    before = (ops.flash_attention.launches,
              dict(ops.flash_attention.launches_by_tile))
    kw = dict(causal=True, window=20, softcap=5.0, q_start=3)
    out = ops.flash_attention(q, k, v, **kw)
    ref = attn.flash_attention_plain(q, k, v, sm_scale=128 ** -0.5, **kw)
    assert torch.equal(out, ref)
    assert (ops.flash_attention.launches,
            ops.flash_attention.launches_by_tile) == before
    assert set(ops.flash_attention.launches_by_tile) == set(attn.TILES)


@pytest.mark.parametrize("sq,sk", [(0, 9), (9, 0)], ids=["no-query",
                                                         "no-key"])
def test_cuda_entry_launches_nothing_without_work(sq, sk):
    """An empty output or a call without keys needs no kernel: the CUDA
    entry returns zeros and names no tile (so the wrapper counts no
    launch) before it looks for a card or a build."""
    q = torch.randn(1, 2, sq, 128).to(bf16)
    k, v = (torch.randn(1, 1, sk, 128).to(bf16) for _ in range(2))
    out, tile = attn.flash_attention_cuda(q, k, v, sm_scale=1.0,
                                          causal=True, window=0,
                                          softcap=0.0, q_start=0)
    assert tile is None
    assert out.shape == q.shape and out.dtype == bf16
    assert torch.equal(out, torch.zeros_like(out))
