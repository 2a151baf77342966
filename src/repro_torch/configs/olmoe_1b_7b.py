"""olmoe-1b-7b [moe]: 16L d=2048 16H d_ff=1024/expert, 64 experts top-8.

QK-norm attention; router keeps raw softmax top-8 weights (no renorm).
vocab 50304.  [arXiv:2409.02060; hf]
"""

from repro_torch.models.base import ArchConfig, MoeConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="transformer",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    mlp_activation="silu",
    mlp_glu=True,
    moe=MoeConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                  capacity_factor=1.25, renormalize=False),
)


def reduced() -> ArchConfig:
    # capacity_factor = E/top_k: zero dropping, so prefill/decode/forward
    # are exactly consistent in the smoke tests.
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=16, d_ff=64, vocab_size=512, attn_chunk=32,
                        moe=MoeConfig(n_experts=8, top_k=2, d_ff_expert=64,
                                      capacity_factor=4.0,
                                      renormalize=False))
