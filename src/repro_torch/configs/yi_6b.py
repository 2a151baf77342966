"""yi-6b [dense]: 32L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Llama architecture with GQA; Yi uses a 5M RoPE base.  [arXiv:2403.04652; hf]
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="transformer",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
    mlp_activation="silu",
    mlp_glu=True,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512, attn_chunk=32)
