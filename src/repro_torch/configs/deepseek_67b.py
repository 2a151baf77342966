"""deepseek-67b [dense]: 95L d=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.

Llama architecture: pre-RMSNorm, SwiGLU, RoPE GQA.  [arXiv:2401.02954; hf]
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="transformer",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=1e4,
    mlp_activation="silu",
    mlp_glu=True,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
                        head_dim=16, d_ff=192, vocab_size=512, attn_chunk=32)
