"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655.

InternViT frontend + Qwen2-0.5B language backbone.  The ViT is a stub:
the caller supplies 256 precomputed patch-token embeddings
(``batch["vision_embeds"]``) that occupy the first positions
(models/transformer.py ``vision_prefix``).  Qwen2 quirks: QKV bias (the paper's
``BiasType=RowRepeat`` epilogue in real use).  Vocab padded 151655→151808
for TP sharding.  [arXiv:2404.16821; hf]
"""

from repro_torch.models.base import ArchConfig

N_IMAGE_TOKENS = 256

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="transformer",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1e6,
    qkv_bias=True,
    mlp_activation="silu",
    mlp_glu=True,
    vision_prefix=N_IMAGE_TOKENS,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512,
                        vision_prefix=8, attn_chunk=32)
