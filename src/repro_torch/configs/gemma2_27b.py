"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.

Local+global alternating, softcaps, query scale (d_model/n_heads)^-0.5 =
144^-0.5 (the 27B uses query_pre_attn_scalar=144).  [arXiv:2408.00118; hf]
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="transformer",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    window=4096,
    layer_pattern="gemma2_alt",
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=144.0 ** -0.5,
    mlp_activation="gelu_tanh",
    mlp_glu=True,
    sandwich_norms=True,
    rmsnorm_unit_offset=True,
    embed_scale=True,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512, window=16,
                        attn_chunk=32)
