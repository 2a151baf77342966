"""gemma2-2b [dense]: 26L d=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local(4096)+global alternating attention, attn softcap 50, final logit
softcap 30, GeGLU, sandwich RMSNorms with unit offset, tied & scaled
embeddings.  [arXiv:2408.00118; hf]
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="transformer",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    window=4096,
    layer_pattern="gemma2_alt",
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=256 ** -0.5,
    mlp_activation="gelu_tanh",
    mlp_glu=True,
    sandwich_norms=True,
    rmsnorm_unit_offset=True,
    embed_scale=True,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    """Smoke-test config: same family wiring, tiny dims."""
    return CONFIG.with_(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512, window=16,
                        attn_chunk=32)
