"""whisper-tiny [audio]: 4L enc + 4L dec, d=384 6H d_ff=1536 vocab=51865.

Encoder-decoder; the conv frontend is a STUB (``input_specs()`` provides
precomputed frame embeddings (B, 1500, 384)).  Learned positional
embeddings, pre-LN LayerNorm blocks, GELU MLP (no GLU), tied output
embedding.  Vocab padded 51865→51968.  [arXiv:2212.04356]
"""

from repro_torch.models.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                 # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_activation="gelu",
    mlp_glu=False,
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=4, n_audio_ctx=1500),
)


def reduced() -> ArchConfig:
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=16, d_ff=128, vocab_size=512, attn_chunk=32,
                        encdec=EncDecConfig(n_encoder_layers=2,
                                            n_audio_ctx=24,
                                            max_positions=256))
