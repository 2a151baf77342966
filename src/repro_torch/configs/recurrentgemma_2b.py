"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) d_ff=7680.

Griffin: (rec, rec, local-attn) repeating — RG-LRU recurrent blocks with
short causal conv, local MQA window 2048, GeGLU MLP after every temporal
block, gemma-style unit-offset RMSNorm, tied + scaled embeddings, final
logit softcap 30.  [arXiv:2402.19427; hf]
"""

from repro_torch.models.base import ArchConfig, RnnConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="griffin",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    window=2048,
    final_softcap=30.0,
    mlp_activation="gelu_tanh",
    mlp_glu=True,
    rmsnorm_unit_offset=True,
    embed_scale=True,
    tie_embeddings=True,
    rnn=RnnConfig(d_rnn=2560, conv_width=4),
)


def reduced() -> ArchConfig:
    return CONFIG.with_(n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
                        head_dim=16, d_ff=128, vocab_size=512, window=16,
                        attn_chunk=32, rnn=RnnConfig(d_rnn=64, conv_width=4))
