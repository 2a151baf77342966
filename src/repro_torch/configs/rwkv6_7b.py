"""rwkv6-7b [ssm]: 32L d=4096 (attention-free) d_ff=14336 vocab=65536.

Finch — data-dependent per-channel decay, 64 heads of size 64, DDLerp
token-shift, squared-ReLU channel mix.  [arXiv:2404.05892; hf]
"""

from repro_torch.models.base import ArchConfig, RwkvConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="rwkv6",
    n_layers=32,
    d_model=4096,
    n_heads=64,                 # d_model / head_size
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv=RwkvConfig(head_size=64, lora_mix=32, lora_decay=64),
)


def reduced() -> ArchConfig:
    return CONFIG.with_(n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
                        head_dim=32, d_ff=256, vocab_size=512,
                        rwkv=RwkvConfig(head_size=32, lora_mix=8,
                                        lora_decay=8))
