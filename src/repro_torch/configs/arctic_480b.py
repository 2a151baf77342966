"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8), MoE 128e top-2 + dense.

Snowflake Arctic: dense transformer residual in parallel with a
128-expert top-2 MoE (dense-MoE hybrid).  d_ff=4864 per expert; the
parallel dense branch uses the same hidden size (the assignment only
specifies 4864).  vocab 32000.  [hf:Snowflake/snowflake-arctic-base]
"""

from repro_torch.models.base import ArchConfig, MoeConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="transformer",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    mlp_activation="silu",
    mlp_glu=True,
    moe=MoeConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  capacity_factor=1.25, renormalize=True,
                  dense_parallel=True),
)


def reduced() -> ArchConfig:
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=96, vocab_size=512, attn_chunk=32,
                        moe=MoeConfig(n_experts=8, top_k=2, d_ff_expert=96,
                                      capacity_factor=4.0, renormalize=True,
                                      dense_parallel=True))
