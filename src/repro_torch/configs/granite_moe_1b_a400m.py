"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155; MoE 32 experts top-8,
expert dim 512.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, d_head=64,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="rope", rope_theta=1e4, tie_embeddings=True,
    moe=MoEConfig(n_routed=32, top_k=8, d_expert=512, n_shared=0),
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab=128, d_head=16,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="rope", tie_embeddings=True,
    moe=MoEConfig(n_routed=8, top_k=2, d_expert=32, n_shared=0),
)
