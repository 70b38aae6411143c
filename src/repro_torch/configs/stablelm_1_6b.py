"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (kv=32, MHA) d_ff=5632 vocab=100352.  LayerNorm,
partial rotary (25% of head dim).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, d_head=64,
    block_pattern=("attn",), norm="layernorm", act="swiglu",
    pos="rope", rope_theta=1e4, rope_fraction=0.25,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="stablelm-1.6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=128, d_head=16,
    block_pattern=("attn",), norm="layernorm", act="swiglu",
    pos="rope", rope_fraction=0.25, tie_embeddings=False,
)
