"""Qwen2-0.5B [arXiv:2407.10671; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.  GQA with QKV bias,
tied embeddings.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, d_head=64,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="rope", rope_theta=1e6, qkv_bias=True, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen2-0.5b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=128, d_head=16,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="rope", rope_theta=1e6, qkv_bias=True, tie_embeddings=True,
)
