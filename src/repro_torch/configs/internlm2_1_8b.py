"""InternLM2-1.8B [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab=92544, d_head=128,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="rope", rope_theta=1e6, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="internlm2-1.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=128, d_head=16,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="rope", tie_embeddings=False,
)
