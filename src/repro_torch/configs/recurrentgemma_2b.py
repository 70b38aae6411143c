"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.  RG-LRU recurrent
blocks : local attention in 2:1 ratio, window 2048.  Sub-quadratic ->
runs the long_500k shape cell.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, d_head=256,
    block_pattern=("rglru", "rglru", "attn_local"), attn_window=2048,
    norm="rmsnorm", act="geglu", pos="rope", rope_theta=1e4,
    tie_embeddings=True, lru_width=2560, conv1d_width=4,
    max_train_seq=1 << 20,
)

SMOKE = ArchConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=128, d_head=16,
    block_pattern=("rglru", "rglru", "attn_local"), attn_window=16,
    norm="rmsnorm", act="geglu", pos="rope",
    tie_embeddings=True, lru_width=64, conv1d_width=4,
    max_train_seq=1 << 20,
)
