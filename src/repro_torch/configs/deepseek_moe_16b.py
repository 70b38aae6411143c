"""DeepSeekMoE-16B [arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16) vocab=102400; fine-grained MoE: 2 shared +
64 routed experts (top-6), expert dim 1408; layer 0 is a dense FFN
(intermediate 10944) per the released config.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, d_head=128,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="rope", rope_theta=1e4, tie_embeddings=False,
    moe=MoEConfig(n_routed=64, top_k=6, d_expert=1408, n_shared=2,
                  first_moe_layer=1, dense_d_ff=10944),
)

SMOKE = ArchConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab=128, d_head=16,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="rope", tie_embeddings=False,
    moe=MoEConfig(n_routed=8, top_k=2, d_expert=32, n_shared=2,
                  first_moe_layer=1, dense_d_ff=128),
)
