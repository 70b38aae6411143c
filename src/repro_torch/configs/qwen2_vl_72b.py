"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  M-RoPE with
(t, h, w) rotary sections; dynamic-resolution vision frontend is a STUB per
the assignment — ``input_specs`` feeds precomputed patch/text embeddings.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, d_head=128,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    qkv_bias=True, tie_embeddings=False, input_mode="embeddings",
)

SMOKE = ArchConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=128, d_head=16,
    block_pattern=("attn",), norm="rmsnorm", act="swiglu",
    pos="mrope", mrope_sections=(2, 3, 3), rope_theta=1e6,
    qkv_bias=True, tie_embeddings=False, input_mode="embeddings",
)
