"""SeamlessM4T-large-v2 text backbone [arXiv:2308.11596; hf].

24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
Encoder-decoder with cross-attention.  The speech (w2v-BERT/conformer)
frontend is a STUB per the assignment: ``input_specs`` provides precomputed
frame embeddings to the encoder.  Adaptation note (DESIGN.md): the original
uses sinusoidal positions; we use RoPE on self-attention — structurally
equivalent compute.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, d_head=64,
    block_pattern=("attn",), norm="layernorm", act="gelu",
    pos="rope", rope_theta=1e4, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, d_head=16,
    block_pattern=("attn",), norm="layernorm", act="gelu",
    pos="rope", tie_embeddings=True,
)
