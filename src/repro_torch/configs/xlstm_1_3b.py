"""xLSTM-1.3B [arXiv:2405.04517; unverified].

48L d_model=2048, 4 xLSTM heads, vocab=50304, d_ff=0 (blocks are
self-contained).  mLSTM : sLSTM 7:1 interleave (xLSTM[7:1]).
Attention-free -> runs the long_500k shape cell.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, d_head=512,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    norm="layernorm", act="gelu", pos="none",
    tie_embeddings=True, n_xlstm_heads=4, conv1d_width=4,
    max_train_seq=1 << 20,
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
    vocab=128, d_head=32,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    norm="layernorm", act="gelu", pos="none",
    tie_embeddings=True, n_xlstm_heads=2, conv1d_width=4,
    max_train_seq=1 << 20,
)
