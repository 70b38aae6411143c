"""ArchConfig: the composable model-definition config.

Block types (``block_pattern`` entries, applied cyclically over layers):
  "attn"        global causal self-attention (+FFN)
  "attn_local"  sliding-window causal self-attention (+FFN)
  "rglru"       Griffin/RecurrentGemma RG-LRU recurrent block (+FFN)
  "mlstm"       xLSTM matrix-LSTM block (self-contained, no FFN)
  "slstm"       xLSTM scalar-LSTM block (self-contained, no FFN)

``family`` tags drive shape-cell applicability (DESIGN.md §4):
  dense | moe | hybrid | ssm | encdec | vlm
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # layers before this index use the dense FFN (DeepSeekMoE layer 0)
    first_moe_layer: int = 0
    dense_d_ff: int = 0            # d_ff of the dense layers (if any)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | geglu | gelu
    pos: str = "rope"               # rope | mrope | none
    rope_theta: float = 1e4
    rope_fraction: float = 1.0      # stablelm rotates only 25% of d_head
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl (t,h,w) rotary split
    qkv_bias: bool = False
    tie_embeddings: bool = False
    attn_window: int = 0            # sliding window for "attn_local"
    attn_logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    # encoder-decoder (seamless): bidirectional encoder + causal decoder
    n_enc_layers: int = 0
    # recurrent (rglru) params
    lru_width: int = 0              # 0 -> d_model
    conv1d_width: int = 4
    # xLSTM
    n_xlstm_heads: int = 4
    # headwise block-diagonal q/k/v projections (official xLSTM
    # qkv_proj_blocksize); 0 -> dense (du, du)
    xlstm_qkv_blocksize: int = 4
    # modality frontend stub: "tokens" | "embeddings"
    input_mode: str = "tokens"
    compute_dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k applicability)
    max_train_seq: int = 8192

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def sub_quadratic(self) -> bool:
        return all(b in ("rglru", "mlstm", "slstm", "attn_local")
                   for b in self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def pattern_for(self, n_layers: int) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(n_layers))


ARCHS = (
    "qwen2-vl-72b", "recurrentgemma-2b", "qwen2-0.5b", "stablelm-1.6b",
    "smollm-360m", "internlm2-1.8b", "seamless-m4t-large-v2",
    "deepseek-moe-16b", "granite-moe-1b-a400m", "xlstm-1.3b",
)


def _module(name: str):
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return _module(name).SMOKE
