"""Architecture config system.

Every assigned architecture is a frozen ``ModelConfig``; ``register`` /
``get_config`` give the launcher its ``--arch <id>`` surface.  Each arch
module also provides a ``smoke`` reduced config (same family, tiny sizes)
used by per-arch CPU smoke tests; the full config is exercised only through
the dry-run (ShapeDtypeStruct lowering, no allocation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "MoESpec",
    "ModelConfig",
    "register",
    "get_config",
    "list_archs",
    "smoke_config",
]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    capacity_factor: float = 2.0  # per (src shard, expert) padding factor
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    moe: Optional[MoESpec] = None
    qk_norm: bool = False
    swa_window: Optional[int] = None          # sliding-window size (tokens)
    full_attn_layers: Tuple[int, ...] = ()    # layers overriding SWA -> full
    ssm_state: Optional[int] = None
    block_pattern: Optional[Tuple[str, ...]] = None  # xlstm: ("m","s",...)
    frontend: Optional[str] = None            # "vision_stub" | "audio_stub"
    frontend_len: int = 0                     # prefix positions fed by stub
    encdec: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500                   # whisper 30 s of frames
    norm: str = "rmsnorm"                     # rmsnorm | layernorm
    act: str = "silu"                         # silu (SwiGLU) | gelu
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # distribution / execution knobs (overridable per run)
    a2a_impl: str = "flash"                   # flash | direct | hierarchical
    remat: bool = True
    scan_layers: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # beyond-paper perf knobs (see EXPERIMENTS.md §Perf)
    seq_shard_activations: bool = False       # SP residual stream
    quantized_dispatch: bool = False          # int8 MoE a2a over DCN
    bf16_ce: bool = False                     # CE loss without f32 logits
    pure_dp: bool = False                     # no TP: replicate weights,
                                              # batch over every mesh axis
    fsdp: bool = False                        # ZeRO-3: shard params/moments
                                              # over the DP axes too
    remat_group: int = 0                      # two-level remat: outer scan
                                              # over groups of this many
                                              # layers (0 = flat remat)
    microbatches: int = 1                     # grad-accumulation chunks

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode with O(1)-per-token state at 500k context?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.swa_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.act == "silu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = attn
        if self.is_moe:
            per_layer += self.moe.num_experts * mlp + d * self.moe.num_experts
        elif self.family == "ssm":
            per_layer = _xlstm_block_params(self)
        elif self.family == "hybrid":
            per_layer = attn + _mamba_head_params(self) + mlp
        else:
            per_layer += mlp
        total = self.n_layers * per_layer + v * d  # embed
        if not self.tie_embeddings:
            total += v * d  # lm head
        if self.encdec:
            total += self.n_encoder_layers * (attn + mlp)  # encoder stack
            total += self.n_layers * attn                  # cross attention
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f if self.act == "silu" else 2 * d * f
        dense = self.n_params() - self.n_layers * self.moe.num_experts * mlp
        return dense + self.n_layers * self.moe.top_k * mlp


def _xlstm_block_params(cfg: ModelConfig) -> int:
    # qkv + gates + out proj + up/down proj (pf=2 mLSTM block)
    d = cfg.d_model
    return 8 * d * d


def _mamba_head_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    n = cfg.ssm_state or 16
    d_in = 2 * d
    return 2 * d * d_in + d_in * (2 * n + 2) + d_in * d


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str, **overrides) -> ModelConfig:
    _ensure_loaded()
    try:
        cfg = _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; known: {list_archs()}")
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(name: str, **overrides) -> ModelConfig:
    _ensure_loaded()
    cfg = _SMOKE[name]()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        dbrx_132b,
        granite_3_2b,
        hymba_1_5b,
        internvl2_1b,
        llama3_2_1b,
        megatron_moe_32e,
        mistral_large_123b,
        mixtral_8x7b,
        qwen3_0_6b,
        whisper_tiny,
        xlstm_125m,
    )
    _LOADED = True
