"""Unified model API: ``build_model(cfg, device, train)`` -> init / loss /
prefill / init_cache / decode_step.

Counterpart of ``src/repro/models/model.py``; the encoder-decoder family is
not ported yet.  The model runs on ``device``, the card unless the caller
asks for the CPU; asking for a CUDA device without one raises.  ``loss``,
``prefill`` and ``decode_step`` take ``use_kernel`` (default True); False
runs the plain versions of the kernels, with or without a ``dist``.
``train=True`` makes ``init`` return trainable parameters with f32 masters
of the expert stacks (``transformer.LM``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.registry import ModelConfig
from ..launch.mesh import resolve_device
from . import transformer

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]  # gen -> LM module
    # (params, batch, dist, use_kernel) -> (loss, metrics)
    loss: Callable[..., Any]
    # (params, batch, dist, cache_len, use_kernel)
    prefill: Callable[..., Any]
    init_cache: Callable[..., Any]    # (batch, seq_len) -> cache
    # (params, cache, tokens, pos, dist, use_kernel)
    decode_step: Callable[..., Any]


def build_model(cfg: ModelConfig, device="cuda", train: bool = False
                ) -> Model:
    if cfg.encdec:
        raise NotImplementedError(
            "the encoder-decoder family is not ported to PyTorch yet: "
            "ROADMAP.md Queue 1, item 4 (dense, ssm and encdec stacks)")
    transformer.layer_kinds(cfg)  # raises for block kinds not ported yet
    dev = resolve_device(device)
    return Model(
        cfg=cfg,
        init=lambda gen: transformer.init_lm(gen, cfg, dev, train),
        loss=lambda params, batch, dist=None, use_kernel=True:
            transformer.lm_loss(cfg, params, batch, dist, use_kernel),
        prefill=lambda params, batch, dist=None, cache_len=None,
        use_kernel=True: transformer.lm_prefill(
            cfg, params, batch["tokens"], batch, dist, cache_len=cache_len,
            use_kernel=use_kernel),
        init_cache=lambda batch, seq_len: transformer.init_decode_cache(
            cfg, batch, seq_len, dev),
        decode_step=lambda params, cache, tokens, pos, dist=None,
        use_kernel=True: transformer.lm_decode_step(
            cfg, params, cache, tokens, pos, dist, use_kernel=use_kernel),
    )
