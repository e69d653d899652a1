"""Unified model API: ``build_model(cfg, device, train)`` -> init / loss /
prefill / init_cache / decode_step.

Counterpart of ``src/repro/models/model.py``: every registered arch, the
encoder-decoder family through ``models/encdec.py`` and the rest through
``models/transformer.py``.  The model runs on ``device``, the card unless
the caller asks for the CPU; asking for a CUDA device without one raises.
``loss``, ``prefill`` and ``decode_step`` take ``use_kernel`` (default
True); False runs the plain versions of the kernels, with or without a
``dist``.  ``train=True`` makes ``init`` return trainable parameters with
f32 masters of the expert stacks (``transformer.LM``).

Two quirks of the reference's encoder-decoder surface are kept: its
``prefill`` is the teacher-forced forward and returns ``(logits [B, S, V],
aux)``, no cache (so it refuses a ``cache_len``), and its ``init_cache``
holds zero cross K/V (``encdec.encdec_init_cache`` with ``frames`` and
``params`` fills them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.registry import ModelConfig
from ..launch.mesh import resolve_device
from . import encdec, transformer

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
    dev = resolve_device(device)
    if cfg.encdec:
        def encdec_prefill(params, batch, dist=None, cache_len=None,
                           use_kernel=True):
            if cache_len is not None:
                raise ValueError(
                    "an encoder-decoder prefill is the teacher-forced "
                    "forward and returns no cache, so it takes no "
                    "cache_len; build the decode cache with "
                    "encdec.encdec_init_cache(cfg, batch, seq_len, frames, "
                    "params)")
            return encdec.encdec_forward(cfg, params, batch["tokens"], batch,
                                         dist, use_kernel)

        return Model(
            cfg=cfg,
            init=lambda gen: encdec.init_encdec(gen, cfg, dev, train),
            loss=lambda params, batch, dist=None, use_kernel=True:
                encdec.encdec_loss(cfg, params, batch, dist, use_kernel),
            prefill=encdec_prefill,
            init_cache=lambda batch, seq_len: encdec.encdec_init_cache(
                cfg, batch, seq_len, device=dev),
            decode_step=lambda params, cache, tokens, pos, dist=None,
            use_kernel=True: encdec.encdec_decode_step(
                cfg, params, cache, tokens, pos, dist, use_kernel=use_kernel),
        )
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
