"""Unified model API: ``build_model(cfg, device, train)`` -> init / loss /
prefill / init_cache / decode_step.

Counterpart of ``src/repro/models/model.py``: every registered arch, the
encoder-decoder family through ``models/encdec.py`` and the rest through
``models/transformer.py``.  The model runs on ``device``, the card unless
the caller asks for the CPU; asking for a CUDA device without one raises.
``loss``, ``prefill`` and ``decode_step`` take ``use_kernel`` (default
True); False runs the plain versions of the kernels, with or without a
``dist``.  ``train=True`` makes ``init`` return trainable parameters with
f32 masters of the expert stacks (``transformer.LM``).  Every family takes
the ``dist`` of a ``ProcessMesh`` with TP over "model" (the encoder-decoder
since the cut through a query head: ``models/encdec.py``; the recurrent
and hybrid families since their TP slice, ``models/ssm.py``) or with
``pure_dp`` (weights whole, the batch over every axis), with sequence
parallelism and FSDP too (``models/tp.py``, ``models/fsdp.py``).

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

__all__ = ["Model", "build_model", "input_specs"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]  # gen -> LM module
    # (params, batch, dist, use_kernel) -> (loss, metrics)
    loss: Callable[..., Any]
    # (params, batch, dist, cache_len, use_kernel)
    prefill: Callable[..., Any]
    # (batch, seq_len[, params, dist]) -> cache (a TP shard's, with them)
    init_cache: Callable[..., Any]
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
        init_cache=lambda batch, seq_len, params=None, dist=None:
            transformer.init_decode_cache(cfg, batch, seq_len, dev, params,
                                          dist),
        decode_step=lambda params, cache, tokens, pos, dist=None,
        use_kernel=True: transformer.lm_decode_step(
            cfg, params, cache, tokens, pos, dist, use_kernel=use_kernel),
    )


def input_specs(cfg: ModelConfig, kind: str, seq_len: int,
                global_batch: int) -> dict:
    """Meta-tensor stand-ins for every model input of a shape cell (the
    reference's ``ShapeDtypeStruct`` ones): shapes and dtypes, no memory.
    ``decode`` kinds return the *step* inputs (tokens + pos); the cache is
    built separately with ``Model.init_cache`` (on ``device="meta"`` for
    its shapes alone)."""
    compute = getattr(torch, cfg.compute_dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    b, s = global_batch, seq_len
    if kind in ("train", "prefill"):
        batch = {"tokens": meta((b, s), torch.int32),
                 "labels": meta((b, s), torch.int32)}
        if cfg.frontend == "vision_stub":
            batch["patch_embeds"] = meta((b, cfg.frontend_len, cfg.d_model),
                                         compute)
        if cfg.frontend == "audio_stub":
            batch["frames"] = meta((b, cfg.encoder_len, cfg.d_model),
                                   compute)
        return batch
    if kind == "decode":
        return {"tokens": meta((b,), torch.int32),
                "pos": meta((), torch.int32)}
    raise ValueError(f"unknown shape kind {kind!r}")
