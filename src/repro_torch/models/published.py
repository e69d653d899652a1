"""Published details of registered architectures that ``ModelConfig``
cannot state.

``configs/`` holds the reference's configuration files byte for byte, so a
detail of a published model that they have no field for lives here, keyed
by the registered name; a smoke config (``<name>-smoke``) takes its full
model's value.

- ``clip_qkv``: q, k and v are clamped to ``[-clip, clip]`` right after
  their projections, before any norm and RoPE (DBRX's ``attn_config.clip_qkv``,
  hf ``databricks/dbrx-base``).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["CLIP_QKV", "clip_qkv"]

CLIP_QKV = {"dbrx-132b": 8.0}


def clip_qkv(name: str) -> Optional[float]:
    """The bound on the projected q, k and v of architecture ``name``, or
    None where its published model clamps nothing."""
    return CLIP_QKV.get(name.removesuffix("-smoke"))
