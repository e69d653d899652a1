"""The one traffic generator: a traffic file's parameters and the run's
seed give every batch, on the device, by its index.

Parameters (``traffic/<name>.json``):

- ``rows``, ``seq_len``: a batch's prompts (or training sequences) and
  their length;
- ``ids``: ``"uniform"`` over the vocabulary (the one law so far);
- ``labels``: true for training, where the labels are the next ids (one
  more id a row is drawn).

Batch ``i`` of seed ``s`` is the same whatever else the run does, so the
reference draws any batch again after the program is freed.
"""

from __future__ import annotations

from typing import Dict

import torch

from .weights import leaf_seed

KNOWN = {"driver", "rows", "seq_len", "ids", "labels", "options"}


def check(traffic: dict) -> dict:
    """Refuse unknown keys and id laws; returns ``traffic``."""
    extra = set(traffic) - KNOWN
    if extra:
        raise ValueError(f"unknown traffic keys {sorted(extra)}")
    if traffic.get("ids", "uniform") != "uniform":
        raise ValueError(f"unknown id law {traffic['ids']!r}")
    if int(traffic["rows"]) < 1 or int(traffic["seq_len"]) < 1:
        raise ValueError("rows and seq_len must be positive")
    return traffic


def _gen(seed: int, what: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, what))
    return gen


def batch(traffic: dict, vocab: int, seed: int, index: int,
          device) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the run seeded ``seed``: ``{"tokens": [rows,
    seq_len]}`` int64, with ``"labels"`` (the next ids) for training."""
    rows, s = int(traffic["rows"]), int(traffic["seq_len"])
    width = s + 1 if traffic.get("labels") else s
    ids = torch.randint(0, vocab, (rows, width),
                        generator=_gen(seed, f"batch:{index}", device),
                        device=device)
    if not traffic.get("labels"):
        return {"tokens": ids}
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}
