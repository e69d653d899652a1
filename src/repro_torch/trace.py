"""Spans and counters of the port, on while the PyTorch profiler is on.

``span(name)`` is a ``torch.profiler.record_function(name)`` range, which
Kineto writes into the profiler's chrome trace beside the device's events,
on one clock.  With the profiler off it returns one shared null context, so
a span site costs one C call (``torch.autograd._profiler_enabled``) and a
``with`` on nothing.  The gate is that C call and not the Python flag
``torch.autograd.profiler._is_profiler_enabled``, which a profiler stopped
through ``torch.autograd._disable_profiler`` leaves set.

Counters count only while the profiler is on, from zero at import (or at
``reset()``), and not from the start of each profiler window: a process
that traces one window, as the benchmark's ``--trace 1`` run does, reads
exactly that window's work, and one that profiles again (a warm-up, a
check) must call ``reset()`` before the window it reads.  ``count`` adds a
host integer, ``count_sum`` adds a tensor's sum on its device without a
sync, and ``snapshot()`` reads every counter to host numbers (a sync: call
it once the window has closed).

``span(name, syncs=True)`` also counts ``host_syncs``: the host-device
synchronizations within its extent, under ``torch.cuda``'s sync debug
mode ``"warn"``, each a warning caught here (the autograd engine replays a
backward's warnings on the calling thread, so a step's backward counts
too).  The first call sites are kept (``sync_sites()``); the mode and the
warning filters are restored after the span, and other warnings re-issued.

The spans the port opens, and the counters: ``serve.prefill`` and
``train.step`` (a step, with its syncs), ``train.forward_backward``,
``train.grad_sync``, ``train.optimizer`` (AdamW with the norm and the
clip), ``attn`` (an attention block's forward: projections, rope, the
kernel, the output projection), ``moe.route``, ``moe.dispatch``,
``moe.exchange`` (each trip between the dispatch buffer and the expert
grid: the all-to-all with the grid's permutes and copies), ``moe.combine``,
the recurrences' time loops ``ssm_scan``, and the process collectives'
``procmesh.*``; ``moe.pairs_routed`` (each held rank's tokens times top-k),
``moe.pairs_kept`` (the pairs within the experts' capacity),
``moe.grid_rows`` (the rows the grouped FFN runs over: the whole grid, or
the sum of its experts' filled rows where it is told them, as on the local
path, whose kernel skips the rest: there kept over grid rows is 1 by
construction) and ``host_syncs``.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Tuple

import torch

__all__ = ["span", "count", "count_sum", "snapshot", "sync_sites", "reset"]

_on = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
# the text of torch.cuda's sync debug warning
SYNC_WARNING = "called a synchronizing CUDA operation"
# distinct call sites of host syncs kept
MAX_SITES = 16

_host: Dict[str, int] = {}
_device: Dict[Tuple[str, torch.device], torch.Tensor] = {}
_sites: Dict[str, int] = {}


def span(name: str, syncs: bool = False):
    """The profiler range ``name`` while the profiler is on (counting the
    host syncs within it with ``syncs``), else a null context."""
    if not _on():
        return _NULL
    if syncs:
        return _counting_syncs(name)
    return torch.profiler.record_function(name)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name``."""
    if _on():
        _host[name] = _host.get(name, 0) + int(n)


def count_sum(name: str, t: torch.Tensor) -> None:
    """Add ``t``'s sum to counter ``name`` on ``t``'s device, without a
    sync (nothing on ``meta`` tensors)."""
    if not _on() or t.is_meta:
        return
    with torch.no_grad():
        s = t.detach().sum(dtype=torch.int64)
        key = (name, s.device)
        if key in _device:
            _device[key].add_(s)
        else:
            _device[key] = s


def snapshot() -> Dict[str, int]:
    """Every counter, summed over devices, as host integers."""
    out = dict(_host)
    for (name, _), total in _device.items():
        out[name] = out.get(name, 0) + int(total.item())
    return out


def sync_sites() -> Dict[str, int]:
    """The first ``MAX_SITES`` call sites (``file:line``) of the counted
    host syncs, each with its count."""
    return dict(_sites)


def reset() -> None:
    """Every counter and call site back to zero."""
    _host.clear()
    _device.clear()
    _sites.clear()


@contextlib.contextmanager
def _counting_syncs(name: str):
    cuda = torch.cuda.is_available()
    caught: list = []
    try:
        with torch.profiler.record_function(name), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if cuda:
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(mode)
    finally:
        _tally(caught)


def _tally(caught) -> None:
    """Count the sync warnings among ``caught`` and re-issue the others
    (the span's filters restored)."""
    for w in caught:
        if SYNC_WARNING not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno, source=w.source)
            continue
        _host["host_syncs"] = _host.get("host_syncs", 0) + 1
        site = f"{w.filename}:{w.lineno}"
        if site in _sites or len(_sites) < MAX_SITES:
            _sites[site] = _sites.get(site, 0) + 1
