"""One OS process per rank: join a ``torch.distributed`` world as a
``ProcessMesh`` (``init_process_mesh``) or start one process per rank and
run a function in each (``spawn``).

The JAX package is single-controller and has no counterpart: there one
program drives every device of the mesh.  Here each rank is a process that
holds only its own shard of the state, and the exchanges of
``launch/mesh.py`` go over process groups.

``backend`` is always explicit:

* ``"nccl"``: the exchange stays on the card.  NCCL refuses two ranks on
  one GPU, so ``init_process_mesh`` raises when the ranks on this host
  outnumber its cards.
* ``"gloo"``: the exchange goes through host memory.  A CUDA tensor is
  staged through pinned host memory inside each collective (gloo's
  transport is the host); this is the backend's named transport, not a
  fallback from a failed NCCL.  Several ranks may share one card.

Every group of the mesh is created at start-up, by every rank in the same
order (creating a group is collective over the whole world).  The timeout
(60 s by default, where gloo's own is 30 minutes) makes a mismatched or
abandoned collective raise instead of hanging the run.  Under ``torchrun``
(``RANK`` and ``WORLD_SIZE`` in the environment) ``spawn`` starts nothing
and runs the function in this process.

    def work(mesh, x):
        return mesh.rank, x.sum().item()
    spawn(work, (2, 2, 1), ("pod", "data", "model"), "gloo", "cpu",
          torch.ones(3))
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as torch_dist

from .mesh import ProcessMesh, resolve_device

__all__ = ["DEFAULT_TIMEOUT_S", "RENDEZVOUS_TIMEOUT_S", "init_process_mesh",
           "spawn", "spawn_with_handoff", "file_rendezvous",
           "under_torchrun", "stop_fork_server"]

DEFAULT_TIMEOUT_S = 60.0
# the processes' rendezvous may wait longer than a collective: a rank can be
# slow to start (its imports, its CUDA context) on a busy host
RENDEZVOUS_TIMEOUT_S = 300.0


@contextlib.contextmanager
def file_rendezvous():
    """A ``file://`` init method in a fresh temporary directory, removed on
    exit: unlike a TCP port picked ahead of time, no other process on the
    host can take it before the world binds it."""
    root = tempfile.mkdtemp(prefix="procs-rdv-")
    try:
        yield f"file://{os.path.join(root, 'store')}"
    finally:
        shutil.rmtree(root, ignore_errors=True)


def under_torchrun() -> bool:
    """Whether ``torchrun`` started this process as one rank (``RANK`` and
    ``WORLD_SIZE`` in the environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _member_sets(shape: Tuple[int, ...]):
    """Every group of the mesh, as sorted world ranks: for each set of axes
    (by size, then mesh order) the ranks sharing every other coordinate.
    The same sequence on every rank."""
    n = len(shape)
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    for k in range(1, n + 1):
        for axes in itertools.combinations(range(n), k):
            rest = [a for a in range(n) if a not in axes]
            moved = np.transpose(ranks, rest + list(axes))
            for row in moved.reshape(-1, int(np.prod(
                    [shape[a] for a in axes]))):
                yield tuple(sorted(int(v) for v in row))


def init_process_mesh(shape: Sequence[int], axes: Sequence[str],
                      backend: str, device: Union[str, torch.device] = "cuda",
                      init_method: Optional[str] = None, *,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """Join this process to the world of ``prod(shape)`` ranks and return
    its ``ProcessMesh``.

    ``rank`` and ``world_size`` default to the environment's ``RANK`` and
    ``WORLD_SIZE`` (``torchrun``), ``init_method`` to ``env://``.  On
    ``cuda`` the process takes card ``LOCAL_RANK`` (default: the rank)
    under NCCL, which raises when the ranks on this host
    (``LOCAL_WORLD_SIZE``, default the world) outnumber the cards, and
    card ``LOCAL_RANK % device_count`` under gloo.  ``timeout`` (seconds)
    bounds every collective (each runs on a group created with it; the
    rendezvous waits up to ``RENDEZVOUS_TIMEOUT_S``)."""
    shape = tuple(int(v) for v in shape)
    axes = tuple(axes)
    world = int(np.prod(shape))
    if len(shape) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"bad mesh shape {shape} for axes {axes}")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ.get("WORLD_SIZE", world)) \
        if world_size is None else int(world_size)
    if world_size != world:
        raise ValueError(f"world of {world_size} processes for a mesh of "
                         f"{world} ranks {shape}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: pick 'gloo' or 'nccl'")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        n_dev = torch.cuda.device_count()
        if backend == "nccl":
            on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            if on_host > n_dev:
                raise ValueError(
                    f"nccl: {on_host} ranks on this host would share its "
                    f"{n_dev} GPU(s), and NCCL refuses two ranks on one "
                    f"GPU; use backend='gloo' to share a card")
            dev = torch.device("cuda", local)
        elif dev.index is None:
            dev = torch.device("cuda", local % n_dev)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("nccl moves CUDA tensors only; use backend='gloo' "
                         "on the CPU")
    td = datetime.timedelta(seconds=float(timeout))
    torch_dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(
            seconds=max(float(timeout), RENDEZVOUS_TIMEOUT_S)))
    groups = {}
    for members in _member_sets(shape):
        if members in groups or (len(members) == 1 and world > 1):
            continue
        groups[members] = torch_dist.new_group(list(members), timeout=td,
                                               backend=backend)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    return ProcessMesh(shape=shape, axis_names=axes, device=dev, rank=rank,
                       backend=backend, root_shape=shape, root_axes=axes,
                       root_coords=coords, groups=groups)


def _context():
    """The multiprocessing context of every process ``spawn`` starts: a
    fork server that has imported torch once, and ``torch._dynamo``,
    which the first operation on the ``meta`` device imports
    (``convert.shard_module`` builds its module there), so that no child
    imports either: on an 8-core host with one H100 the last of 16
    processes held its shard 35 to 42 s after the start when each
    imported them, about 5 s now (``chip_smoke.py``, phase 14).  The
    server never touches CUDA, so its children may."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed",
                                "torch._dynamo", "numpy"])
    return ctx


def stop_fork_server() -> None:
    """Stop the fork server of ``spawn``'s processes, if one runs (it
    would end with this process)."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


def _child(index: int, fn: Callable, shape, axes, backend, device,
           init_method, timeout, args, queue, env) -> None:
    """One rank: take the parent's environment ``env`` as it was at the
    start (a fork server's own dates from its first start), the CUDA
    allocator's settings included, join the world, run ``fn(mesh,
    *args)`` and send its result (pickled by value) to the parent.  On the CPU each rank takes an equal share of the
    host's cores for its own threads."""
    os.environ.clear()
    os.environ.update(env)
    conf = env.get("PYTORCH_CUDA_ALLOC_CONF")
    if conf and torch.cuda.is_available():
        # the server's import of torch read the allocator's settings from
        # its own environment; this process's allocate nothing yet
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(conf)
    world = int(np.prod(shape))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    mesh = init_process_mesh(shape, axes, backend, device, init_method,
                             rank=index, world_size=world,
                             timeout=timeout)
    try:
        out = fn(mesh, *args)
        queue.put(pickle.dumps((index, out)))
    finally:
        torch_dist.destroy_process_group()


def spawn(fn: Callable[..., Any], shape: Sequence[int], axes: Sequence[str],
          backend: str, device: Union[str, torch.device] = "cuda", *args,
          init_method: Optional[str] = None,
          timeout: float = DEFAULT_TIMEOUT_S,
          join_timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` in one process per rank of ``shape`` and
    return the results by rank.

    The processes start from a fork server that has imported torch
    (``_context``; never a fork of this process: they use CUDA), each
    with this process's environment as it is at the call, so ``fn`` must
    be importable and ``args`` picklable; CUDA
    tensors among them reach the children through CUDA IPC and CPU tensors
    through shared memory, without a copy.  A result is pickled by value:
    return host tensors or numpy.  ``init_method`` defaults to a ``file://``
    store in a fresh temporary directory (``file_rendezvous``).  A child
    that raises or exits non-zero fails the call (its traceback in the
    exception), and so does a run past ``join_timeout`` seconds.  Under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set) it runs ``fn`` in this process only and returns
    ``[its result]``."""
    shape = tuple(int(v) for v in shape)
    if under_torchrun():
        mesh = init_process_mesh(shape, axes, backend, device, init_method,
                                 timeout=timeout)
        try:
            return [fn(mesh, *args)]
        finally:
            torch_dist.destroy_process_group()
    if init_method is None:
        with file_rendezvous() as rdv:
            return spawn(fn, shape, axes, backend, device, *args,
                         init_method=rdv, timeout=timeout,
                         join_timeout=join_timeout)
    import torch.multiprocessing as tmp

    world = int(np.prod(shape))
    queue = _context().SimpleQueue()
    ctx = tmp.start_processes(
        _child, args=(fn, shape, tuple(axes), backend, device, init_method,
                      timeout, args, queue, dict(os.environ)),
        nprocs=world, join=False, start_method="forkserver")
    results = {}
    deadline = None if join_timeout is None else \
        time.monotonic() + join_timeout

    def drain():
        while not queue.empty():
            i, out = pickle.loads(queue.get())
            results[i] = out

    try:
        while not ctx.join(timeout=0.2):
            drain()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawn: the {world} processes ran past "
                                   f"{join_timeout} s")
        drain()
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    missing = sorted(set(range(world)) - set(results))
    if missing:
        raise RuntimeError(f"spawn: ranks {missing} returned no result")
    return [results[i] for i in range(world)]


def _card_used_gb(device: torch.device) -> float:
    """Memory in use on the card by every process (``cudaMemGetInfo``)."""
    free_b, total = torch.cuda.mem_get_info(device)
    return (total - free_b) / 1e9


def spawn_with_handoff(run: Callable[[Any], List[Any]], named: list,
                       world: int, device: Union[str, torch.device]
                       ) -> Tuple[List[Any], dict]:
    """Run ``run(handoff)`` (a ``spawn`` of ``world`` ranks, each of which
    takes its shard of the model in ``named``, a one-element list of
    ``{name: tensor}`` shared with it, then waits on ``handoff`` twice) and
    drop the parent's copy of the model in between: once every rank holds
    its shard (the first wait), the list is emptied (the spawned
    ``Process`` objects keep it alive otherwise) and what the children no
    longer map is freed; then the ranks go on (the second wait).  Returns
    the ranks' results and, on the card, the memory in use (GB) before and
    after the drop."""
    import gc
    import threading

    dev = resolve_device(device)
    handoff = _context().Barrier(1 + world)
    result, used = {}, {}

    def ranks():
        try:
            result["out"] = run(handoff)
        except BaseException as e:  # re-raised below, in this thread
            result["err"] = e
            handoff.abort()

    th = threading.Thread(target=ranks)
    th.start()
    try:
        handoff.wait(timeout=RENDEZVOUS_TIMEOUT_S)
        if dev.type == "cuda":
            used["parent and every shard"] = _card_used_gb(dev)
        named.clear()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.ipc_collect()  # what the children no longer map
            used["shards alone"] = _card_used_gb(dev)
        handoff.wait(timeout=RENDEZVOUS_TIMEOUT_S)
    except threading.BrokenBarrierError:
        pass  # a child failed: its error is raised below
    finally:
        th.join()
    if "err" in result:
        raise result["err"]
    if "out" not in result:
        raise RuntimeError("the hand-off barrier broke")
    return result["out"], used
