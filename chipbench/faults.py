"""Faults planted under the timed path, to show that ``correct`` comes out
false for each fault a cell can have.  Each is a context manager that
patches the program for its duration.

- ``no_exchange``: the exchange between ranks left out (every all-to-all
  returns its input);
- ``pair_skipped``: one pair of ranks left out of the exchange: rank 0
  keeps the rows it would send its first peer in place of those it would
  receive from it, both ways (two requests of a batch of one request a
  rank go wrong, the rest stay right);
- ``half_batch``: half of the batch left out, the rest standing in for it
  (serving: the first half's answers for the second half; training: the
  step's loss and gradient the mean over the first half's rows);
- ``token_altered``: an answer altered where it is produced (serving:
  every request's logits shifted by one vocabulary entry, the head's
  columns off by one; training: each step's loss one percent high);
- ``state_unchanged``: a training step that returns its state unchanged
  (AdamW computes the norm and updates nothing).
"""

from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = ("no_exchange", "pair_skipped", "half_batch", "token_altered",
          "state_unchanged")


@contextlib.contextmanager
def planted(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    import repro_torch.launch.serve as serve
    import repro_torch.launch.train as train
    import repro_torch.models.moe as moe

    patches = []
    if name == "no_exchange":
        real = moe.resolve_all_to_all

        def resolve(*a, **kw):
            a2a = real(*a, **kw)
            return None if a2a is None else (lambda x: x)

        patches.append(mock.patch.object(moe, "resolve_all_to_all",
                                         resolve))
    elif name == "pair_skipped":
        real = moe.resolve_all_to_all

        def resolve(*a, **kw):
            a2a = real(*a, **kw)
            if a2a is None:
                return None

            def skipped(x):
                # x: [ranks held, peers, rows, d], chunk [r, j] for peer j
                y = a2a(x).clone()
                y[0, 1] = x[0, 1]
                return y
            return skipped

        patches.append(mock.patch.object(moe, "resolve_all_to_all",
                                         resolve))
    elif name == "half_batch":
        real_prefill, real_train = serve.make_prefill_step, \
            train.make_train_step

        def make_prefill(*a, **kw):
            step = real_prefill(*a, **kw)

            def half(params, batch):
                n = batch["tokens"].shape[0] // 2
                logits, cache = step(params, {k: v[:n] for k, v in
                                              batch.items()})
                return logits.repeat(2, 1), cache
            return half

        def make_train(*a, **kw):
            step = real_train(*a, **kw)

            def half(state, batch):
                n = batch["tokens"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()})
            return half

        patches += [mock.patch.object(serve, "make_prefill_step",
                                      make_prefill),
                    mock.patch.object(train, "make_train_step", make_train)]
    elif name == "token_altered":
        real_prefill, real_train = serve.make_prefill_step, \
            train.make_train_step

        def make_prefill(*a, **kw):
            step = real_prefill(*a, **kw)

            def altered(params, batch):
                logits, cache = step(params, batch)
                return logits.roll(1, dims=-1), cache
            return altered

        def make_train(*a, **kw):
            step = real_train(*a, **kw)

            def altered(state, batch):
                state, metrics = step(state, batch)
                return state, {**metrics, "loss": metrics["loss"] * 1.01}
            return altered

        patches += [mock.patch.object(serve, "make_prefill_step",
                                      make_prefill),
                    mock.patch.object(train, "make_train_step", make_train)]
    else:
        def unchanged(grads, state, params, lr, cfg, *a, **kw):
            from repro_torch.optim import global_norm

            return params, state, global_norm(grads, *a, **kw)

        patches.append(mock.patch.object(train, "adamw_update", unchanged))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield
