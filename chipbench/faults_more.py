"""Faults that ``faults.py`` cannot plant, in the router and the norms,
for the cells whose model has them (DBRX's top-4 routing and LayerNorm).
Each is a context manager that patches the program for its duration;
``planted`` also plants every fault of ``faults.py``.

- ``top_k_halved``: each token served by the first half of its top-k
  choices (top-2 in place of top-4), their gates renormalised to sum to
  1; the other choices are dispatched and weighted 0;
- ``norm_uncentred``: every LayerNorm without its mean subtracted (an
  RMS norm in its place, the bias still added).

Calibration with these runs ``calibrate.py`` through this file:

    python3 chipbench/faults_more.py --workload <cell> --seeds 1,2 \\
        --seconds 2 --fault top_k_halved --no-control
"""

import contextlib
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import faults  # noqa: E402

FAULTS = ("top_k_halved", "norm_uncentred")
# faults.py's own, kept before main() patches faults.planted with ours
_planted = faults.planted


@contextlib.contextmanager
def planted(name: str):
    if name in faults.FAULTS:
        with _planted(name):
            yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: "
                         f"{faults.FAULTS + FAULTS}")
    import torch

    import repro_torch.models.moe as moe
    import repro_torch.models.transformer as transformer

    if name == "top_k_halved":
        real = moe._route

        def halved(cfg, router_w, x_flat):
            gates, eids, aux = real(cfg, router_w, x_flat)
            k = gates.shape[-1] // 2
            kept = gates[..., :k]
            gates = torch.cat([kept / kept.sum(-1, keepdim=True),
                               torch.zeros_like(gates[..., k:])], -1)
            return gates, eids, aux

        patch = mock.patch.object(moe, "_route", halved)
    else:
        real = transformer.norm_apply

        def uncentred(cfg, p, x):
            if cfg.norm != "layernorm":
                return real(cfg, p, x)
            x32 = x.float()
            y = x32 * torch.rsqrt((x32 ** 2).mean(-1, keepdim=True) + 1e-6)
            return (y * p.scale + p.bias).to(x.dtype)

        patch = mock.patch.object(transformer, "norm_apply", uncentred)
    with patch:
        yield


def main(argv=None) -> int:
    """``calibrate.py``'s command line, planting this file's faults too."""
    from chipbench import calibrate

    with mock.patch.object(faults, "planted", planted):
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
