"""Distribution context: which axes of the mesh play which role.

Counterpart of ``src/repro/models/dist.py`` over a ``LocalMesh`` or a
``ProcessMesh`` (``launch/mesh.py``); ``ep_size`` and ``choose_ep_axes``
read the whole mesh's shape, whichever ranks this process holds, and
``tp_size`` the size of "model" on a ``ProcessMesh`` (1 on a ``LocalMesh``,
which keeps whole weights: ``models/tp.py``, and 1 under ``pure_dp``).
``seq_shard`` runs the residual stream on a sequence chunk under TP, and
``fsdp`` names the leaves a ``ProcessMesh`` stores over its DP axes
(``models/fsdp.py``).
``None`` in place of a context means the single-device path, the
correctness oracle for the distributed one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

from ..configs.registry import ModelConfig
from ..core.topology import Topology
from ..launch.mesh import LocalMesh, ProcessMesh

__all__ = ["DistContext", "choose_ep_axes"]


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Union[LocalMesh, ProcessMesh]
    dp_axes: Tuple[str, ...]            # batch-sharded axes (the MoE island)
    slow_axis: Optional[str]            # inter-pod axis ("pod"), if present
    ep_axes: Optional[Tuple[str, ...]]  # expert-parallel axes, slow-major
    # Registry name consumed by comm.all_to_all.resolve_all_to_all.
    a2a_impl: str = "flash"             # a registry name, or "auto"
    # Physical fabric, when known; a2a_impl="auto" resolves against it.
    topology: Optional[Topology] = None
    # Synthesized schedule (core.plan.Plan or simulator.ExecutableSchedule)
    # backing a2a_impl="plan"; "auto" prefers "plan" whenever this is set.
    plan: Optional[object] = None
    # False runs the plain PyTorch versions of the kernels on the MoE path
    # (pack, unpack, grouped matmul) instead of the CUDA kernels.
    use_kernel: bool = True
    # cfg.pure_dp: weights whole on every rank and the batch over every
    # axis, "model" included; no TP, and the MoE routes a (pod, data)
    # shard's rows together (models/moe.py)
    pure_dp: bool = False
    # cfg.seq_shard_activations: the residual stream on a sequence chunk
    # between the TP regions (models/tp.py's SeqShard; only with TP)
    seq_shard: bool = False
    # FSDP on a ProcessMesh: {parameter name: (dim, axes)} of every leaf
    # whose spec adds the intra-pod DP axes (launch/shardings.fsdp_layout),
    # each gathered before use (models/fsdp.py); None without FSDP
    fsdp: Optional[Dict[str, Tuple[int, Tuple[str, ...]]]] = None

    @property
    def ep_size(self) -> int:
        if not self.ep_axes:
            return 1
        return self.mesh.axis_size(self.ep_axes)

    @property
    def tp_size(self) -> int:
        """The tensor-parallel degree: "model"'s size on a ``ProcessMesh``,
        else 1 (and 1 under ``pure_dp``, whose weights are whole)."""
        if self.pure_dp or not isinstance(self.mesh, ProcessMesh) \
                or "model" not in self.mesh.axis_names:
            return 1
        return self.mesh.axis_size("model")


def choose_ep_axes(cfg: ModelConfig, mesh
                   ) -> Optional[Tuple[str, ...]]:
    """Pick EP axes for an arch on a mesh: the largest slow-major prefix of
    the DP axes whose size divides num_experts.

    Priority (production mesh pod=2, data=16):
      E % (pod*data) == 0 -> ("pod", "data")   # megatron-moe-32e
      E % data == 0       -> ("data",)         # dbrx-16e
      E % pod == 0        -> ("pod",)          # mixtral-8e
      otherwise           -> None              # experts replicated
    """
    if cfg.moe is None:
        return None
    shape = dict(zip(mesh.axis_names, mesh.shape))
    e = cfg.moe.num_experts
    has_pod = "pod" in shape
    pod = shape.get("pod", 1)
    data = shape.get("data", 1)
    if has_pod and e % (pod * data) == 0:
        return ("pod", "data")
    if e % data == 0 and data > 1:
        return ("data",)
    if has_pod and e % pod == 0 and pod > 1:
        return ("pod",)
    return None
