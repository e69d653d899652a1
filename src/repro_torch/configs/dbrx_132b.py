"""dbrx-132b [moe]: 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

EP mapping: 16 experts shard exactly over the ``data``(16) axis -> the
dispatch All-to-All stays on intra-pod ICI (FLASH degenerates to its
merged-transfer step only; see DESIGN.md section 3).
"""

from .registry import ModelConfig, MoESpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        moe=MoESpec(num_experts=16, top_k=4),
        rope_theta=5e5,
        norm="layernorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        moe=MoESpec(num_experts=4, top_k=2),
        norm="layernorm",
        scan_layers=False,
    )


register("dbrx-132b", full, smoke)
