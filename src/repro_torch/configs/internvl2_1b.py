"""internvl2-1b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821].

The transformer BACKBONE only; the vision frontend is a STUB per the
assignment -- ``input_specs()`` feeds precomputed patch embeddings which
occupy the first ``frontend_len`` positions of the sequence.
"""

from .registry import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151655,
        frontend="vision_stub",
        frontend_len=256,
        rope_theta=1e6,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        frontend="vision_stub",
        frontend_len=8,
        tie_embeddings=True,
        scan_layers=False,
    )


register("internvl2-1b", full, smoke)
