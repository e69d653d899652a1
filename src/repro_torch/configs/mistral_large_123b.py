"""mistral-large-123b [dense]: 88L GQA dense transformer
[hf:mistralai/Mistral-Large-Instruct-2407]."""

from .registry import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=28672,
        vocab=32768,
        head_dim=128,
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
        head_dim=8,
        scan_layers=False,
    )


register("mistral-large-123b", full, smoke)
