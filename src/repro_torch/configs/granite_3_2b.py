"""granite-3-2b [dense]: GQA [hf:ibm-granite/granite-3.0-2b-base]."""

from .registry import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=49155,
        rope_theta=1e4,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=128,
        tie_embeddings=True,
        scan_layers=False,
    )


register("granite-3-2b", full, smoke)
