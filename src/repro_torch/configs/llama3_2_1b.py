"""llama3.2-1b [dense]: small llama3 [hf:meta-llama/Llama-3.2-1B]."""

from .registry import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=128256,
        head_dim=64,
        rope_theta=5e5,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        head_dim=8,
        tie_embeddings=True,
        scan_layers=False,
    )


register("llama3.2-1b", full, smoke)
