"""qwen3-0.6b [dense]: qk_norm, GQA [hf:Qwen/Qwen3-0.6B]."""

from .registry import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=3072,
        vocab=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=128,
        head_dim=16,
        qk_norm=True,
        tie_embeddings=True,
        scan_layers=False,
    )


register("qwen3-0.6b", full, smoke)
