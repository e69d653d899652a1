"""whisper-tiny [audio]: enc-dec, conv frontend (stub) [arXiv:2212.04356].

The conv mel-frontend is a STUB per the assignment -- ``input_specs()``
provides precomputed frame embeddings of shape [B, encoder_len, d_model].
Encoder-decoder: decode shapes use self-attn KV cache + cross-attn cache.
"""

from .registry import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        encdec=True,
        n_encoder_layers=4,
        encoder_len=1500,
        frontend="audio_stub",
        norm="layernorm",
        act="gelu",
        scan_layers=False,  # 4 layers: unrolled HLO is fine
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke",
        family="encdec",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab=128,
        encdec=True,
        n_encoder_layers=2,
        encoder_len=32,
        frontend="audio_stub",
        norm="layernorm",
        act="gelu",
        scan_layers=False,
    )


register("whisper-tiny", full, smoke)
