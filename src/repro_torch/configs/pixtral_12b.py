"""pixtral-12b [vlm] — Pixtral-ViT frontend + Mistral-Nemo-style decoder.

40L d_model=5120 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]

The ViT patch encoder is a STUB: input_specs() provides precomputed patch
embeddings already projected to d_model. head_dim=128 (q projection
5120 -> 4096, Nemo-style).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    activation="silu",
    frontend="vision",
    rope_theta=1_000_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="pixtral-12b-reduced", n_layers=4, d_model=160,
        n_heads=4, n_kv_heads=2, head_dim=40, d_ff=512, vocab_size=512)
