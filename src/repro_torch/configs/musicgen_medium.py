"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (kv=24, head_dim 64) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf]

The EnCodec audio frontend is a STUB: input_specs() provides precomputed
frame embeddings (B, T, d_model); the vocabulary is the 2048-entry
codebook. MLP is plain GELU (fairseq-style), not gated.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    activation="gelu",
    gated_mlp=False,
    frontend="audio",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="musicgen-medium-reduced", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=512, vocab_size=256)
