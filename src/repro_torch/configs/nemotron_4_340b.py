"""nemotron-4-340b [dense] — GQA, squared-ReLU, plain (ungated) MLP.

96L d_model=18432 96H (GQA kv=8, head_dim 192) d_ff=73728 vocab=256000
[arXiv:2402.16819; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    activation="relu2",
    gated_mlp=False,
    rope_theta=10_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="nemotron-4-340b-reduced", n_layers=4, d_model=192,
        n_heads=6, n_kv_heads=2, head_dim=32, d_ff=768, vocab_size=512)
