"""stablelm-12b [dense] — GQA, gated SiLU MLP.

40L d_model=5120 32H (GQA kv=8, head_dim 160) d_ff=13824 vocab=100352
[hf:stabilityai/stablelm-2-12b; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,
    activation="silu",
    rope_theta=10_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="stablelm-12b-reduced", n_layers=4, d_model=160,
        n_heads=4, n_kv_heads=2, head_dim=40, d_ff=512, vocab_size=512)
