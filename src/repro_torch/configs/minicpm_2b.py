"""minicpm-2b [dense] — llama-like MHA (kv=36), tied embeddings, WSD LR
schedule (implemented in repro.train.schedules).

40L d_model=2304 36H (kv=36, head_dim 64) d_ff=5760 vocab=122753
[arXiv:2404.06395; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    activation="silu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="minicpm-2b-reduced", n_layers=4, d_model=144,
        n_heads=6, n_kv_heads=6, head_dim=24, d_ff=384, vocab_size=512)
