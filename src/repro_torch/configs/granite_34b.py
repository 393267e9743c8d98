"""granite-34b [dense] — llama-style code model with MQA (kv=1), ungated
GELU MLP (gpt-bigcode lineage).

88L d_model=6144 48H (GQA kv=1, head_dim 128) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    activation="gelu",
    gated_mlp=False,
    rope_theta=10_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="granite-34b-reduced", n_layers=4, d_model=192,
        n_heads=6, n_kv_heads=1, head_dim=32, d_ff=768, vocab_size=512)
