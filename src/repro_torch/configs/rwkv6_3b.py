"""rwkv6-3b [ssm] — RWKV-6 "Finch": attention-free, data-dependent decay.

32L d_model=2560 (attn-free) d_ff=8960 vocab=65536  [arXiv:2404.05892; hf]

O(1) state per layer => long_500k RUNS for this arch.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    rwkv_head_dim=64,
    activation="relu2",    # RWKV channel mix uses squared ReLU
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="rwkv6-3b-reduced", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=448, vocab_size=512, rwkv_head_dim=32)
