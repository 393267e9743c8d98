"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e
top-2 on every other layer.

32L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=65536
[arXiv:2403.19887; hf]

Block pattern (period 8, matching Jamba's published layout): attention at
position 4 of each 8-layer group; MoE on odd layers. Long-context decode
is supported (only 4 of 32 layers keep a KV cache; the Mamba state is
O(1)) — long_500k RUNS for this arch.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    activation="silu",
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    n_experts=16,
    top_k=2,
    moe_period=2,
    moe_offset=1,
    d_state=16,
    d_conv=4,
    mamba_expand=2,
    supports_long_context=True,
    rope_theta=10_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="jamba-v0.1-52b-reduced", n_layers=8, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        n_experts=4, top_k=2, d_state=8)
