"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8, fine-grained (d_ff=768
per expert), MoE on every layer.

48L d_model=2048 32H (GQA kv=4, head_dim 128) d_ff=768 vocab=151936,
MoE 128e top-8  [hf:Qwen/Qwen3-30B-A3B; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    activation="silu",
    n_experts=128,
    top_k=8,
    moe_period=1,
    rope_theta=1_000_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-reduced", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=96, vocab_size=512,
        n_experts=8, top_k=2)
