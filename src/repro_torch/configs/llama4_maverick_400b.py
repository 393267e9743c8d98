"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE interleaved
with dense layers; early-fusion multimodal (frontend stubbed via the
shared vision-embedding path when present).

48L d_model=5120 40H (GQA kv=8, head_dim 128) d_ff=8192/expert
vocab=202048, MoE 128e top-1  [hf:meta-llama/Llama-4-*; unverified]

Llama-4 interleaves MoE and dense FFN layers (interleave step 2); the
shared expert is folded into the dense-layer FFN here (noted in
DESIGN.md §9 as a simplification).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    activation="silu",
    block_pattern=("attn", "attn"),   # period 2 so MoE layout is static
    n_experts=128,
    top_k=1,
    moe_period=2,
    moe_offset=1,
    rope_theta=500_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="llama4-maverick-reduced", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=192, vocab_size=512,
        n_experts=8, top_k=1)
