"""Architecture + run configuration schema (copy of ``repro/configs/base.py``).

One ``ArchConfig`` per assigned architecture (see configs/<id>.py), plus
``reduced()`` variants for CPU smoke tests. The model stack
(repro_torch.models) consumes only this schema — adding an architecture is a
config file, not a code change.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    # trunk
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "silu"      # silu | gelu | relu2 (squared ReLU)
    gated_mlp: bool = True        # False => plain act(xW1)W2 (nemotron,
                                  # granite, musicgen)
    # block pattern: kind of each layer, repeating with this period.
    # entries: 'attn' | 'mamba' | 'rwkv6'
    block_pattern: tuple[str, ...] = ("attn",)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 0           # every moe_period-th layer is MoE (0=off)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048    # dispatch group (GShard-style)
    # SSM (mamba blocks)
    d_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    # rwkv6
    rwkv_head_dim: int = 64
    # attention details
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # used by hybrid long-context
    # 'xla' computes attention as plain products and a softmax; 'flash'
    # uses the blocked online-softmax kernel (kernels/flash_attention:
    # CUDA on the card, its plain version on the CPU).
    attention_impl: str = "xla"
    # modality frontend: None | 'audio' | 'vision' (stubbed: input_specs
    # provides precomputed frame/patch embeddings)
    frontend: Optional[str] = None
    tie_embeddings: bool = False
    # Override for long_500k eligibility (hybrids with few full-attention
    # layers can still decode 500k contexts; see DESIGN.md).
    supports_long_context: Optional[bool] = None
    # norms / numerics
    rms_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_kv_heads must divide n_heads")
        if self.n_layers % len(self.block_pattern):
            raise ValueError("n_layers must be a multiple of the pattern")

    # -- derived ----------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // self.pattern_period

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % self.pattern_period]

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe_period:
            return False
        return i % self.moe_period == self.moe_offset

    @property
    def subquadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (SSM/hybrid)."""
        if self.supports_long_context is not None:
            return self.supports_long_context
        kinds = set(self.block_pattern)
        if kinds <= {"mamba", "rwkv6"}:
            return True
        return "attn" in kinds and self.sliding_window is not None and \
            kinds != {"attn"}

    # -- parameter counting (for roofline MODEL_FLOPS) ---------------------

    def param_count(self, active_only: bool = False) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.head_dim_, self.n_heads, self.n_kv_heads
        ffn_mats = 3 if self.gated_mlp else 2
        total = V * d                      # embed
        if not self.tie_embeddings:
            total += V * d                 # unembed
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += d * H * hd + 2 * d * KV * hd + H * hd * d
            elif kind == "mamba":
                di, ds = self.d_inner, self.d_state
                R = max(d // 16, 1)
                total += d * 2 * di + di * self.d_conv \
                    + di * (R + 2 * ds) // 1 + R * di \
                    + di * (ds + 2) + di * d            # projs+conv+ssm+out
            elif kind == "rwkv6":
                total += 5 * d * d                      # wr wk wv wg wo
            total += 2 * d                              # norms
            if kind == "rwkv6":
                total += 2 * d * ff + d * d             # channel mix
            elif self.is_moe_layer(i):
                experts = self.top_k if active_only else self.n_experts
                total += experts * ffn_mats * d * ff \
                    + d * self.n_experts                # router
            else:
                total += ffn_mats * d * ff
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> list[ShapeConfig]:
    """The shape cells that apply to this architecture.

    long_500k needs sub-quadratic attention: skipped for pure
    full-attention archs (recorded in DESIGN.md §Arch-applicability).
    """
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out
