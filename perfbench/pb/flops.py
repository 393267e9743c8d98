"""Operations of the model's work, counted from the configuration and
the shapes alone (model FLOPs: what the work needs, whatever computes
it).  A multiply-add is two operations."""

from __future__ import annotations


def matmul_params(arch: dict) -> int:
    """Weights each token multiplies by: attention's four projections,
    the feed-forward layer's three matrices (the top-k experts' and the
    router where there are experts), and the unembedding."""
    d, hd = arch["d_model"], arch["head_dim"]
    h, kv, f = arch["n_heads"], arch["n_kv_heads"], arch["d_ff"]
    attn = 2 * d * h * hd + 2 * d * kv * hd
    if arch.get("n_experts", 0):
        ffn = arch["top_k"] * 3 * d * f + d * arch["n_experts"]
    else:
        ffn = 3 * d * f
    return arch["n_layers"] * (attn + ffn) + d * arch["vocab_size"]


def attention_flops(arch: dict, spans: int) -> int:
    """Scores and the weighted sum over ``spans`` (query, key) pairs,
    summed over the layers."""
    return arch["n_layers"] * 4 * arch["n_heads"] * arch["head_dim"] * spans


def causal_pairs(t: int) -> int:
    """(query, key) pairs of causal attention over t positions."""
    return t * (t + 1) // 2


def forward_flops(arch: dict, batch: int, seq: int) -> int:
    """A causal forward over ``batch`` sequences of ``seq`` tokens."""
    return (2 * matmul_params(arch) * batch * seq
            + attention_flops(arch, batch * causal_pairs(seq)))


def flash_call(arch: dict, batch: int, seq: int) -> tuple[int, int]:
    """(operations, bytes) of one layer's causal attention over
    ``batch`` x ``seq`` in bf16: q, k, v read once, o written once."""
    h, kv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    ops = 4 * batch * h * hd * causal_pairs(seq)
    nbytes = 2 * batch * seq * hd * (2 * h + 2 * kv)
    return ops, nbytes
