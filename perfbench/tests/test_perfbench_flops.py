"""Operation counts worked out from the shapes, and the readers built on
them."""

import pytest

from pb import flops, harness, manifest as mf, peaks

STABLELM = mf.config("stablelm-12b")["arch"]
QWEN = mf.config("qwen3-moe-30b-a3b")["arch"]


def test_matmul_params_by_hand():
    d, f, v, L = 5120, 13824, 100352, 40
    attn = d * 32 * 160 * 2 + d * 8 * 160 * 2
    assert flops.matmul_params(STABLELM) == L * (attn + 3 * d * f) + d * v
    d, f, v, L = 2048, 768, 151936, 48
    attn = d * 32 * 128 * 2 + d * 4 * 128 * 2
    assert flops.matmul_params(QWEN) == \
        L * (attn + 8 * 3 * d * f + d * 128) + d * v
    # 11.6e9 and 3.0e9 weights a token multiplies by (the embedding
    # lookup multiplies by none)
    assert 11.5e9 < flops.matmul_params(STABLELM) < 11.7e9
    assert 2.9e9 < flops.matmul_params(QWEN) < 3.1e9


def test_forward_by_hand():
    arch = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
            "head_dim": 2, "d_ff": 8, "vocab_size": 10}
    p = flops.matmul_params(arch)
    assert p == (2 * 4 * 2 * 2 + 2 * 4 * 1 * 2) + 3 * 4 * 8 + 4 * 10
    # 3 tokens, causal: 1 + 2 + 3 = 6 pairs, 4 * H * hd ops a pair
    assert flops.forward_flops(arch, 1, 3) == 2 * p * 3 + 6 * 4 * 2 * 2


def test_flash_call_by_hand():
    ops, nbytes = flops.flash_call(STABLELM, 2, 4096)
    assert ops == 4 * 2 * 32 * 160 * 4096 * 4097 // 2
    assert nbytes == 2 * 2 * 4096 * 160 * (2 * 32 + 2 * 8)
    # compute-bound: 0.35 ms at the bf16 peak
    assert ops / peaks.BF16_FLOPS == pytest.approx(3.48e-4, rel=0.01)


class _Drv:
    traced_calls = 1

    def __init__(self, arch):
        self.arch = arch

    def traced_flash(self):
        o, b = flops.flash_call(self.arch, 2, 4096)
        return o * self.arch["n_layers"], b * self.arch["n_layers"]

    def window_flops(self):
        return flops.forward_flops(self.arch, 2, 4096) * 5


def test_readers_from_a_trace():
    trace = {"busy_s": 2.0, "window_s": 2.5,
             "by_kind": {"gemm_f32": 1.5, "flash": 0.05},
             "moe_s": {"moe.experts": 0.0}}
    ctx = harness.Context("score", STABLELM, _Drv(STABLELM), trace, 10.0)
    read = harness.load_reader
    assert read("f32_gemm_share.score")(ctx) == pytest.approx(75.0)
    assert read("idle_share.score")(ctx) == pytest.approx(20.0)
    assert read("moe_share.score")(ctx) is None
    bound = 40 * flops.flash_call(STABLELM, 2, 4096)[0] / peaks.BF16_FLOPS
    assert read("flash_roofline.score")(ctx) == pytest.approx(
        100 * bound / 0.05)
    mfu = read("mfu.score")(ctx)
    assert mfu == pytest.approx(100 * flops.forward_flops(STABLELM, 2, 4096)
                                * 5 / 10.0 / peaks.BF16_FLOPS)
    # a reader of the score kind is silent in a run of another kind
    other = harness.Context("train", STABLELM, _Drv(STABLELM), trace, 10.0)
    assert read("f32_gemm_share.score")(other) is None
    assert read("mfu.score")(other) is None


def test_roofline_reader_is_silent_without_flash():
    trace = {"busy_s": 2.0, "window_s": 2.5, "by_kind": {"gemm_f32": 1.5},
             "moe_s": {}}
    ctx = harness.Context("score", STABLELM, _Drv(STABLELM), trace, 10.0)
    assert harness.load_reader("flash_roofline.score")(ctx) is None
    assert harness.load_reader("idle_share.score")(
        harness.Context("score", STABLELM, None, None, 1.0)) is None
