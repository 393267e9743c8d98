"""The port's ``models/ssm.py`` vs the JAX package's, on the CPU.

Both get the same seeded numpy parameters and inputs in f32.  Outputs
and carried states agree within rtol 1e-4 / atol 1e-5: the port runs
JAX's associative-scan recursion and chunk loops, but the two
frameworks round f32 sums in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as S

TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _both(tree):
    """f32 numpy tree -> (jnp tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    a = np.asarray(tree, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _same_state(got[k], w)
        else:
            _close(got[k], w)


def _mamba_params(rng, D=32, Di=64, St=8, K=4):
    R = max(D // 16, 1)
    return {
        "in_proj": rng.normal(0, D ** -0.5, (D, 2 * Di)),
        "conv_w": rng.normal(0, 0.3, (Di, K)),
        "conv_b": rng.normal(0, 0.1, Di),
        "x_proj": rng.normal(0, Di ** -0.5, (Di, R + 2 * St)),
        "dt_proj": rng.normal(0, R ** -0.5, (R, Di)),
        "dt_bias": np.full(Di, -2.0),
        "A_log": np.log(np.broadcast_to(np.arange(1, St + 1.0), (Di, St))),
        "D": rng.normal(1, 0.1, Di),
        "out_proj": rng.normal(0, Di ** -0.5, (Di, D)),
    }


def _rwkv_params(rng, D=64, hd=16, Fd=96):
    R = max(D // 32, 8)
    p = {}
    for nm in ("r", "k", "v", "w", "g"):
        p[f"mu_{nm}"] = rng.uniform(0, 1, D)
        p[f"lora_a_{nm}"] = rng.normal(0, D ** -0.5, (D, R))
        p[f"lora_b_{nm}"] = rng.normal(0, 0.1, (R, D))
    p["w0"] = rng.normal(-2.0, 1.0, D)
    p["lora_a_w2"] = rng.normal(0, D ** -0.5, (D, R))
    p["lora_b_w2"] = rng.normal(0, 0.5, (R, D))
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        p[nm] = rng.normal(0, D ** -0.5, (D, D))
    p["u"] = rng.normal(0, 0.5, (D // hd, hd))
    p["ln_scale"] = rng.normal(1, 0.1, D)
    channel = {"mu_r": rng.uniform(0, 1, D), "mu_k": rng.uniform(0, 1, D),
               "wr": rng.normal(0, D ** -0.5, (D, D)),
               "wk": rng.normal(0, D ** -0.5, (D, Fd)),
               "wv": rng.normal(0, Fd ** -0.5, (Fd, D))}
    return p, channel


@pytest.mark.parametrize("T,chunk", [(37, 256), (512, 256), (48, 16)])
@pytest.mark.parametrize("return_state", [False, True])
def test_mamba_train_matches_reference(T, chunk, return_state):
    """T = 37 is one odd-length chunk, 512 two chunks of 256, 48 three
    chunks of 16; the carried state crosses every chunk boundary."""
    rng = np.random.default_rng(T)
    jp, tp = _both(_mamba_params(rng))
    x = rng.normal(size=(2, T, 32)).astype(np.float32)
    kw = dict(d_state=8, chunk=chunk, return_state=return_state)
    want = JS.mamba_train(jnp.asarray(x), jp, **kw)
    got = S.mamba_train(torch.from_numpy(x), tp, **kw)
    if return_state:
        _close(got[0], want[0])
        _same_state(got[1], want[1])
    else:
        _close(got, want)


def test_mamba_train_short_prompt_state():
    """A prompt shorter than the conv's K - 1 pads the carried tail."""
    rng = np.random.default_rng(1)
    jp, tp = _both(_mamba_params(rng))
    x = rng.normal(size=(2, 2, 32)).astype(np.float32)
    want = JS.mamba_train(jnp.asarray(x), jp, d_state=8, return_state=True)
    got = S.mamba_train(torch.from_numpy(x), tp, d_state=8,
                        return_state=True)
    assert tuple(got[1]["conv"].shape) == (2, 3, 64)
    _close(got[0], want[0])
    _same_state(got[1], want[1])


def test_mamba_decode_three_steps_matches_reference():
    rng = np.random.default_rng(2)
    jp, tp = _both(_mamba_params(rng))
    x = rng.normal(size=(2, 20, 32)).astype(np.float32)
    _, jstate = JS.mamba_train(jnp.asarray(x[:, :17]), jp, d_state=8,
                               return_state=True)
    _, state = S.mamba_train(torch.from_numpy(x[:, :17]), tp, d_state=8,
                             return_state=True)
    for t in range(17, 20):
        jout, jstate = JS.mamba_decode(jnp.asarray(x[:, t:t + 1]), jstate,
                                       jp, d_state=8)
        out, state = S.mamba_decode(torch.from_numpy(x[:, t:t + 1]), state,
                                    tp, d_state=8)
        _close(out, jout)
        _same_state(state, jstate)
    # The decoded steps equal the full sequence's last positions.
    full = S.mamba_train(torch.from_numpy(x), tp, d_state=8)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(),
                               **TOL)


def test_mamba_init_state_matches_reference():
    want = JS.mamba_init_state(64, 8, 4, 3, jnp.bfloat16)
    got = S.mamba_init_state(64, 8, 4, 3, torch.bfloat16, "cpu")
    for k in ("conv", "ssm"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


@pytest.mark.parametrize("T", [37, 96])
@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_time_mix_matches_reference(T, carried):
    """T = 37 runs 37 one-step chunks (37 is prime), 96 three chunks of
    32; with ``carried`` the shift and wkv states come from a prompt."""
    rng = np.random.default_rng(T + carried)
    p, _ = _rwkv_params(rng)
    jp, tp = _both(p)
    x = rng.normal(size=(2, T, 64)).astype(np.float32)
    jstate = state = None
    if carried:
        pre = rng.normal(size=(2, 32, 64)).astype(np.float32)
        _, jstate = JS.rwkv6_time_mix(jnp.asarray(pre), jp, head_dim=16,
                                      return_state=True)
        _, state = S.rwkv6_time_mix(torch.from_numpy(pre), tp, head_dim=16,
                                    return_state=True)
        _same_state(state, jstate)
    want = JS.rwkv6_time_mix(jnp.asarray(x), jp, head_dim=16, state=jstate,
                             return_state=True)
    got = S.rwkv6_time_mix(torch.from_numpy(x), tp, head_dim=16,
                           state=state, return_state=True)
    _close(got[0], want[0])
    _same_state(got[1], want[1])


def test_rwkv6_decode_and_channel_mix_match_reference():
    """Three single-token steps of time and channel mix, carrying their
    states from a 24-token prompt, equal JAX's; the decoded steps equal
    the chunked form over the whole sequence."""
    rng = np.random.default_rng(5)
    p, c = _rwkv_params(rng)
    (jp, tp), (jc, tc) = _both(p), _both(c)
    x = rng.normal(size=(2, 27, 64)).astype(np.float32)
    _, jt = JS.rwkv6_time_mix(jnp.asarray(x[:, :24]), jp, head_dim=16,
                              return_state=True)
    _, tt = S.rwkv6_time_mix(torch.from_numpy(x[:, :24]), tp, head_dim=16,
                             return_state=True)
    jout, jch = JS.rwkv6_channel_mix(jnp.asarray(x[:, :24]), jc,
                                     return_state=True)
    out, ch = S.rwkv6_channel_mix(torch.from_numpy(x[:, :24]), tc,
                                  return_state=True)
    _close(out, jout)
    _same_state(ch, jch)
    for t in range(24, 27):
        step = x[:, t:t + 1]
        jo, jt = JS.rwkv6_time_mix_decode(jnp.asarray(step), jt, jp,
                                          head_dim=16)
        o, tt = S.rwkv6_time_mix_decode(torch.from_numpy(step), tt, tp,
                                        head_dim=16)
        _close(o, jo)
        _same_state(tt, jt)
        jo, jch = JS.rwkv6_channel_mix(jnp.asarray(step), jc, state=jch,
                                       return_state=True)
        o, ch = S.rwkv6_channel_mix(torch.from_numpy(step), tc, state=ch,
                                    return_state=True)
        _close(o, jo)
        _same_state(ch, jch)
    _, prefix = S.rwkv6_time_mix(torch.from_numpy(x[:, :26]), tp,
                                 head_dim=16, return_state=True)
    last, _ = S.rwkv6_time_mix_decode(torch.from_numpy(x[:, 26:]), prefix,
                                      tp, head_dim=16)
    full = S.rwkv6_time_mix(torch.from_numpy(x), tp, head_dim=16)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               **TOL)


def test_rwkv6_init_state_matches_reference():
    want = JS.rwkv6_init_state(3, 64, 16, jnp.bfloat16)
    got = S.rwkv6_init_state(3, 64, 16, torch.bfloat16, "cpu")
    for part in ("time", "channel"):
        assert sorted(got[part]) == sorted(want[part])
        for k, w in want[part].items():
            assert tuple(got[part][k].shape) == w.shape
            assert str(got[part][k].dtype).split(".")[-1] == str(w.dtype)
            assert not got[part][k].any()
