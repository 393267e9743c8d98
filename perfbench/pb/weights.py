"""The model's parameters, drawn from the seed on the device.

Every leaf is drawn in the type it is served in (bfloat16 weights,
float32 norms and router), with a generator on the device, in slices of
at most ``CHUNK`` elements along the stacked layers.  Scales are
fan-in: each product's output has about its input's size, and the
logits are about N(0, 1).  The router's logits are N(0, 9)
(``ROUTER_SCALE``): a peaked routing, in which the top-k experts carry
most of the gate mass, as a trained router's do; with N(0, 1) logits
over 128 experts the top 8 carry about a fifth, and the experts add
little to the residual stream.  Random layers leave the residual stream
of every token near one shared direction, so the router ranks the
experts alike for nearly all tokens, and most choices overflow the
capacity (the program's work does not depend on it: its buffers have
the capacity's size).  The tree has the layout the program takes
(``blocks/s0`` holds every layer stacked on a leading axis).
"""

from __future__ import annotations

import torch

CHUNK = 1 << 30
ROUTER_SCALE = 3.0
BF16 = torch.bfloat16
F32 = torch.float32


def _draw(gen: torch.Generator, shape, dtype, scale: float, device,
          shift: float = 0.0) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    per = max(1, out[0].numel()) if out.dim() > 1 else out.numel()
    step = max(1, CHUNK // per) if out.dim() > 1 else out.shape[0]
    for i in range(0, out.shape[0], step):
        part = out[i:i + step]
        part.normal_(generator=gen).mul_(scale).add_(shift)
    return out


def draw(arch: dict, seed: int, device) -> dict:
    """Parameters of ``arch`` (a configuration's ``arch`` table) drawn
    from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, d, v = arch["n_layers"], arch["d_model"], arch["vocab_size"]
    h, kv, hd, f = (arch["n_heads"], arch["n_kv_heads"], arch["head_dim"],
                    arch["d_ff"])

    def w(shape, fan_in, dtype=BF16):
        return _draw(gen, shape, dtype, fan_in ** -0.5, device)

    def norm(shape):
        return _draw(gen, shape, F32, 0.1, device, shift=1.0)

    mixer = {"wq": w((n, d, h, hd), d), "wk": w((n, d, kv, hd), d),
             "wv": w((n, d, kv, hd), d), "wo": w((n, h, hd, d), h * hd)}
    e = arch.get("n_experts", 0)
    if e:
        ffn = {"router": _draw(gen, (n, d, e), F32, ROUTER_SCALE * d ** -0.5,
                               device),
               "wi": w((n, e, d, 2, f), d),
               "wo": w((n, e, f, d), f)}
    else:
        ffn = {"wi": w((n, d, 2, f), d), "wo": w((n, f, d), f)}
    return {"embed": _draw(gen, (v, d), BF16, 1.0, device),
            "final_norm": norm((d,)),
            "unembed": w((d, v), d),
            "blocks": {"s0": {"norm1": norm((n, d)), "norm2": norm((n, d)),
                              "mixer": mixer, "ffn": ffn}}}

