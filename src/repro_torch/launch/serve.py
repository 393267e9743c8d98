"""Serving launcher: batched requests against a (reduced) model.

Port of ``repro/launch/serve.py``, with ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

``--reduced`` is on whatever the command line says, as in the JAX
package (``store_true`` with ``default=True``); the full-width model is
driven through the Python API (``chip_smoke.py`` phase 7).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.serving.server import BatchedServer, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or the CPU")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, reduced=args.reduced)
    if cfg.frontend is not None:
        raise SystemExit("choose a token-input arch for the serve demo")
    device = ops.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device)
    server = BatchedServer(cfg, params, slots=args.slots,
                           prompt_len=args.prompt_len, cache_len=128,
                           device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    rng.integers(4, args.prompt_len)),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    server.serve(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.tokens_out) for r in reqs)
    print(f"arch={cfg.name}: {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s, "
          f"{server.steps} engine steps) on {device}")
    for r in reqs[:3]:
        print(f"  req{r.request_id}: {r.tokens_out[:10]}...")


if __name__ == "__main__":
    main()
