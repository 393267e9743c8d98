"""Training launcher.

Port of ``repro/launch/train.py``, with ``--device``.  Reduced-config
CPU run:

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --reduced --steps 200 --device cpu

Without ``--device`` it trains on the card.  Without ``--workdir`` it
works in a new temporary directory; a given workdir that holds a
committed checkpoint is resumed from it.  A stubbed-frontend config
(musicgen, pixtral) trains on embedding batches: each token batch looked
up in a copy of the initial embedding table, as the reference does.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import (
    SelfScheduledLoader, synthetic_token_shards)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_loader(cfg, batch_size: int, seq_len: int, workdir: str,
                 n_shards: int = 12, seed: int = 0) -> SelfScheduledLoader:
    shard_dir = os.path.join(workdir, "shards")
    shards = synthetic_token_shards(
        shard_dir, n_shards=n_shards, vocab_size=cfg.vocab_size,
        tokens_per_shard_mean=batch_size * (seq_len + 1) * 8, seed=seed)
    return SelfScheduledLoader(shards, batch_size=batch_size,
                               seq_len=seq_len, seed=seed)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--opt-state", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="train on the card (default) or the CPU")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, reduced=args.reduced)
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_train_")
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"workdir={workdir}")

    loader = build_loader(cfg, args.batch_size, args.seq_len, workdir)
    print(f"ingest: {len(loader.job_result.results)} shards in "
          f"{loader.job_result.job_seconds:.2f}s "
          f"({loader.job_result.messages_sent} messages, largest-first)")

    tcfg = TrainerConfig(workdir=workdir, total_steps=args.steps,
                         ckpt_every=args.ckpt_every,
                         schedule=args.schedule, peak_lr=args.lr)
    trainer = Trainer(cfg, OptimizerConfig(state_dtype=args.opt_state),
                      tcfg, device=args.device)
    if cfg.frontend is not None:
        # stub frontend: swap token batches for embedding batches
        emb = trainer.params["embed"].detach().clone()

        def embed_batches(n):
            for b in loader.batches(n):
                tokens = torch.from_numpy(b["tokens"]).to(emb.device)
                yield {"embeds": emb[tokens.long()], "labels": b["labels"]}
        log = trainer.run(embed_batches(args.steps), args.steps)
    else:
        log = trainer.run(loader.batches(args.steps), args.steps)
    trainer.close()
    first = np.mean([r["loss"] for r in log[:5]])
    last = np.mean([r["loss"] for r in log[-5:]])
    print(f"loss {first:.4f} -> {last:.4f} over {len(log)} steps; "
          f"stragglers={trainer.straggler_steps} on {trainer.device}")


if __name__ == "__main__":
    main()
