"""Scoring: back-to-back forward calls over full-context documents.

The program's ``models.model.forward`` (flash attention) runs on a
batch of ``batch`` x ``seq_len`` ids; the next batch is drawn on the
card while the current one runs, so nothing is copied from the host in
the window.  ``sample_calls`` of the window's calls are drawn from the
seed as the window runs (a reservoir: every call equally likely, only
the drawn ones kept), and of each the logits at ``sample_positions``
positions per sequence (drawn from the seed, the last one always among
them) are copied into buffers allocated before the warm-up: what is
kept does not grow with the window, and its bytes are left out of the
peak the run reports.  Once the window has closed the reference
recomputes the kept rows.  Two readings compare them: the widest row
(``logit_err``), and the largest of the medians of the rows in each
block of ``sample_block`` consecutive positions
(``logit_err_block_median``), which sees a fault confined to one block
(a query tile of attention, a group of the experts).  The cell's file
may set any of these numbers in place of the mix's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from pb import flops, tokens
from reference import decoder as ref


class Score:
    def __init__(self, run):
        self.run = run
        tr = run.traffic
        opt = {**tr, **run.cell}
        self.B = opt["batch"]
        self.T = tr["seq_len"]
        self.cfg = dataclasses.replace(run.arch_cfg, attention_impl="flash")
        self.stream = tokens.DeviceStream(run.arch["vocab_size"],
                                          tr["zipf_s"], run.seed, run.device)
        rng = np.random.default_rng(run.seed)
        pos = rng.choice(self.T - 1, opt["sample_positions"] - 1,
                         replace=False)
        self.pos = torch.tensor(sorted(pos.tolist()) + [self.T - 1],
                                device=run.device)
        self.block = opt["sample_block"]
        self.rng = rng
        self.n_slots = opt["sample_calls"]
        self.rows = None              # (slots, B, positions, V) on the device
        self.held_bytes = 0           # what the harness holds in the window
        self.kept: dict = {}          # slot -> tokens of the call kept there
        self.n_calls = 0
        self.window_s = 0.0
        self._next = None

    def _call(self, slot=None) -> None:
        cur = self._next
        with record_function("bench.forward"):
            logits = self.run.M.forward(self.cfg, self.run.params,
                                        {"tokens": cur})
        self._next = self.stream.next(self.B, self.T)
        if slot is not None:
            torch.index_select(logits, 1, self.pos, out=self.rows[slot])
            self.kept[slot] = cur
        del logits

    def _slot(self, i: int):
        """Where call ``i`` of the window is kept, or None (reservoir
        sampling: after the window each call was kept with the same
        chance)."""
        if i < self.n_slots:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.n_slots else None

    def warm_up(self) -> None:
        dev = self.run.device
        cuda = dev.type == "cuda"
        before = torch.cuda.memory_allocated(dev) if cuda else 0
        self.rows = torch.empty((self.n_slots, self.B, len(self.pos),
                                 self.run.arch["vocab_size"]),
                                dtype=torch.float32, device=dev)
        self.held_bytes = (torch.cuda.memory_allocated(dev) - before
                           if cuda else 0)
        self._next = self.stream.next(self.B, self.T)
        with torch.inference_mode():
            self._call(slot=0)
        self.run.sync()
        self.kept.clear()

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        with torch.inference_mode():
            while True:
                self._call(self._slot(self.n_calls))
                self.run.sync()
                self.n_calls += 1
                t = time.perf_counter()
                if t - t0 >= seconds:
                    break
        self.window_s = t - t0

    def traced(self) -> None:
        with torch.inference_mode():
            self._call()
        self.traced_calls = 1

    def release(self) -> None:
        self._next = None

    # -- metrics -------------------------------------------------------------

    def attempted(self) -> int:
        return self.n_calls * self.B

    def end_to_end(self) -> dict:
        n = self.n_calls * self.B * self.T
        return {"score_tokens_per_s": n / self.window_s}

    def window_flops(self) -> int:
        return self.n_calls * flops.forward_flops(self.run.arch, self.B,
                                                  self.T)

    def traced_flash(self) -> tuple[int, int]:
        """(operations, bytes) of the flash work in the traced stretch."""
        o, b = flops.flash_call(self.run.arch, self.B, self.T)
        n = self.traced_calls * self.run.arch["n_layers"]
        return n * o, n * b

    # -- correctness ---------------------------------------------------------

    def _reference(self, decoder: ref.Decoder, slot: int):
        """The kept rows of the call in ``slot`` (on the device) and the
        reference's logits of the same rows."""
        toks = self.kept[slot]
        rows = [(b, p) for b in range(self.B) for p in self.pos.tolist()]
        seqs = [toks[b].long() for b in range(self.B)]
        calls = [[(b, t) for b in range(self.B) for t in range(self.T)]]
        got = self.rows[slot].reshape(len(rows), -1)
        return got, decoder.logits(seqs, rows, calls)

    def _errs(self, pairs) -> dict:
        rows = torch.cat([ref.row_err(got, want) for got, want in pairs])
        block = (self.pos // self.block).repeat(self.B * len(pairs))
        medians = [torch.quantile(rows[block == b], 0.5)
                   for b in torch.unique(block)]
        return {"logit_err": float(rows.max()),
                "logit_err_block_median": float(torch.stack(medians).max())}

    def compare(self, decoder: ref.Decoder) -> dict:
        """Over the kept calls' rows, each row's widest gap to the
        reference's logits (over their rms): the widest row's
        (``logit_err``) and the largest block median
        (``logit_err_block_median``)."""
        return self._errs([self._reference(decoder, i)
                           for i in sorted(self.kept)])

    def control(self, exact: ref.Decoder, low: ref.Decoder) -> dict:
        """The same readings with the low-precision reference in the
        program's place."""
        return self._errs([(self._reference(low, i)[1],
                            self._reference(exact, i)[1])
                           for i in sorted(self.kept)])
