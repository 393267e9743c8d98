"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell on the CPU at a small size (the
look for a card skipped), with the cell's own limits, and breaks the
program in one way the cell can be broken.  The program runs with
float32 activations here, so that a sound run reads rounding alone and
whatever a broken one reads is the fault's."""

import pytest
import torch

import tiny
from pb import harness, manifest as mf

SEED = 2 ** 31 + 555


def _run(cell, hooks=None):
    out = harness.run_cell(cell, SEED, 1.0, False, device="cpu",
                           overrides=tiny.overrides(
                               cell, activation_dtype="float32"),
                           hooks=hooks)
    return out["correct"], out["_compared"]


def _answer_altered(run):
    orig = run.M.forward

    def forward(cfg, params, batch, **kw):
        logits = orig(cfg, params, batch, **kw)
        return torch.roll(logits, shifts=1, dims=1)
    return {"forward": forward}


def _positions_altered(lo, hi):
    """The logits of positions [lo * T, hi * T) shifted by one along the
    vocabulary where ``forward`` produces them, the others untouched."""
    def make(run):
        orig = run.M.forward

        def forward(cfg, params, batch, **kw):
            logits = orig(cfg, params, batch, **kw)
            T = logits.shape[1]
            a, b = int(lo * T), int(hi * T)
            logits[:, a:b] = torch.roll(logits[:, a:b], shifts=1, dims=-1)
            return logits
        return {"forward": forward}
    return make


def _half_batch(run):
    orig = run.M.forward

    def forward(cfg, params, batch, **kw):
        toks = batch["tokens"]
        half = orig(cfg, params, {"tokens": toks[:toks.shape[0] // 2]}, **kw)
        mean = half.mean(dim=0, keepdim=True)
        return mean.expand(toks.shape[0], *half.shape[1:]).contiguous()
    return {"forward": forward}


# The score cells have no step with state and no exchange between chips.
# ``later_half``: the experts' second group of a qwen3 call; ``one_block``:
# one block of ``sample_block`` positions (a query tile of attention).
FAULTS = {"answer_altered": _answer_altered, "half_batch": _half_batch,
          "later_half": _positions_altered(0.5, 1.0),
          "one_block": _positions_altered(0.5, 0.75)}
CELLS = [w["name"] for w in mf.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    ok, compared = _run(cell)
    assert ok, compared


# A batch of one has no half to leave out.
CASES = [(f, c) for f in FAULTS for c in CELLS
         if not (f == "half_batch" and c.startswith("qwen3"))]


@pytest.mark.parametrize("fault,cell", CASES)
def test_fault_is_caught(fault, cell, monkeypatch):
    def hooks(run):
        for name, fn in FAULTS[fault](run).items():
            monkeypatch.setattr(run.M, name, fn)
    ok, compared = _run(cell, hooks)
    assert not ok, compared
