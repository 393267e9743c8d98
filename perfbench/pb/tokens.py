"""Token ids: Zipf(s) over the ranks of the vocabulary, the ranks mapped
to ids by a permutation drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch


def zipf_cdf(vocab: int, s: float) -> np.ndarray:
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -s
    c = np.cumsum(w)
    return c / c[-1]


class DeviceStream:
    """Batches of ids made on the device from the seed: no copy from the
    host once it is built."""

    def __init__(self, vocab: int, s: float, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.cdf = torch.from_numpy(zipf_cdf(vocab, s)).to(device)
        self.perm = torch.randperm(vocab, generator=self.gen, device=device)
        self.device = device

    def next(self, batch: int, seq: int) -> torch.Tensor:
        u = torch.rand((batch, seq), generator=self.gen, device=self.device,
                       dtype=torch.float64)
        rank = torch.searchsorted(self.cdf, u).clamp_(max=len(self.cdf) - 1)
        return self.perm[rank].to(torch.int32)
