"""Traffic is a function of the mix and the seed alone."""

import torch

from pb import tokens


def test_device_stream_is_deterministic_per_seed():
    big = 2 ** 31 + 7
    a = tokens.DeviceStream(1000, 1.5, big, "cpu")
    b = tokens.DeviceStream(1000, 1.5, big, "cpu")
    x1, x2 = a.next(2, 64), a.next(2, 64)
    assert torch.equal(x1, b.next(2, 64)) and torch.equal(x2, b.next(2, 64))
    assert not torch.equal(x1, x2)
    assert x1.dtype == torch.int32 and int(x1.max()) < 1000


def test_zipf_ranks_follow_the_law():
    cdf = tokens.zipf_cdf(1000, 1.5)
    p1 = cdf[0]
    assert abs(p1 - 1.0 / sum(k ** -1.5 for k in range(1, 1001))) < 1e-12
    draws = tokens.DeviceStream(1000, 1.5, 5, "cpu").next(4, 50_000)
    top = tokens.DeviceStream(1000, 1.5, 5, "cpu").perm[0]
    assert abs((draws == top).double().mean().item() - p1) < 0.01
