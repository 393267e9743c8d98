"""Sharding rules + mesh-aware partitioning for the production meshes
(port of ``repro/distribution``)."""

from repro_torch.distribution.sharding import (
    P, batch_spec, cache_shardings, make_spec, opt_state_shardings,
    param_shardings, to_placements)

__all__ = ["P", "batch_spec", "cache_shardings", "make_spec",
           "opt_state_shardings", "param_shardings", "to_placements"]
