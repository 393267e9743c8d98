"""Three-term roofline from dry-run records, at the H100's constants.

Port of ``repro/roofline/analysis.py``, with the same math:

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

The denominators are ``launch/mesh.py``'s H100 SXM datasheet figures
(989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 50 GB/s a GPU on the
inter-node link).  These are planning estimates from traced graphs, not
measurements.

Loop-body composition: the dry run traces the step with the trunk cut
to one superblock, and one superblock alone (fwd, and fwd+bwd for
training), so totals are composed as the reference composes them:

    total = full_graph_cost + (n_superblocks - 1) * block_cost
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                   # PER-CHIP (counted on the local graph)
    hbm_bytes: float               # PER-CHIP
    collective_bytes: float        # PER-CHIP wire bytes (ring model)
    model_flops: float             # GLOBAL (6*N*D etc.)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0      # MODEL_FLOPS / traced FLOPs
    roofline_fraction: float = 0.0  # model-flops time / bound

    def finalize(self) -> "RooflineTerms":
        # The local graph's FLOPs and operand shapes are one chip's, so
        # all three numerators here are per-chip; the spec's
        # global/(chips * rate) is identical to per_chip/rate.
        self.compute_s = self.flops / PEAK_FLOPS_BF16
        self.memory_s = self.hbm_bytes / HBM_BW
        self.collective_s = self.collective_bytes / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / (self.flops * self.chips)
                             if self.flops else 0.0)
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        ideal = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        self.roofline_fraction = ideal / bound if bound > 0 else 0.0
        return self


def compute_terms(record: dict) -> RooflineTerms:
    """Build roofline terms from one dry-run JSON record."""
    n_sb = record["n_superblocks"]
    full = record["cost"]
    blk = record.get("block_cost")         # may be None for tiny models
    extra = (n_sb - 1) if blk else 0
    flops = full.get("flops", 0.0) + extra * (blk or {}).get("flops", 0.0)
    hbm = full.get("bytes accessed", 0.0) \
        + extra * (blk or {}).get("bytes accessed", 0.0)
    coll = record["collectives"]["wire_bytes_total"] \
        + extra * record.get("block_collectives", {}).get(
            "wire_bytes_total", 0.0)
    return RooflineTerms(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        chips=record["chips"],
        flops=flops, hbm_bytes=hbm,
        collective_bytes=coll,
        model_flops=record["model_flops"],
    ).finalize()
