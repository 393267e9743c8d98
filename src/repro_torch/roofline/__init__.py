"""Roofline analysis from the dry run's traced graphs (port of
``repro/roofline``; ``graph_parse`` stands where ``hlo_parse`` does)."""

from repro_torch.roofline.analysis import RooflineTerms, compute_terms
from repro_torch.roofline.graph_parse import (
    CollectiveStats, collective_bytes, parse_graph_shapes)

__all__ = ["CollectiveStats", "collective_bytes", "parse_graph_shapes",
           "RooflineTerms", "compute_terms"]
