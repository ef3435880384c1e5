"""Compiled-artifact analysis: HLO collective accounting + roofline terms."""
from .hlo import collective_bytes, parse_collectives, xla_cost_dict
from .roofline import RooflineTerms, roofline

__all__ = ["collective_bytes", "parse_collectives", "xla_cost_dict",
           "RooflineTerms", "roofline"]
