"""One epoch of ``configs/acmgcnpp-penn94.json``: ACM-GCN++ with the
structure channel (T = 4, LayerNorm, the input Linear), F = 4,814 > 128
so the dropped training branch projects first and gathers the
projections, bf16 projections and sparse products."""

from benchmark.countlib import Counts, acm_two_layer


def epoch(config: dict) -> Counts:
    return acm_two_layer(config)
