"""One epoch of ``configs/acmgcnp-twitch_gamers.json``: ACM-GCN+ (T = 3,
LayerNorm), the first layer hoisted on both branches (F = 7 <= 128), f32
projections, bf16 sparse products."""

from benchmark.countlib import Counts, acm_two_layer


def epoch(config: dict) -> Counts:
    return acm_two_layer(config)
