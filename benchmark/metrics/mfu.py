"""Whole step: the epoch's model operations (``countlib``), each at the
dense peak of its dtype, over the wall time a loop body takes in the
window of replays, in percent."""

from benchmark.peaks import FLOPS_PER_S


def read(record):
    if not record["window_us"] or not record["bodies"]:
        return None
    at_peak = record["counts"].seconds_at_peak(FLOPS_PER_S)
    return 100.0 * at_peak / (record["window_us"] * 1e-6 / record["bodies"])
