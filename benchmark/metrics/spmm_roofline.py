"""Kernels (K1): the least bytes of an epoch's sparse traversals
(``countlib.Traversal``) at the H100's 3.35 TB/s, over K1's device time a
loop body in the profile of replays, in percent."""

from benchmark.peaks import HBM_BYTES_PER_S
from benchmark.trace import device_us, kernel_group


def read(record):
    us = device_us(record, lambda n: kernel_group(n) == "K1 spmm")
    if not us or not record["bodies"]:
        return None
    least_s = record["counts"].traversal_bytes() / HBM_BYTES_PER_S
    return 100.0 * least_s / (us * 1e-6 / record["bodies"])
