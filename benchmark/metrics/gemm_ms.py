"""Model layers: device ms of the cuBLAS group a loop body, from the
profile of replays."""

from benchmark.trace import device_us, kernel_group


def read(record):
    us = device_us(record, lambda n: kernel_group(n) == "cuBLAS GEMM")
    if not us or not record["bodies"]:
        return None
    return us / 1e3 / record["bodies"]
