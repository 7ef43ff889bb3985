"""Model layers: device ms of ATen's copy and dtype-conversion kernels a
loop body (not memcpy or memset), from the profile of replays."""

from benchmark.trace import device_us, is_cast


def read(record):
    us = device_us(record, is_cast)
    if not us or not record["bodies"]:
        return None
    return us / 1e3 / record["bodies"]
