"""Host build: seconds of ``prepare_data`` (the benchmark's clock around
it, the card synchronized on both sides)."""


def read(record):
    return record.get("prepare_s")
