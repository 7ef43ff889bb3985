"""Trainer loop: host ms of the one capture of the run
(``SplitState.capture_ms`` of set-up's warm-up split)."""


def read(record):
    return record.get("capture_ms")
