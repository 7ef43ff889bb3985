"""Trainer loop: device operations (kernels, copies, sets) a loop body in
the profile of replays."""


def read(record):
    if not record["ops"] or not record["bodies"]:
        return None
    return len(record["ops"]) / record["bodies"]
