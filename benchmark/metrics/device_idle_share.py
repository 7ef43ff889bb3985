"""Device: the share of the window of replays in which no operation ran
on the card, in percent."""


def read(record):
    if not record["window_us"]:
        return None
    return 100.0 * (1.0 - record["busy_us"] / record["window_us"])
