"""The share of the traced window in which nothing ran on the card:
1 − (union of device-busy intervals) / (traced span), over whole calls."""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "solves_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
