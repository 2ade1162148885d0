"""The traced calls' least time (their work's bytes over the card's HBM
bandwidth, ``bench/yardstick.py``) over the device's busy time in them."""
from bench import readers


def read(ctx):
    return readers.roofline_pct(ctx)
