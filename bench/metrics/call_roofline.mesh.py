"""The traced calls' least time (their work's bytes over the HBM bandwidth
of all the cards, ``bench/yardstick.py``) over the cards' mean device busy
time in them."""
from bench import readers


def read(ctx):
    return readers.roofline_pct(ctx)
