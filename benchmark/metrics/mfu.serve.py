"""Model FLOPs of the requests computed in the profiled window (their
unpadded frames, benchmark/work.py) over its wall time and the card's peak
for the configuration's type."""

from benchmark import readers


def read(view):
    return readers.mfu(view)
