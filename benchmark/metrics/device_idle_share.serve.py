"""Share of the profiled serving window in which no kernel, copy or memset
ran on the card."""

from benchmark import readers


def read(view):
    return readers.idle_share(view)
