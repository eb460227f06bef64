"""Drivers, one a kind of traffic: each has run(rc) -> dict (see run.py)."""
