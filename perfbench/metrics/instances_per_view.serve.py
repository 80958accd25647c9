"""Rows binning made per served view before the cap ((Gaussian, tile) pairs
and one row per Gaussian on no tile): the program's instances counter
(window A). Nothing without the program's spans (perfbench/spans.py)."""
from perfbench import spans


def read(t):
    return spans.counter(t, "instances")
