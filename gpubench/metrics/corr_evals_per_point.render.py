"""Kernel B's skinning-MLP evaluations a point, from the traced images:
both phases' evaluations (one at init and one an iteration of each
unmasked point) over phase 1's unmasked points, as the program counted
them (`gpubench/counts.py`)."""
from gpubench.counts import window_counts


def read(facts):
    if facts.get('kind') != 'render' or 'trace' not in facts:
        return None
    counts = window_counts()
    if not counts or not counts.get('corr.p1.points'):
        return None
    return (counts.get('corr.p1', 0) + counts.get('corr.p2', 0)) \
        / counts['corr.p1.points']
