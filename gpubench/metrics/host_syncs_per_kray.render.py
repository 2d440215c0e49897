"""The host's waits for the device stream a thousand rendered rays, from
the traced images: the program's sync points passed while the trace
recorded (each an `arah.<layer>.sync.<what>` span, counted by the
program; `gpubench/counts.py`)."""
from gpubench.counts import window_counts


def read(facts):
    if facts.get('kind') != 'render' or 'trace' not in facts:
        return None
    counts = window_counts()
    if counts is None:
        return None
    syncs = sum(v for k, v in counts.items() if '.sync.' in k)
    return syncs / (facts['rays'] / 1000.0)
