"""Kernel B's share of its roofline while images render: its least time
from the evaluations, rows and launches the program counted in the
traced images (`counts.b_least_s`, the configuration's skinning MLP)
over B's device time there, in percent."""
from gpubench.counts import b_least_s, cell_config, skin_dims, window_counts


def read(facts):
    if facts.get('kind') != 'render' or 'trace' not in facts:
        return None
    dev = facts['trace'].family_s.get('B')
    counts = window_counts()
    cfg = cell_config()
    if not dev or not counts or 'corr.launches' not in counts \
            or cfg is None:
        return None
    least = b_least_s(counts.get('corr.p1', 0) + counts.get('corr.p2', 0),
                      counts['corr.rows'], counts['corr.launches'],
                      skin_dims(cfg))
    return 100.0 * least / dev
