"""The device's idle share while images render: 1 - the union of the
kernels' intervals over the traced window, in percent."""


def read(facts):
    if facts.get('kind') != 'render' or 'trace' not in facts:
        return None
    t = facts['trace']
    return 100.0 * (1.0 - t.busy_s / t.window_s)
