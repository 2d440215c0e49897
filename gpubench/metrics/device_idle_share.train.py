"""The device's idle share while the train step runs: 1 - the union of the
kernels' intervals over the traced window, from the first traced
`train.step` span to the window's end (the last traced step
synchronised), in percent."""


def read(facts):
    if facts.get('kind') != 'train' or 'trace' not in facts:
        return None
    t = facts['trace']
    return 100.0 * (1.0 - t.busy_s / t.window_s)
