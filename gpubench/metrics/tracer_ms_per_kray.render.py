"""Device milliseconds of the tracer's kernels (A knn, B corr, E march, F
iso) a thousand rendered rays, from the traced images."""

TRACER = ('A', 'B', 'E', 'F')


def read(facts):
    if facts.get('kind') != 'render' or 'trace' not in facts:
        return None
    fam = facts['trace'].family_s
    if not any(k in fam for k in TRACER):
        return None
    return 1e3 * sum(fam.get(k, 0.0) for k in TRACER) \
        / (facts['rays'] / 1000.0)
