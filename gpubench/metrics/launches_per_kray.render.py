"""Device kernel launches a thousand rendered rays, from the traced
images."""


def read(facts):
    if facts.get('kind') != 'render' or 'trace' not in facts:
        return None
    return facts['trace'].launches / (facts['rays'] / 1000.0)
