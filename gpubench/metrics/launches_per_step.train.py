"""Device kernel launches a train step, from the traced steps."""


def read(facts):
    if facts.get('kind') != 'train' or 'trace' not in facts \
            or not facts.get('steps'):
        return None
    return facts['trace'].launches / facts['steps']
