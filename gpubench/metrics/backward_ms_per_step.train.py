"""Host milliseconds inside the program's `train.backward` spans (each
block's backward pass, launched) a train step, from the traced steps;
nothing where the program has no such span."""


def read(facts):
    if facts.get('kind') != 'train' or not facts.get('steps'):
        return None
    span = facts.get('spans', {}).get('train.backward')
    if not span:
        return None
    return 1e3 * span[1] / facts['steps']
