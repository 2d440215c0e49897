"""Host milliseconds inside the program's `train.frame` spans (each
block's frame recomputed from the learnable SMPL leaves) a train step,
from the traced steps; nothing where the step refines no SMPL or the
program has no such span."""


def read(facts):
    if facts.get('kind') != 'train' or not facts.get('steps'):
        return None
    span = facts.get('spans', {}).get('train.frame')
    if not span:
        return None
    return 1e3 * span[1] / facts['steps']
