"""The host's waits for the device stream a train step, from the traced
steps: the program's sync points passed while the trace recorded (each
an `arah.<layer>.sync.<what>` span, counted by the program: the render
path's and the train step's); nothing where the program counts none of
the train step's."""


def read(facts):
    if facts.get('kind') != 'train' or not facts.get('steps'):
        return None
    counts = facts.get('counts') or {}
    if not any(k.startswith('train.sync.') for k in counts):
        return None
    syncs = sum(v for k, v in counts.items() if '.sync.' in k)
    return syncs / facts['steps']
