"""A cell at a size the CPU holds: its configuration and traffic with a
64 x 64 image and a pool of two images, run on the CPU, where every
kernel of the program computes its plain version. The fit runs 150 steps
(an unfitted SIREN's level set leaves a few per cent of the image's rays
grazing it, where the two sides' roots part by round-off) and is not
cached."""
import json
import os
import time

from gpubench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cells() -> dict:
    """workload -> its entry in BENCHMARK.json."""
    return {w['name']: w for w in load(ROOT, 'BENCHMARK.json')['workloads']}


def tiny_run(workload: str, seed: int = 1910724965, fault=None,
             seconds: float = 0.2) -> harness.Run:
    cell = cells()[workload]
    cfg = load(HERE, 'configs', cell['config'] + '.json')
    tr = load(HERE, 'traffic', cell['traffic'] + '.json')
    scene = cfg['scene']
    scene['cameras']['focal'] *= 64 / max(scene['img_size'])
    scene['img_size'] = [64, 64]
    tr.update(pool=2, checked_images=1, chunk=512, fit_steps=150)
    return harness.Run(workload, cfg, tr,
                       load(HERE, 'limits', workload + '.json'), seed,
                       seconds, False, 'cpu', time.perf_counter(), fault)


def run_tiny(workload: str, **kw):
    """(Outcome, correct) of a tiny run."""
    import importlib
    import torch
    torch.set_num_threads(4)
    r = tiny_run(workload, **kw)
    kind = importlib.import_module('gpubench.kinds.' + r.traffic['kind'])
    out = kind.run(r)
    return out, harness.verdict(out.checks)
