"""Host-clock times of the flagship eval frame, train step and refined
step of one checkout, and an A/B of two checkouts in turns.

    python3 arah_tpu_torch/utils/bench_steps.py [--tree DIR] [--reps 7]
    python3 arah_tpu_torch/utils/bench_steps.py --ab OTHER_DIR [--reps 7]

The first form imports `arah_tpu_torch` from DIR (by default the checkout
that holds this file), builds the bench scene (`scene.build_scene`, seed
0, with its fit) and times, each after one warm-up call and `--reps`
times: `render` of one eval frame of 8,192 rays with the flagship's
straggler splits, the same frame with the splits off, the flagship train
step (`scene.build_train_setup`) and the refined step (`refined=True`).
Each time is the host clock around one synchronised call. It prints one
JSON line: per metric the median and every time, in ms, with the card's
`nvidia-smi` name and power limit.

The second form runs the first on OTHER_DIR (say a `git archive` of the
parent commit) and on this checkout in turns, OTHER, this, this, OTHER,
in child processes (both kernel libraries built first, side by side), and
prints each child's line and then the medians side by side. It needs a
CUDA device; nothing here reads the network.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RAYS = 8192
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRICS = ('frame', 'frame_splits_off', 'step', 'refined_step')


def card() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi not available'


def measure(tree: str, reps: int, build_only: bool = False) -> dict:
    """The first form's numbers for the package in `tree`."""
    sys.path[0] = tree
    import numpy as np
    import torch
    from arah_tpu_torch.ops import _build
    _build.load()
    if build_only:
        return {}
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.render.renderer import render
    from arah_tpu_torch.scene import (build_scene, build_train_setup,
                                      flagship_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    cfg = flagship_config()
    params, fd, inp = build_scene(cfg, RAYS, seed=0)
    off = cfg._replace(tracer=cfg.tracer._replace(
        corr_phase1_steps=0, march_phase1_steps=0, iso_phase1_steps=0))
    times = {}
    for name, c in (('frame', cfg), ('frame_splits_off', off)):
        render(params, c, inp)
        times[name] = [clock(lambda: render(params, c, inp))[0]
                       for _ in range(reps)]
    dev = fd.verts_cano.device
    for name, refined, seed in (('step', False, 3), ('refined_step', True,
                                                     4)):
        s = build_train_setup(cfg, RAYS, scene=(params, fd), refined=refined)
        B, R = s.batch.ray_dirs.shape[:2]
        rng = np.random.RandomState(seed)
        draws = [draw_train_draws(rng, cfg, B, R, dev)
                 for _ in range(1 + reps)]
        state, _ = s.step(s.state, s.batch, draws[0])
        times[name] = []
        for d in draws[1:]:
            ms, (state, losses) = clock(lambda: s.step(state, s.batch, d))
            times[name].append(ms)
        if not bool(torch.isfinite(losses['loss'])):
            raise RuntimeError(f'{name}: loss not finite')
        del s, state, draws
        torch.cuda.empty_cache()
    return {k: {'median': float(np.median(v)), 'ms': v}
            for k, v in times.items()}


def ab(other: str, reps: int) -> int:
    """The second form; returns the exit code."""
    import numpy as np
    me = os.path.abspath(__file__)
    trees = (os.path.abspath(other), HERE)
    builds = [subprocess.Popen([sys.executable, me, '--tree', t,
                                '--build-only']) for t in trees]
    if any(p.wait() for p in builds):
        print('a kernel build failed', file=sys.stderr)
        return 1
    rows = {t: [] for t in trees}
    for t in (trees[0], trees[1], trees[1], trees[0]):
        r = subprocess.run([sys.executable, me, '--tree', t, '--reps',
                            str(reps)], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows[t].append(json.loads(line))
    for m in METRICS:
        med = [[row[m]['median'] for row in rows[t]] for t in trees]
        print(f'{m}: other {[round(v, 1) for v in med[0]]} this '
              f'{[round(v, 1) for v in med[1]]} ms (medians of {reps} calls'
              f' each; this / other {np.mean(med[1]) / np.mean(med[0]):.3f})'
              f' [{card()}]', flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=HERE)
    ap.add_argument('--ab', default=None)
    ap.add_argument('--reps', type=int, default=7)
    ap.add_argument('--build-only', action='store_true')
    a = ap.parse_args(argv)
    if a.ab:
        return ab(a.ab, a.reps)
    out = measure(os.path.abspath(a.tree), a.reps, a.build_only)
    if not a.build_only:
        print(json.dumps({'tree': os.path.abspath(a.tree), 'card': card(),
                          **out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
