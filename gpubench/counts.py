"""What the per-layer metrics of a traced run read from the program's own
counters (`arah_tpu_torch/utils/trace.py`), and kernel B's least time
from them.

The program counts only while a `torch.profiler` session records, and in
a run the one session is the harness's trace of the window's traced
images (`devtrace.Tracer`), so what `window_counts` reads once the run
has ended is that trace's: the host's syncs by name, and kernel B's
evaluations by phase (one at init and one an iteration of each unmasked
point), phase 1's unmasked points, its rows and launches. A program
without the counters (a tree older than them) gives None, and so do the
readers.

B's least time is `chip_smoke.py:check_corr`'s bound, frozen: the larger
of its evaluations' operations at the f32 peak (each the skinning MLP's
products, its softplus, the 24-bone blend and the Broyden update) and
its bytes at the HBM's (each row's inputs and outputs, the weights once
a launch). The skinning MLP's widths are the configuration's, the cell's
that the command line names.
"""
from __future__ import annotations

import json
import os
import sys

from gpubench.flops import PEAK

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# a row of B: x_bar, x0 (3 f32 each), T0 (16 f32) and the mask in; x_hat,
# T (3 and 16 f32), valid and active out
B_ROW_BYTES = 12 + 12 + 64 + 1 + 12 + 64 + 2


def window_counts():
    """The program's counts of the traced window ({name: int}), or None
    where the program keeps none or counted nothing."""
    try:
        from arah_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.take_counts(reset=False) or None


def cell_config(argv=None):
    """The configuration of the cell that the command line's `--workload`
    names (`run.py`'s), or None where it names none."""
    argv = sys.argv if argv is None else argv
    name = None
    for i, a in enumerate(argv):
        if a == '--workload' and i + 1 < len(argv):
            name = argv[i + 1]
        elif a.startswith('--workload='):
            name = a.split('=', 1)[1]
    if name is None:
        return None
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        cells = {w['name']: w for w in json.load(f)['workloads']}
    if name not in cells:
        return None
    with open(os.path.join(HERE, 'configs',
                           cells[name]['config'] + '.json')) as f:
        return json.load(f)


def skin_dims(cfg) -> list:
    """The skinning MLP's widths, input to output, of a configuration."""
    from gpubench.reference import config as rconfig
    sk = rconfig.model_config(cfg).skinning
    return [sk.d_in] + [sk.d_hidden] * sk.n_layers + [sk.d_out]


def b_least_s(evals: int, rows: int, launches: int, dims) -> float:
    """Kernel B's least seconds for `evals` MLP evaluations over `rows`
    rows in `launches` launches of a skinning MLP of widths `dims`."""
    macs = sum(int(a) * int(b) for a, b in zip(dims[:-1], dims[1:]))
    flops_eval = 2 * macs + 4 * sum(dims[1:-1]) + 2 * 24 * 16 + 250
    nbytes = rows * B_ROW_BYTES + launches * 4 * (macs + 600)
    return max(evals * flops_eval / PEAK['f32'], nbytes / PEAK['hbm'])
