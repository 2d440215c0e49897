"""The benchmark of `arah_tpu_torch` on NVIDIA GPUs: one run of one cell.

    python3 gpubench/run.py --workload zju313.novel_view --seed 7 \\
        --seconds 40 --trace 0

From the root of a checkout. It reads the cell from `BENCHMARK.json`,
its configuration from `gpubench/configs/<config>.json`, its traffic mix
from `gpubench/traffic/<traffic>.json` (whose `kind` names the driver in
`gpubench/kinds/`) and the limits of its checks from
`gpubench/limits/<workload>.json`. It makes every input and weight from
`--seed`, warms up, measures for `--seconds`, and checks what the timed
path produced against the plain reference (`gpubench/reference/`).
With `--trace 0` it reports the cell's end-to-end metrics; with
`--trace 1` the per-layer ones, each read by `gpubench/metrics/<name>.py`
from a profiler trace of part of the window.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` when
traced), and last `checks`, every condition of `correct` with its value
and limit; the same checks are the last lines of standard error.
`correct` is exactly the conjunction of those checks. Without a CUDA
device, or with fewer than the cell asks for, it exits with code 2 and
prints no result; with JAX or the JAX package loaded once the window has
closed, code 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the package is imported as `gpubench` from the checkout's root, never
# its modules by their bare names (one of them would shadow the stdlib)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or '.') not in (HERE, ROOT)]


def _load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str):
    """(the cell's entry, its end-to-end and per-layer metric entries)."""
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; the cells are '
                         f'{sorted(cells)}')

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get('workloads', [workload])]
    return cells[workload], mine(bench['end_to_end']), \
        mine(bench['per_layer'])


def read_metric(name: str, facts: dict):
    """The per-layer metric `name` from its reader,
    `gpubench/metrics/<name>.py:read(facts)`; None where it finds
    nothing to read."""
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'gpubench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(facts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = _load_json(ROOT, 'BENCHMARK.json')
    cell, e2e_specs, layer_specs = cell_of(bench, args.workload)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell['chips']:
        print(f'gpubench: {cell["chips"]} CUDA device(s) needed, {found} '
              'found', file=sys.stderr)
        return 2

    from gpubench import harness
    traffic = _load_json(HERE, 'traffic', cell['traffic'] + '.json')
    run = harness.Run(
        workload=args.workload,
        cfg=_load_json(HERE, 'configs', cell['config'] + '.json'),
        traffic=traffic,
        limits=_load_json(HERE, 'limits', args.workload + '.json'),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device='cuda', t0=T0)
    kind = importlib.import_module('gpubench.kinds.' + traffic['kind'])
    out = kind.run(run)

    breakdown = None
    if args.trace:
        summary = out.facts['trace']
        metrics = {}
        for m in layer_specs:
            v = read_metric(m['name'], out.facts)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        breakdown = {'device_ops': summary.top_ops,
                     'idle_gaps': summary.idle_gaps}
    else:
        metrics = {m['name']: {'value': out.e2e[m['name']],
                               'unit': m['unit']} for m in e2e_specs}
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': cell['chips'],
              'memory_peak_bytes': int(out.memory_peak_bytes)}
    if args.trace:
        device.update(busy_s=out.facts['trace'].busy_s,
                      window_s=out.facts['trace'].window_s)
    print(f'card: {harness.card()}', file=sys.stderr)

    bad = harness.forbidden_modules()
    if bad:
        print(f'gpubench: the process holds {bad} after the window',
              file=sys.stderr)
        return 3
    harness.emit(out, metrics, device, breakdown)
    return 0


if __name__ == '__main__':
    sys.exit(main())
