"""The control of a cell, and the program's readings beside it, over many
seeds in one process: what the limits of `gpubench/limits/` are set
from. The benchmark's own runs never run it.

    python3 gpubench/control.py --workload zju313.novel_view \\
        --seeds 11 22 33 --seconds 3 [--no-program] [--no-control] \\
        [--fault half_batch] [--out FILE]

For each seed it runs the cell as `run.py` does (`--seconds` of window,
the program checked against the reference; with `--fault`, a fault
planted in the program's timed path, as the CPU tests plant it) and then
the control: the
reference computed one precision lower (`reference/precision.py:lower`:
fp8 products where the configuration states bf16, bf16 where it states
f32) put in the program's place, compared with the reference by the
cell's own checks on the same inputs. It prints one JSON line a seed:
the seed, each side's checks ({name: value}) and each side's `correct`
under the cell's limits, and appends the lines to `--out`.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or '.') not in (HERE, ROOT)]


def control_checks(r) -> list:
    """The cell's checks of the control against the reference."""
    import torch
    from gpubench.kinds import render
    from gpubench.reference.precision import lower
    device = torch.device(r.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = render.prepare(r)
    keys = render.checked_keys(range(len(s.items)), s.items, r.seed,
                               r.traffic['checked_images'])
    compared = []
    for k in keys:
        chunk = r.traffic['chunk']
        with lower():
            rgb, depth, hit = render.reference_of(s, k, device, chunk)
        low = (rgb, None, depth, hit)
        ref = render.reference_of(s, k, device, chunk)
        print('control ' + render.depth_profile(low, ref), file=sys.stderr)
        compared.append(render.compare(low, ref, r.traffic['rgb_tol'],
                                       r.traffic['depth_tol']))
    return render.checks_of(1, compared, r.limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--no-program', action='store_true')
    ap.add_argument('--no-control', action='store_true')
    ap.add_argument('--fault', choices=('half_batch', 'altered_answer',
                                        'moved_roots'),
                    help='plant this fault in the program\'s timed path')
    ap.add_argument('--out')
    args = ap.parse_args(argv)

    import importlib
    import torch
    from gpubench import harness
    from gpubench.run import _load_json, cell_of
    if not torch.cuda.is_available():
        print('control: no CUDA device', file=sys.stderr)
        return 2
    bench = _load_json(ROOT, 'BENCHMARK.json')
    cell, _, _ = cell_of(bench, args.workload)
    traffic = _load_json(HERE, 'traffic', cell['traffic'] + '.json')
    kind = importlib.import_module('gpubench.kinds.' + traffic['kind'])
    for seed in args.seeds:
        r = harness.Run(
            workload=args.workload,
            cfg=_load_json(HERE, 'configs', cell['config'] + '.json'),
            traffic=traffic,
            limits=_load_json(HERE, 'limits', args.workload + '.json'),
            seed=seed, seconds=args.seconds, trace=False, device='cuda',
            t0=time.perf_counter(), fault=args.fault)
        line = {'workload': args.workload, 'seed': seed,
                'card': harness.card(), 'fault': args.fault}
        if not args.no_program:
            out = kind.run(r)
            line['program'] = {c.name: c.value for c in out.checks}
            line['program_correct'] = harness.verdict(out.checks)
            line['e2e'] = out.e2e
            del out
            torch.cuda.empty_cache()
        if not args.no_control:
            t0 = time.perf_counter()
            checks = control_checks(r)
            line['control'] = {c.name: c.value for c in checks}
            line['control_correct'] = harness.verdict(checks)
            line['control_s'] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(text + '\n')
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
