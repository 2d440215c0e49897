"""The control of a train cell, and the program's readings beside it, over
many seeds in one process: what the limits of `gpubench/limits/` of the
train cells are set from. The benchmark's own runs never run it.

    python3 gpubench/control_train.py --workload h36m_s9.train \\
        --seeds 11 22 33 --seconds 3 [--no-program] [--no-control] \\
        [--fault dropped_smpl_grad] [--out FILE]

For each seed it runs the cell as `run.py` does (`--seconds` of window,
the compared steps checked against the reference; with `--fault`, a
fault planted in the program, as the CPU tests plant it) and then the
control: the reference computed one precision lower
(`reference/precision.py:lower`: fp8 products where the configuration
states bf16, bf16 where it states f32) put in the program's place on two
steps of the pool from the initial parameters (the pool's first in the
seed's order and one drawn from the seed, each with the seed's draws),
compared with the reference by the cell's own checks. It prints one JSON
line a seed: the seed, each side's checks ({name: value}) and each
side's `correct` under the cell's limits, and appends the lines to
`--out`.
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
    from gpubench import train_inputs
    from gpubench.kinds import train
    from gpubench.reference import train as rtrain
    from gpubench.reference.precision import lower
    device = torch.device(r.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = train.prepare(r)
    P, tr = len(s.pool), r.traffic
    w = rtrain.loss_weights(r.cfg, s.n_rays)
    paths = [p for p, _ in rtrain.leaves(s.params)]
    labels = {p: rtrain.label(p, bool(r.cfg['training'].get(
        'train_skinning_net', False))) for p in paths}
    compared, points, guarded = [], 0, 0
    for j in train.compared_units(r.seed, P, tr['trace_steps']):
        draws = train_inputs.step_draws(r.seed, j, tr['blocks'], s.n_rays,
                                        s.ref_cfg, device)
        snap = {'k': s.order[j % P], 'adam': {},
                'params': {p: t.detach().cpu() for p, t in
                           rtrain.leaves(s.params)},
                'draws': [t.cpu() for t in draws]}
        with lower():
            lo_loss, lo_grads, lo_after, lo_counts, _, _ = \
                train.reference_step(s, r.cfg, w, snap, device)
        ref_loss, grads, after, _, before, denom = train.reference_step(
            s, r.cfg, w, snap, device)
        g = train.gaps({'loss': lo_loss['loss'], 'grads': lo_grads,
                        'after': lo_after},
                       {'loss': ref_loss['loss'], 'grads': grads,
                        'after': after, 'denom': denom}, before, labels)
        print('control step: grad gaps ' + ', '.join(
            f'{n} {v:.3g}' for n, v in g['groups']['grad'].items()),
            file=sys.stderr)
        compared.append(g)
        points += lo_counts['points']
        guarded += lo_counts['guarded']
        del lo_grads, lo_after, grads, after, before, denom
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    return train.checks_of(1, compared, r.limits, 0,
                           guarded / points if points else float('nan'),
                           s.refine)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--no-program', action='store_true')
    ap.add_argument('--no-control', action='store_true')
    ap.add_argument('--fault', choices=('dropped_smpl_grad',
                                        'unguarded_singular', 'wide_floor'),
                    help='plant this fault in the program')
    ap.add_argument('--out')
    args = ap.parse_args(argv)

    import torch
    from gpubench import harness
    from gpubench.kinds import train
    from gpubench.run import _load_json, cell_of
    if not torch.cuda.is_available():
        print('control: no CUDA device', file=sys.stderr)
        return 2
    bench = _load_json(ROOT, 'BENCHMARK.json')
    cell, _, _ = cell_of(bench, args.workload)
    traffic = _load_json(HERE, 'traffic', cell['traffic'] + '.json')
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
            out = train.run(r)
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
