"""Repeat clean builds of kernels B and L's source and compare ptxas's
reports.

    python3 -m arah_tpu_torch.utils.ptxas_builds [--tree DIR ...]
        [--copies 6] [--out .cache/ptxas_builds]

For each checkout DIR (by default the one that holds this file) it starts
`--copies` compiles of `arah_tpu_torch/csrc/corr_rows.cu` all together,
each `nvcc -c` with `ops/_build.py`'s flags and `-Xptxas -v` in a
directory of its own (nothing cached), and writes each build's log to
`--out` as `<tree>_<k>.log`. Then it prints, per function ptxas reports
(the `corr_kernel<...>` entries, and every device function of the source
that was not inlined), its registers, stack and spills in each
build, whether the builds agree, and a JSON line
{tree: {"builds", "identical_logs", "spilling_builds", "functions":
{name: [[registers, stack, spill stores, spill loads], ...]}}}. It exits 1
if any build spills in a reported function. Needs `nvcc`; no card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = 'corr_rows.cu'
PREFIX = 'corr_kernel<'


def start(tree: str, nvcc: str, flags: list) -> tuple:
    """One clean compile of SOURCE in `tree`: (process, its temp dir)."""
    csrc = os.path.join(tree, 'arah_tpu_torch', 'csrc')
    tmp = tempfile.mkdtemp(prefix='ptxas_build_')
    proc = subprocess.Popen(
        [nvcc, *flags, '-Xptxas', '-v', '-c', os.path.join(csrc, SOURCE),
         '-o', os.path.join(tmp, SOURCE + '.o')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def main(argv=None) -> int:
    sys.path.insert(0, HERE)
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.utils import ptxas
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--tree', action='append', default=None)
    p.add_argument('--copies', type=int, default=6)
    p.add_argument('--out', default=os.path.join(HERE, '.cache',
                                                 'ptxas_builds'))
    args = p.parse_args(argv)
    trees = [os.path.abspath(t) for t in (args.tree or [HERE])]
    os.makedirs(args.out, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = [(t, k, *start(t, nvcc, _build.NVCC_FLAGS))
            for t in trees for k in range(args.copies)]
    logs = {}
    for t, k, proc, tmp in jobs:
        text, _ = proc.communicate()
        subprocess.run(['rm', '-rf', tmp])
        if proc.returncode != 0:
            print(f'{t} build {k}: nvcc failed\n{text[-3000:]}', flush=True)
            return 1
        logs.setdefault(t, []).append(f'== {SOURCE}\n{text}')
        tag = re.sub(r'\W+', '_', os.path.relpath(t, HERE)).strip('_') \
            or 'this'
        with open(os.path.join(args.out, f'{tag}_{k}.log'), 'w') as fh:
            fh.write(logs[t][-1])
    summary, bad = {}, False
    for t in trees:
        reps = [ptxas.parse(text) for text in logs[t]]
        names = []
        for r in reps:
            ks, callees = ptxas.group(r, [PREFIX])
            names += [n for n in (*ks, *callees) if n not in names]
        funcs, spilling = {}, set()
        for n in names:
            row = []
            for b, r in enumerate(reps):
                f = r.get(n, {})
                row.append([f.get('registers'), f.get('stack'),
                            f.get('spill_stores'), f.get('spill_loads')])
                if n in r and ptxas.spills(f):
                    spilling.add(b)
            funcs[n] = row
            same = all(x == row[0] for x in row)
            print(f'{os.path.relpath(t, HERE) or "."}: {n}: '
                  + ('same in every build ' if same else 'DIFFERS ')
                  + '; '.join(f'{x[0]} registers, stack {x[1]} B, spills '
                              f'{x[2]}/{x[3]} B' for x in
                              (row[:1] if same else row)), flush=True)
        summary[os.path.relpath(t, HERE) or '.'] = {
            'builds': len(reps),
            'identical_logs': len({re.sub(r'Compile time = [\d.]+ ms', '',
                                          x) for x in logs[t]}) == 1,
            'spilling_builds': sorted(spilling), 'functions': funcs}
        bad = bad or bool(spilling)
    print(json.dumps(summary))
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
