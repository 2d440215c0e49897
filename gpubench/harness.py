"""What every run shares: the run's settings, the checks that decide
`correct`, the card's description, the look for JAX in the process, and
the result line."""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from typing import Any, NamedTuple

# top-level module names that no run may hold once its window has closed:
# the JAX package and JAX itself (compared whole: `arah_tpu_torch` is not
# `arah_tpu`)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'arah_tpu')


class Run(NamedTuple):
    """One run of one cell."""
    workload: str
    cfg: dict            # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    limits: dict         # limits/<workload>.json: check name -> limit
    seed: int
    seconds: float
    trace: bool
    device: Any          # 'cuda', or 'cpu' in the CPU tests
    t0: float            # perf_counter at the process's start
    fault: str | None = None   # a planted fault (the tests' only)


class Check(NamedTuple):
    """One condition of `correct`: `value <= limit` ('max') or `value >=
    limit` ('min'). A value that is not a number fails."""
    name: str
    value: float
    limit: float
    rule: str = 'max'

    @property
    def ok(self) -> bool:
        v = float(self.value)
        if math.isnan(v):
            return False
        return v <= self.limit if self.rule == 'max' else v >= self.limit


def verdict(checks) -> bool:
    """`correct`: every printed check holds, and there is at least one."""
    return len(checks) > 0 and all(c.ok for c in checks)


class Outcome(NamedTuple):
    """What a cell's kind hands back from one run."""
    e2e: dict            # end-to-end metric name -> value
    facts: dict          # what the per-layer readers read (traced runs)
    checks: list         # [Check]
    attempted: int
    failed: int
    memory_peak_bytes: int


def card() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        return out[0] if out else 'nvidia-smi gave nothing'
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi not available'


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among the module names `names`
    (by default those `sys.modules` holds), compared whole."""
    tops = {name.split('.')[0] for name in list(
        sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def check_line(c: Check) -> str:
    op = '<=' if c.rule == 'max' else '>='
    return (f'check {c.name}: {c.value!r} {op} {c.limit!r} '
            f'{"ok" if c.ok else "FAILED"}')


def _number(v):
    """A float for the JSON line; None where it is not finite."""
    v = float(v)
    return v if math.isfinite(v) else None


def emit(outcome: Outcome, metrics: dict, device: dict, breakdown=None):
    """The checks on standard error (last lines there) and the result as
    the last line of standard output, its `checks` key last."""
    correct = verdict(outcome.checks)
    for c in outcome.checks:
        print(check_line(c), file=sys.stderr)
    print(f'correct: {correct}', file=sys.stderr, flush=True)
    line = {'correct': correct, 'attempted': int(outcome.attempted),
            'failed': int(outcome.failed), 'metrics': metrics,
            'device': device}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['checks'] = {c.name: {'value': _number(c.value), 'limit': c.limit,
                               'rule': c.rule} for c in outcome.checks}
    print(json.dumps(line), flush=True)
    return correct


def closed_loop(call, seconds: float, trace_units: int = 0,
                trace_from: int = 1, multiple: int = 1):
    """call(i) for i = 0, 1, ... back to back until `seconds` have passed
    and the units done are a whole multiple of `multiple` (a whole number
    of passes over a pool; the unit in flight finishes). With
    `trace_units`, units trace_from .. trace_from + trace_units - 1 run
    under the tracer, and the loop does not end before they have.
    Returns (seconds of each unit, each unit's output, the window's
    seconds, the trace's summary or None)."""
    from gpubench.devtrace import Tracer, window
    times, outs = [], []
    stack, tracer, summary = None, None, None
    t_start = t_prev = time.perf_counter()
    i = 0
    while True:
        if trace_units and i == trace_from:
            stack = contextlib.ExitStack()
            tracer = stack.enter_context(Tracer())
            stack.enter_context(window())
        outs.append(call(i))
        now = time.perf_counter()
        times.append(now - t_prev)
        t_prev = now
        i += 1
        if stack is not None and i == trace_from + trace_units:
            stack.close()
            stack, summary = None, tracer.summary
            # the trace's export and reduction are no unit's time
            t_prev = time.perf_counter()
        if now - t_start >= seconds and i % multiple == 0 and (
                not trace_units or summary is not None):
            return times, outs, t_prev - t_start, summary
