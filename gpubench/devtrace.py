"""The device trace of a traced run, and what the per-layer metrics read
from it.

`Tracer` runs `torch.profiler` (CPU and CUDA activities) over part of
the window, exports its Chrome trace to a file under the run's `TMPDIR`,
reads it back and deletes it. `TraceSummary` reduces the kernel events:
the union of their intervals (busy time), the launches, each kernel
family's device time, the operations that took most time, and the
longest idle gaps named by the innermost host operation running when
each began.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import NamedTuple

# The port's kernels by the letters of its kernel table (PERF.md),
# matched on the device event's name. The weight-gradient reduction of H
# and I (`csrc/atb.cuh`) counts to whichever of the two launched last.
FAMILIES = (
    ('A', re.compile(r'\bknn_kernel\b')),
    ('B', re.compile(r'\bcorr_kernel\b')),
    ('C', re.compile(r'\bshade_kernel\b')),
    ('D', re.compile(r'\bcolor_fwd_kernel\b|\bcolor_pose_sums\b')),
    ('E', re.compile(r'\bmarch_kernel\b|\bverts4_kernel\b')),
    ('F', re.compile(r'\biso_kernel\b')),
    ('G', re.compile(r'\bskin_jac_kernel\b')),
    ('H', re.compile(r'\bshade_bwd_kernel\b')),
    ('I', re.compile(r'\bcolor_bwd_kernel\b|\bcolor_pose_epilogue\b')),
    ('J', re.compile(r'\bsiren_kernel\b')),
)
ATB = re.compile(r'\batb_kernel\b|\batb_bf16_kernel\b|\batb_sum\b'
                 r'|\bsum_partials\b')


WINDOW = 'gpubench.window'


def window():
    """The traced window's span: every kernel launched inside it has
    ended when it closes."""
    import contextlib
    import torch

    @contextlib.contextmanager
    def span():
        torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    return span()


def family(name: str):
    for letter, pat in FAMILIES:
        if pat.search(name):
            return letter
    return None


class Kernel(NamedTuple):
    name: str
    start_us: float
    dur_us: float


class TraceSummary(NamedTuple):
    window_s: float          # the traced window, host clock
    busy_s: float            # union of the kernels' intervals
    launches: int            # device kernels in the window
    family_s: dict           # letter -> device seconds
    top_ops: list            # [[name, seconds], ...] most time first
    idle_gaps: list          # [[host op, seconds], ...] longest first


def _union(kernels) -> float:
    busy, end = 0.0, None
    for k in sorted(kernels, key=lambda k: k.start_us):
        a, b = k.start_us, k.start_us + k.dur_us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _short(name: str, n: int = 96) -> str:
    name = re.sub(r'\s+', ' ', name)
    return name if len(name) <= n else name[:n - 3] + '...'


def summarize(events: list, t0_us: float, t1_us: float) -> TraceSummary:
    """Reduce Chrome-trace events to the window [t0_us, t1_us]."""
    kernels, host = [], []
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        ts, dur = float(e['ts']), float(e['dur'])
        if ts < t0_us or ts + dur > t1_us:
            continue
        cat = e.get('cat', '')
        if cat == 'kernel':
            kernels.append(Kernel(e.get('name', '?'), ts, dur))
        elif cat in ('cpu_op', 'user_annotation', 'python_function'):
            host.append((ts, dur, e.get('name', '?')))
    kernels.sort(key=lambda k: k.start_us)
    fam, totals, owner = {}, {}, None
    for k in kernels:
        totals[k.name] = totals.get(k.name, 0.0) + k.dur_us
        letter = family(k.name)
        if letter in ('H', 'I'):
            owner = letter
        elif letter is None and owner is not None and ATB.search(k.name):
            letter = owner
        if letter is not None:
            fam[letter] = fam.get(letter, 0.0) + k.dur_us * 1e-6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    end = t0_us
    for k in kernels:
        if k.start_us > end:
            gaps.append((end, k.start_us - end))
        end = max(end, k.start_us + k.dur_us)
    if t1_us > end:
        gaps.append((end, t1_us - end))
    gaps.sort(key=lambda g: -g[1])
    host.sort()
    named = []
    for start, length in gaps[:10]:
        inner = [(dur, name) for ts, dur, name in host
                 if ts <= start < ts + dur]
        label = min(inner)[1] if inner else '(no host op)'
        named.append([_short(label), length * 1e-6])
    return TraceSummary((t1_us - t0_us) * 1e-6, _union(kernels) * 1e-6,
                        len(kernels), fam,
                        [[_short(n), s * 1e-6] for n, s in top], named)


class Tracer:
    """torch.profiler over the calls made inside `with Tracer() as t:`,
    reduced on exit to `t.summary`, a `TraceSummary` of the span named
    `WINDOW` that the caller records inside it (`window()`)."""

    def __init__(self):
        self._prof = None
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.remove(path)
        spans = [e for e in events if e.get('name') == WINDOW
                 and e.get('cat') == 'user_annotation'
                 and e.get('ph') == 'X']
        if not spans:
            raise RuntimeError('trace: the window span is missing')
        t0 = float(spans[0]['ts'])
        t1 = t0 + float(spans[0]['dur'])
        self.summary = summarize(events, t0, t1)
        self._prof = None
        return False
