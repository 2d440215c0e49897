"""The device's idle time in a Chrome trace split over the program's
layers, and its host syncs.

    python3 gpubench/layer_idle.py TRACE.json [--window NAME]

TRACE.json is a `torch.profiler` Chrome trace of the program with its
spans (`arah_tpu_torch/utils/trace.py`), such as the trainer's
`profile_dir/trace.json`. The window is the span named NAME (the first
one), or else the trace from its first event to its last. The device is
idle where no kernel runs; each idle interval is cut at the spans'
edges, and each piece goes to the layer (`eval`, `renderer`, `tracer`)
of the innermost `arah.` span open on the host then, or to `none`. The
layers' parts add up to the window's idle time. The syncs are the
`arah.<layer>.sync.<what>` spans inside the window. Prints one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import sys

PREFIX = 'arah.'


def _kernel_union(events, t0, t1):
    """Sorted disjoint busy intervals of the kernels inside [t0, t1]."""
    ivs = sorted((max(float(e['ts']), t0),
                  min(float(e['ts']) + float(e['dur']), t1))
                 for e in events if e.get('cat') == 'kernel')
    out = []
    for a, b in ivs:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _idle(busy, t0, t1):
    out, end = [], t0
    for a, b in busy:
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if t1 > end:
        out.append((end, t1))
    return out


def _owners(spans, t0, t1):
    """[(start, end, layer)] covering [t0, t1]: between consecutive span
    edges, the layer of the innermost span open (the latest started), or
    'none'."""
    edges = sorted({t0, t1} | {t for s in spans for t in s[:2]
                               if t0 < t < t1})
    out = []
    for a, b in zip(edges[:-1], edges[1:]):
        m = 0.5 * (a + b)
        inner = max(((s[0], -s[1], s[2]) for s in spans
                     if s[0] <= m < s[1]), default=None)
        out.append((a, b, inner[2] if inner else 'none'))
    return out


def split(events: list, t0_us: float, t1_us: float) -> dict:
    """{'window_s', 'busy_s', 'idle_s', 'layer_idle_s': {layer: s},
    'syncs'} of the Chrome-trace events in [t0_us, t1_us]."""
    events = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    spans = []
    syncs = 0
    for e in events:
        name = e.get('name', '')
        if e.get('cat') != 'user_annotation' or not name.startswith(PREFIX):
            continue
        a, b = float(e['ts']), float(e['ts']) + float(e['dur'])
        spans.append((a, b, name[len(PREFIX):].split('.')[0]))
        if '.sync.' in name and t0_us <= a and b <= t1_us:
            syncs += 1
    busy = _kernel_union(events, t0_us, t1_us)
    idle = _idle(busy, t0_us, t1_us)
    parts, j = {}, 0
    owners = _owners(spans, t0_us, t1_us)
    for a, b in idle:
        while j < len(owners) and owners[j][1] <= a:
            j += 1
        k = j
        while k < len(owners) and owners[k][0] < b:
            lo, hi = max(a, owners[k][0]), min(b, owners[k][1])
            if hi > lo:
                layer = owners[k][2]
                parts[layer] = parts.get(layer, 0.0) + (hi - lo) * 1e-6
            k += 1
    return {'window_s': (t1_us - t0_us) * 1e-6,
            'busy_s': sum(b - a for a, b in busy) * 1e-6,
            'idle_s': sum(b - a for a, b in idle) * 1e-6,
            'layer_idle_s': parts, 'syncs': syncs}


def window_of(events: list, name: str | None):
    """(t0_us, t1_us) of the first span named `name`, or of the whole
    trace."""
    xs = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    if name is not None:
        for e in xs:
            if e.get('name') == name:
                return float(e['ts']), float(e['ts']) + float(e['dur'])
        raise SystemExit(f'layer_idle: no span named {name!r}')
    return (min(float(e['ts']) for e in xs),
            max(float(e['ts']) + float(e['dur']) for e in xs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('trace')
    ap.add_argument('--window', default=None)
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        events = json.load(f)['traceEvents']
    print(json.dumps(split(events, *window_of(events, args.window))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
