"""ptxas's resource report (`nvcc -Xptxas -v`) of the kernel build, parsed.

`report(log)` reads a build log as `ops/_build.py` writes it (each
source's `nvcc -c` output after a `== <source>` line) and returns, for
every function ptxas describes, its registers, stack frame, spill stores
and loads and static shared memory. Each block goes to the function it
names: the `Function properties for <f>` line sets the function whose
stack and spills the next line gives, and the `Used N registers` line
belongs to the entry function ptxas is compiling. A device function that
was not inlined has a properties block of its own (its spills are its
own, and no entry's); it is reported under `<name> [<source>]` with
`entry` False, so that a check can hold every function of a kernel's
source file. Two functions whose names differ only in a type argument
(which `demangle` drops) share one key, which keeps the larger of each
number, so that a spill under that key is never hidden by a clean block.
"""
from __future__ import annotations

import re

_STATS = (('stack', r'(\d+) bytes stack frame'),
          ('spill_stores', r'(\d+) bytes spill stores'),
          ('spill_loads', r'(\d+) bytes spill loads'))
_USED = (('registers', r'Used (\d+) registers'),
         ('smem', r'(\d+) bytes smem'))


def demangle(sym: str) -> str:
    """`_Z16shade_bwd_kernelILb1ELb0EEv...` -> `shade_bwd_kernel<true,
    false>`: the name and the integer and bool template arguments of an
    Itanium-mangled function, in order, a launch shape's
    (csrc/stream_mlp.cuh:TileShape) flattened: `corr_kernel<R, NT, C, KC,
    MINB, ST, MAXW, NG, precision, want_jac>`."""
    m = re.match(r'_Z(\d+)', sym)
    if not m:
        return sym
    i = m.end()
    name = sym[i:i + int(m.group(1))]
    args = [v if k == 'i' else ('true' if v == '1' else 'false')
            for k, v in re.findall(r'L([ib])(\d+)E',
                                   sym[i + int(m.group(1)):])]
    return f'{name}<{", ".join(args)}>' if args else name


def report(log: str) -> dict:
    """{function: {'entry', 'source', 'registers', 'smem', 'stack',
    'spill_stores', 'spill_loads'}} from the build log at path `log`
    (entries only carry 'registers' and 'smem'). Entry functions are
    keyed by their demangled name, other functions by `name [source]`;
    under a key that several functions share, each number is the
    largest."""
    with open(log) as fh:
        return parse(fh.read())


def parse(text: str) -> dict:
    """`report` of a log's text."""
    out, src, entry, props = {}, None, None, None
    for line in text.splitlines():
        if line.startswith('== '):
            src, entry, props = line[3:].strip(), None, None
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = demangle(m.group(1))
            out.setdefault(entry, {'entry': True, 'source': src})
            props = None
            continue
        m = re.search(r'Function properties for (\w+)', line)
        if m:
            name = demangle(m.group(1))
            if name != entry:
                name = f'{name} [{src}]'
                out.setdefault(name, {'entry': False, 'source': src})
            props = name
            continue
        if props is not None and 'bytes stack frame' in line:
            for key, pat in _STATS:
                v = re.search(pat, line)
                if v:
                    _keep_max(out[props], key, int(v.group(1)))
            props = None
            continue
        if entry is not None and 'Used' in line:
            for key, pat in _USED:
                v = re.search(pat, line)
                if v:
                    _keep_max(out[entry], key, int(v.group(1)))
    return out


def _keep_max(r: dict, key: str, v: int):
    r[key] = max(r.get(key, v), v)


def spills(r: dict) -> bool:
    """Whether a function's report shows a spill store or load (or lacks
    the line that says it has none)."""
    return r.get('spill_stores') != 0 or r.get('spill_loads') != 0


def group(ptx: dict, prefixes) -> tuple[dict, dict]:
    """(the entry functions whose names start with one of `prefixes`,
    every other function of their source files): what a check of those
    kernels holds, since a device function of their file that was not
    inlined may be called by any of them."""
    ks = {n: r for n, r in ptx.items()
          if r['entry'] and n.startswith(tuple(prefixes))}
    srcs = {r['source'] for r in ks.values()}
    callees = {n: r for n, r in ptx.items()
               if not r['entry'] and r['source'] in srcs}
    return ks, callees
