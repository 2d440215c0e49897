"""The ctypes bindings of `arah_tpu_torch/ops/_build.py` against the C
sources of `arah_tpu_torch/csrc/`, on the CPU: no `nvcc`, no card.

A binding that disagrees with its C function reads garbage on the card
without an error. So `_build.load()` runs here against a stub
`ctypes.CDLL` (a faked library path, nothing built), and every
`extern "C"` function must get `argtypes` of its parameters' count and
kind and the `restype` of its return type, and each `ctypes.Structure`
of `_build` must name its C struct's members in order, with their types
and array shapes.
"""
import ctypes
import os
import re

import pytest

from arah_tpu_torch.ops import _build


def _sources(suffixes):
    out = {}
    for f in sorted(os.listdir(_build.CSRC)):
        if f.endswith(suffixes):
            with open(os.path.join(_build.CSRC, f)) as fh:
                src = re.sub(r'/\*.*?\*/', ' ', fh.read(), flags=re.S)
            out[f] = re.sub(r'//[^\n]*', '', src)
    return out


def _c_functions():
    """{name: (file, return type, [parameter declarations])} of every
    extern "C" function of csrc/*.cu."""
    out = {}
    for f, src in _sources('.cu').items():
        for m in re.finditer(
                r'extern\s+"C"\s+([\w\s*]+?)\b(\w+)\s*\(([^)]*)\)', src):
            ps = [' '.join(p.split()) for p in m.group(3).split(',')
                  if p.strip()]
            out[m.group(2)] = (f, ' '.join(m.group(1).split()),
                               [] if ps == ['void'] else ps)
    return out


def _defines():
    out = {}
    for src in _sources(('.cu', '.cuh')).values():
        for m in re.finditer(r'#define\s+(\w+)\s+(\d+)\b', src):
            out[m.group(1)] = int(m.group(2))
    return out


C_FUNCTIONS = _c_functions()
STRUCTS = ('NetMeta', 'ShadeMeta', 'ColorMeta')
SCALARS = {'int': ctypes.c_int, 'float': ctypes.c_float,
           'long long': ctypes.c_longlong}


def _kind(decl):
    """The ctypes type a C parameter or return declaration binds to."""
    if '*' in decl:
        return ctypes.c_void_p
    words = [w for w in decl.split() if w not in ('const', '__restrict__')]
    t = ' '.join(words[:-1])          # the type, without the name
    return getattr(_build, t) if t in STRUCTS else SCALARS[t]


class _Fn:
    """A stub foreign function: holds what `load()` sets on it."""


class _Lib:
    def __init__(self, path):
        self.path, self.fns = path, {}

    def __getattr__(self, name):
        if name.startswith('__'):
            raise AttributeError(name)
        return self.fns.setdefault(name, _Fn())


@pytest.fixture
def stub_lib(monkeypatch):
    """`_build.load()` on a stub CDLL; the library path is faked to this
    file, which exists, so nothing is built."""
    opened = []

    def cdll(path):
        opened.append(_Lib(path))
        return opened[-1]
    monkeypatch.setattr(_build, '_LIB', None)
    monkeypatch.setattr(_build, 'library_path', lambda: __file__)
    monkeypatch.setattr(_build.ctypes, 'CDLL', cdll)
    lib = _build.load()
    assert len(opened) == 1 and lib is opened[0] and lib.path == __file__
    return lib


def test_sources_parse():
    assert len(C_FUNCTIONS) >= 15, sorted(C_FUNCTIONS)
    assert C_FUNCTIONS['arah_shade_bwd_ws'][1] == 'long long'
    assert len(C_FUNCTIONS['arah_corr'][2]) == 24
    assert _kind('const unsigned char* mask') is ctypes.c_void_p
    assert _kind('NetMeta m') is _build.NetMeta
    assert _kind('long long gsize') is ctypes.c_longlong


@pytest.mark.parametrize('name', sorted(C_FUNCTIONS))
def test_binding_matches_c_signature(stub_lib, name):
    f, ret, params = C_FUNCTIONS[name]
    fn = stub_lib.fns.get(name)
    assert fn is not None and hasattr(fn, 'argtypes'), \
        f'{name} ({f}) has no argtypes in _build.load()'
    assert len(fn.argtypes) == len(params), (name, fn.argtypes, params)
    for i, (a, p) in enumerate(zip(fn.argtypes, params)):
        assert a is _kind(p), f'{name} parameter {i} ({p}): bound as {a}'
    assert getattr(fn, 'restype', ctypes.c_int) is _kind(ret + ' r'), name


def test_every_binding_has_a_c_function(stub_lib):
    assert set(stub_lib.fns) <= set(C_FUNCTIONS), \
        set(stub_lib.fns) - set(C_FUNCTIONS)


def _c_struct(name):
    """[(member, C type, [array lengths])] of `struct name` in csrc/."""
    defs = _defines()
    bodies = [m.group(1) for src in _sources(('.cu', '.cuh')).values()
              for m in re.finditer(r'struct\s+' + name + r'\s*\{(.*?)\};',
                                   src, flags=re.S)]
    assert len(bodies) == 1, f'struct {name}: {len(bodies)} definitions'
    out = []
    for decl in bodies[0].split(';'):
        decl = ' '.join(decl.split())
        if not decl:
            continue
        m = re.match(r'(long long|int|float)\s+(.*)$', decl)
        assert m, f'struct {name}: cannot read {decl!r}'
        for var in m.group(2).split(','):
            v = re.match(r'\s*(\w+)((?:\s*\[[^]]*\])*)\s*$', var)
            # array lengths: integers, #defines and their sums
            dims = [sum(int(t) if t.isdigit() else defs[t]
                        for t in d.replace('+', ' ').split())
                    for d in re.findall(r'\[([^]]*)\]', v.group(2))]
            out.append((v.group(1), m.group(1), dims))
    return out


def _ctype_shape(t):
    dims = []
    while hasattr(t, '_length_'):
        dims.append(t._length_)
        t = t._type_
    return t, dims


@pytest.mark.parametrize('name', STRUCTS)
def test_structure_matches_c_struct(name):
    c = _c_struct(name)
    py = getattr(_build, name)._fields_
    assert [f for f, *_ in py] == [m for m, *_ in c], name
    for (field, t), (_, ct, dims) in zip(py, c):
        base, pdims = _ctype_shape(t)
        assert base is SCALARS[ct] and pdims == dims, (name, field)
