"""Build and load the CUDA kernels of `arah_tpu_torch/csrc/`.

At first use, `load()` compiles every `csrc/*.cu` with `nvcc` for
`sm_90a` (one `nvcc -c` per source, all started together), links them
into one shared library with a plain C interface, and loads it with
ctypes. The library lands in `<repo>/.cache/torch_ext/<hash>/`, keyed by
a hash of the sources and flags, so a later process reuses it. There is
no fallback: a missing `nvcc`, a failed build or a failed load raises.

`--use_fast_math` is deliberately absent: the SIREN takes sin(30 z) at
tens of radians, softplus100 and the hierarchical softmax need exact
expf/log1pf, and the solvers converge at 1e-5.

Each kernel wrapper adds one to `COUNTS[name]` per launch and nowhere
else, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), '.cache', 'torch_ext')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']

COUNTS = {'knn': 0, 'corr': 0, 'shade': 0, 'color_fwd': 0, 'march': 0,
          'iso': 0, 'skin_jac': 0, 'shade_bwd': 0, 'color_bwd': 0,
          'siren': 0, 'knn_rows': 0, 'corr_rows': 0}
BUILD_SECONDS = None     # wall time of this process's build, None if cached

_LIB = None


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith(('.cu', '.cuh')))


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'arah_tpu_torch build only where the CUDA '
                           'toolkit is installed')
    return path


def library_path() -> str:
    h = hashlib.sha1(repr(NVCC_FLAGS).encode())
    for f in _sources():
        with open(os.path.join(CSRC, f), 'rb') as fh:
            h.update(f.encode() + fh.read())
    return os.path.join(CACHE, h.hexdigest()[:16], 'libarah_kernels.so')


def _build(out: str):
    global BUILD_SECONDS
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(out))
    cus = [f for f in _sources() if f.endswith('.cu')]
    procs = []
    for f in cus:
        obj = os.path.join(tmp, f + '.o')
        procs.append((f, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-Xptxas', '-v', '-c',
             os.path.join(CSRC, f), '-o', obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for f, _, p in procs:
        log, _ = p.communicate()
        logs.append(f'== {f}\n{log}')
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed on {f}:\n{log}')
    lib_tmp = os.path.join(tmp, 'lib.so')
    r = subprocess.run([nvcc, *NVCC_FLAGS, '-shared', '-o', lib_tmp,
                        *[o for _, o, _ in procs]],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f'nvcc link failed:\n{r.stdout}{r.stderr}')
    with open(os.path.join(os.path.dirname(out), 'build.log'), 'w') as fh:
        fh.write('\n'.join(logs))
    os.replace(lib_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class ShadeMeta(ctypes.Structure):
    """`struct ShadeMeta` of csrc/shade_meta.cuh."""
    _fields_ = [('n_layers', _I), ('din', _I), ('hidden', _I),
                ('dout', _I), ('film', _I), ('bf16', _I),
                ('wt_off', ctypes.c_longlong * 8),
                ('w_off', ctypes.c_longlong * 8),
                ('b_off', ctypes.c_longlong * 8),
                ('freq_off', ctypes.c_longlong),
                ('phase_off', ctypes.c_longlong)]


class ColorMeta(ctypes.Structure):
    """`struct ColorMeta` of csrc/color.cu."""
    _fields_ = [('n_layers', _I), ('S', _I), ('F', _I), ('P', _I),
                ('hmax', _I), ('squeeze', _I), ('bf16', _I),
                ('feats_bf16', _I),
                ('out', _I * 8), ('n_comp', _I * 8),
                ('kind', (_I * 4) * 8), ('width', (_I * 4) * 8),
                ('w_off', (ctypes.c_longlong * 4) * 8),
                ('b_off', ctypes.c_longlong * 8),
                ('start', (_I * 4) * 8),
                ('wo_off', ctypes.c_longlong * 8),
                ('g_off', ctypes.c_longlong * 8),
                ('gb_off', ctypes.c_longlong * 8),
                ('gpose_off', ctypes.c_longlong),
                ('gs_off', ctypes.c_longlong * 8),
                ('wd_off', _I * 8), ('wx_off', _I * 8), ('ws_cols', _I)]


class NetMeta(ctypes.Structure):
    """`struct NetMeta` of csrc/tile_mlp.cuh."""
    _fields_ = [('n_layers', _I), ('hidden', _I), ('film', _I),
                ('wt_off', ctypes.c_longlong * 8),
                ('wl_off', ctypes.c_longlong),
                ('b_off', ctypes.c_longlong * 8),
                ('freq_off', ctypes.c_longlong),
                ('phase_off', ctypes.c_longlong),
                ('n_skin', _I), ('skin_dims', _I * 9),
                ('skin_wt_off', ctypes.c_longlong * 8),
                ('skin_b_off', ctypes.c_longlong * 8)]


def load():
    """The kernels' ctypes library, built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    lib.arah_knn.argtypes = [_P, _I, _P, _I, _P, _P]
    lib.arah_knn_rows.argtypes = [_P, _I, _P, _I, _P, _P]
    lib.arah_siren.argtypes = [_P, _I, _P, NetMeta, _I, _P, _P]
    lib.arah_corr.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, NetMeta, _I,
                              _F, _F, _F, _F, _P, _P, _P, _P, _P]
    lib.arah_shade.argtypes = [_P, _I, _P, ShadeMeta, _P, _P, _I, _P, _P]
    lib.arah_color_fwd.argtypes = [_P, _P, _P, _I, _P, ColorMeta, _P, _P]
    lib.arah_march.argtypes = [_P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                               NetMeta, _I, _F, _F, _P, _P, _P, _P, _P, _P]
    lib.arah_iso.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                             NetMeta, _I, _F, _F, _F, _F, _P, _P, _P, _P, _P]
    lib.arah_skin_jac.argtypes = [_P, _I, _P, _P, _P, NetMeta, _F, _P, _P]
    lib.arah_shade_bwd.argtypes = [_P, _I, _P, _P, ShadeMeta, _P, _P, _P,
                                   _P, _P, _I, ShadeMeta, ctypes.c_longlong,
                                   _P, _P, _P]
    lib.arah_shade_bwd_blocks.argtypes = [_I, ShadeMeta]
    lib.arah_shade_bwd_ws.argtypes = [_I, _I, ShadeMeta]
    lib.arah_shade_bwd_ws.restype = ctypes.c_longlong
    lib.arah_color_bwd.argtypes = [_P, _P, _P, _P, _I, _P, ColorMeta, _P, _P,
                                   _P, _I, ctypes.c_longlong, _P, _P, _P]
    lib.arah_color_bwd_blocks.argtypes = [_I, ColorMeta]
    lib.arah_color_bwd_ws.argtypes = [_I, ColorMeta]
    lib.arah_color_bwd_ws.restype = ctypes.c_longlong
    for fn in (lib.arah_knn, lib.arah_corr, lib.arah_shade,
               lib.arah_color_fwd, lib.arah_march, lib.arah_iso,
               lib.arah_skin_jac, lib.arah_shade_bwd, lib.arah_color_bwd,
               lib.arah_knn_rows, lib.arah_siren, lib.arah_shade_bwd_blocks,
               lib.arah_color_bwd_blocks):
        fn.restype = _I
    _LIB = lib
    return lib


class ParamPack:
    """One f32 parameter buffer for a kernel under construction: `put`
    appends a tensor (flattened) and returns its offset in floats."""

    def __init__(self):
        self.blocks, self.total = [], 0

    def put(self, t) -> int:
        t = t.float().reshape(-1)
        self.blocks.append(t)
        self.total += t.numel()
        return self.total - t.numel()

    def tensor(self):
        import torch
        return torch.cat(self.blocks).contiguous()


def check(err: int, name: str):
    """Raise on a non-zero cudaGetLastError() from a launch."""
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None):
    """Device, dtype, shape and contiguity checks of a kernel operand."""
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor')
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
