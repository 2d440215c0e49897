"""ctypes bindings of the port's native host library: the geometry ops of
`arahx.cpp` (the port's copy of `arah_tpu/native`) and the codec loops of
`codec.cpp` (JPEG Huffman coding, PNG unfiltering; `utils/image.py`).

Built with `g++` at first use into `<repo>/.cache/native/<source hash>/`
(a process builds into a file of its own and renames it into place, so
concurrent first uses are safe)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ('arahx.cpp', 'codec.cpp')
_FLAGS = ['-O3', '-fPIC', '-shared', '-std=c++17', '-pthread']
CACHE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), '.cache',
                     'native')
_lock = threading.Lock()
_lib = None

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I16P = ctypes.POINTER(ctypes.c_int16)
_LP = ctypes.POINTER(ctypes.c_long)
_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long

_SIGNATURES = {
    'triangle_hash_build': (_V, [_FP, _I, _IP, _I, _I]),
    'triangle_hash_free': (None, [_V]),
    'points_inside_mesh': (None, [_V, _FP, _I, _U8P]),
    'point_mesh_squared_distance': (None, [_FP, _I, _FP, _I, _IP, _I, _FP,
                                           _IP, _FP]),
    'marching_cubes': (_V, [_FP, _I, _I, _I, ctypes.c_float, _FP, _FP]),
    'mc_num_verts': (_I, [_V]),
    'mc_num_faces': (_I, [_V]),
    'mc_copy': (None, [_V, _FP, _IP]),
    'mc_free': (None, [_V]),
    'rasterize_mesh': (None, [_FP, _FP, _I, _IP, _I, _I, _I, _IP, _FP,
                              _FP]),
    'jpeg_decode_scan': (_I, [_U8P, _L, _I, _IP, _IP, _IP, _IP, _U8P, _U8P,
                              _I, _I, _I, _I16P, _LP, _IP]),
    'jpeg_encode_scan': (_L, [_I, _IP, _IP, _IP, _IP, _U8P, _U8P, _I, _I,
                              _I16P, _LP, _IP, _U8P, _L]),
    'png_unfilter': (_I, [_U8P, _I, _L, _I, _U8P]),
}


def library_path() -> str:
    h = hashlib.sha256(' '.join(_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_HERE, name), 'rb') as f:
            h.update(f.read())
    return os.path.join(CACHE, h.hexdigest()[:16], 'libarahx.so')


def load():
    """The library, built first if this tree's sources have no build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f'{path}.{os.getpid()}.tmp'
            subprocess.check_call(
                ['g++', *_FLAGS, '-o', tmp]
                + [os.path.join(_HERE, s) for s in _SOURCES])
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def ptr(a: np.ndarray, kind):
    """A ctypes pointer of `kind` to a contiguous array's data."""
    return a.ctypes.data_as(kind)


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


class MeshIntersector:
    """Point-in-mesh queries via a 2D triangle hash and z-parity rays."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 resolution: int = 512):
        self._lib = load()
        self._verts = _f32(verts)
        self._faces = _i32(faces)
        self._handle = self._lib.triangle_hash_build(
            ptr(self._verts, _FP), len(self._verts), ptr(self._faces, _IP),
            len(self._faces), resolution)

    def query(self, points: np.ndarray) -> np.ndarray:
        pts = _f32(points)
        out = np.zeros(len(pts), np.uint8)
        self._lib.points_inside_mesh(self._handle, ptr(pts, _FP), len(pts),
                                     ptr(out, _U8P))
        return out.astype(bool)

    def __del__(self):
        if getattr(self, '_handle', None):
            self._lib.triangle_hash_free(self._handle)
            self._handle = None


def point_mesh_squared_distance(points, verts, faces):
    """(sq_dist (N,), face_idx (N,), bary (N, 3)) of each point's closest
    point on the mesh."""
    lib = load()
    pts, v, f = _f32(points), _f32(verts), _i32(faces)
    n = len(pts)
    sq = np.zeros(n, np.float32)
    fi = np.zeros(n, np.int32)
    bary = np.zeros((n, 3), np.float32)
    lib.point_mesh_squared_distance(
        ptr(pts, _FP), n, ptr(v, _FP), len(v), ptr(f, _IP), len(f),
        ptr(sq, _FP), ptr(fi, _IP), ptr(bary, _FP))
    return sq, fi, bary


def marching_cubes(grid: np.ndarray, iso: float = 0.0, origin=None,
                   spacing=None):
    """Iso-surface of a (nx, ny, nz) scalar grid. Returns (verts (V, 3)
    float32, faces (F, 3) int32)."""
    lib = load()
    g = _f32(grid)
    nx, ny, nz = g.shape
    origin = _f32(origin if origin is not None else [0, 0, 0])
    spacing = _f32(spacing if spacing is not None else [1, 1, 1])
    h = lib.marching_cubes(ptr(g, _FP), nx, ny, nz, ctypes.c_float(iso),
                           ptr(origin, _FP), ptr(spacing, _FP))
    nv, nf = lib.mc_num_verts(h), lib.mc_num_faces(h)
    verts = np.zeros((nv, 3), np.float32)
    faces = np.zeros((nf, 3), np.int32)
    if nv:
        lib.mc_copy(h, ptr(verts, _FP), ptr(faces, _IP))
    lib.mc_free(h)
    return verts, faces


def rasterize_mesh(proj_xy, depth, faces, height, width):
    """Z-buffer rasterisation of projected triangles: proj_xy (V, 2) pixel
    coordinates, depth (V,) camera z, faces (F, 3) -> (face_idx (H, W)
    int32, -1 on the background; bary (H, W, 3); zbuf (H, W))."""
    lib = load()
    p, d, f = _f32(proj_xy), _f32(depth), _i32(faces)
    face_buf = np.zeros((height, width), np.int32)
    bary_buf = np.zeros((height, width, 3), np.float32)
    z_buf = np.zeros((height, width), np.float32)
    lib.rasterize_mesh(ptr(p, _FP), ptr(d, _FP), len(p), ptr(f, _IP),
                       len(f), height, width, ptr(face_buf, _IP),
                       ptr(bary_buf, _FP), ptr(z_buf, _FP))
    return face_buf, bary_buf, z_buf


def png_unfilter(raw: np.ndarray, height: int, rowbytes: int,
                 bpp: int) -> np.ndarray:
    """PNG rows (a filter-type byte and `rowbytes` bytes each) -> the
    unfiltered (height * rowbytes,) uint8 bytes; ValueError on a bad
    filter type."""
    raw = _c(raw, np.uint8)
    out = np.empty(height * rowbytes, np.uint8)
    if load().png_unfilter(ptr(raw, _U8P), height, rowbytes, bpp,
                           ptr(out, _U8P)):
        raise ValueError('bad PNG filter type')
    return out


def jpeg_decode_scan(seg, h, v, dc, ac, bits, vals, mcux, mcuy, restart,
                     coefs, off, bw) -> int:
    """Huffman-decode one JPEG scan `seg` (uint8) into the int16 `coefs`
    (see `codec.cpp:jpeg_decode_scan`); returns its error code (0: ok)."""
    h, v, dc, ac, bw = (_c(a, np.int32) for a in (h, v, dc, ac, bw))
    off = _c(off, np.int64)
    seg = _c(seg, np.uint8)
    return load().jpeg_decode_scan(
        ptr(seg, _U8P), len(seg), len(h), ptr(h, _IP), ptr(v, _IP),
        ptr(dc, _IP), ptr(ac, _IP), ptr(_c(bits, np.uint8), _U8P),
        ptr(_c(vals, np.uint8), _U8P), mcux, mcuy, restart,
        ptr(coefs, _I16P), ptr(off, _LP), ptr(bw, _IP))


def jpeg_encode_scan(h, v, dc, ac, bits, vals, mcux, mcuy, coefs, off,
                     bw) -> bytes:
    """One baseline JPEG scan's entropy-coded bytes of the int16
    `coefs` (laid out as `jpeg_decode_scan` writes them)."""
    h, v, dc, ac, bw = (_c(a, np.int32) for a in (h, v, dc, ac, bw))
    off = _c(off, np.int64)
    coefs = _c(coefs, np.int16)
    cap = coefs.size * 4 + 4096
    out = np.zeros(cap, np.uint8)
    n = load().jpeg_encode_scan(
        len(h), ptr(h, _IP), ptr(v, _IP), ptr(dc, _IP), ptr(ac, _IP),
        ptr(_c(bits, np.uint8), _U8P), ptr(_c(vals, np.uint8), _U8P), mcux,
        mcuy, ptr(coefs, _I16P), ptr(off, _LP), ptr(bw, _IP),
        ptr(out, _U8P), cap)
    if n < 0:
        raise ValueError('jpeg_encode_scan: the scan outgrew its buffer')
    return out[:n].tobytes()
