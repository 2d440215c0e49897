"""Image reading, writing and the pixel operations of the data path, in
numpy with `zlib`/`struct` and the port's native codec loops
(`native/codec.cpp`): the port's replacement of the OpenCV calls that
`arah_tpu/data/human_video.py`, `data/fake_dataset.py` and
`eval/evaluator.py` make. Each follows OpenCV's integer rules, so that it
gives OpenCV's bytes on 8-bit images (`tests/test_torch_image.py`):

  read_png / write_png      8-bit gray and RGB, every filter type
  read_jpeg                 baseline (and extended sequential) Huffman
                            JPEG, 8-bit gray and YCbCr at 4:4:4 or 4:2:0,
                            restart markers: libjpeg's integer `islow`
                            IDCT, its h2v2 "fancy" upsampling and its
                            fixed-point YCbCr -> RGB
  write_jpeg                baseline 4:2:0, the Annex K tables scaled to
                            a quality (95, as OpenCV's default)
  resize_linear             cv2.resize INTER_LINEAR on uint8 (11-bit
                            fixed-point coefficients, half-pixel centres)
  resize_nearest            cv2.resize INTER_NEAREST
  erode5 / dilate5          cv2.erode / cv2.dilate with a 5x5 box
  fill_poly                 cv2.fillPoly of one polygon, integer vertices
  undistort                 cv2.undistort(img, K, D) with 5 coefficients

Images are numpy arrays, RGB channel order (not OpenCV's BGR)."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b'\x89PNG\r\n\x1a\n'


# ------------------------------------------------------------------ files
def read_image(path: str, gray: bool = False) -> np.ndarray:
    """A PNG or JPEG file as uint8 (H, W, 3) RGB, or (H, W) with `gray`
    (a gray file read as RGB has its channel repeated, as cv2.imread
    does; a colour file read as gray raises)."""
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        img = read_png(data, path)
    elif data.startswith(b'\xff\xd8'):
        img = read_jpeg(data, path)
    else:
        raise ValueError(f'{path}: neither PNG nor JPEG')
    if gray:
        if img.ndim != 2:
            raise ValueError(f'{path}: a colour image read as gray')
        return img
    return img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)


def write_image(path: str, img: np.ndarray, quality: int = 95):
    """uint8 (H, W) gray or (H, W, 3) RGB to `path`: PNG for a `.png`
    name, JPEG (colour only) for `.jpg`/`.jpeg`."""
    low = path.lower()
    if low.endswith('.png'):
        data = write_png(img)
    elif low.endswith(('.jpg', '.jpeg')):
        data = write_jpeg(img, quality)
    else:
        raise ValueError(f'{path}: write .png or .jpg')
    with open(path, 'wb') as f:
        f.write(data)


# -------------------------------------------------------------------- PNG
def read_png(data: bytes, name: str = '<png>') -> np.ndarray:
    """8-bit gray (H, W) or RGB (H, W, 3) PNG bytes, not interlaced."""
    from arah_tpu_torch import native
    if not data.startswith(_PNG_SIG):
        raise ValueError(f'{name}: not a PNG')
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (0, 2) or interlace:
        raise ValueError(f'{name}: PNG bit depth {depth}, colour type '
                         f'{ctype}, interlace {interlace}: only 8-bit gray '
                         'or RGB, not interlaced')
    ch = 1 if ctype == 0 else 3
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f'{name}: PNG data of {raw.size} bytes')
    out = native.png_unfilter(raw, h, w * ch, ch)
    return out.reshape((h, w) if ch == 1 else (h, w, 3))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def write_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a uint8 gray (H, W) or RGB (H, W, 3) image (filter
    type 0 on every row)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f'write_png: uint8 gray or RGB, not {img.dtype} '
                         f'{img.shape}')
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, 0 if img.ndim == 2 else 2, 0, 0,
                       0)
    return (_PNG_SIG + _chunk(b'IHDR', ihdr)
            + _chunk(b'IDAT', zlib.compress(raw.tobytes(), level))
            + _chunk(b'IEND', b''))


# ------------------------------------------------------------------- JPEG
def _zigzag() -> np.ndarray:
    """zz[k] = the natural (row-major) index of zigzag position k."""
    order = sorted(((r + c, c if (r + c) % 2 == 0 else r, r * 8 + c)
                    for r in range(8) for c in range(8)))
    return np.array([o[2] for o in order])


ZIGZAG = _zigzag()

# libjpeg's integer IDCT (jidctint.c) constants, CONST_BITS = 13
_CB, _P1 = 13, 2
_F = {k: v for k, v in (
    ('0_298631336', 2446), ('0_390180644', 3196), ('0_541196100', 4433),
    ('0_765366865', 6270), ('0_899976223', 7373), ('1_175875602', 9633),
    ('1_501321110', 12299), ('1_847759065', 15137), ('1_961570560', 16069),
    ('2_053119869', 16819), ('2_562915447', 20995),
    ('3_072711026', 25172))}


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by (x & 1023) for a
    centred sample x: x + 128 clamped to [0, 255] for |x| < 512."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(0, 128)
    return t


_IDCT_LIMIT = _range_limit_table()


def _idct_1d(x, shift_in: int):
    """One pass of jpeg_idct_islow over 8 int64 arrays x[0..7] (x[0] and
    x[4] pre-scaled by `shift_in`); returns the 8 outputs before the
    descale."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F['0_541196100']
    tmp2 = z1 + z3 * -_F['1_847759065']
    tmp3 = z1 + z2 * _F['0_765366865']
    tmp0 = (x[0] + x[4]) << shift_in
    tmp1 = (x[0] - x[4]) << shift_in
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F['1_175875602']
    t0 = t0 * _F['0_298631336']
    t1 = t1 * _F['2_053119869']
    t2 = t2 * _F['3_072711026']
    t3 = t3 * _F['1_501321110']
    z1 = z1 * -_F['0_899976223']
    z2 = z2 * -_F['2_562915447']
    z3 = z3 * -_F['1_961570560'] + z5
    z4 = z4 * -_F['0_390180644'] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(n, 64) quantised coefficients (natural order) and their (64,)
    table -> (n, 8, 8) uint8 samples, as libjpeg's jpeg_idct_islow."""
    blk = (coefs.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (blk[:, row, :] is one input of every column)
    cols = _idct_1d([blk[:, r, :] for r in range(8)], _CB)
    ws = np.stack([_descale(c, _CB - _P1) for c in cols], axis=1)
    # pass 2: rows
    rows = _idct_1d([ws[:, :, c] for c in range(8)], _CB)
    out = np.stack([_descale(r, _CB + _P1 + 3) for r in rows], axis=2)
    return _IDCT_LIMIT[out & 1023]


def _fancy_h2v2(c: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2 "fancy" (triangle) upsampling of one (h, w) uint8
    component, the edges replicated: (2h, 2w)."""
    c = c.astype(np.int32)
    above = np.concatenate([c[:1], c[:-1]], axis=0)
    below = np.concatenate([c[1:], c[-1:]], axis=0)
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int32)
    for v, other in ((0, above), (1, below)):
        s = 3 * c + other
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * s + left + 8) >> 4
        out[v::2, 1::2] = (3 * s + right + 7) >> 4
    return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, SCALEBITS 16)."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    half = 1 << 15
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-22554 * cb + half - 46802 * cr) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _segments(data: bytes, name: str):
    """(marker, segment body, offset after it) of each marker segment up
    to the first SOS, then of each later one."""
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f'{name}: JPEG marker expected at {pos}')
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        n = struct.unpack('>H', data[pos:pos + 2])[0]
        yield marker, data[pos + 2:pos + n], pos + n
        pos += n
        if marker == 0xDA:
            # entropy-coded data up to the next marker other than a
            # stuffed 0xFF00 or a restart marker
            arr = np.frombuffer(data, np.uint8, offset=pos)
            ff = np.flatnonzero(arr[:-1] == 0xFF)
            nxt = arr[ff + 1]
            stop = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))
                      & (nxt != 0xFF)]
            end = pos + (int(stop[0]) if len(stop) else len(arr))
            yield 'scan', data[pos:end], end
            pos = end


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _decode_scan(body, frame, scan_comps, bits, vals, restart, coefs,
                 name):
    """Huffman-decode one scan's entropy-coded bytes into `coefs`."""
    from arah_tpu_torch import native
    H, W, comps, hmax, vmax, mcux, mcuy, bw, bh, off = frame
    ci = [c[0] for c in scan_comps]
    if len(ci) == 1:
        # a non-interleaved scan: one block an MCU over the component's
        # own extent
        c = comps[ci[0]]
        sh = sv = [1]
        smx = _ceil(_ceil(W * c[1], hmax), 8)
        smy = _ceil(_ceil(H * c[2], vmax), 8)
    else:
        sh = [comps[i][1] for i in ci]
        sv = [comps[i][2] for i in ci]
        smx, smy = mcux, mcuy
    dc = [c[1] for c in scan_comps]
    ac = [c[2] for c in scan_comps]
    err = native.jpeg_decode_scan(
        np.frombuffer(body, np.uint8), sh, sv, dc, ac, bits, vals, smx, smy,
        restart, coefs, off[ci], bw[ci])
    if err:
        raise ValueError(f'{name}: JPEG scan decode failed ({err})')


def read_jpeg(data: bytes, name: str = '<jpeg>') -> np.ndarray:
    """Sequential Huffman JPEG bytes (8-bit, gray or YCbCr, 4:4:4 or
    4:2:0) -> uint8 (H, W) gray or (H, W, 3) RGB, as libjpeg decodes them
    with its defaults (islow IDCT, fancy upsampling)."""
    from arah_tpu_torch import native
    if not data.startswith(b'\xff\xd8'):
        raise ValueError(f'{name}: not a JPEG')
    quant = {}
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    restart = 0
    frame = None
    coefs = None
    scan_comps = None
    for marker, body, _ in _segments(data, name):
        if marker == 'scan':
            _decode_scan(body, frame, scan_comps, bits, vals, restart,
                         coefs, name)
        elif marker == 0xDB:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                n = 128 if pq else 64
                q = np.frombuffer(body[p + 1:p + 1 + n],
                                  '>u2' if pq else np.uint8)
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = q
                quant[tq] = nat
                p += 1 + n
        elif marker == 0xC4:
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                b = np.frombuffer(body[p + 1:p + 17], np.uint8)
                n = int(b.sum())
                slot = tc * 4 + th
                bits[slot] = b
                vals[slot] = 0
                vals[slot, :n] = np.frombuffer(body[p + 17:p + 17 + n],
                                               np.uint8)
                p += 17 + n
        elif marker == 0xDD:
            restart = struct.unpack('>H', body[:2])[0]
        elif marker in (0xC0, 0xC1):
            prec, H, W, nc = struct.unpack('>BHHB', body[:6])
            if prec != 8 or nc not in (1, 3):
                raise ValueError(f'{name}: JPEG precision {prec}, {nc} '
                                 'components: only 8-bit gray or YCbCr')
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                      body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(nc)]
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = _ceil(W, 8 * hmax), _ceil(H, 8 * vmax)
            bw = np.array([mcux * c[1] for c in comps], np.int32)
            bh = [mcuy * c[2] for c in comps]
            sizes = [int(w) * h * 64 for w, h in zip(bw, bh)]
            off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
                np.int64)
            coefs = np.zeros(sum(sizes), np.int16)
            frame = (H, W, comps, hmax, vmax, mcux, mcuy, bw, bh, off)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f'{name}: JPEG SOF{marker - 0xC0} (only '
                             'baseline and extended sequential Huffman)')
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f'{name}: SOS before SOF')
            ns = body[0]
            ids = [frame[2][i][0] for i in range(len(frame[2]))]
            scan_comps = [(ids.index(body[1 + 2 * i]), body[2 + 2 * i] >> 4,
                           body[2 + 2 * i] & 15) for i in range(ns)]
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError(f'{name}: not a sequential scan')
    if frame is None:
        raise ValueError(f'{name}: no frame header')
    H, W, comps, hmax, vmax, mcux, mcuy, bw, bh, off = frame
    planes = []
    for (cid, h, v, tq), w_b, h_b, o in zip(comps, bw, bh, off):
        n = int(w_b) * h_b
        blocks = idct_islow(coefs[o:o + n * 64].reshape(n, 64), quant[tq])
        plane = blocks.reshape(h_b, int(w_b), 8, 8).transpose(
            0, 2, 1, 3).reshape(h_b * 8, int(w_b) * 8)
        cw, ch = _ceil(W * h, hmax), _ceil(H * v, vmax)
        plane = plane[:ch, :cw]
        if (hmax // h, vmax // v) == (2, 2):
            plane = _fancy_h2v2(plane)
        elif (h, v) != (hmax, vmax):
            raise ValueError(f'{name}: JPEG sampling {h}x{v} of {hmax}x'
                             f'{vmax}: only 4:4:4 and 4:2:0')
        planes.append(plane[:H, :W])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    return _ycc_to_rgb(*planes)


# Annex K tables (natural order) and Huffman tables (bits, values)
_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)


def _ac_vals(groups) -> list:
    """An AC table's symbols, written as runs of run/size pairs."""
    return [int(x, 16) for x in groups.split()]


_HUFF = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
             list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], _ac_vals(
        '01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 '
        'a1 08 23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a '
        '25 26 27 28 29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 '
        '54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 '
        '7a 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 '
        'a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 '
        'ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2 e3 e4 e5 e6 e7 e8 e9 ea f1 f2 '
        'f3 f4 f5 f6 f7 f8 f9 fa')),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_vals(
        '00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 '
        '42 91 a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 '
        '18 19 1a 26 27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a '
        '53 54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 '
        '79 7a 82 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 '
        'a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 '
        'c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e2 e3 e4 e5 e6 e7 e8 e9 ea f2 '
        'f3 f4 f5 f6 f7 f8 f9 fa')),
}


def quant_tables(quality: int):
    """(luma, chroma) quantisation tables (natural order) at `quality`,
    scaled as libjpeg's jpeg_quality_scaling, baseline-limited."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.int64)
                 for t in (_QUANT_LUMA, _QUANT_CHROMA))


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    c[0] *= 1 / np.sqrt(2)
    return c / 2


_DCT = _dct_matrix()


def write_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JPEG bytes of a uint8 (H, W, 3) RGB image: libjpeg's
    fixed-point RGB -> YCbCr, 4:2:0 (its h2v2 box downsampling with
    alternating bias), a float DCT rounded to the quantiser, the Annex K
    Huffman tables."""
    from arah_tpu_torch import native
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'write_jpeg: uint8 RGB, not {img.dtype} '
                         f'{img.shape}')
    H, W = img.shape[:2]
    mcux, mcuy = _ceil(W, 16), _ceil(H, 16)
    pad = np.pad(img, ((0, mcuy * 16 - H), (0, mcux * 16 - W), (0, 0)),
                 mode='edge').astype(np.int64)
    r, g, b = pad[..., 0], pad[..., 1], pad[..., 2]
    half, off = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16
    bias = np.tile([1, 2], mcux * 4)[None, :]

    def down(c):
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        return (s + bias) >> 2
    ql, qc = quant_tables(quality)
    planes = [(y, ql), (down(cb), qc), (down(cr), qc)]
    blocks = []
    for plane, q in planes:
        hb, wb = plane.shape[0] // 8, plane.shape[1] // 8
        t = (plane - 128).astype(np.float64).reshape(hb, 8, wb, 8) \
            .transpose(0, 2, 1, 3)
        f = _DCT @ t @ _DCT.T
        blocks.append(np.round(f.reshape(-1, 64) / q).astype(np.int16))
    coefs = np.concatenate([b.ravel() for b in blocks])
    off_c = np.array([0, blocks[0].size, blocks[0].size + blocks[1].size],
                     np.int64)
    bw = np.array([2 * mcux, mcux, mcux], np.int32)
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for (cls, tid), (bt, vl) in _HUFF.items():
        bits[cls * 4 + tid] = bt
        vals[cls * 4 + tid, :len(vl)] = vl
    scan = native.jpeg_encode_scan([2, 1, 1], [2, 1, 1], [0, 1, 1],
                                   [0, 1, 1], bits, vals, mcux, mcuy, coefs,
                                   off_c, bw)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack('>H', len(body) + 2) \
            + body
    head = [b'\xff\xd8',
            seg(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')]
    for tid, q in enumerate((ql, qc)):
        head.append(seg(0xDB, bytes([tid]) + bytes(
            q[ZIGZAG].astype(np.uint8))))
    head.append(seg(0xC0, struct.pack('>BHHB', 8, H, W, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (cls, tid), (bt, vl) in _HUFF.items():
        head.append(seg(0xC4, bytes([cls << 4 | tid]) + bytes(bt)
                        + bytes(vl)))
    head.append(seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b''.join(head) + scan + b'\xff\xd9'


# ------------------------------------------------------- pixel operations
def _linear_taps(d: int, s: int):
    """cv2's INTER_LINEAR taps of one axis: (first source index (d,),
    second (d,), weights (d, 2) int32 in 11-bit fixed point), with its
    float32 coordinate and its edge clamps."""
    scale = s / d
    fx = ((np.arange(d) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    return sx, fx


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=INTER_LINEAR) for a uint8
    (h, w) or (h, w, c) image: 11-bit fixed-point coefficients from a
    float32 source coordinate (dst + 0.5) * scale - 0.5, a horizontal
    pass in int32 and OpenCV's vertical rounding
    ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2."""
    W, H = size
    if img.dtype != np.uint8:
        raise ValueError('resize_linear takes uint8 images')
    h, w = img.shape[:2]
    if (w, h) == (W, H):
        return img.copy()
    if w / W == 2 and h / H == 2:
        # OpenCV takes INTER_AREA for an exact halving: the 2x2 mean
        x = img.astype(np.int32)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    one = 2048

    def coef(f):
        return np.rint(f * np.float32(one)).astype(np.int32)
    # horizontal taps, edges clamped as cv2 does (weight on one pixel)
    sx, fx = _linear_taps(W, w)
    left = sx < 0
    fx[left], sx[left] = 0, 0
    right = sx >= w - 1
    fx[right], sx[right] = 0, w - 1
    a0 = coef(np.float32(1) - fx)
    a1 = coef(fx)
    x = img.astype(np.int32)
    x0 = x[:, sx]
    x1 = x[:, np.minimum(sx + 1, w - 1)]
    sh = (slice(None),) + (None,) * (img.ndim - 2)
    hz = x0 * a0[sh] + x1 * a1[sh]
    hz = np.where(right[sh], x0 * one, hz)
    # vertical taps: rows clamped into the image, weights as computed
    sy, fy = _linear_taps(H, h)
    b0 = coef(np.float32(1) - fy)
    b1 = coef(fy)
    r0 = np.clip(sy, 0, h - 1)
    r1 = np.clip(sy + 1, 0, h - 1)
    col = (slice(None), None) + (None,) * (img.ndim - 2)
    v = (((b0[col] * (hz[r0] >> 4)) >> 16)
         + ((b1[col] * (hz[r1] >> 4)) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=INTER_NEAREST): source index
    floor(dst * src / dst_size), clamped."""
    W, H = size
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(W) * (w / W)).astype(np.int64),
                    w - 1)
    sy = np.minimum(np.floor(np.arange(H) * (h / H)).astype(np.int64),
                    h - 1)
    return img[sy][:, sx]


def _box5(img: np.ndarray, reduce, fill) -> np.ndarray:
    pad = np.pad(img, 2, mode='constant', constant_values=fill)
    h, w = img.shape
    out = pad[2:2 + h, 2:2 + w].copy()
    for dy in range(5):
        for dx in range(5):
            out = reduce(out, pad[dy:dy + h, dx:dx + w])
    return out


def erode5(img: np.ndarray) -> np.ndarray:
    """cv2.erode with a 5x5 box on a 2D uint8 image (the border ignored)."""
    return _box5(img, np.minimum, 255)


def dilate5(img: np.ndarray) -> np.ndarray:
    """cv2.dilate with a 5x5 box on a 2D uint8 image (the border
    ignored)."""
    return _box5(img, np.maximum, 0)


_XY_SHIFT = 16


def _clip_line(w: int, h: int, p1, p2):
    """cv2's clipLine to [0, w-1] x [0, h-1]; (inside, p1, p2)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(img: np.ndarray, p1, p2, value):
    """cv2's 8-connected Line (LineIterator, left to right)."""
    h, w = img.shape[:2]
    ok, p1, p2 = _clip_line(w, h, p1, p2)
    if not ok:
        return
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(img: np.ndarray, pts, value) -> np.ndarray:
    """cv2.fillPoly(img, [pts], value) for one polygon of integer
    vertices (in place; returns img): each edge drawn as an 8-connected
    line, then the scanline fill of cv2's FillEdgeCollection (16-bit
    fixed-point edge x, spans [x_left, x_right] between sorted pairs)."""
    h, w = img.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    one = 1 << _XY_SHIFT
    edges = []
    for i in range(len(pts)):
        p0, p1 = pts[i - 1], pts[i]
        _line8(img, p0, p1, value)
        x0c, y0c = (p0[0] << _XY_SHIFT), p0[1]
        x1c, y1c = (p1[0] << _XY_SHIFT), p1[1]
        if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h
                and 0 <= p1[1] < h):
            ok, t0, t1 = _clip_line(w, h, p0, p1)
            if t0[1] != t1[1]:
                x0c, y0c = t0[0] << _XY_SHIFT, t0[1]
                x1c, y1c = t1[0] << _XY_SHIFT, t1[1]
        else:
            pass
        if p0[1] == p1[1]:
            continue
        ddx = _tdiv(x1c - x0c, y1c - y0c) if y1c != y0c else 0
        if p0[1] < p1[1]:
            y0, y1, xs = p0[1], p1[1], x0c + (p0[1] - y0c) * ddx
        else:
            y0, y1, xs = p1[1], p0[1], x1c + (p1[1] - y1c) * ddx
        edges.append((y0, y1, xs, ddx))
    if len(edges) < 2:
        return img
    for y in range(max(0, min(e[0] for e in edges)),
                   min(h, max(e[1] for e in edges))):
        xs = sorted(xs0 + (y - y0) * ddx for y0, y1, xs0, ddx in edges
                    if y0 <= y < y1)
        for xl, xr in zip(xs[0::2], xs[1::2]):
            x1, x2 = (xl + one - 1) >> _XY_SHIFT, xr >> _XY_SHIFT
            if x1 < w and x2 >= 0:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = value
    return img


def undistort(img: np.ndarray, K, D) -> np.ndarray:
    """cv2.undistort(img, K, D, None) of a uint8 (H, W) or (H, W, 3)
    image: the new camera matrix is K, D is (k1, k2, p1, p2, k3) (fewer
    are padded with zeros); OpenCV's float64 map at 1/32 pixel and its
    15-bit bilinear remap with a constant 0 border
    (`native/codec.cpp:undistort_u8`)."""
    from arah_tpu_torch import native
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f'undistort: uint8 gray or RGB, not {img.dtype} '
                         f'{img.shape}')
    d = np.zeros(5, np.float64)
    dist = np.asarray(D, np.float64).ravel()
    if dist.size > 5 and np.any(dist[5:]):
        raise ValueError(f'undistort: the 5-coefficient model only, not '
                         f'{dist.tolist()}')
    d[:min(dist.size, 5)] = dist[:5]
    return native.undistort_u8(img, np.asarray(K, np.float64), d)
