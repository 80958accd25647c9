"""Minimal PNG reader/writer on zlib + numpy, so the port needs no
imaging package: 8-bit grey, grey+alpha, RGB and RGBA, non-interlaced,
all five row filter types on read; filter type 0 on write."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> channels


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * c + 1)
    ftype = rows[:, 0]
    if ftype.max() > 4:
        raise ValueError(f"bad PNG filter type {ftype.max()}")
    filt = rows[:, 1:].astype(np.int32).reshape(h, w, c)
    if not np.isin(ftype, (3, 4)).any():
        # None / Sub / Up: each row is one vectorised step.
        out = np.zeros((h, w, c), np.int32)
        prior = np.zeros((w, c), np.int32)
        for y in range(h):
            line = filt[y]
            if ftype[y] == 1:
                line = np.cumsum(line, axis=0)
            elif ftype[y] == 2:
                line = line + prior
            out[y] = prior = line & 0xFF
        return out.astype(np.uint8)
    # Average / Paeth depend on the left, upper and upper-left pixels:
    # sweep anti-diagonals x + y = t, each one vectorised, on a copy padded
    # with a zero row on top and a zero column on the left.
    rec = np.zeros((h + 1, w + 1, c), np.int32)
    for t in range(h + w - 1):
        ys = np.arange(max(0, t - w + 1), min(h, t + 1))
        xs = t - ys
        a, b, ul = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        f = ftype[ys][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, ul), 0))))
        rec[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """[H, W, C] uint8 (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) "
                         f"PNGs are supported (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] uint8."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                         axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, level)))
        f.write(chunk(b"IEND", b""))
