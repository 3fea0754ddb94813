"""Host-side image IO and resampling, on numpy + zlib + struct alone.

Counterpart of ``nerf_shared_tpu/data/images.py``. The port must run where
no imaging package (imageio, PIL, cv2) is installed, so it carries its own
8-bit PNG codec:

- read: grey, grey+alpha, RGB and RGBA at bit depth 8, non-interlaced, with
  all five scanline filters (None, Sub, Up, Average, Paeth);
- write: the same colour types with filter 0 on every row.

``resize_area`` is the exact area average of the JAX package's native
resizer (``native/imageops.cpp``) at any factor, in numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (palette images, type 3, are not read)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-scanline filters of a decompressed 8-bit image stream."""
    stride = w * c
    rows = raw.reshape(h, stride + 1)
    ftypes = rows[:, 0]
    data = rows[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = int(ftypes[y]), data[y]
        if f == 0:
            cur = line
        elif f == 1:  # Sub: a running sum along the row, per channel
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif f == 2:  # Up
            cur = (line + prev) & 0xFF
        elif f in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            left = np.zeros(c, np.int32)
            upleft = np.zeros(c, np.int32)
            for x in range(w):
                sl = slice(x * c, (x + 1) * c)
                up = prev[sl]
                if f == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, upleft))
                cur[sl] = (line[sl] + pred) & 0xFF
                left, upleft = cur[sl], up
        else:
            raise ValueError(f"PNG: unknown filter type {f} on row {y}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, c)


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array [H, W] (grey) or [H, W, C]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"PNG: only 8-bit non-interlaced grey/RGB(A) images are read "
            f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w, c)
    return img[..., 0] if c == 1 else img


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def png_encode(img_u8: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W] or [H, W, 1|2|3|4] -> PNG bytes (filter 0 on every row)."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8:
        raise TypeError(f"png_encode takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"png_encode: {c} channels is not a PNG colour type")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def imread_float(path: str) -> np.ndarray:
    """Read a PNG as float32 in [0, 1], keeping the alpha channel."""
    with open(path, "rb") as f:
        img = png_decode(f.read())
    return (img / 255.0).astype(np.float32)


def imwrite_u8(path: str, img_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_encode(img_u8))


def _area_taps(n_in: int, n_out: int):
    """(index, weight), each [taps, n_out]: output pixel o averages the input
    pixels [o * n_in / n_out, (o + 1) * n_in / n_out) weighted by how much
    of each the interval covers (0 for taps past its end)."""
    scale = n_in / n_out
    lo = np.arange(n_out) * scale
    hi = (np.arange(n_out) + 1) * scale
    idx = np.floor(lo).astype(np.int64)[None] + np.arange(int(np.ceil(scale)) + 1)[:, None]
    weight = np.clip(np.minimum(idx + 1, hi) - np.maximum(idx, lo), 0.0, None)
    return np.minimum(idx, n_in - 1), weight


def resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Area-average resize at any factor: every output pixel is the exact
    average of the input area it covers, partial pixels weighted by their
    covered fraction (cv2.INTER_AREA for downscaling), summed in float64
    and cast back to the input's dtype."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1).astype(np.float64)
    iy, wy = _area_taps(h, out_h)
    ix, wx = _area_taps(w, out_w)
    rows = sum(wk[:, None, None] * x[ik] for ik, wk in zip(iy, wy))
    rows /= wy.sum(0)[:, None, None]
    out = sum(wk[None, :, None] * rows[:, ik] for ik, wk in zip(ix, wx))
    out /= wx.sum(0)[None, :, None]
    return out.reshape(out_h, out_w, *img.shape[2:]).astype(img.dtype, copy=False)
