"""Host-side image IO and resampling, on numpy + zlib + struct alone.

Counterpart of ``nerf_shared_tpu/data/images.py``. The port must run where
no imaging package (imageio, PIL, cv2) is installed, so it carries its own
8-bit PNG codec:

- read: grey, grey+alpha, RGB and RGBA at bit depth 8, non-interlaced, with
  all five scanline filters (None, Sub, Up, Average, Paeth);
- write: the same colour types with filter 0 on every row;

and reads baseline JPEG through its own decoder (data/jpeg.py), bit-equal
to Pillow's libjpeg read. ``imread_float`` picks the codec by the file's
signature, not its name. ``gif_encode`` writes render-path videos as
GIF89a (the JAX package writes mp4 through imageio's ffmpeg backend and
falls back to GIF). ``resize_area`` is the exact area average of the JAX
package's native resizer (``native/imageops.cpp``) at any factor, in numpy.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from nerf_shared_tpu_torch.data.jpeg import is_jpeg, jpeg_decode

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
    """Read a PNG or a baseline JPEG (by its signature) as float32 in
    [0, 1], keeping the alpha channel."""
    with open(path, "rb") as f:
        data = f.read()
    img = jpeg_decode(data) if is_jpeg(data) else png_decode(data)
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


IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def image_files(imgdir: str):
    """The sorted image file names (JPEG or PNG) of a directory."""
    return sorted(f for f in os.listdir(imgdir) if f.lower().endswith(IMAGE_EXTS))


def minify_images(basedir: str, factor: int) -> str:
    """Create (once) and return the images_{factor}/ cache directory with all
    of images/ area-downsampled by ``factor`` (``resize_area``) as 8-bit PNG,
    truncated as ``(clip(x, 0, 1) * 255).astype(uint8)``; an existing
    directory is returned untouched. The directory appears whole or not at
    all. Sources may be PNG or JPEG."""
    srcdir = os.path.join(basedir, "images")
    outdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(outdir):
        return outdir
    files = image_files(srcdir)
    tmpdir = outdir + ".partial"
    os.makedirs(tmpdir, exist_ok=True)
    for f in files:
        img = imread_float(os.path.join(srcdir, f))
        h, w = img.shape[:2]
        small = resize_area(img, int(round(h / factor)), int(round(w / factor)))
        imwrite_u8(os.path.join(tmpdir, os.path.splitext(f)[0] + ".png"),
                   (np.clip(small, 0, 1) * 255).astype(np.uint8))
    os.replace(tmpdir, outdir)
    return outdir


# GIF: one global palette, the 6 x 7 x 6 colour cube (252 colours; entries
# 252-255 are black and unused). Each channel goes to its nearest level, so
# a pixel is off its input by at most GIF_MAX_ERROR levels a channel
_GIF_LEVELS = (np.round(np.arange(6) * 255 / 5), np.round(np.arange(7) * 255 / 6),
               np.round(np.arange(6) * 255 / 5))
_GIF_LUT = [np.abs(np.arange(256)[:, None] - lv[None]).argmin(1).astype(np.uint8)
            for lv in _GIF_LEVELS]
GIF_PALETTE = np.zeros((256, 3), np.uint8)
GIF_PALETTE[:252] = np.stack(np.meshgrid(*_GIF_LEVELS, indexing="ij"), -1).reshape(-1, 3)
GIF_MAX_ERROR = (25, 21, 25)
# LZW: every pixel is a literal 9-bit code, with a clear code before each run
# of _GIF_RUN literals, so the decoder's table (258 + run - 1 entries) never
# reaches 512 and the code width never changes
_GIF_CLEAR, _GIF_END, _GIF_RUN = 256, 257, 250


def gif_palette_indices(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] RGB -> uint8 [...] indices into GIF_PALETTE."""
    f = np.asarray(frames_u8)
    r, g, b = (_GIF_LUT[c][f[..., c]].astype(np.uint16) for c in range(3))
    return (r * 42 + g * 6 + b).astype(np.uint8)


def _gif_sub_blocks(data: bytes) -> bytes:
    """``data`` as GIF sub-blocks (a length byte, then up to 255 bytes) and
    the zero-length terminator."""
    arr = np.frombuffer(data, np.uint8)
    n = len(arr) // 255
    full = np.concatenate([np.full((n, 1), 255, np.uint8),
                           arr[:n * 255].reshape(n, 255)], 1).tobytes()
    rest = arr[n * 255:].tobytes()
    return full + (bytes([len(rest)]) + rest if rest else b"") + b"\x00"


def _gif_lzw(indices: np.ndarray) -> bytes:
    """The LZW stream of one frame's palette indices, min code size 8:
    literal 9-bit codes, a clear code before every _GIF_RUN of them, the end
    code last, packed least significant bit first."""
    px = indices.reshape(-1).astype(np.uint16)
    runs = -(-len(px) // _GIF_RUN)
    codes = np.empty(len(px) + runs + 1, np.uint16)
    clear = np.arange(runs) * (_GIF_RUN + 1)
    literal = np.ones(len(codes), bool)
    literal[clear] = False
    literal[-1] = False
    codes[clear] = _GIF_CLEAR
    codes[literal] = px
    codes[-1] = _GIF_END
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def gif_encode(frames_u8: np.ndarray, fps: float = 30.0) -> bytes:
    """uint8 frames [N, H, W, 3] -> an animated GIF89a that loops forever,
    each frame shown round(100 / fps) centiseconds.

    Colours: the fixed 6 x 7 x 6 cube (``GIF_PALETTE``, 252 colours), each
    channel rounded to its nearest level, so every decoded pixel is within
    25 levels of the input on red and blue and 21 on green
    (``GIF_MAX_ERROR``); ``GIF_PALETTE[gif_palette_indices(frames)]`` is the
    decoded video exactly. The pixel data is uncompressed LZW (9 bits a
    pixel, see ``_gif_lzw``)."""
    frames = np.asarray(frames_u8)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"gif_encode takes uint8 [N, H, W, 3], got {frames.dtype} "
                         f"{frames.shape}")
    _, h, w, _ = frames.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"gif_encode: a {w}x{h} frame does not fit a GIF")
    delay = int(round(100.0 / fps))
    out = [b"GIF89a",
           # logical screen: global colour table of 256 entries, 8 bits a colour
           struct.pack("<HHBBB", w, h, 0xF7, 0, 0), GIF_PALETTE.tobytes(),
           # NETSCAPE2.0 application block: loop forever
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for idx in gif_palette_indices(frames):
        out += [struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay, 0, 0),
                struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0), b"\x08",
                _gif_sub_blocks(_gif_lzw(idx))]
    out.append(b"\x3b")
    return b"".join(out)
