"""A baseline JPEG decoder in numpy.

The JAX package reads images through imageio and Pillow, whose JPEG codec
is libjpeg(-turbo) at its defaults. The port must run where no imaging
package is installed, so it carries this decoder, written to give the same
bytes as that library:

- markers: SOI, EOI, DQT (8- and 16-bit tables), SOF0 and SOF1 at 8 bits,
  DHT (any tables, optimised ones included), SOS (interleaved or one
  component a scan), DRI and RST0-7; APPn and COM are skipped, so EXIF
  orientation is ignored, as the JAX read ignores it;
- greyscale, or three components in YCbCr, sampled 4:4:4, 4:2:2 (h2v1) or
  4:2:0 (h2v2), at any image size;
- the integer IDCT of libjpeg's ``jidctint.c`` (``jpeg_idct_islow``) with
  its range limit, vectorised over all blocks;
- chroma upsampling as libjpeg's ``jdsample.c`` does it by default (the
  "fancy" triangle filters ``h2v1_fancy_upsample`` / ``h2v2_fancy_upsample``,
  the edges replicated; plain replication for a chroma plane 2 samples
  wide or less);
- YCbCr -> RGB through libjpeg's fixed-point tables (``jdcolor.c``).

Only the entropy decoding is a loop over symbols (16-bit lookup tables).
Progressive, arithmetic-coded, lossless, hierarchical and 12-bit JPEGs,
CMYK, Adobe / RGB transforms and any other sampling raise
NotImplementedError naming the item.
"""

from __future__ import annotations

import array
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_SOI, _EOI = 0xD8, 0xD9
# SOF markers other than SOF0 / SOF1 -> what they are
_UNSUPPORTED_SOF = {0xC2: "progressive JPEG (SOF2)", 0xC3: "lossless JPEG (SOF3)",
                    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
                    0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic coding (SOF9)",
                    0xCA: "arithmetic coding (SOF10)", 0xCB: "arithmetic coding (SOF11)",
                    0xCC: "arithmetic coding (DAC)", 0xCD: "arithmetic coding (SOF13)",
                    0xCE: "arithmetic coding (SOF14)", 0xCF: "arithmetic coding (SOF15)"}
# zigzag position -> natural (row-major) index, then 16 guards at 63 as
# libjpeg's jpeg_natural_order has, for a corrupt run past the block's end
_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
           40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
           36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
           60, 61, 54, 47, 55, 62, 63] + [63] * 16
_END_OF_SCAN = re.compile(rb"\xff(?![\x00\xd0-\xd7])")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.coef: Optional[np.ndarray] = None   # int16 [bh, bw, 64], natural order


def _huffman_lut(counts: List[int], symbols: bytes) -> List[int]:
    """The canonical code of a DHT table as a 65,536-entry list indexed by
    the next 16 bits: (code length << 8) | symbol, 0 for no code."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(segment: bytes) -> List[int]:
    """Big-endian 32-bit words starting at every byte of ``segment``
    (zeros past its end, as libjpeg feeds zeros after the data)."""
    b = np.frombuffer(segment + b"\x00" * 8, np.uint8).astype(np.uint32)
    n = len(segment) + 4
    return ((b[:n] << 24) | (b[1:n + 1] << 16) | (b[2:n + 2] << 8) | b[3:n + 3]).tolist()


def _decode_segment(segment: bytes, blocks, dc_luts, ac_luts, out) -> None:
    """Huffman-decode the blocks of one restart interval into ``out`` (the
    flat int16 coefficient store). ``blocks`` holds one (flat offset of
    the block, DC table, AC table, predictor slot) a block, in scan order."""
    w = _windows(segment)
    zz = _ZIGZAG
    pred = [0, 0, 0, 0]
    p = 0
    for base, dct, act, slot in blocks:
        dc_lut, ac_lut = dc_luts[dct], ac_luts[act]
        e = dc_lut[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if not e:
            raise ValueError("JPEG: bad Huffman code (corrupt data)")
        p += e >> 8
        t = e & 0xFF
        if t:
            d = ((w[p >> 3] >> (16 - (p & 7))) & 0xFFFF) >> (16 - t)
            p += t
            if d < (1 << (t - 1)):
                d -= (1 << t) - 1
            pred[slot] += d
        out[base] = pred[slot]
        k = 1
        while k < 64:
            e = ac_lut[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise ValueError("JPEG: bad Huffman code (corrupt data)")
            p += e >> 8
            s = e & 15
            if s:
                k += (e >> 4) & 15
                a = ((w[p >> 3] >> (16 - (p & 7))) & 0xFFFF) >> (16 - s)
                p += s
                if a < (1 << (s - 1)):
                    a -= (1 << s) - 1
                out[base + zz[k]] = a
                k += 1
            elif (e >> 4) & 15 == 15:
                k += 16
            else:
                break


# --- jidctint.c jpeg_idct_islow -------------------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
          f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(x, shift):
    """One 1-D pass of jpeg_idct_islow on the 8 inputs ``x`` (int64 arrays),
    each output DESCALE'd by ``shift`` bits."""
    f = _F
    z1 = (x[2] + x[6]) * f["f0541"]
    tmp2 = z1 + x[6] * -f["f1847"]
    tmp3 = z1 + x[2] * f["f0765"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0, t1, t2, t3 = t0 * f["f0298"], t1 * f["f2053"], t2 * f["f3072"], t3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift,
            (tmp12 + t1 + r) >> shift, (tmp13 + t0 + r) >> shift,
            (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by value & 1023: the value
    + 128 clamped to [0, 255] for values in [-512, 511] (a wraparound
    beyond, as in jdmaster.c prepare_range_limit_table)."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0], i - 896).astype(np.uint8)


_RANGE = _idct_range_table()


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Blocks of quantised coefficients [n, 64] (natural order) and their
    quantisation table [64] -> samples uint8 [n, 8, 8]."""
    x = coef.astype(np.int64).reshape(-1, 8, 8) * qtable.astype(np.int64).reshape(8, 8)
    # pass 1: columns (the 8 vertical frequencies of each column)
    ws = np.stack(_idct_1d([x[:, k, :] for k in range(8)],
                           _CONST_BITS - _PASS1_BITS), axis=1)
    # pass 2: rows (the workspace's 8 horizontal entries of each row)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), axis=2)
    return _RANGE[out & 1023]


# --- jdsample.c upsampling and jdcolor.c colour conversion -------------------------


def _h2_fancy(rows: np.ndarray, scale: int, bias_even: int, bias_odd: int) -> np.ndarray:
    """Horizontal half of the fancy upsamplers on int rows [r, w]: output
    column 2j = (3 in[j] + in[j-1] + bias_even) >> scale, 2j + 1 = (3 in[j]
    + in[j+1] + bias_odd) >> scale, the end columns from the edge (``scale``
    2: h2v1's weights on samples; 4: h2v2's on the vertical sums)."""
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int64)
    out[:, 0::2] = (3 * rows + left + bias_even) >> scale
    out[:, 1::2] = (3 * rows + right + bias_odd) >> scale
    return out


def upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A chroma plane uint8 [dh, dw] (the component's real samples) grown by
    (fh, fv) as libjpeg's default upsampler does -> [fv dh, fh dw]."""
    if (fh, fv) == (1, 1):
        return plane
    x = plane.astype(np.int64)
    dw = x.shape[1]
    if dw <= 2:
        # jinit_upsampler: no fancy upsampling this narrow, plain replication
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    if (fh, fv) == (2, 1):
        # h2v1_fancy_upsample; its end columns copy the edge sample
        out = _h2_fancy(x, 2, 1, 2)
        out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
        return out.astype(np.uint8)
    # h2v2_fancy_upsample: each output row blends its nearest input row
    # (x3) with the next nearest (above for the even output row, below for
    # the odd one; the edge rows repeat, as jdmainct.c's context rows do)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * dw), np.int64)
    for r0, near in ((0, above), (1, below)):
        sums = 3 * x + near
        row = _h2_fancy(sums, 4, 8, 7)
        row[:, 0] = (4 * sums[:, 0] + 8) >> 4
        row[:, -1] = (4 * sums[:, -1] + 7) >> 4
        out[r0::2] = row
    return out.astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_XS = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _XS + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _XS + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _XS
_CB_G = -_fix(0.34414) * _XS + (1 << 15)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on uint8 planes -> uint8 [H, W, 3]."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# --- the stream -----------------------------------------------------------------


def _segment(data: bytes, pos: int) -> Tuple[bytes, int]:
    (length,) = struct.unpack(">H", data[pos:pos + 2])
    return data[pos + 2:pos + length], pos + length


def jpeg_decode(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> uint8 [H, W] (greyscale) or [H, W, 3] (RGB)."""
    if not is_jpeg(data):
        raise ValueError("not a JPEG file")
    qt: Dict[int, np.ndarray] = {}
    dc_luts: Dict[int, List[int]] = {}
    ac_luts: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    H = W = 0
    restart, adobe_transform = 0, None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while data[pos] == 0xFF:          # fill bytes
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == _EOI:
            break
        if marker == _SOI or 0xD0 <= marker <= 0xD7:
            continue
        body, pos = _segment(data, pos)
        if marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(f"JPEG: {_UNSUPPORTED_SOF[marker]} is not supported "
                                      "(baseline and extended sequential Huffman only)")
        if marker in (0xC0, 0xC1):
            precision, H, W, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"JPEG: {precision}-bit samples are not "
                                          "supported (8-bit only)")
            if H == 0:
                raise NotImplementedError("JPEG: a height set by DNL is not supported")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                body[7 + 3 * i] & 15, body[8 + 3 * i]) for i in range(nf)]
            _check_components(comps, adobe_transform)
            _allocate(comps, H, W)
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                lut = _huffman_lut(counts, body[i + 17:i + 17 + n])
                (dc_luts if tc == 0 else ac_luts)[th] = lut
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int32)
                    i += 129
                else:
                    vals = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int32)
                    i += 65
                table = np.zeros(64, np.int32)
                table[_ZIGZAG[:64]] = vals
                qt[tq] = table
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe_transform = body[11] if len(body) > 11 else 0
        elif marker == 0xDA:
            if not comps:
                raise ValueError("JPEG: SOS before SOF")
            _check_components(comps, adobe_transform)
            pos = _decode_scan(data, pos, body, comps, dc_luts, ac_luts, restart, H, W)
        # APPn, COM and anything else: skipped
    if not comps or any(c.coef is None for c in comps):
        raise ValueError("JPEG: no image data")
    return _to_pixels(comps, qt, H, W)


def _check_components(comps, adobe_transform):
    ids = tuple(c.cid for c in comps)
    if len(comps) == 4:
        raise NotImplementedError("JPEG: CMYK / YCCK (4 components) is not supported")
    if len(comps) not in (1, 3):
        raise NotImplementedError(f"JPEG: {len(comps)} components are not supported")
    if len(comps) == 3 and (ids == (82, 71, 66) or adobe_transform == 0):
        raise NotImplementedError("JPEG: RGB components (Adobe transform 0) are not "
                                  "supported (YCbCr only)")
    if adobe_transform not in (None, 1) and len(comps) == 3:
        raise NotImplementedError(f"JPEG: Adobe transform {adobe_transform} is not supported")
    if len(comps) == 3:
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        for c in comps:
            if (hmax % c.h or vmax % c.v
                    or (hmax // c.h, vmax // c.v) not in ((1, 1), (2, 1), (2, 2))):
                raise NotImplementedError(
                    "JPEG: sampling " + ",".join(f"{k.h}x{k.v}" for k in comps)
                    + " is not supported (4:4:4, 4:2:2 h2v1 and 4:2:0 h2v2 only)")


def _allocate(comps, H, W):
    """Each component's coefficient store: the blocks of whole MCUs."""
    if len(comps) == 1:
        # one component is coded block by block, whatever its factors say
        comps[0].h = comps[0].v = 1
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    for c in comps:
        c.bw, c.bh = mcux * c.h, mcuy * c.v
        # the component's real samples (libjpeg's downsampled_width/height)
        c.dw, c.dh = -(-W * c.h // hmax), -(-H * c.v // vmax)
        c.coef = np.zeros((c.bh, c.bw, 64), np.int16)


def _decode_scan(data, pos, header, comps, dc_luts, ac_luts, restart, H, W) -> int:
    """Decode one scan's entropy-coded data into the components'
    coefficient stores; returns the position of the marker after it."""
    ns = header[0]
    by_id = {c.cid: c for c in comps}
    scomps, tables = [], []
    for i in range(ns):
        c = by_id[header[1 + 2 * i]]
        scomps.append(c)
        tables.append((header[2 + 2 * i] >> 4, header[2 + 2 * i] & 15))
    ss, se = header[1 + 2 * ns], header[2 + 2 * ns]
    if ss != 0 or se != 63:
        raise NotImplementedError("JPEG: spectral selection (progressive) is not supported")
    end = _END_OF_SCAN.search(data, pos)
    stop = end.start() if end else len(data)
    # one flat store for the scan's components, in scan order
    offsets, total = [], 0
    for c in scomps:
        offsets.append(total)
        total += c.coef.size
    out = array.array("h", bytes(2 * total))
    for c, off in zip(scomps, offsets):
        out[off:off + c.coef.size] = array.array("h", c.coef.tobytes())
    # (flat offset, dc table, ac table, predictor slot) of each block in
    # scan order: MCU by MCU, each component's h x v blocks in raster order;
    # one component alone is non-interleaved: its real blocks in raster order
    if ns == 1:
        c = scomps[0]
        nbx, nby = -(-c.dw // 8), -(-c.dh // 8)
        by, bx = np.divmod(np.arange(nbx * nby), nbx)
        bases = (64 * (by * c.bw + bx)).tolist()
        per_mcu = 1
    else:
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
        my, mx = np.divmod(np.arange(mcux * mcuy), mcux)
        cols = []
        for c, off in zip(scomps, offsets):
            for v in range(c.v):
                for h in range(c.h):
                    cols.append(off + 64 * ((my * c.v + v) * c.bw + mx * c.h + h))
        per_mcu = len(cols)
        bases = np.stack(cols, axis=1).reshape(-1).tolist()
    slot = [i for i, c in enumerate(scomps) for _ in range(1 if ns == 1 else c.h * c.v)]
    tabs = [tables[i] for i in slot]
    for dc, ac in tabs:
        if dc not in dc_luts or ac not in ac_luts:
            raise ValueError("JPEG: a scan uses an undefined Huffman table")
    blocks = [(b, tabs[j % per_mcu][0], tabs[j % per_mcu][1], slot[j % per_mcu])
              for j, b in enumerate(bases)]
    segments = _RST.split(data[pos:stop]) if restart else [data[pos:stop]]
    step = restart * per_mcu if restart else len(blocks)
    for i, seg in enumerate(segments):
        chunk = blocks[i * step:(i + 1) * step]
        if chunk:
            _decode_segment(seg.replace(b"\xff\x00", b"\xff"), chunk, dc_luts, ac_luts, out)
    flat = np.frombuffer(out, np.int16)
    for c, off in zip(scomps, offsets):
        c.coef = flat[off:off + c.coef.size].reshape(c.coef.shape).copy()
    return stop


def _to_pixels(comps, qt, H, W) -> np.ndarray:
    planes = []
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    for c in comps:
        if c.tq not in qt:
            raise ValueError("JPEG: a component uses an undefined quantisation table")
        px = idct_islow(c.coef.reshape(-1, 64), qt[c.tq])
        plane = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(8 * c.bh, 8 * c.bw)
        plane = upsample(plane[:c.dh, :c.dw], hmax // c.h, vmax // c.v)
        planes.append(plane[:H, :W])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    return ycc_to_rgb(*planes)
