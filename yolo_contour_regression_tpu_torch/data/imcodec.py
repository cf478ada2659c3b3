"""Image decoding without cv2 or PIL: the port's ``cv2.imdecode(buf,
IMREAD_COLOR)`` and ``cv2.imread(path)``, in numpy and the standard library.

``imdecode(buf)`` returns (H, W, 3) uint8 BGR, byte-equal to OpenCV 5's
decode over libjpeg-turbo 3.1 and libpng 1.6:

- **PNG**: colour types 0, 2, 3, 4 and 6 at bit depths 1-16 as the type
  allows; ``zlib`` inflates, the five row filters are undone (None, Sub and
  Up vectorised per row; Average and Paeth walk the row); a 16-bit sample
  keeps its high byte (libpng's ``png_set_strip_16``); gray below 8 bits is
  scaled to 8 (``png_set_expand_gray_1_2_4_to_8``); a palette expands to
  BGR; alpha is dropped, not composited; an ``eXIf`` orientation is applied
  as for JPEG. CRCs are checked.
- **JPEG**: sequential DCT with Huffman coding (SOF0 and SOF1), 8-bit, one
  component (gray, replicated to BGR) or three (YCbCr), any sampling
  factors, interleaved or not, restart intervals. The entropy decode is the
  one Python loop (a 32-bit window per byte and a 16-bit lookahead table
  that holds each code with its magnitude bits); the rest is numpy over all
  blocks at once, in libjpeg-turbo's exact integer arithmetic:
  ``jidctint.c``'s ISLOW IDCT (13-bit constants, pass 1 descaled by 11
  bits, pass 2 by 18, then + 128 and clamped), ``jdsample.c``'s fancy
  (triangle) upsampling for h2v1, h1v2 and h2v2 where the downsampled plane
  is wider than 2 samples (plain replication otherwise and for the other
  factors), the plane's edges replicated from its true size, and
  ``jdcolor.c``'s YCbCr -> BGR tables (16 fraction bits, rounded by
  ``ONE_HALF``). An EXIF orientation tag (APP1, tags 1-8) is applied as
  cv2's ``IMREAD_COLOR`` applies it.

What is not decoded raises ``NotImplementedError`` naming the format:
progressive, lossless, hierarchical and arithmetic-coded JPEG, 12-bit
JPEG, CMYK (four components) and Adobe-transformed JPEG (APP14 transform 0
or 2), Adam7-interlaced PNG, WebP, TIFF, BMP, GIF and JPEG 2000. Bytes that
are neither, or are truncated or corrupt, raise ``ValueError``.
"""
from __future__ import annotations

import functools
import struct
from array import array
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["imdecode", "imread"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
MAX_PIXELS = 1 << 30  # cv2's CV_IO_MAX_IMAGE_PIXELS: a larger header is refused


def _check_size(width: int, height: int, fmt: str):
    if width * height > MAX_PIXELS:
        raise ValueError(f"{fmt} of {width}x{height} exceeds {MAX_PIXELS} pixels")


def imread(path: Union[str, Path]) -> np.ndarray:
    """Decode the image file at ``path`` (``cv2.imread(path)``)."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"cannot read {path}")
    return imdecode(p.read_bytes())


def imdecode(buf) -> np.ndarray:
    """Encoded bytes (bytes, bytearray, memoryview or a uint8 array) ->
    (H, W, 3) uint8 BGR (``cv2.imdecode(buf, cv2.IMREAD_COLOR)``)."""
    data = bytes(np.asarray(buf, np.uint8).reshape(-1)) if isinstance(buf, np.ndarray) \
        else bytes(buf)
    if data[:8] == PNG_SIGNATURE:
        return _decode_png(data)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data)
    fmt = _other_format(data)
    if fmt:
        raise NotImplementedError(f"{fmt} decoding is not ported (JPEG and PNG only)")
    raise ValueError("not a JPEG or PNG image (unknown signature)")


def _other_format(data: bytes) -> Optional[str]:
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if data[:2] == b"BM":
        return "BMP"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or data[:4] == b"\xff\x4f\xff\x51":
        return "JPEG 2000"
    return None


# ---------------------------------------------------------------------------- PNG


def _png_chunks(data: bytes):
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        crc = data[pos + 8 + n : pos + 12 + n]
        if len(body) < n or len(crc) < 4:
            raise ValueError(f"truncated PNG: chunk {kind!r} cut short")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"corrupt PNG: CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _decode_png(data: bytes) -> np.ndarray:
    header, palette, idat, orientation = None, None, [], 1
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = _exif_orientation(body)
    if header is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype] or not width or not height:
        raise ValueError(f"corrupt PNG: colour type {ctype} at bit depth {depth}")
    _check_size(width, height, "PNG")
    if interlace:
        raise NotImplementedError("Adam7-interlaced PNG decoding is not ported")
    if ctype == 3 and palette is None:
        raise ValueError("corrupt PNG: palette image without PLTE")
    channels = _PNG_CHANNELS[ctype]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    try:  # inflate no further than the rows the header implies (as libpng); the tail is ignored
        raw = zlib.decompressobj().decompress(b"".join(idat), height * (stride + 1))
    except zlib.error as e:
        raise ValueError(f"corrupt or truncated PNG: {e}") from None
    if len(raw) < height * (stride + 1):
        raise ValueError("truncated PNG: image data cut short")
    rows = _unfilter(np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, -1),
                     max(bits // 8, 1))
    if depth == 16:  # big-endian samples: keep the high byte (png_set_strip_16)
        px = rows.reshape(height, width, channels, 2)[..., 0]
    elif depth == 8:
        px = rows.reshape(height, width, channels)
    else:
        px = np.unpackbits(rows, axis=1).reshape(height, -1, depth)[:, :width]
        px = (px * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        px = px[..., None]
    if ctype == 3:
        idx = px[..., 0]
        if idx.max() >= len(palette):
            raise ValueError("corrupt PNG: palette index past the palette")
        img = palette[idx][..., ::-1]
    elif ctype in (0, 4):
        g = px[..., 0]
        if depth < 8:
            g = (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
        img = np.repeat(g[..., None], 3, axis=2)
    else:
        img = px[..., 2::-1]
    return _orient(img, orientation)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters: rows (H, 1 + stride) uint8 -> (H, stride)."""
    height, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = _sub(line, bpp)
        elif ftype == 2:
            cur = line + prior
        elif ftype == 3:
            cur = _average(line, prior, bpp)
        elif ftype == 4:
            cur = _paeth(line, prior, bpp)
        else:
            raise ValueError(f"corrupt PNG: row filter {ftype}")
        out[y] = cur
        prior = cur
    return out


def _sub(line: np.ndarray, bpp: int) -> np.ndarray:
    """recon[x] = filt[x] + recon[x - bpp]: a cumulative sum mod 256 within
    each of the bpp byte lanes."""
    n = len(line)
    pad = (-n) % bpp
    lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
    return np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:n]


def _average(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    f, b = line.tolist(), prior.tolist()
    r = [0] * len(f)
    for x in range(min(bpp, len(f))):
        r[x] = (f[x] + (b[x] >> 1)) & 255
    for x in range(bpp, len(f)):
        r[x] = (f[x] + ((r[x - bpp] + b[x]) >> 1)) & 255
    return np.asarray(r, np.uint8)


def _paeth(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    f, b = line.tolist(), prior.tolist()
    r = [0] * len(f)
    for x in range(min(bpp, len(f))):
        r[x] = (f[x] + b[x]) & 255  # left and upper-left are 0: Paeth picks up
    for x in range(bpp, len(f)):
        a, up, c = r[x - bpp], b[x], b[x - bpp]
        pa, pb, pc = abs(up - c), abs(a - c), abs(a + up - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = up
        else:
            pred = c
        r[x] = (f[x] + pred) & 255
    return np.asarray(r, np.uint8)


# ---------------------------------------------------------------------------- JPEG


def _zigzag() -> np.ndarray:
    """jpeg_natural_order: zigzag index -> row-major position in the block."""
    cells = [(i, j) for i in range(8) for j in range(8)]
    cells.sort(key=lambda c: (c[0] + c[1], c[0] if (c[0] + c[1]) % 2 else -c[0]))
    return np.array([i * 8 + j for i, j in cells], np.int64)


NATURAL = _zigzag()
_NATURAL_LIST = NATURAL.tolist()


@functools.lru_cache(maxsize=32)
def _huffman_lut(counts: bytes, symbols: bytes, ac: bool) -> list:
    """A 16-bit lookahead table of one Huffman table. Entry ``w`` (the next
    16 bits of the stream) is None where no code starts w, else:
    DC ``(length, value, extra)`` and AC ``(length, run, value, extra)``.
    With ``extra`` -1 the magnitude bits fit in the window: ``length``
    counts code and magnitude bits and ``value`` is the decoded
    coefficient. Otherwise ``length`` is the code's alone and ``extra``
    magnitude bits follow it. An AC EOB has run -1."""
    code_len = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols):
                raise ValueError("corrupt JPEG: DHT lists more codes than symbols")
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            if hi > 1 << 16:
                raise ValueError("corrupt JPEG: DHT codes overflow")
            code_len[lo:hi] = length
            sym[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    w = np.arange(1 << 16, dtype=np.int64)
    s = sym & 15 if ac else sym
    total = code_len + s
    fits = total <= 16
    shift = np.where(fits, 16 - total, 0)
    bits = (w >> shift) & ((1 << s) - 1)
    value = np.where(s == 0, 0, np.where(bits >= (1 << np.maximum(s - 1, 0)), bits,
                                         bits - (1 << s) + 1))
    value = np.where(fits, value, 0)
    length = np.where(fits, total, code_len)
    extra = np.where(fits, -1, s)
    ok = (code_len > 0).tolist()
    if ac:
        run = np.where(sym == 0, -1, sym >> 4)
        rows = zip(length.tolist(), run.tolist(), value.tolist(), extra.tolist())
    else:
        rows = zip(length.tolist(), value.tolist(), extra.tolist())
    return [row if good else None for row, good in zip(rows, ok)]


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "width", "height", "bw", "bh", "coefs")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical sequential",
              0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
              0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
              0xCE: "arithmetic-coded hierarchical progressive",
              0xCF: "arithmetic-coded hierarchical lossless"}


def _decode_jpeg(data: bytes) -> np.ndarray:
    qt: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, list] = {}
    ac_tables: Dict[int, list] = {}
    comps: List[_Component] = []
    frame = None
    restart = 0
    orientation = 1
    adobe = None
    pos = 2
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1  # garbage before a marker: libjpeg skips it
        while pos < n and data[pos] == 0xFF:
            pos += 1  # fill bytes
        if pos >= n:
            raise ValueError("truncated JPEG: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG: segment length cut short")
        seg_len = struct.unpack(">H", data[pos : pos + 2])[0]
        body = data[pos + 2 : pos + seg_len]
        if len(body) < seg_len - 2:
            raise ValueError("truncated JPEG: segment cut short")
        pos += seg_len
        if marker in (0xC0, 0xC1):
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG decoding is not ported")
            if nc not in (1, 3):
                raise NotImplementedError(
                    f"{'CMYK' if nc == 4 else f'{nc}-component'} JPEG decoding is not ported")
            if not height or not width:
                raise NotImplementedError("JPEG with a DNL-defined height is not ported")
            _check_size(width, height, "JPEG")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                                body[8 + 3 * i]) for i in range(nc)]
            if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 for c in comps):
                raise ValueError("corrupt JPEG: sampling factor out of range")
            frame = _frame(comps, width, height)
        elif marker in _SOF_NAMES or 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8,
                                                                                 0xCC):
            raise NotImplementedError(
                f"{_SOF_NAMES.get(marker, 'SOF%X' % marker)} JPEG decoding is not ported")
        elif marker == 0xDB:
            _read_dqt(body, qt)
        elif marker == 0xC4:
            _read_dht(body, dc_tables, ac_tables)
        elif marker == 0xCC:
            raise NotImplementedError("arithmetic-coded JPEG decoding is not ported")
        elif marker == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            orientation = _exif_orientation(body[6:])
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            pos = _decode_scan(data, pos, body, comps, frame, dc_tables, ac_tables, restart)
    if frame is None or any(c.coefs is None for c in comps):
        raise ValueError("truncated JPEG: no complete scan")
    if adobe is not None and adobe != 1 and len(comps) == 3:
        raise NotImplementedError(f"Adobe-transformed (transform {adobe}) JPEG decoding is "
                                  f"not ported")
    if len(comps) == 3 and adobe is None and [c.cid for c in comps] == [82, 71, 66]:
        raise NotImplementedError("RGB (untransformed) JPEG decoding is not ported")
    planes = []
    for c in comps:
        if c.tq not in qt:
            raise ValueError(f"corrupt JPEG: no quantization table {c.tq}")
        planes.append(_idct_plane(c, qt[c.tq]))
    width, height, hmax, vmax = frame
    if len(comps) == 1:
        y = planes[0][:height, :width]
        img = np.repeat(y[..., None], 3, axis=2)
    else:
        full = [_upsample(p, c, hmax, vmax)[:height, :width] for p, c in zip(planes, comps)]
        img = _ycc_to_bgr(*full)
    return _orient(img, orientation)


def _frame(comps, width, height):
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c in comps:
        c.width = -(-width * c.h // hmax)
        c.height = -(-height * c.v // vmax)
        c.bw, c.bh = mcux * c.h, mcuy * c.v
        c.coefs = None
    return width, height, hmax, vmax


def _read_dqt(body: bytes, qt: Dict[int, np.ndarray]):
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 128 if pq else 64
        raw = body[pos + 1 : pos + 1 + size]
        if len(raw) < size:
            raise ValueError("corrupt JPEG: DQT cut short")
        vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int64)
        table = np.zeros(64, np.int64)
        table[NATURAL] = vals
        qt[tq] = table
        pos += 1 + size


def _read_dht(body: bytes, dc_tables: dict, ac_tables: dict):
    pos = 0
    while pos < len(body):
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = body[pos + 1 : pos + 17]
        total = sum(counts)
        symbols = body[pos + 17 : pos + 17 + total]
        if len(counts) < 16 or len(symbols) < total:
            raise ValueError("corrupt JPEG: DHT cut short")
        (ac_tables if tc else dc_tables)[th] = _huffman_lut(bytes(counts), bytes(symbols),
                                                            bool(tc))
        pos += 17 + total


def _exif_orientation(tiff: bytes) -> int:
    """The IFD0 Orientation tag (0x0112) of an EXIF block, 1 without one."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    try:
        off = struct.unpack(end + "I", tiff[4:8])[0]
        count = struct.unpack(end + "H", tiff[off : off + 2])[0]
        for i in range(count):
            e = off + 2 + 12 * i
            tag, typ, _ = struct.unpack(end + "HHI", tiff[e : e + 8])
            if tag == 0x0112 and typ == 3:
                value = struct.unpack(end + "H", tiff[e + 8 : e + 10])[0]
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform for tags 1-8."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(orientation, ()):
        img = img[::-1] if axis == 0 else img[:, ::-1]
    return np.ascontiguousarray(img)


def _scan_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from ``pos`` to the next marker that is not a
    restart, split at the restart markers and unstuffed; and the position
    of that marker's 0xFF."""
    segments, start, i, n = [], pos, pos, len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise ValueError("truncated JPEG: entropy-coded data runs to the end")
        nxt = data[i + 1]
        if nxt == 0x00:
            i += 2
            continue
        if nxt == 0xFF:
            i += 1
            continue
        segments.append(data[start:i].rstrip(b"\xff").replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= nxt <= 0xD7:
            i += 2
            start = i
            continue
        return segments, i


def _decode_scan(data, pos, body, comps, frame, dc_tables, ac_tables, restart) -> int:
    ns = body[0]
    if len(body) < 1 + 2 * ns + 3:
        raise ValueError("corrupt JPEG: SOS cut short")
    by_id = {c.cid: c for c in comps}
    scan = []
    for i in range(ns):
        cid, tables = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"corrupt JPEG: scan names no component {cid}")
        c = by_id[cid]
        if tables >> 4 not in dc_tables or tables & 15 not in ac_tables:
            raise ValueError("corrupt JPEG: scan uses an undefined Huffman table")
        scan.append((c, dc_tables[tables >> 4], ac_tables[tables & 15]))
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    if ss != 0 or se != 63 or a != 0:
        raise NotImplementedError("progressive JPEG decoding is not ported")
    segments, end = _scan_segments(data, pos)
    # a block takes at least 2 bits (a DC code and an EOB): refuse a header
    # whose blocks the data cannot hold before allocating their coefficients
    if ns == 1:
        n_blocks = -(-scan[0][0].height // 8) * -(-scan[0][0].width // 8)
    else:
        n_blocks = sum(c.bw * c.bh for c, _, _ in scan)
    if 8 * sum(len(seg) for seg in segments) < 2 * n_blocks:
        raise ValueError("truncated JPEG: too little entropy-coded data for its blocks")
    for c, _, _ in scan:
        if c.coefs is None:
            c.coefs = array("i", bytes(4 * c.bw * c.bh * 64))
    # every block of the scan in coding order: (coefficients, offset, tables, component)
    plan = []
    if ns == 1:
        c, dct, act = scan[0]
        for by in range(-(-c.height // 8)):
            for bx in range(-(-c.width // 8)):
                plan.append((c.coefs, (by * c.bw + bx) * 64, dct, act, 0))
        per_mcu = 1
    else:
        _, _, hmax, vmax = frame
        mcux, mcuy = scan[0][0].bw // scan[0][0].h, scan[0][0].bh // scan[0][0].v
        per_mcu = sum(c.h * c.v for c, _, _ in scan)
        for my in range(mcuy):
            for mx in range(mcux):
                for ci, (c, dct, act) in enumerate(scan):
                    for y in range(c.v):
                        for x in range(c.h):
                            plan.append((c.coefs, ((my * c.v + y) * c.bw + mx * c.h + x) * 64,
                                         dct, act, ci))
    step = restart * per_mcu if restart else len(plan)
    chunks = [plan[i : i + step] for i in range(0, len(plan), step)]
    if len(segments) < len(chunks):
        raise ValueError("truncated JPEG: fewer restart intervals than the scan needs")
    for seg, chunk in zip(segments, chunks):
        try:
            _decode_blocks(seg, chunk, len(scan))
        except OverflowError:  # a DC sum past int32: no 8-bit JPEG gets there
            raise ValueError("corrupt JPEG: coefficient out of range") from None
    return end


def _decode_blocks(seg: bytes, blocks: list, n_comp: int):
    """Huffman-decode ``blocks`` (one restart interval) from ``seg`` into
    their coefficient lists (natural order, not dequantized)."""
    b = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.uint32)
    win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    nat = _NATURAL_LIST
    pred = [0] * n_comp
    p = 0
    for coefs, off, dct, act, ci in blocks:
        e = dct[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if e is None:
            raise ValueError("corrupt JPEG: bad DC Huffman code")
        length, v, s = e
        p += length
        if s >= 0:
            bits = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            v = bits if bits >> (s - 1) else bits - (1 << s) + 1
        v += pred[ci]
        pred[ci] = v
        coefs[off] = v
        k = 1
        while k < 64:
            e = act[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if e is None:
                raise ValueError("corrupt JPEG: bad AC Huffman code")
            length, r, v, s = e
            p += length
            if r < 0:
                break
            if s >= 0:
                bits = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                v = bits if bits >> (s - 1) else bits - (1 << s) + 1
            k += r
            if k > 63:
                raise ValueError("corrupt JPEG: AC run past the block")
            coefs[off + nat[k]] = v
            k += 1
    if p > 8 * len(seg):
        raise ValueError("truncated JPEG: entropy-coded data ran out")


# ISLOW IDCT constants (jidctint.c, CONST_BITS 13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x):
    """The ISLOW butterfly on the 8 inputs x[0..7] (arrays): the 8 outputs
    before their descale, scaled by 2^13."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = -z1 * _F0899, -z2 * _F2562
    z3, z4 = -z3 * _F1961 + z5, -z4 * _F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _idct_plane(c: _Component, qtable: np.ndarray) -> np.ndarray:
    """A component's dequantized blocks through the ISLOW IDCT -> its
    (bh * 8, bw * 8) uint8 plane."""
    blocks = np.frombuffer(c.coefs, np.int32).astype(np.int64).reshape(-1, 8, 8) \
        * qtable.reshape(8, 8)
    # pass 1: columns (axis 1, the vertical frequency), descaled by 11 bits
    cols = _idct_1d([blocks[:, u, :] for u in range(8)])
    ws = np.stack([(v + (1 << 10)) >> 11 for v in cols], axis=1)
    # pass 2: rows, descaled by 18 bits, + 128 and clamped (the SIMD IDCT's saturation)
    rows = _idct_1d([ws[:, :, u] for u in range(8)])
    out = np.stack([(v + (1 << 17)) >> 18 for v in rows], axis=2)
    out = np.clip(out + 128, 0, 255).astype(np.uint8)
    return out.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)


def _fancy_h2(x: np.ndarray, width: int, bias_left: int, bias_right: int, scale: int
              ) -> np.ndarray:
    """Triangle-filter ``x[:, :width]`` to twice its width: each output is
    3/4 its nearer and 1/4 its farther input column, the end columns
    replicated (which gives libjpeg's special cases for the first and last
    column)."""
    x = x[:, :width]
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * width), np.int64)
    out[:, 0::2] = (3 * x + left + bias_left) >> scale
    out[:, 1::2] = (3 * x + right + bias_right) >> scale
    return out


def _vertical_pairs(p: np.ndarray, height: int):
    """Each row's 3x-nearer sums with the row above and the row below (the
    plane's true first and last rows replicated past its edges)."""
    x = p[:height].astype(np.int64)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    return 3 * x + above, 3 * x + below


def _upsample(plane: np.ndarray, c: _Component, hmax: int, vmax: int) -> np.ndarray:
    """A component's plane at full resolution, as libjpeg-turbo's upsampler
    (jdsample.c) makes it with fancy upsampling on."""
    hf, vf = hmax // c.h, vmax // c.v
    if hmax % c.h or vmax % c.v:
        raise NotImplementedError("JPEG with fractional sampling ratios is not ported")
    if hf == 1 and vf == 1:
        return plane
    x = plane.astype(np.int64)
    if hf == 2 and vf == 1 and c.width > 2:  # h2v1_fancy_upsample
        out = _fancy_h2(x, c.width, 1, 2, 2)
    elif hf == 1 and vf == 2:  # h1v2_fancy_upsample
        up, down = _vertical_pairs(x, c.height)
        out = np.empty((2 * c.height, x.shape[1]), np.int64)
        out[0::2] = (up + 1) >> 2
        out[1::2] = (down + 2) >> 2
    elif hf == 2 and vf == 2 and c.width > 2:  # h2v2_fancy_upsample
        up, down = _vertical_pairs(x, c.height)
        out = np.empty((2 * c.height, 2 * c.width), np.int64)
        for rows, sums in ((slice(0, None, 2), up), (slice(1, None, 2), down)):
            out[rows] = _fancy_h2(sums, c.width, 8, 7, 4)
    else:  # h2v1_upsample, h2v2_upsample, int_upsample: replication
        out = np.repeat(np.repeat(x, vf, axis=0), hf, axis=1)
    return out.astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(f):
        return int(f * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    y = y.astype(np.int64)
    b = y + _CB_B[cb]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    r = y + _CR_R[cr]
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)
