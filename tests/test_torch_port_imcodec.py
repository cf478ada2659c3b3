"""The port's image decoder (``data/imcodec.py``) against cv2 (written
against 5.0.0 over libjpeg-turbo 3.1.2 and libpng 1.6): ``imdecode`` must be
byte-equal to ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` on JPEGs written by
cv2 at several qualities, sampling factors, sizes, restart intervals and
Huffman tables, grayscale, EXIF-oriented and the test datasets' JPEGs, and
on PNGs of every colour type and depth; what it does not decode must
raise. cv2 is imported here only. The committed decode fixtures that the
card's smoke posts over HTTP are regenerated and compared."""
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from chip_smoke import SERVE_DECODES, SERVE_FIXTURES, SERVE_TIMED, shape_images
from yolo_contour_regression_tpu_torch.data import imcodec
from yolo_contour_regression_tpu_torch.data.imcodec import imdecode, imread

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "411": 0x411111,
            "440": 0x121111}
DATA = Path(__file__).resolve().parent / "data"


def _image(h, w, seed=0):
    """Smooth ramps with 30% noise pixels: every coefficient band is used."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([(xx * 3 + yy) % 256, (yy * 2) % 256, (xx + yy * 5) % 256], -1)
    noise = rng.integers(0, 256, (h, w, 3))
    return np.where(rng.uniform(size=(h, w, 1)) < 0.3, noise, smooth).astype(np.uint8)


def _jpeg(img, quality=95, sampling="420", *extra):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                         *extra])
    assert ok
    return buf.tobytes()


def _assert_same(buf: bytes):
    want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    assert want is not None
    got = imdecode(buf)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_quality_and_sampling(quality, sampling):
    _assert_same(_jpeg(_image(17, 33, quality), quality, sampling))


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (2, 5), (481, 641)])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_sizes(hw, sampling):
    """1x1 and 2-wide planes take the replicating upsamplers, wider ones
    the triangle filter; the edges come from the planes' true sizes."""
    _assert_same(_jpeg(_image(*hw, seed=hw[0]), 95, sampling))


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("interval", [1, 3])
def test_jpeg_restart_intervals(sampling, interval):
    _assert_same(_jpeg(_image(40, 57, interval), 90, sampling,
                       cv2.IMWRITE_JPEG_RST_INTERVAL, interval))


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_optimized_huffman(sampling):
    _assert_same(_jpeg(_image(33, 47, 3), 85, sampling, cv2.IMWRITE_JPEG_OPTIMIZE, 1))


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (120, 161)])
def test_jpeg_grayscale(hw):
    ok, buf = cv2.imencode(".jpg", _image(*hw)[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    got = _assert_same(buf.tobytes())
    assert (got[..., 0] == got[..., 2]).all()


def _exif(orientation: int, order: str) -> bytes:
    end = "<" if order == "II" else ">"
    ifd = struct.pack(end + "H", 1) + struct.pack(end + "HHIHH", 0x0112, 3, 1, orientation, 0)
    return order.encode() + struct.pack(end + "HI", 42, 8) + ifd + struct.pack(end + "I", 0)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(orientation):
    """cv2's IMREAD_COLOR applies an APP1 orientation tag (1-8), in either
    byte order."""
    buf = _jpeg(_image(13, 21, orientation), 90, "420")
    for order in ("MM", "II"):
        app1 = b"Exif\x00\x00" + _exif(orientation, order)
        got = _assert_same(buf[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
                           + buf[2:])
        assert got.shape[:2] == ((21, 13) if orientation >= 5 else (13, 21))


def test_jpeg_test_datasets(tmp_path):
    """The JPEGs ``tests/helpers.py`` writes (``cv2.imwrite``'s defaults)."""
    from tests.helpers import make_pose_dataset, make_shape_dataset

    make_shape_dataset(tmp_path / "seg", n_train=3, n_val=2, img_w=120)
    make_pose_dataset(tmp_path / "pose", n_train=2, n_val=1)
    files = sorted(tmp_path.rglob("*.jpg"))
    assert len(files) == 8
    for f in files:
        np.testing.assert_array_equal(imread(f), cv2.imread(str(f)))


def test_cv2_decodes_with_islow_and_fancy_upsampling(monkeypatch):
    """What the decoder reproduces is what cv2 runs: plain replication of
    the chroma (the merged upsampler's rule too) or a float IDCT each
    change the 4:2:0 decode, where the ISLOW IDCT with fancy upsampling
    gives cv2's bytes."""
    buf = _jpeg(_image(64, 96, 5), 90, "420")
    _assert_same(buf)
    want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)

    def replicate(plane, c, hmax, vmax):
        return np.repeat(np.repeat(plane, vmax // c.v, 0), hmax // c.h, 1)

    with monkeypatch.context() as m:
        m.setattr(imcodec, "_upsample", replicate)
        assert (imdecode(buf) != want).any()

    n = np.arange(8)
    basis = np.cos((2 * n[:, None] + 1) * n[None, :] * np.pi / 16) * np.where(n == 0, 1 / 8 ** .5,
                                                                              .5)

    def float_idct(c, qtable):
        blocks = np.asarray(c.coefs, np.float64).reshape(-1, 8, 8) * qtable.reshape(8, 8)
        out = np.clip(np.round(basis @ blocks @ basis.T) + 128, 0, 255).astype(np.uint8)
        return out.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)

    with monkeypatch.context() as m:
        m.setattr(imcodec, "_idct_plane", float_idct)
        assert (imdecode(buf) != want).any()


# ---------------------------------------------------------------------------- PNG


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png(w, h, depth, ctype, rows: bytes, plte=None, trns=None, interlace=0) -> bytes:
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _png_chunk(b"PLTE", plte)
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    return out + _png_chunk(b"IDAT", zlib.compress(rows)) + _png_chunk(b"IEND", b"")


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (120, 161)])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_written_by_cv2(hw, depth, channels):
    """Gray, BGR and BGRA at 8 and 16 bits (cv2 keeps a 16-bit sample's
    high byte; alpha is dropped), each row filter cv2's encoder picks."""
    rng = np.random.default_rng(depth + channels)
    hi = (1 << depth) - 1
    shape = hw + ((channels,) if channels > 1 else ())
    img = rng.integers(0, hi + 1, shape).astype(np.uint16 if depth == 16 else np.uint8)
    img[: hw[0] // 2] = (np.arange(hw[1]) * 997 % hi).reshape((1, -1) + (1,) * (channels > 1))
    for level in (0, 9):
        ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert ok
        _assert_same(buf.tobytes())


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("ctype", [0, 3])
def test_png_palette_and_low_depth_gray(depth, ctype):
    """Palette PNGs (with a tRNS alpha, dropped) and gray below 8 bits,
    written with zlib, every row filter."""
    rng = np.random.default_rng(depth)
    h, w = 11, 13
    n = 1 << depth
    idx = rng.integers(0, n, (h, w), dtype=np.uint8)
    rows, prev = b"", None
    for y in range(h):
        bits = np.unpackbits(idx[y][:, None], axis=1)[:, 8 - depth :].reshape(-1)
        line = np.packbits(bits)
        prev = np.zeros_like(line) if prev is None else prev
        rows += bytes([y % 5]) + _filter(line, prev, 1, y % 5)
        prev = line
    plte = rng.integers(0, 256, (n, 3), dtype=np.uint8).tobytes() if ctype == 3 else None
    _assert_same(_png(w, h, depth, ctype, rows, plte=plte, trns=b"\x00\x80" if plte else None))


def _filter(line: np.ndarray, prior: np.ndarray, bpp: int, ftype: int) -> bytes:
    """Apply PNG row filter ``ftype`` (the encoder's side)."""
    x = line.astype(np.int64)
    b = prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8).tobytes()


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype", [4, 6])
def test_png_alpha_types_every_filter(depth, ctype):
    """Gray + alpha (which cv2 does not write) and RGBA, rows filtered by
    each of the five filters in turn."""
    rng = np.random.default_rng(ctype * depth)
    h, w = 10, 9
    bpp = (2 if ctype == 4 else 4) * depth // 8
    rows, prev = b"", np.zeros(w * bpp, np.uint8)
    for y in range(h):
        line = rng.integers(0, 256, w * bpp, dtype=np.uint8)
        rows += bytes([y % 5]) + _filter(line, prev, bpp, y % 5)
        prev = line
    _assert_same(_png(w, h, depth, ctype, rows))


def test_png_exif_orientation():
    """cv2 applies a PNG eXIf orientation too."""
    ok, buf = cv2.imencode(".png", _image(5, 7))
    buf = buf.tobytes()
    i = buf.index(b"IDAT") - 4
    for orientation in range(1, 9):
        _assert_same(buf[:i] + _png_chunk(b"eXIf", _exif(orientation, "MM")) + buf[i:])


# ---------------------------------------------------------------------------- raising


def _truncated_jpeg():
    buf = _jpeg(_image(64, 64), 95)
    return buf[: len(buf) * 2 // 3]


def _truncated_png():
    ok, buf = cv2.imencode(".png", _image(64, 64))
    return buf.tobytes()[: len(buf) // 2]


@pytest.mark.parametrize("case, error, words", [
    ("progressive", NotImplementedError, "progressive JPEG"),
    ("adam7", NotImplementedError, "Adam7"),
    ("webp", NotImplementedError, "WebP"),
    ("tiff", NotImplementedError, "TIFF"),
    ("bmp", NotImplementedError, "BMP"),
    ("truncated_jpeg", ValueError, "truncated JPEG"),
    ("truncated_png", ValueError, "PNG"),
    ("junk", ValueError, "not a JPEG or PNG"),
])
def test_unsupported_and_broken_bytes_raise(case, error, words):
    img = _image(16, 16)
    if case == "progressive":
        buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    elif case == "adam7":
        rows = b"".join(b"\x00" + img[y].tobytes() for y in range(16))
        buf = _png(16, 16, 8, 2, rows, interlace=1)
    elif case in ("webp", "tiff", "bmp"):
        buf = cv2.imencode("." + case, img)[1].tobytes()
    elif case == "truncated_jpeg":
        buf = _truncated_jpeg()
    elif case == "truncated_png":
        buf = _truncated_png()
    else:
        buf = b"hello, not an image"
    with pytest.raises(error, match=words):
        imdecode(buf)


def test_oversized_headers_raise():
    """A header past cv2's pixel limit is refused before any allocation."""
    huge = _png(1 << 16, 1 << 15, 8, 2, b"")
    with pytest.raises(ValueError, match="exceeds"):
        imdecode(huge)
    buf = bytearray(_jpeg(_image(8, 8), 90))
    sof = buf.index(b"\xff\xc0")
    buf[sof + 5 : sof + 9] = struct.pack(">HH", 1 << 15, (1 << 16) - 1)
    with pytest.raises(ValueError, match="exceeds"):
        imdecode(bytes(buf))
    buf[sof + 5 : sof + 9] = struct.pack(">HH", 1 << 14, 1 << 14)  # allowed, but no data
    with pytest.raises(ValueError, match="too little entropy-coded data"):
        imdecode(bytes(buf))


def test_png_inflates_only_the_rows_of_its_header():
    """A 1x1 PNG whose IDAT inflates to 64 MiB (a zlib bomb of 65 KB):
    decoded as cv2 decodes it (libpng ignores the tail), without inflating
    the tail."""
    import tracemalloc

    z = zlib.compressobj(9)
    idat = z.compress(b"\x00\x10\x20\x30") + b"".join(
        z.compress(bytes(1 << 20)) for _ in range(64)) + z.flush()
    buf = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))
    assert len(buf) < 100_000
    tracemalloc.start()
    try:
        got = imdecode(buf)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 * len(buf), peak
    assert np.array_equal(got, cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR))


def test_imread_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        imread(tmp_path / "none.jpg")


# ---------------------------------------------------------------------------- fixtures


def make_serve_fixtures() -> dict:
    """The encoded files the card's smoke posts over HTTP and the two whose
    decode it times (name -> bytes), written by cv2 from
    ``chip_smoke.shape_images`` (the timed pair on a gradient, the JPEG
    with noise of sigma 2)."""
    img = shape_images(2, 240, 320, seed=11)
    small = shape_images(1, 120, 160, seed=12)[0]
    exif = b"Exif\x00\x00" + _exif(6, "MM")
    q90 = _jpeg(small, 90, "422")
    out = {
        "torch_port_serve_q95_420.jpg": _jpeg(img[0], 95, "420"),
        "torch_port_serve_q75_444_rst.jpg": _jpeg(img[1], 75, "444",
                                                  cv2.IMWRITE_JPEG_RST_INTERVAL, 4,
                                                  cv2.IMWRITE_JPEG_OPTIMIZE, 1),
        "torch_port_serve_q90_422_exif6.jpg": (q90[:2] + b"\xff\xe1"
                                               + struct.pack(">H", len(exif) + 2) + exif
                                               + q90[2:]),
        "torch_port_serve_bgr8.png": cv2.imencode(".png", img[0])[1].tobytes(),
        "torch_port_serve_bgra16.png": cv2.imencode(
            ".png", np.concatenate([small, np.full(small.shape[:2] + (1,), 255, np.uint8)],
                                   -1).astype(np.uint16) * 257)[1].tobytes(),
    }
    assert set(out) == set(SERVE_FIXTURES)
    yy, xx = np.mgrid[:480, :640]
    tex = shape_images(1, 480, 640, seed=13)[0] + ((xx // 4 + yy // 3) % 64).astype(np.uint8)[
        ..., None]
    noisy = np.clip(tex + np.random.default_rng(0).normal(0, 2, tex.shape), 0, 255)
    out[SERVE_TIMED[0]] = _jpeg(noisy.astype(np.uint8), 95, "420")
    out[SERVE_TIMED[1]] = cv2.imencode(".png", tex)[1].tobytes()
    return out


def test_committed_serve_fixtures():
    """The committed files are what cv2 writes today, their committed
    decodes are cv2's, and ``imdecode`` gives them byte for byte."""
    fresh = make_serve_fixtures()
    with np.load(DATA / SERVE_DECODES) as z:
        decodes = {k: z[k] for k in z.files}
    assert sorted(decodes) == sorted(SERVE_FIXTURES)
    total = (DATA / SERVE_DECODES).stat().st_size
    for name, buf in fresh.items():
        assert (DATA / name).read_bytes() == buf, name
        total += len(buf)
        want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        if name in decodes:
            np.testing.assert_array_equal(decodes[name], want)
        np.testing.assert_array_equal(imread(DATA / name), want)
    assert total < 300_000
