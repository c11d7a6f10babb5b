"""PNG without OpenCV or PIL, on zlib and numpy.

The card machine has neither, and the training data (VFHQ clips) are PNG
frames, so the port reads them here:
- `decode`: 8- and 16-bit gray, RGB and RGBA (16-bit samples as uint16,
  KITTI's flow maps), non-interlaced, every row filter (None, Sub, Up,
  Average, Paeth), chunk CRCs checked. Any other form (palette, gray +
  alpha, 1/2/4-bit depths, Adam7) raises ValueError.
- `imread_bgr` / `decode_bgr`: what cv2.imread(path, cv2.IMREAD_COLOR) returns
  for the 8-bit forms: (H, W, 3) uint8 BGR, gray replicated, alpha dropped.
- `imread_unchanged`: cv2.imread(path, cv2.IMREAD_UNCHANGED) (gray 2-D,
  BGR, BGRA; 8 or 16 bits).
- `encode` / `imwrite_bgr`: a minimal writer (the tests' fixtures,
  chip_smoke.py's clip, KITTI flow maps, validation images), uint8 or
  uint16, one filter for every row or one per row.

Sub and Up rows unfilter as numpy array operations; Average and Paeth
depend on the pixel to their left, so they run byte by byte in Python, far
slower (OpenCV writes Sub rows, and so does `encode` by default).
"""
import struct
import zlib
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> samples a pixel


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _average(line: bytes, prior: bytes, bpp: int) -> bytearray:
    cur = bytearray(len(line))
    for i in range(len(line)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (line[i] + ((a + prior[i]) >> 1)) & 255
    return cur


def _paeth(line: bytes, prior: bytes, bpp: int) -> bytearray:
    cur = bytearray(len(line))
    for i in range(len(line)):
        b = prior[i]
        if i >= bpp:
            a, c = cur[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (line[i] + pred) & 255
    return cur


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:]
        if f == 0:
            cur = line
        elif f == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = line + prior
        elif f == 3:
            cur = np.frombuffer(_average(line.tobytes(), prior.tobytes(),
                                         bpp), np.uint8)
        elif f == 4:
            cur = np.frombuffer(_paeth(line.tobytes(), prior.tobytes(),
                                       bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: filter type {f}")
        out[y] = cur
        prior = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) in the file's channel order (C = 1 gray, 3
    RGB, 4 RGBA), uint8 for 8-bit files and uint16 for 16-bit ones."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace != 0 \
            or comp != 0 or filt != 0:
        raise ValueError(
            f"PNG form not supported: bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace} (8- or 16-bit gray, RGB or "
            "RGBA, non-interlaced only)")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8          # bytes a pixel, the filters' unit
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, the header "
                         f"implies {h * (w * bpp + 1)}")
    out = _unfilter(raw.reshape(h, w * bpp + 1), h, w, bpp)
    if depth == 16:               # big-endian samples
        out = out.view(">u2").astype(np.uint16)
    return out.reshape(h, w, c)


def decode_bgr(data: bytes) -> np.ndarray:
    """cv2.imdecode(buf, cv2.IMREAD_COLOR) of a supported PNG: (H, W, 3)
    uint8 BGR."""
    img = decode(data)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def imread_bgr(path: str) -> np.ndarray:
    """cv2.imread(path, cv2.IMREAD_COLOR) of a supported PNG file."""
    with open(path, "rb") as f:
        return decode_bgr(f.read())


def _filtered(img2d: np.ndarray, bpp: int, filters) -> bytes:
    """Each row prefixed by its filter type and filtered by it."""
    x = img2d.astype(np.int16)
    h, stride = x.shape
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[:, bpp:] = up[:, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    out = np.empty((h, stride + 1), np.uint8)
    for y, f in enumerate(filters):
        out[y, 0] = f
        out[y, 1:] = ((x[y] - preds[f][y]) & 255).astype(np.uint8)
    return out.tobytes()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(img: np.ndarray, filters: Union[int, Sequence[int]] = 1,
           level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8 or uint16 (C = 1 gray, 3 RGB, 4 RGBA) ->
    an 8- or 16-bit PNG's bytes; filters: one type (0-4) for every row, or
    one per row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG encode takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    depth = 8 * img.dtype.itemsize
    if isinstance(filters, int):
        filters = [filters] * h
    if len(filters) != h or any(f not in range(5) for f in filters):
        raise ValueError("one filter type in 0-4 for each row")
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    raw = _filtered(rows.view(np.uint8).reshape(h, -1), c * depth // 8,
                    filters)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """A supported PNG file as `decode` gives it: (H, W, C) in the file's
    order and depth."""
    with open(path, "rb") as f:
        return decode(f.read())


def imread_unchanged(path: str) -> np.ndarray:
    """cv2.imread(path, cv2.IMREAD_UNCHANGED) of a supported PNG file, in
    the file's depth: gray as (H, W), colour as (H, W, 3) BGR, colour with
    alpha as (H, W, 4) BGRA."""
    img = imread(path)
    if img.shape[2] == 1:
        return img[:, :, 0]
    order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
    return np.ascontiguousarray(img[:, :, order])


def imwrite_bgr(path: str, img: np.ndarray, filters=1):
    """Write an (H, W, 3) BGR, (H, W, 4) BGRA or (H, W) gray image, uint8
    or uint16, as PNG, as cv2.imwrite would store it (RGB[A] samples)."""
    img = np.asarray(img)
    if img.ndim == 3:
        if img.shape[2] not in (3, 4):
            raise ValueError("imwrite_bgr writes (H, W, 3) BGR, (H, W, 4) "
                             "BGRA or (H, W)")
        order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
        img = np.ascontiguousarray(img[:, :, order])
    with open(path, "wb") as f:
        f.write(encode(img, filters))
