"""Binary PPM (P6) without OpenCV or PIL: FlyingChairs' frames are `.ppm`,
and the card machine has neither."""
import numpy as np


def _token(data: bytes, pos: int):
    """The next whitespace-separated header token from pos, skipping `#`
    comments; returns (token, position after it)."""
    n = len(data)
    while pos < n:
        if data[pos:pos + 1] == b"#":
            while pos < n and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
        elif data[pos:pos + 1].isspace():
            pos += 1
        else:
            break
    start = pos
    while pos < n and not data[pos:pos + 1].isspace() \
            and data[pos:pos + 1] != b"#":
        pos += 1
    return data[start:pos], pos


def decode(data: bytes) -> np.ndarray:
    """P6 bytes -> (H, W, 3) RGB: uint8 for a maxval below 256, else
    uint16 (big-endian samples), as PIL reads them."""
    magic, pos = _token(data, 0)
    if magic != b"P6":
        raise ValueError(f"not a binary PPM (P6) file: magic {magic!r}")
    w, pos = _token(data, pos)
    h, pos = _token(data, pos)
    maxval, pos = _token(data, pos)
    w, h, maxval = int(w), int(h), int(maxval)
    if not 0 < maxval < 65536:
        raise ValueError(f"PPM maxval {maxval}")
    dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    n = w * h * 3 * dt.itemsize
    body = data[pos + 1:pos + 1 + n]   # one whitespace byte ends the header
    if len(body) != n:
        raise ValueError(f"PPM data holds {len(body)} bytes, the header "
                         f"implies {n}")
    img = np.frombuffer(body, dt).reshape(h, w, 3)
    return img.astype(np.uint16) if maxval >= 256 else img.copy()


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def write(path: str, img: np.ndarray):
    """Write an (H, W, 3) uint8 RGB image as binary PPM (maxval 255)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PPM write takes (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
            img).tobytes())
