"""OpenCV's pixel operations of the face toolkit, computed without OpenCV.

The card machine has no OpenCV, so the helper's warps, morphology, blurs,
area resize and similarity estimate are rebuilt here from OpenCV's own
arithmetic (imgproc imgwarp.cpp, morph, smooth, box_filter, resize.cpp;
calib3d ptsetreg.cpp). The image operations take torch tensors, (H, W) or
(H, W, C), and run on the tensor's device: on the card when serving, on the
CPU in the tests, with the same integer or float32 arithmetic on both.
tests/test_torch_cvops.py holds each one against cv2:
- `warp_affine` (INTER_LINEAR / INTER_NEAREST; borders constant,
  replicate, reflect101, reflect), `erode`, `box_filter`, `resize_area`,
  `copy_make_border` (BORDER_CONSTANT), `gray_to_bgr` and `bgr_to_gray`
  (8-bit and 16-bit) bitwise. OpenCV 5's warp kernels map each destination pixel
  to the source in float32 with fused multiply-adds, in one form for the
  vector body and another for the last columns of a row, and interpolate
  in float32 with fused multiply-adds too (`warp_affine` says which).
- `gaussian_blur` within 1e-6 on [0, 1] masks (OpenCV sums with FMAs in its
  vector code; this sums by a convolution in float32, TF32 off).
- `resize_linear_f32` within 2e-5 (1 ulp at an integer factor).
- the training data's float32 forms (tests/test_torch_data.py):
  `filter2d_f32` (cv2.filter2D, reflect-101) and `resize_area_f32` within
  1e-6, `resize_cubic_f32` (INTER_CUBIC) within 1e-5.
- `estimate_affine_partial_lmeds` (`cv2.estimateAffinePartial2D` with
  `method=cv2.LMEDS`): the same random 2-point subsets (OpenCV's RNG,
  seeded in each call), models, medians, scale and inliers; the refinement
  follows OpenCV's damped least squares over the inliers, to within the gap
  stated in that function.
"""
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

BORDERS = ("constant", "replicate", "reflect101", "reflect")


# -- index helpers ------------------------------------------------------------

def border_index(p, n: int, border: str):
    """OpenCV's borderInterpolate for an int64 tensor of coordinates along an
    axis of length n: the source index, or -1 (constant border)."""
    inside = (p >= 0) & (p < n)
    if border == "constant":
        return torch.where(inside, p, torch.full_like(p, -1))
    if border == "replicate":
        return p.clamp(0, n - 1)
    if n == 1:
        return torch.zeros_like(p)
    if border == "reflect101":
        period = 2 * n - 2
        q = torch.remainder(p, period)
        return torch.where(q >= n, period - q, q)
    if border == "reflect":
        period = 2 * n
        q = torch.remainder(p, period)
        return torch.where(q >= n, period - 1 - q, q)
    raise ValueError(f"border {border!r}: one of {BORDERS}")


def _np_border_index(p: np.ndarray, n: int, border: str) -> np.ndarray:
    return border_index(torch.as_tensor(p, dtype=torch.int64), n,
                        border).numpy()


def _as_hwc(img: torch.Tensor) -> torch.Tensor:
    if img.dim() == 2:
        return img[:, :, None]
    if img.dim() != 3:
        raise ValueError(f"an (H, W) or (H, W, C) image, got "
                         f"{tuple(img.shape)}")
    return img


def _check_dtype(img: torch.Tensor, ops: str):
    if img.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{ops} takes uint8 or float32 images, got "
                         f"{img.dtype}")


# -- warpAffine ---------------------------------------------------------------

def invert_affine_cv(m: np.ndarray) -> np.ndarray:
    """warpAffine's inversion of a forward 2x3 matrix, in double, as
    OpenCV computes it (a singular matrix gives zeros)."""
    M = np.asarray(m, np.float64).reshape(6).tolist()
    D = M[0] * M[4] - M[1] * M[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = M[4] * D, M[0] * D
    M[0], M[4] = a11, a22
    M[1] *= -D
    M[3] *= -D
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return np.array(M, np.float64)


WARP_BODY = 16   # pixels a vector step of OpenCV's warp kernels (AVX2 build)


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add a * b + c, rounded once: the product of two
    float32 numbers is exact in float64, so only a sum of far-apart
    magnitudes rounds twice (about one case in 2^29)."""
    return (a.double() * b.double() + c.double()).float()


def _warp_coords(m: np.ndarray, w: int, h: int, device):
    """float32 source coordinates (sx, sy) of every destination pixel, as
    OpenCV's warpAffine kernels compute them from the inverted matrix in
    float32: the vector body (WARP_BODY pixels a step) as
    fma(M0, x, y M1 + M2); the columns past the last full step as
    fma(x, M0, y M1) + M2."""
    M = [torch.tensor(float(v), dtype=torch.float32, device=device)
         for v in np.float32(invert_affine_cv(m))]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    tail = x >= (w // WARP_BODY) * WARP_BODY
    coords = []
    for a, b, c in ((M[0], M[1], M[2]), (M[3], M[4], M[5])):
        body = _fma32(a.expand(h, w), x, y * b + c)
        rest = _fma32(x.expand(h, w), a, y * b) + c
        coords.append(torch.where(tail, rest, body))
    return coords


def _cval(border_value, c: int, dtype, device) -> torch.Tensor:
    v = np.zeros(c, np.float64)
    if border_value is not None:
        bv = np.atleast_1d(np.asarray(border_value, np.float64))
        v[:min(c, len(bv))] = bv[:c]
    if dtype == torch.uint8:
        v = np.clip(np.rint(v), 0, 255)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def warp_affine(img: torch.Tensor, m: np.ndarray, dsize: Tuple[int, int],
                interpolation: str = "linear", border: str = "constant",
                border_value=None) -> torch.Tensor:
    """cv2.warpAffine(img, m, dsize, flags=INTER_LINEAR or INTER_NEAREST,
    borderMode=..., borderValue=...) for a uint8 or float32 (H, W[, C])
    tensor; m is the forward 2x3 matrix, dsize (width, height). The result
    lies on img's device, in its dtype.

    OpenCV inverts m in double, maps each destination pixel to the source
    in float32 (`_warp_coords`), and interpolates the four taps in float32
    with fused multiply-adds: v0 = fma(ax, p01 - p00, p00), v1 likewise,
    v = fma(ay, v1 - v0, v0), rounded half to even for uint8. A tap outside
    the source takes the border (the constant, or borderInterpolate's
    pixel); with a constant border a pixel whose taps all lie outside is the
    constant. Nearest takes the pixel at the rounded coordinates."""
    _check_dtype(img, "warp_affine")
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"interpolation {interpolation!r}: linear or nearest")
    if border not in BORDERS:
        raise ValueError(f"border {border!r}: one of {BORDERS}")
    squeeze = img.dim() == 2
    src = _as_hwc(img)
    sh, sw, c = src.shape
    w, h = int(dsize[0]), int(dsize[1])
    dev = src.device
    flat = src.reshape(sh * sw, c).to(torch.float32)
    cval = _cval(border_value, c, src.dtype, dev)
    sx, sy = _warp_coords(m, w, h, dev)

    def tap(ix, iy):
        jx, jy = border_index(ix, sw, border), border_index(iy, sh, border)
        ok = ((jx >= 0) & (jy >= 0)).reshape(-1, 1)
        idx = (jy.clamp(min=0) * sw + jx.clamp(min=0)).reshape(-1)
        return torch.where(ok, flat[idx], cval)

    if interpolation == "nearest":
        out = tap(torch.round(sx).long(), torch.round(sy).long())
    else:
        fx, fy = torch.floor(sx), torch.floor(sy)
        ax = (sx - fx).reshape(-1, 1)
        ay = (sy - fy).reshape(-1, 1)
        ix, iy = fx.long(), fy.long()
        p00, p01 = tap(ix, iy), tap(ix + 1, iy)
        p10, p11 = tap(ix, iy + 1), tap(ix + 1, iy + 1)
        v0 = _fma32(ax, p01 - p00, p00)
        v1 = _fma32(ax, p11 - p10, p10)
        out = _fma32(ay, v1 - v0, v0)
        if border == "constant":
            away = ((ix >= sw) | (ix < -1) | (iy >= sh) | (iy < -1))
            out = torch.where(away.reshape(-1, 1), cval, out)
    if src.dtype == torch.uint8:
        out = torch.round(out).clamp(0, 255).to(torch.uint8)
    out = out.reshape(h, w, c)
    return out[..., 0] if squeeze else out


# -- morphology and filters ---------------------------------------------------

def erode(img: torch.Tensor, k: int) -> torch.Tensor:
    """cv2.erode(img, np.ones((k, k), np.uint8)): the minimum over a k x k
    window anchored at (k // 2, k // 2), so rows y - k//2 ... y + (k-1) - k//2
    (asymmetric for an even k); pixels beyond the border are ignored."""
    _check_dtype(img, "erode")
    if k <= 1:
        return img.clone()
    squeeze = img.dim() == 2
    x = _as_hwc(img)
    a = k // 2
    xf = x.permute(2, 0, 1)[None].to(torch.float32)     # (1, C, H, W)
    big = torch.finfo(torch.float32).max
    xf = F.pad(xf, (a, k - 1 - a, a, k - 1 - a), value=big)
    out = -F.max_pool2d(-xf, (k, 1), stride=1)
    out = -F.max_pool2d(-out, (1, k), stride=1)
    out = out[0].permute(1, 2, 0).to(img.dtype)
    return out[..., 0] if squeeze else out


_SMALL_GAUSSIAN = {1: (1,), 3: (1, 2, 1), 5: (1, 4, 6, 4, 1),
                   7: (1, 3.5, 7, 9, 7, 3.5, 1),
                   9: (4, 13, 30, 51, 60, 51, 30, 13, 4)}


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F), OpenCV's bit-exact form:
    fixed tables for sigma <= 0 and ksize <= 9; otherwise, with
    sigma = 0.15 ksize + 0.35 (one rounding) when sigma <= 0, the half
    kernel exp(x^2 * -0.125 / sigma^2) over x = 1 - ksize, 3 - ksize, ...
    (twice the offsets), the centre 1, normalised by the double sum."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        t = np.asarray(_SMALL_GAUSSIAN[ksize], np.float64)
        return (t / t.sum()).astype(np.float32)
    from fractions import Fraction
    sig = (float(sigma) if sigma > 0 else
           float(Fraction(ksize) * Fraction(0.15) + Fraction(0.35)))
    scale2x = -0.125 / (sig * sig)
    half = (ksize - 1) // 2
    values = [math.exp(float(x * x) * scale2x)
              for x in range(1 - ksize, 1 - ksize + 2 * half, 2)]
    total = 0.0
    for v in values:
        total += v
    total = total * 2 + 1
    if ksize % 2 == 0:
        total += 1
    mul = 1.0 / total
    out = np.empty(ksize, np.float64)
    for i, v in enumerate(values):
        out[i] = out[ksize - 1 - i] = v * mul
    out[half] = mul
    if ksize % 2 == 0:
        out[half + 1] = mul
    return out.astype(np.float32)


def _filter_axis(x: torch.Tensor, kernel: np.ndarray, axis: int,
                 border: str) -> torch.Tensor:
    """Correlate (C, H, W) float32 x with a 1-D kernel along axis 1 or 2,
    the border by OpenCV's borderInterpolate."""
    k = len(kernel)
    r = k // 2
    n = x.shape[axis]
    idx = _np_border_index(np.arange(-r, n + k - 1 - r), n, border)
    xp = x.index_select(axis, torch.as_tensor(idx, device=x.device))
    wt = torch.as_tensor(kernel, device=x.device)
    c = x.shape[0]
    shape = (c, 1, k, 1) if axis == 1 else (c, 1, 1, k)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(xp[None], wt.reshape(1, 1, *shape[2:]).expand(shape),
                        groups=c)[0]


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) of a float32 image:
    the separable kernel of `gaussian_kernel`, rows then columns, the
    border reflected without repeating the edge (BORDER_REFLECT_101)."""
    if img.dtype != torch.float32:
        raise ValueError(f"gaussian_blur takes float32, got {img.dtype}")
    if ksize == 1:
        return img.clone()
    squeeze = img.dim() == 2
    x = _as_hwc(img).permute(2, 0, 1)
    kern = gaussian_kernel(ksize, sigma)
    x = _filter_axis(x, kern, 2, "reflect101")
    x = _filter_axis(x, kern, 1, "reflect101")
    out = x.permute(1, 2, 0)
    return out[..., 0] if squeeze else out.contiguous()


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.boxFilter(img, -1, (ksize, ksize)) of a uint8 image: the window's
    integer sum times 1 / ksize^2, rounded half to even, BORDER_REFLECT_101."""
    if img.dtype != torch.uint8:
        raise ValueError(f"box_filter takes uint8, got {img.dtype}")
    squeeze = img.dim() == 2
    x = _as_hwc(img).to(torch.int64)
    h, w, _ = x.shape
    r = ksize // 2
    for axis, n in ((0, h), (1, w)):
        idx = _np_border_index(np.arange(-r, n + ksize - 1 - r), n,
                               "reflect101")
        xp = x.index_select(axis, torch.as_tensor(idx, device=x.device))
        cs = torch.cumsum(xp, axis)
        zero = torch.zeros_like(cs.narrow(axis, 0, 1))
        cs = torch.cat([zero, cs], axis)
        x = cs.narrow(axis, ksize, n) - cs.narrow(axis, 0, n)
    out = torch.round(x.to(torch.float64) * (1.0 / (ksize * ksize)))
    out = out.clamp(0, 255).to(torch.uint8)
    return out[..., 0] if squeeze else out


# -- resizes ------------------------------------------------------------------

def _area_tab(src_n: int, dst_n: int, scale: float):
    """computeResizeAreaTab: for each output index its (source index,
    float32 weight) entries in OpenCV's order, padded with weight 0."""
    rows = []
    for d in range(dst_n):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src_n - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, src_n - 1)
        s1 = min(s1, s2)
        ent = []
        if s1 - fs1 > 1e-3:
            ent.append((s1 - 1, np.float32((s1 - fs1) / cell)))
        for s in range(s1, s2):
            ent.append((s, np.float32(1.0 / cell)))
        if fs2 - s2 > 1e-3:
            ent.append((s2, np.float32(min(min(fs2 - s2, 1.0), cell) / cell)))
        rows.append(ent)
    k = max(len(e) for e in rows)
    idx = np.zeros((dst_n, k), np.int64)
    wgt = np.zeros((dst_n, k), np.float32)
    for d, ent in enumerate(rows):
        for j, (s, a) in enumerate(ent):
            idx[d, j], wgt[d, j] = s, a
    return idx, wgt


def resize_area(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_AREA) of a uint8
    (H, W[, C]) tensor, shrinking (or keeping) both sides. An integer
    factor averages each block (a factor of 2 as (a + b + c + d + 2) >> 2,
    others as the int sum times float32(1 / area), rounded); otherwise each
    row's float32 weighted sums, then the rows', in OpenCV's order, rounded
    half to even."""
    if img.dtype != torch.uint8:
        raise ValueError(f"resize_area takes uint8, got {img.dtype}")
    squeeze = img.dim() == 2
    x = _as_hwc(img)
    sh, sw, c = x.shape
    w, h = int(dsize[0]), int(dsize[1])
    if (h, w) == (sh, sw):
        return img.clone()
    scale_x = 1.0 / (w / sw)
    scale_y = 1.0 / (h / sh)
    if scale_x < 1 or scale_y < 1:
        raise ValueError("resize_area shrinks only (INTER_AREA enlarging is "
                         "another method)")
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        blocks = x[:h * iy, :w * ix].to(torch.int32).reshape(h, iy, w, ix, c)
        total = blocks.sum(dim=(1, 3))
        if ix == 2 and iy == 2 and c in (1, 3, 4):
            out = (total + 2) >> 2
        else:
            out = torch.round(total.to(torch.float32)
                              * np.float32(1.0 / (ix * iy)))
        out = out.clamp(0, 255).to(torch.uint8)
        return out[..., 0] if squeeze else out
    out = _area_weighted(x.to(torch.float32), w, h, scale_x, scale_y)
    out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return out[..., 0] if squeeze else out


def _area_weighted(xf: torch.Tensor, w: int, h: int, scale_x: float,
                   scale_y: float) -> torch.Tensor:
    """INTER_AREA at a non-integer factor: each source row's float32
    weighted sums over _area_tab's taps, then the rows' in OpenCV's order;
    (h, w, C) unrounded from a float32 (H, W, C) image."""
    sh, sw = xf.shape[:2]
    xi, xw = _area_tab(sw, w, scale_x)
    yi, yw = _area_tab(sh, h, scale_y)
    dev = xf.device
    buf = None                          # (sh, w, c): each source row's sums
    for j in range(xi.shape[1]):
        term = (xf[:, torch.as_tensor(xi[:, j], device=dev)]
                * torch.as_tensor(xw[:, j], device=dev)[None, :, None])
        buf = term if buf is None else buf + term
    out = None
    for j in range(yi.shape[1]):
        term = (torch.as_tensor(yw[:, j], device=dev)[:, None, None]
                * buf[torch.as_tensor(yi[:, j], device=dev)])
        out = term if out is None else out + term
    return out


def resize_linear_f32(img: torch.Tensor, dsize: Tuple[int, int],
                      fx=None, fy=None) -> torch.Tensor:
    """cv2.resize(img, dsize, fx, fy) (INTER_LINEAR) of a float32 (H, W[,
    C]) tensor: half-pixel source coordinates, float weights, the horizontal
    fraction clamped to 0 past either edge, edge rows replicated; rows,
    then columns, in float32. Given fx and fy (and dsize (0, 0)) the size
    is (round(w fx), round(h fy)), rounded half to even, and coordinates
    map by 1 / fx and 1 / fy, as OpenCV maps them."""
    if img.dtype != torch.float32:
        raise ValueError(f"resize_linear_f32 takes float32, got {img.dtype}")
    squeeze = img.dim() == 2
    x = _as_hwc(img)
    sh, sw, _ = x.shape
    if fx or fy:
        if tuple(dsize) != (0, 0) or not (fx and fy):
            raise ValueError("give dsize (0, 0) with both fx and fy")
        dsize = (round(sw * fx), round(sh * fy))
    w, h = int(dsize[0]), int(dsize[1])
    if (h, w) == (sh, sw) and not (fx or fy):
        return img.clone()
    dev = x.device

    def taps(dst_n, src_n, clamp_fraction, inv_scale):
        scale = 1.0 / (inv_scale if inv_scale else dst_n / src_n)
        f = ((np.arange(dst_n, dtype=np.float64) + 0.5) * scale
             - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = f - s.astype(np.float32)
        if clamp_fraction:
            f = np.where((s < 0) | (s >= src_n - 1), np.float32(0), f)
            s = np.clip(s, 0, src_n - 1)
        i0 = np.clip(s, 0, src_n - 1)
        i1 = np.clip(s + 1, 0, src_n - 1)
        return (torch.as_tensor(i0, device=dev),
                torch.as_tensor(i1, device=dev),
                torch.as_tensor(np.float32(1) - f, device=dev),
                torch.as_tensor(f, device=dev))

    x0, x1, ax0, ax1 = taps(w, sw, True, fx)
    y0, y1, by0, by1 = taps(h, sh, False, fy)
    rows = x[:, x0] * ax0[None, :, None] + x[:, x1] * ax1[None, :, None]
    out = rows[y0] * by0[:, None, None] + rows[y1] * by1[:, None, None]
    return out[..., 0] if squeeze else out


def resize_area_f32(img: torch.Tensor, dsize: Tuple[int, int]
                    ) -> torch.Tensor:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_AREA) of a float32
    (H, W[, C]) tensor, shrinking (or keeping) both sides. An integer factor
    sums each block row by row in float32, four taps at a time ((a + b) + c)
    + d as OpenCV's resizeAreaFast does, then multiplies by float32(1 /
    area); other factors take _area_weighted's sums, unrounded."""
    if img.dtype != torch.float32:
        raise ValueError(f"resize_area_f32 takes float32, got {img.dtype}")
    squeeze = img.dim() == 2
    x = _as_hwc(img)
    sh, sw, c = x.shape
    w, h = int(dsize[0]), int(dsize[1])
    if (h, w) == (sh, sw):
        return img.clone()
    scale_x, scale_y = 1.0 / (w / sw), 1.0 / (h / sh)
    if scale_x < 1 or scale_y < 1:
        raise ValueError("resize_area_f32 shrinks only")
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        blocks = x[:h * iy, :w * ix].reshape(h, iy, w, ix, c)
        taps = [blocks[:, a, :, b] for a in range(iy) for b in range(ix)]
        total = None
        for k in range(0, len(taps), 4):
            group = taps[k]
            for t in taps[k + 1:k + 4]:
                group = group + t
            total = group if total is None else total + group
        out = total * np.float32(1.0 / (ix * iy))
        return out[..., 0] if squeeze else out
    out = _area_weighted(x, w, h, scale_x, scale_y)
    return out[..., 0] if squeeze else out


def _cubic_coeffs(f: np.ndarray) -> np.ndarray:
    """OpenCV's interpolateCubic (A = -0.75) in float32: (n,) fractions ->
    (n, 4) tap weights for the pixels at -1, 0, +1, +2."""
    f = f.astype(np.float32)
    a = np.float32(-0.75)
    one = np.float32(1)
    x1 = f + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    g = one - f
    c2 = ((a + np.float32(2)) * g - (a + np.float32(3))) * g * g + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


def resize_cubic_f32(img: torch.Tensor, dsize: Tuple[int, int]
                     ) -> torch.Tensor:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC) of a float32
    (H, W[, C]) tensor: half-pixel source coordinates, OpenCV's cubic
    weights (A = -0.75) in float32, the four taps' indices clamped to the
    image (edge pixels replicated); rows, then columns, in float32."""
    if img.dtype != torch.float32:
        raise ValueError(f"resize_cubic_f32 takes float32, got {img.dtype}")
    squeeze = img.dim() == 2
    x = _as_hwc(img)
    sh, sw, _ = x.shape
    w, h = int(dsize[0]), int(dsize[1])
    if (h, w) == (sh, sw):
        return img.clone()
    dev = x.device

    def taps(dst_n, src_n):
        scale = 1.0 / (dst_n / src_n)
        f = ((np.arange(dst_n, dtype=np.float64) + 0.5) * scale
             - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        coef = _cubic_coeffs(f - s.astype(np.float32))
        idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, src_n - 1)
        return (torch.as_tensor(idx, device=dev),
                torch.as_tensor(coef, device=dev))

    xi, xc = taps(w, sw)
    yi, yc = taps(h, sh)
    rows = None
    for k in range(4):
        term = x[:, xi[:, k]] * xc[None, :, k, None]
        rows = term if rows is None else rows + term
    out = None
    for k in range(4):
        term = rows[yi[:, k]] * yc[:, k, None, None]
        out = term if out is None else out + term
    return out[..., 0] if squeeze else out


def filter2d_f32(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.filter2D(img, -1, kernel) of a float32 (H, W[, C]) tensor: the
    correlation with the kernel (cast to float32, as OpenCV casts it),
    anchored at its centre, over BORDER_REFLECT_101, summed in float32 by a
    convolution. OpenCV takes a DFT for large kernels (21 x 21), so the two
    differ by float32 rounding (2.4e-7 on [0, 1] frames), not bitwise."""
    if img.dtype != torch.float32:
        raise ValueError(f"filter2d_f32 takes float32, got {img.dtype}")
    squeeze = img.dim() == 2
    x = _as_hwc(img)
    c = x.shape[2]
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    kh, kw = k.shape
    top, left = kh // 2, kw // 2
    xp = F.pad(x.permute(2, 0, 1)[None],
               (left, kw - 1 - left, top, kh - 1 - top), mode="reflect")
    out = F.conv2d(xp, k.expand(c, 1, kh, kw), groups=c)[0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def rgb_to_hsv_full(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2HSV_FULL) of an (..., 3) uint8
    array, bit for bit: OpenCV's 8-bit integer form, with its division
    tables (255 << 12) / v and (256 << 12) / (6 diff) rounded once, the
    hue taken from the channel that holds the maximum (red, then green,
    then blue on ties) and rounded by a 12-bit shift."""
    x = np.asarray(img).astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    shift, i = 12, np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << shift) / i)
    hdiv[1:] = np.rint((256 << shift) / (6.0 * i))
    s = (diff * sdiv[v] + (1 << (shift - 1))) >> shift
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << (shift - 1))) >> shift
    h = np.where(h < 0, h + 256, h)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb_full(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB_FULL) of an (..., 3) uint8 array
    in OpenCV's float form (HSV2RGB_native: s and v scaled by 1 / 255, the
    tabs v (1 - s), v (1 - s h), v (1 - s (1 - h)), the result times 255
    rounded half to even). The hue scale is 6 * (1 / 255) in float32,
    0.023529414, one ulp above float32(6 / 255): with it the form agrees
    with OpenCV 5.0.0 on all but 14 of the 2^24 HSV triples, which differ
    by one level at near-ties (ROADMAP Queue 3)."""
    f32 = np.float32
    x = np.asarray(hsv)
    inv255 = f32(1 / 255.0)
    h = x[..., 0].astype(f32) * (f32(6) * inv255)
    s = x[..., 1].astype(f32) * inv255
    v = x[..., 2].astype(f32) * inv255
    h = np.fmod(h, f32(6))
    sector = np.floor(h)
    h = h - sector
    one = f32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], -1)
    idx = _HSV_SECTORS[sector.astype(np.int64) % 6]
    bgr = np.take_along_axis(tab, idx, -1)
    rgb = np.where((s == 0)[..., None], v[..., None], bgr[..., ::-1])
    return np.clip(np.rint(rgb * f32(255)), 0, 255).astype(np.uint8)


def gray_to_bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_GRAY2BGR) of an (H, W) image."""
    return np.repeat(np.asarray(img)[:, :, None], 3, axis=2)


GRAY_COEFS = (3735, 19235, 9798)   # B, G, R of OpenCV 5's RGB2Gray, 15 bits
GRAY_SHIFT = 15


def bgr_to_gray(img):
    """cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) of a uint8 or uint16 (H, W, 3)
    image (numpy, or an integer tensor on any device): OpenCV's fixed-point
    luma, (B 3735 + G 19235 + R 9798 + 2^14) >> 15, for both depths; of a
    float32 numpy image, OpenCV 5's fused form fma(R, 0.299f, fma(B,
    0.114f, G * 0.587f)) in float32 (each fma emulated in float64: the
    products are exact there). The result is (H, W), of the input's kind
    and dtype."""
    if isinstance(img, np.ndarray) and img.dtype == np.float32:
        x = img.astype(np.float64)
        cb, cg, cr = (np.float64(np.float32(c)) for c in (0.114, 0.587,
                                                          0.299))
        t = (x[..., 0] * cb + (x[..., 1] * cg).astype(np.float32)).astype(
            np.float32)
        return (x[..., 2] * cr + t).astype(np.float32)
    is_tensor = torch.is_tensor(img)
    x = (img if is_tensor else torch.from_numpy(
        np.ascontiguousarray(img).astype(np.int64))).to(torch.int64)
    b, g, r = GRAY_COEFS
    y = (x[..., 0] * b + x[..., 1] * g + x[..., 2] * r
         + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    return y.to(img.dtype) if is_tensor else y.numpy().astype(img.dtype)


def copy_make_border(img: torch.Tensor, top: int, bottom: int, left: int,
                     right: int, value=0) -> torch.Tensor:
    """cv2.copyMakeBorder(img, top, bottom, left, right,
    cv2.BORDER_CONSTANT, value=value) of an (H, W[, C]) tensor: the image
    inside a frame of the constant, on the image's device, in its dtype.
    `value` is OpenCV's Scalar: one value per channel, the missing ones 0
    (a single number fills the first channel only)."""
    squeeze = img.dim() == 2
    x = _as_hwc(img)
    h, w, c = x.shape
    out = torch.empty((h + top + bottom, w + left + right, c),
                      dtype=x.dtype, device=x.device)
    out[:] = _cval(value, c, x.dtype, x.device).to(x.dtype)
    out[top:top + h, left:left + w] = x
    return out[..., 0] if squeeze else out


# -- estimateAffinePartial2D(method=LMEDS) ------------------------------------

_RNG_COEF = 4164903690
_U32, _U64 = 0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF


class _CvRNG:
    """cv::RNG: multiply-with-carry, uniform(a, b) = a + next() % (b - a)."""

    def __init__(self, state: int = _U64):
        self.state = state

    def next(self) -> int:
        s = self.state
        self.state = ((s & _U32) * _RNG_COEF + (s >> 32)) & _U64
        return self.state & _U32

    def uniform(self, a: int, b: int) -> int:
        return a if a == b else a + self.next() % (b - a)


def _ransac_iters(p: float, ep: float, model_points: int, max_iters: int):
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(round(num / denom))


def _two_point_model(f: np.ndarray, t: np.ndarray) -> np.ndarray:
    """AffinePartial2DEstimatorCallback::runKernel on two float32 points."""
    x1, y1, x2, y2 = (float(f[0, 0]), float(f[0, 1]), float(f[1, 0]),
                      float(f[1, 1]))
    X1, Y1, X2, Y2 = (float(t[0, 0]), float(t[0, 1]), float(t[1, 0]),
                      float(t[1, 1]))
    d = 1.0 / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2))
    s0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
    s1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
    s2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2)
              - (X1 * x2 - X2 * x1) * (x1 - x2))
    s3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1)
              - (Y1 * x2 - Y2 * x1) * (x1 - x2)
              - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.array([[s0, -s1, s2], [s1, s0, s3]], np.float64)


def _errors(model: np.ndarray, f: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Squared reprojection errors in float32 (Affine2DEstimatorCallback::
    computeError)."""
    m = model.astype(np.float32)
    a = m[0, 0] * f[:, 0] + m[0, 1] * f[:, 1] + m[0, 2] - t[:, 0]
    b = m[1, 0] * f[:, 0] + m[1, 1] * f[:, 1] + m[1, 2] - t[:, 1]
    return a * a + b * b


def _residuals(h, f, t):
    mx, my = f[:, 0].astype(np.float64), f[:, 1].astype(np.float64)
    xi = h[0] * mx - h[1] * my + h[2]
    yi = h[1] * mx + h[0] * my + h[3]
    r = np.stack([xi - t[:, 0], yi - t[:, 1]], 1).reshape(-1)
    one, zero = np.ones_like(mx), np.zeros_like(mx)
    jac = np.empty((2 * len(f), 4))
    jac[0::2] = np.stack([mx, -my, one, zero], 1)
    jac[1::2] = np.stack([my, mx, zero, one], 1)
    return r, jac


def _refine(h: np.ndarray, f: np.ndarray, t: np.ndarray, max_iters: int = 10,
            tol: float = 1e-6) -> np.ndarray:
    """Damped least squares of (a, b, tx, ty) over the inliers as OpenCV's
    Levenberg-Marquardt takes it: the normal matrix's diagonal scaled by
    1 + lambda, lambda from 1e-4, divided by 3 after a step that lowers the
    energy and doubled after one that does not; stop when a step lowers the
    energy, or moves the parameters, by less than 1e-6 of itself."""
    lam = 1e-4
    r, jac = _residuals(h, f, t)
    energy = r @ r
    for _ in range(max_iters):
        a = jac.T @ jac
        a[np.diag_indices(4)] *= 1 + lam
        step = np.linalg.solve(a, jac.T @ r)
        cand = h - step
        rc, jc = _residuals(cand, f, t)
        ec = rc @ rc
        if ec < energy:
            done = (energy - ec < tol * energy
                    or np.linalg.norm(step) < tol * np.linalg.norm(h))
            h, r, jac, energy = cand, rc, jc, ec
            lam /= 3
            if done:
                break
        else:
            lam *= 2
    return h


def estimate_affine_partial_lmeds(src: np.ndarray, dst: np.ndarray,
                                  confidence: float = 0.99,
                                  max_iters: int = 2000,
                                  refine_iters: int = 10):
    """cv2.estimateAffinePartial2D(src, dst, method=cv2.LMEDS): a 4-DOF
    similarity (2x3, float64) mapping src -> dst, and the (n, 1) uint8
    inlier mask; (None, zeros) when no model is found.

    As OpenCV: points in float32; a fresh cv::RNG (state 2^64 - 1) draws
    RANSACUpdateNumIters(confidence, 0.45, 2, max_iters) (at least 3)
    two-point subsets, redrawing duplicate indices; each subset's exact
    similarity is scored by the median (element n // 2) of the float32
    squared errors, the first least median kept; sigma = 2.5 * 1.4826 *
    (1 + 5 / (n - 2)) * sqrt(median), at least 0.001, gives the inliers
    (error <= sigma^2 in float32); the model is then refined over the
    inliers (`_refine`). The model and the inliers are OpenCV's exactly. The
    refined matrix is not quite: OpenCV's solver departs from a damped
    least-squares step by its own rounding, so over 600 seeded landmark
    sets the linear part agreed within 1e-6 in 96 % of them (1.8e-5 at
    most) and a 512^2 crop's corners within 9.8e-5 px
    (tests/test_torch_cvops.py)."""
    f = np.asarray(src, np.float64).reshape(-1, 2).astype(np.float32)
    t = np.asarray(dst, np.float64).reshape(-1, 2).astype(np.float32)
    n = len(f)
    mask = np.zeros((n, 1), np.uint8)
    if n < 2:
        return None, mask
    if n == 2:
        return _two_point_model(f, t), np.ones((n, 1), np.uint8)
    rng = _CvRNG()
    iters = max(_ransac_iters(confidence, 0.45, 2, max_iters), 3)
    best, min_median = None, math.inf
    for _ in range(iters):
        idx = []
        for _ in range(2):
            j = rng.uniform(0, n)
            while j in idx:
                j = rng.uniform(0, n)
            idx.append(j)
        model = _two_point_model(f[idx], t[idx])
        median = float(np.sort(_errors(model, f, t))[n // 2])
        if median < min_median:
            min_median, best = median, model
    if best is None or not math.isfinite(min_median):
        return None, mask
    sigma = max(2.5 * 1.4826 * (1 + 5.0 / (n - 2)) * math.sqrt(min_median),
                0.001)
    inl = _errors(best, f, t) <= np.float32(sigma * sigma)
    mask[:, 0] = inl
    if inl.sum() < 2:
        return None, np.zeros((n, 1), np.uint8)
    if refine_iters:
        h = np.array([best[0, 0], best[1, 0], best[0, 2], best[1, 2]])
        h = _refine(h, f[inl], t[inl], refine_iters)
        best = np.array([[h[0], -h[1], h[2]], [h[1], h[0], h[3]]])
    return best, mask


def similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Closed-form least-squares 4-DOF similarity src -> dst (2x3): the JAX
    helper's fallback when no LMedS model exists."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mean_s, mean_d = src.mean(0), dst.mean(0)
    src_c, dst_c = src - mean_s, dst - mean_d
    denom = (src_c ** 2).sum()
    a = (src_c * dst_c).sum() / denom
    b = (src_c[:, 0] * dst_c[:, 1] - src_c[:, 1] * dst_c[:, 0]).sum() / denom
    rot = np.array([[a, -b], [b, a]])
    t = mean_d - rot @ mean_s
    return np.concatenate([rot, t[:, None]], axis=1)
