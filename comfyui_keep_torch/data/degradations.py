"""Online degradations of the training data (reference wm_basicsr/data/
degradations.py), the port's copy of comfyui_keep_tpu/data/degradations.py:
bivariate (generalized) Gaussian and plateau blur kernels, the sinc kernel,
Gaussian and Poisson noise, JPEG and video compression. Host-side numpy, as
in the JAX package; the OpenCV calls are replaced by utils/cvops.py
(BGR2GRAY) and utils/diffjpeg.py (JPEG).

Every random draw takes `rng`: a numpy Generator or RandomState (the
datasets pass the RandomState they own); without one, a fresh
np.random.default_rng(), as the JAX package draws.
"""
import math
from typing import Sequence

import numpy as np
import torch

from comfyui_keep_torch.utils.cvops import bgr_to_gray
from comfyui_keep_torch.utils.diffjpeg import diff_jpeg


# ---------------------------------------------------------------------------
# blur kernels
# ---------------------------------------------------------------------------

def sigma_matrix2(sig_x, sig_y, theta):
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def mesh_grid(kernel_size):
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack((xx.reshape(kernel_size * kernel_size, 1),
                    yy.reshape(kernel_size * kernel_size, 1))).reshape(
        kernel_size, kernel_size, 2)
    return xy, xx, yy


def pdf2(sigma_matrix, grid):
    inverse_sigma = np.linalg.inv(sigma_matrix)
    return np.exp(-0.5 * np.sum(np.dot(grid, inverse_sigma) * grid, 2))


def bivariate_Gaussian(kernel_size, sig_x, sig_y, theta, grid=None,
                       isotropic=True):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma_matrix = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma_matrix = sigma_matrix2(sig_x, sig_y, theta)
    kernel = pdf2(sigma_matrix, grid)
    return kernel / np.sum(kernel)


def bivariate_generalized_Gaussian(kernel_size, sig_x, sig_y, theta, beta,
                                   grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma_matrix = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma_matrix = sigma_matrix2(sig_x, sig_y, theta)
    inverse_sigma = np.linalg.inv(sigma_matrix)
    kernel = np.exp(-0.5 * np.power(
        np.sum(np.dot(grid, inverse_sigma) * grid, 2), beta))
    return kernel / np.sum(kernel)


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, grid=None,
                      isotropic=True):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma_matrix = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma_matrix = sigma_matrix2(sig_x, sig_y, theta)
    inverse_sigma = np.linalg.inv(sigma_matrix)
    kernel = np.reciprocal(
        np.power(np.sum(np.dot(grid, inverse_sigma) * grid, 2), beta) + 1)
    return kernel / np.sum(kernel)


def _rand(rng, rang):
    return rng.uniform(rang[0], rang[1])


def random_bivariate_Gaussian(kernel_size, sigma_x_range, sigma_y_range,
                              rotation_range, noise_range=None,
                              isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sigma_x = _rand(rng, sigma_x_range)
    if isotropic:
        sigma_y, rotation = sigma_x, 0
    else:
        sigma_y = _rand(rng, sigma_y_range)
        rotation = _rand(rng, rotation_range)
    kernel = bivariate_Gaussian(kernel_size, sigma_x, sigma_y, rotation,
                                isotropic=isotropic)
    if noise_range is not None:
        kernel = kernel * rng.uniform(noise_range[0], noise_range[1],
                                      size=kernel.shape)
    return kernel / np.sum(kernel)


def random_bivariate_generalized_Gaussian(kernel_size, sigma_x_range,
                                          sigma_y_range, rotation_range,
                                          beta_range, noise_range=None,
                                          isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sigma_x = _rand(rng, sigma_x_range)
    if isotropic:
        sigma_y, rotation = sigma_x, 0
    else:
        sigma_y = _rand(rng, sigma_y_range)
        rotation = _rand(rng, rotation_range)
    # beta sampled either side of 1 (reference :252-257)
    if rng.uniform() < 0.5:
        beta = rng.uniform(beta_range[0], 1)
    else:
        beta = rng.uniform(1, beta_range[1])
    kernel = bivariate_generalized_Gaussian(kernel_size, sigma_x, sigma_y,
                                            rotation, beta, isotropic=isotropic)
    if noise_range is not None:
        kernel = kernel * rng.uniform(noise_range[0], noise_range[1],
                                      size=kernel.shape)
    return kernel / np.sum(kernel)


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range,
                             rotation_range, beta_range, noise_range=None,
                             isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sigma_x = _rand(rng, sigma_x_range)
    if isotropic:
        sigma_y, rotation = sigma_x, 0
    else:
        sigma_y = _rand(rng, sigma_y_range)
        rotation = _rand(rng, rotation_range)
    if rng.uniform() < 0.5:
        beta = rng.uniform(beta_range[0], 1)
    else:
        beta = rng.uniform(1, beta_range[1])
    kernel = bivariate_plateau(kernel_size, sigma_x, sigma_y, rotation, beta,
                               isotropic=isotropic)
    if noise_range is not None:
        kernel = kernel * rng.uniform(noise_range[0], noise_range[1],
                                      size=kernel.shape)
    return kernel / np.sum(kernel)


def random_mixed_kernels(kernel_list: Sequence[str],
                         kernel_prob: Sequence[float], kernel_size=21,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi),
                         betag_range=(0.5, 8), betap_range=(0.5, 8),
                         noise_range=None, rng=None):
    """kernel_list entries: iso/aniso/generalized_iso/generalized_aniso/
    plateau_iso/plateau_aniso (reference :324-388)."""
    rng = rng or np.random.default_rng()
    p = np.asarray(kernel_prob, np.float64)
    p = p / p.sum()  # reference uses random.choices (weights need not sum to 1)
    kind = rng.choice(list(kernel_list), p=p)
    if kind == "iso":
        return random_bivariate_Gaussian(kernel_size, sigma_x_range,
                                         sigma_y_range, rotation_range,
                                         noise_range, True, rng)
    if kind == "aniso":
        return random_bivariate_Gaussian(kernel_size, sigma_x_range,
                                         sigma_y_range, rotation_range,
                                         noise_range, False, rng)
    if kind == "generalized_iso":
        return random_bivariate_generalized_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, noise_range, True, rng)
    if kind == "generalized_aniso":
        return random_bivariate_generalized_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, noise_range, False, rng)
    if kind == "plateau_iso":
        return random_bivariate_plateau(kernel_size, sigma_x_range,
                                        sigma_y_range, rotation_range,
                                        betap_range, None, True, rng)
    if kind == "plateau_aniso":
        return random_bivariate_plateau(kernel_size, sigma_x_range,
                                        sigma_y_range, rotation_range,
                                        betap_range, None, False, rng)
    raise ValueError(kind)


def circular_lowpass_kernel(cutoff, kernel_size, pad_to=0):
    """2D sinc filter (reference :389-416; requires odd kernel size)."""
    assert kernel_size % 2 == 1
    from scipy import special
    kernel = np.fromfunction(
        lambda x, y: cutoff * special.j1(
            cutoff * np.sqrt((x - (kernel_size - 1) / 2) ** 2 +
                             (y - (kernel_size - 1) / 2) ** 2)) /
        (2 * np.pi * np.sqrt((x - (kernel_size - 1) / 2) ** 2 +
                             (y - (kernel_size - 1) / 2) ** 2)),
        [kernel_size, kernel_size])
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = cutoff ** 2 / (4 * np.pi)
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

def generate_gaussian_noise(img, sigma=10, gray_noise=False, rng=None):
    rng = rng or np.random.default_rng()
    if gray_noise:
        noise = rng.standard_normal(img.shape[:2]).astype(np.float32) * sigma / 255.0
        noise = noise[..., None].repeat(3, axis=2) if img.ndim == 3 else noise
    else:
        noise = rng.standard_normal(img.shape).astype(np.float32) * sigma / 255.0
    return noise


def add_gaussian_noise(img, sigma=10, clip=True, rounds=False,
                       gray_noise=False, rng=None):
    out = img + generate_gaussian_noise(img, sigma, gray_noise, rng)
    if clip and rounds:
        out = np.clip((out * 255.0).round(), 0, 255) / 255.0
    elif clip:
        out = np.clip(out, 0, 1)
    elif rounds:
        out = (out * 255.0).round() / 255.0
    return out


def random_add_gaussian_noise(img, sigma_range=(0, 1.0), gray_prob=0,
                              clip=True, rounds=False, rng=None):
    rng = rng or np.random.default_rng()
    sigma = rng.uniform(sigma_range[0], sigma_range[1])
    gray = rng.uniform() < gray_prob
    return add_gaussian_noise(img, sigma, clip, rounds, gray, rng)


def generate_poisson_noise(img, scale=1.0, gray_noise=False, rng=None):
    """Poisson noise sampled at the image's estimated bit depth (reference
    :559-585)."""
    rng = rng or np.random.default_rng()
    if gray_noise:
        base = bgr_to_gray((img * 255).astype(np.uint8)) / 255.0
    else:
        base = img
    vals = len(np.unique(base))
    vals = 2 ** np.ceil(np.log2(vals))
    out = rng.poisson(base * vals) / float(vals)
    noise = out - base
    if gray_noise:
        noise = noise[..., None].repeat(3, axis=2)
    return noise * scale


def add_poisson_noise(img, scale=1.0, clip=True, rounds=False,
                      gray_noise=False, rng=None):
    out = img + generate_poisson_noise(img, scale, gray_noise, rng)
    if clip and rounds:
        out = np.clip((out * 255.0).round(), 0, 255) / 255.0
    elif clip:
        out = np.clip(out, 0, 1)
    elif rounds:
        out = (out * 255.0).round() / 255.0
    return out


def random_add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0,
                             clip=True, rounds=False, rng=None):
    rng = rng or np.random.default_rng()
    scale = rng.uniform(scale_range[0], scale_range[1])
    gray = rng.uniform() < gray_prob
    return add_poisson_noise(img, scale, clip, rounds, gray, rng)


# ---------------------------------------------------------------------------
# JPEG / video compression
# ---------------------------------------------------------------------------

def add_jpg_compression(img, quality=90):
    """JPEG round trip of a float32 [0, 1] BGR image at `quality` (reference
    :731-749): the image cut to uint8 as cv2.imencode is given it, the
    standard-table JPEG of utils/diffjpeg.py (differentiable=False) on a
    CPU tensor, the result rounded to uint8 as a decoder returns it. Not
    libjpeg: its integer DCT and chroma upsampling differ from this float
    form (ROADMAP Queue 3)."""
    u8 = (np.clip(img, 0, 1) * 255.0).astype(np.uint8)
    rgb = torch.from_numpy(np.ascontiguousarray(u8[..., ::-1])).float()
    out = diff_jpeg(rgb[None] / 255.0, int(quality), differentiable=False)[0]
    out = torch.round(out * 255.0).to(torch.uint8).numpy()
    return np.float32(out[..., ::-1]) / 255.0


def random_add_jpg_compression(img, quality_range=(90, 100), rng=None):
    rng = rng or np.random.default_rng()
    quality = rng.uniform(quality_range[0], quality_range[1])
    return add_jpg_compression(img, int(quality))


def crf_to_jpeg_quality(crf) -> int:
    """The JAX package's last-resort mapping of a video CRF to a per-frame
    JPEG quality: 15 -> 95, 40 -> 30, linear between, clamped."""
    return int(np.interp(crf, [15, 40], [95, 30]))


def add_video_compression(frames, codec="libx264", crf=23, fps=25):
    """CRF video compression of a clip (reference vfhq_real_degradation2_
    dataset.py:325-376): a real codec through PyAV where it is installed,
    as in the JAX package; otherwise the JAX package's last resort,
    per-frame JPEG at crf_to_jpeg_quality(crf) (add_jpg_compression). The
    card machine has neither PyAV nor OpenCV, so there the JPEG form runs.

    frames: list of float32 [0, 1] BGR images -> the same, compressed."""
    try:
        import av
    except ImportError:
        av = None
    if av is not None:
        import io
        buf = io.BytesIO()
        container = av.open(buf, mode="w", format="mp4")
        stream = container.add_stream(codec.replace("lib", ""), rate=fps)
        h, w = frames[0].shape[:2]
        stream.width, stream.height = w, h
        stream.pix_fmt = "yuv420p"
        stream.options = {"crf": str(crf)}
        for f in frames:
            frame = av.VideoFrame.from_ndarray(
                (f[..., ::-1] * 255).astype(np.uint8), format="rgb24")
            container.mux(stream.encode(frame))
        container.mux(stream.encode())
        container.close()
        buf.seek(0)
        out = []
        with av.open(buf) as c:
            for frame in c.decode(video=0):
                out.append(frame.to_ndarray(format="rgb24")[..., ::-1]
                           / 255.0)
        return [o.astype(np.float32) for o in out]
    quality = crf_to_jpeg_quality(crf)
    return [add_jpg_compression(f, quality) for f in frames]
