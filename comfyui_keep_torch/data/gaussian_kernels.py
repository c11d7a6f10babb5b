"""The extended blur-kernel zoo (reference wm_basicsr/data/
gaussian_kernels.py), ported from comfyui_keep_tpu/data/gaussian_kernels.py:
skewed bivariate Gaussians (Shi et al. 2004), anisotropic / isotropic
Gaussians, generalized Gaussians and plateau-type-1 kernels, the strict-mode
random samplers and this module's own random_mixed_kernels (type names
'iso' / 'aniso' / 'skew' / 'generalized' / 'plateau_iso' / 'plateau_aniso',
another name set than degradations.random_mixed_kernels).

Host-side numpy and scipy, as in the JAX package. Every sampler takes `rng`,
a np.random.RandomState (numpy's global stream without one), and
random_mixed_kernels also `py_rng`, a random.Random for the type pick
(Python's global stream without one): they draw in the JAX package's
order, so streams seeded alike give its kernels.
"""
import math
import random

import numpy as np
from scipy.ndimage import shift as _ndimage_shift
from scipy.stats import multivariate_normal

from comfyui_keep_torch.data.degradations import mesh_grid, pdf2, sigma_matrix2

__all__ = [
    "cdf2", "mass_center_shift",
    "bivariate_skew_Gaussian", "bivariate_skew_Gaussian_center",
    "bivariate_anisotropic_Gaussian", "bivariate_isotropic_Gaussian",
    "bivariate_generalized_Gaussian",
    "bivariate_plateau_type1", "bivariate_plateau_type1_iso",
    "random_bivariate_skew_Gaussian_center",
    "random_bivariate_anisotropic_Gaussian",
    "random_bivariate_isotropic_Gaussian",
    "random_bivariate_generalized_Gaussian",
    "random_bivariate_plateau_type1",
    "random_bivariate_plateau_type1_iso",
    "random_mixed_kernels",
]

_STD_BIVARIATE_NORMAL = multivariate_normal([0.0, 0.0], [[1.0, 0.0],
                                                          [0.0, 1.0]])


def cdf2(skew_matrix, grid):
    """The standard bivariate normal CDF on the skewed grid (grid @ D),
    the skew factor of Shi et al.'s skew-normal density."""
    return _STD_BIVARIATE_NORMAL.cdf(np.dot(grid, skew_matrix))


def bivariate_skew_Gaussian(kernel_size, sig_x, sig_y, theta, skew_matrix,
                            grid=None):
    """The normalised skew-normal kernel pdf(Sigma) * cdf(grid @ D)."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    kernel = pdf2(sigma_matrix2(sig_x, sig_y, theta), grid) \
        * cdf2(skew_matrix, grid)
    return kernel / np.sum(kernel)


def mass_center_shift(kernel_size, kernel):
    """(delta_h, delta_w) of the kernel's centre of mass from the grid's
    centre."""
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    return np.sum(kernel, axis=1) @ ax, np.sum(kernel, axis=0) @ ax


def bivariate_skew_Gaussian_center(kernel_size, sig_x, sig_y, theta,
                                   skew_matrix, grid=None):
    """The skew kernel moved onto its centre of mass (scipy's cubic-spline
    shift, nearest padding) and normalised."""
    kernel = bivariate_skew_Gaussian(kernel_size, sig_x, sig_y, theta,
                                     skew_matrix, grid)
    delta_h, delta_w = mass_center_shift(kernel_size, kernel)
    kernel = _ndimage_shift(kernel, [-delta_h, -delta_w], mode="nearest")
    return kernel / np.sum(kernel)


def bivariate_anisotropic_Gaussian(kernel_size, sig_x, sig_y, theta,
                                   grid=None):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    kernel = pdf2(sigma_matrix2(sig_x, sig_y, theta), grid)
    return kernel / np.sum(kernel)


def bivariate_isotropic_Gaussian(kernel_size, sig, grid=None):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    kernel = pdf2(np.array([[sig ** 2, 0.0], [0.0, sig ** 2]]), grid)
    return kernel / np.sum(kernel)


def _quadratic_form(inverse_sigma, grid):
    return np.sum(np.dot(grid, inverse_sigma) * grid, 2)


def bivariate_generalized_Gaussian(kernel_size, sig_x, sig_y, theta, beta,
                                   grid=None):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = np.linalg.inv(sigma_matrix2(sig_x, sig_y, theta))
    kernel = np.exp(-0.5 * np.power(_quadratic_form(inverse_sigma, grid),
                                    beta))
    return kernel / np.sum(kernel)


def bivariate_plateau_type1(kernel_size, sig_x, sig_y, theta, beta,
                            grid=None):
    """The plateau kernel 1 / (1 + (x^T Sigma^-1 x)^beta)."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = np.linalg.inv(sigma_matrix2(sig_x, sig_y, theta))
    kernel = np.reciprocal(np.power(_quadratic_form(inverse_sigma, grid),
                                    beta) + 1)
    return kernel / np.sum(kernel)


def bivariate_plateau_type1_iso(kernel_size, sig, beta, grid=None):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = np.linalg.inv(np.array([[sig ** 2, 0.0],
                                            [0.0, sig ** 2]]))
    kernel = np.reciprocal(np.power(_quadratic_form(inverse_sigma, grid),
                                    beta) + 1)
    return kernel / np.sum(kernel)


def _check_ranges(kernel_size, *ranges):
    if kernel_size % 2 != 1:
        raise ValueError("Kernel size must be an odd number.")
    for r in ranges:
        if not r[0] < r[1]:
            raise ValueError(f"invalid range {r}")


def _sample_sigmas(rng, sigma_x_range, sigma_y_range, strict):
    sigma_x = rng.uniform(*sigma_x_range)
    sigma_y = rng.uniform(*sigma_y_range)
    if strict:
        # strict mode makes sigma_x the major axis
        sigma_x, sigma_y = max(sigma_x, sigma_y), min(sigma_x, sigma_y)
    return sigma_x, sigma_y


def _apply_kernel_noise(rng, kernel, noise_range):
    if noise_range is not None:
        if not noise_range[0] < noise_range[1]:
            raise ValueError("Wrong noise range.")
        kernel = kernel * rng.uniform(*noise_range, size=kernel.shape)
    return kernel / np.sum(kernel)


def _sample_beta_bimodal(rng, beta_range):
    # below and above 1 with equal probability: beta = 1, the Gaussian,
    # sits between the modes
    if rng.uniform() < 0.5:
        return rng.uniform(beta_range[0], 1)
    return rng.uniform(1, beta_range[1])


def random_bivariate_skew_Gaussian_center(kernel_size, sigma_x_range,
                                          sigma_y_range, rotation_range,
                                          noise_range=None, strict=False,
                                          rng=None):
    rng = np.random if rng is None else rng
    _check_ranges(kernel_size, sigma_x_range, sigma_y_range, rotation_range)
    sigma_x, sigma_y = _sample_sigmas(rng, sigma_x_range, sigma_y_range,
                                      strict)
    rotation = rng.uniform(*rotation_range)
    # the skew is bounded by 3 / sigma_max, so that the re-centring shift
    # stays inside the kernel
    thres = 3 / max(sigma_x, sigma_y)
    skew = [[rng.uniform(-thres, thres), rng.uniform(-thres, thres)],
            [rng.uniform(-thres, thres), rng.uniform(-thres, thres)]]
    kernel = bivariate_skew_Gaussian_center(kernel_size, sigma_x, sigma_y,
                                            rotation, skew)
    kernel = _apply_kernel_noise(rng, kernel, noise_range)
    if strict:
        return kernel, sigma_x, sigma_y, rotation, skew
    return kernel


def random_bivariate_anisotropic_Gaussian(kernel_size, sigma_x_range,
                                          sigma_y_range, rotation_range,
                                          noise_range=None, strict=False,
                                          rng=None):
    rng = np.random if rng is None else rng
    _check_ranges(kernel_size, sigma_x_range, sigma_y_range, rotation_range)
    sigma_x, sigma_y = _sample_sigmas(rng, sigma_x_range, sigma_y_range,
                                      strict)
    rotation = rng.uniform(*rotation_range)
    kernel = bivariate_anisotropic_Gaussian(kernel_size, sigma_x, sigma_y,
                                            rotation)
    kernel = _apply_kernel_noise(rng, kernel, noise_range)
    if strict:
        return kernel, sigma_x, sigma_y, rotation
    return kernel


def random_bivariate_isotropic_Gaussian(kernel_size, sigma_range,
                                        noise_range=None, strict=False,
                                        rng=None):
    rng = np.random if rng is None else rng
    _check_ranges(kernel_size, sigma_range)
    sigma = rng.uniform(*sigma_range)
    kernel = bivariate_isotropic_Gaussian(kernel_size, sigma)
    kernel = _apply_kernel_noise(rng, kernel, noise_range)
    if strict:
        return kernel, sigma
    return kernel


def random_bivariate_generalized_Gaussian(kernel_size, sigma_x_range,
                                          sigma_y_range, rotation_range,
                                          beta_range, noise_range=None,
                                          strict=False, rng=None):
    rng = np.random if rng is None else rng
    _check_ranges(kernel_size, sigma_x_range, sigma_y_range, rotation_range)
    sigma_x, sigma_y = _sample_sigmas(rng, sigma_x_range, sigma_y_range,
                                      strict)
    rotation = rng.uniform(*rotation_range)
    beta = _sample_beta_bimodal(rng, beta_range)
    kernel = bivariate_generalized_Gaussian(kernel_size, sigma_x, sigma_y,
                                            rotation, beta)
    kernel = _apply_kernel_noise(rng, kernel, noise_range)
    if strict:
        return kernel, sigma_x, sigma_y, rotation, beta
    return kernel


def random_bivariate_plateau_type1(kernel_size, sigma_x_range, sigma_y_range,
                                   rotation_range, beta_range,
                                   noise_range=None, strict=False, rng=None):
    rng = np.random if rng is None else rng
    _check_ranges(kernel_size, sigma_x_range, sigma_y_range, rotation_range)
    sigma_x, sigma_y = _sample_sigmas(rng, sigma_x_range, sigma_y_range,
                                      strict)
    rotation = rng.uniform(*rotation_range)
    beta = _sample_beta_bimodal(rng, beta_range)
    kernel = bivariate_plateau_type1(kernel_size, sigma_x, sigma_y, rotation,
                                     beta)
    kernel = _apply_kernel_noise(rng, kernel, noise_range)
    if strict:
        return kernel, sigma_x, sigma_y, rotation, beta
    return kernel


def random_bivariate_plateau_type1_iso(kernel_size, sigma_range, beta_range,
                                       noise_range=None, strict=False,
                                       rng=None):
    rng = np.random if rng is None else rng
    _check_ranges(kernel_size, sigma_range)
    sigma = rng.uniform(*sigma_range)
    beta = rng.uniform(*beta_range)
    kernel = bivariate_plateau_type1_iso(kernel_size, sigma, beta)
    kernel = _apply_kernel_noise(rng, kernel, noise_range)
    if strict:
        return kernel, sigma, beta
    return kernel


def random_mixed_kernels(kernel_list, kernel_prob, kernel_size=21,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi),
                         beta_range=(0.5, 8), noise_range=None, rng=None,
                         py_rng=None):
    """One kernel of a type drawn from kernel_list with kernel_prob weights
    (py_rng.choices), then that type's sampler (rng). With noise_range the
    multiplicative noise is applied twice, in the sampler and here, as the
    reference does; kept for its draw order. An unknown type raises
    ValueError."""
    rng = np.random if rng is None else rng
    py_rng = random if py_rng is None else py_rng
    kernel_type = py_rng.choices(kernel_list, kernel_prob)[0]
    if kernel_type == "iso":
        kernel = random_bivariate_isotropic_Gaussian(
            kernel_size, sigma_x_range, noise_range=noise_range, rng=rng)
    elif kernel_type == "aniso":
        kernel = random_bivariate_anisotropic_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            noise_range=noise_range, rng=rng)
    elif kernel_type == "skew":
        kernel = random_bivariate_skew_Gaussian_center(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            noise_range=noise_range, rng=rng)
    elif kernel_type == "generalized":
        kernel = random_bivariate_generalized_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            beta_range, noise_range=noise_range, rng=rng)
    elif kernel_type == "plateau_iso":
        kernel = random_bivariate_plateau_type1_iso(
            kernel_size, sigma_x_range, beta_range, noise_range=noise_range,
            rng=rng)
    elif kernel_type == "plateau_aniso":
        kernel = random_bivariate_plateau_type1(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            beta_range, noise_range=noise_range, rng=rng)
    else:
        raise ValueError(f"unknown kernel type {kernel_type!r}")
    return _apply_kernel_noise(rng, kernel, noise_range)
