"""Spectral normalisation as a function (reference spectral_norm_arch.py,
torch.nn.utils.spectral_norm), ported from comfyui_keep_tpu/ops/spectral.py.

The power-iteration vector u is passed in and the updated one returned, as
the JAX package threads it, instead of living in a hook. Weights are in
torch's layout, the output dimension first, which is the dimension torch's
spectral_norm keeps (dim 0 of a Conv2d/Conv3d/Linear weight).
"""
import torch


def _l2normalize(v, eps: float):
    return v / (v.norm() + eps)


def spectral_norm_weight(w, u, n_power_iterations: int = 1,
                         eps: float = 1e-12):
    """w: (O, ...) weight, u: (O,) -> (w / sigma, u'). The power iteration
    (v = W^T u normalised, u' = W v normalised) runs on the detached weight;
    sigma = u'.(W v) keeps W's gradient."""
    wm = w.reshape(w.shape[0], -1)
    wd = wm.detach()
    u = u.detach()
    v = None
    for _ in range(n_power_iterations):
        v = _l2normalize(wd.t() @ u, eps)
        u = _l2normalize(wd @ v, eps)
    sigma = u @ (wm @ v)
    return w / sigma, u


def power_iteration_v(w, u, eps: float = 1e-12):
    """v = W^T u normalised, the first step of the power iteration from u:
    what torch's spectral_norm keeps as weight_v (w: (O, ...), u: (O,))."""
    return _l2normalize(w.reshape(w.shape[0], -1).t() @ u, eps)
