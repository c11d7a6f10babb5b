"""Spectral normalisation as a function (reference spectral_norm_arch.py,
torch.nn.utils.spectral_norm), ported from comfyui_keep_tpu/ops/spectral.py.

Two forms. spectral_norm_weight is the JAX package's: the power iteration
from a u passed in, the updated u returned and v not kept (the port's eval
forward). spectral_norm_step is torch's hook in training: it advances the
stored u and v in place, as the reference's spectral_norm does on every
training forward. layer_weight picks one by the layer's mode. Weights are
in torch's layout, the output dimension first, which is the dimension
torch's spectral_norm keeps (dim 0 of a Conv2d/Conv3d/Linear weight).
"""
import torch
import torch.nn.functional as F


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


def spectral_norm_step(w, u, v, n_power_iterations: int = 1,
                       eps: float = 1e-12):
    """torch's spectral_norm in training: w (O, ...), the stored u (O,) and
    v, buffers written in place without gradients: v = normalize(W^T u),
    u = normalize(W v), F.normalize's max(|x|, eps) (n_power_iterations
    times); then w / sigma, sigma = u.(W v) on copies of the new u and v,
    which keeps W's gradient. The iteration runs in the buffers' dtype
    (f32 under mixed precision)."""
    wm = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        wd = wm.detach().to(u.dtype)
        for _ in range(n_power_iterations):
            v.copy_(F.normalize(torch.mv(wd.t(), u), dim=0, eps=eps))
            u.copy_(F.normalize(torch.mv(wd, v), dim=0, eps=eps))
    sigma = torch.dot(u.clone().to(w.dtype), torch.mv(wm, v.clone().to(
        w.dtype)))
    return w / sigma


def layer_weight(layer):
    """A spectral-norm layer's (weight_orig, weight_u, weight_v) weight
    over its norm: torch's training step in training mode (u and v
    advance), the JAX package's form in eval (u and v kept)."""
    if layer.training:
        return spectral_norm_step(layer.weight_orig, layer.weight_u,
                                  layer.weight_v)
    return spectral_norm_weight(layer.weight_orig, layer.weight_u)[0]
