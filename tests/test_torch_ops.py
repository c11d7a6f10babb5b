"""Primitives of the PyTorch port against the JAX package's, on the CPU in
f32 (bf16 only where the dtype is the point). The port is NCHW with torch
weight layouts; inputs are transposed at the boundary. Tolerance 1e-5
absolute unless stated: the two frameworks differ only in summation order.

Also: no module of the port, nor chip_smoke.py, imports JAX, the JAX
package or OpenCV.
"""
import ast
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu import ops as J
from comfyui_keep_tpu.ops import attention as jattn
from comfyui_keep_torch import ops as T

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(a):
    return torch.as_tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("stride,padding", [
    (1, 1), (2, 0), (2, [(0, 1), (0, 1)]), (1, [(2, 1), (0, 3)])])
def test_conv2d(rng, stride, padding):
    x = rng.standard_normal((2, 11, 12, 5), dtype=np.float32)
    w = rng.standard_normal((3, 3, 5, 7), dtype=np.float32)   # HWIO
    b = rng.standard_normal(7, dtype=np.float32)
    ref = J.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                   stride=stride, padding=padding)
    ours = T.conv2d(_nchw(x), torch.as_tensor(w.transpose(3, 2, 0, 1).copy()),
                    torch.as_tensor(b), stride=stride, padding=padding)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)


def test_linear(rng):
    x = rng.standard_normal((3, 4, 6), dtype=np.float32)
    w = rng.standard_normal((6, 5), dtype=np.float32)          # (in, out)
    b = rng.standard_normal(5, dtype=np.float32)
    np.testing.assert_allclose(
        T.linear(torch.as_tensor(x), torch.as_tensor(w.T.copy()),
                 torch.as_tensor(b)).numpy(),
        np.asarray(J.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))),
        **TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_group_norm(rng, dtype):
    x = rng.standard_normal((2, 6, 5, 64), dtype=np.float32) * 3 + 1
    g = rng.standard_normal(64, dtype=np.float32)
    b = rng.standard_normal(64, dtype=np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ref = J.group_norm(jnp.asarray(x, jdt), {"scale": jnp.asarray(g, jdt),
                                             "bias": jnp.asarray(b, jdt)})
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ours = T.group_norm(_nchw(x).to(tdt), torch.as_tensor(g).to(tdt),
                        torch.as_tensor(b).to(tdt))
    assert ours.dtype == tdt
    tol = dict(atol=5e-2, rtol=1.6e-2) if dtype == "bf16" else \
        dict(atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(_nhwc(ours.float()),
                               np.asarray(ref, np.float32), **tol)


def test_group_norm_backward_channels_last_affine_only(rng):
    """A channels-last input that needs no gradient, with affine parameters
    that do (a CFT block's first GroupNorm over a frozen generator's
    features in training): torch's CPU kernel faulted here; the port's
    group_norm gives the affine gradients of a contiguous input."""
    x = torch.as_tensor(rng.standard_normal((1, 64, 8, 8), dtype=np.float32))
    grads = []
    for t in (x, x.contiguous(memory_format=torch.channels_last)):
        w = torch.ones(64, requires_grad=True)
        b = torch.zeros(64, requires_grad=True)
        (T.group_norm(t, w, b) * torch.arange(64.0)[:, None, None]).sum(
            ).backward()
        grads.append((w.grad, b.grad))
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)


def test_layer_and_instance_norm(rng):
    x = rng.standard_normal((2, 7, 9, 32), dtype=np.float32) * 2 - 1
    g = rng.standard_normal(32, dtype=np.float32)
    b = rng.standard_normal(32, dtype=np.float32)
    np.testing.assert_allclose(
        T.layer_norm(torch.as_tensor(x), torch.as_tensor(g),
                     torch.as_tensor(b)).numpy(),
        np.asarray(J.layer_norm(jnp.asarray(x), {"scale": jnp.asarray(g),
                                                 "bias": jnp.asarray(b)})),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_nhwc(T.instance_norm(_nchw(x))),
                               np.asarray(J.instance_norm(jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_activations(rng, dtype):
    """gelu takes the tanh form for bf16 and erf for f32 (act.py rule)."""
    x = rng.standard_normal(1000).astype(np.float32) * 3
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xt, xj = torch.as_tensor(x).to(tdt), jnp.asarray(x, jdt)
    tol = dict(atol=2e-2, rtol=1.6e-2) if dtype == "bf16" else TOL
    for ours, ref in ((T.gelu(xt), J.gelu(xj)), (T.swish(xt), J.swish(xj)),
                      (T.relu(xt), J.relu(xj)),
                      (T.leaky_relu(xt, 0.2), J.leaky_relu(xj, 0.2))):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(ref, np.float32), **tol)


def test_gelu_form_follows_dtype():
    x = torch.linspace(-4, 4, 101)
    xb = x.bfloat16()
    gelu = torch.nn.functional.gelu
    assert torch.equal(T.gelu(x), gelu(x))
    assert torch.equal(T.gelu(xb), gelu(xb, approximate="tanh"))
    assert torch.equal(T.gelu(xb, approximate=False), gelu(xb))


@pytest.mark.parametrize("out_hw,align", [((16, 12), False), ((16, 12), True),
                                          ((5, 7), False), ((5, 7), True)])
def test_resize_bilinear(rng, out_hw, align):
    x = rng.standard_normal((2, 8, 6, 3), dtype=np.float32)
    ref = J.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align)
    ours = T.resize_bilinear(_nchw(x), out_hw, align_corners=align)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), **TOL)


def test_upsample_nearest(rng):
    x = rng.standard_normal((2, 4, 5, 3), dtype=np.float32)
    np.testing.assert_array_equal(
        _nhwc(T.upsample_nearest_2x(_nchw(x))),
        np.asarray(J.upsample_nearest_2x(jnp.asarray(x))))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample(rng, padding_mode):
    img = rng.standard_normal((2, 9, 11, 3), dtype=np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    ref = J.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                        padding_mode=padding_mode)
    ours = T.grid_sample(_nchw(img), torch.as_tensor(grid),
                         padding_mode=padding_mode)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), **TOL)


def test_flow_warp_xy(rng):
    """The KEEP recurrence warp (keep.py:335)."""
    x = rng.standard_normal((2, 16, 20, 3), dtype=np.float32)
    fx = rng.standard_normal((2, 16, 20), dtype=np.float32) * 3
    fy = rng.standard_normal((2, 16, 20), dtype=np.float32) * 3
    ref = J.flow_warp_xy(jnp.asarray(x), jnp.asarray(fx), jnp.asarray(fy))
    ours = T.flow_warp_xy(_nchw(x), torch.as_tensor(fx), torch.as_tensor(fy))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_softmax_attention(rng, with_bias):
    q = rng.standard_normal((2, 3, 10, 8), dtype=np.float32)
    k = rng.standard_normal((2, 3, 12, 8), dtype=np.float32)
    v = rng.standard_normal((2, 3, 12, 5), dtype=np.float32)
    bias = rng.standard_normal((10, 12), dtype=np.float32) if with_bias \
        else None
    ref = jattn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3,
        bias=None if bias is None else jnp.asarray(bias))
    ours = T.softmax_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), scale=0.3,
        bias=None if bias is None else torch.as_tensor(bias))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_multi_head_attention_packed_in_proj(rng):
    e, h = 16, 4
    p = {n: rng.standard_normal((e, e), dtype=np.float32) * 0.3
         for n in ("q_w", "k_w", "v_w", "out_w")}
    p.update({n: rng.standard_normal(e, dtype=np.float32)
              for n in ("q_b", "k_b", "v_b", "out_b")})
    qk = rng.standard_normal((2, 7, e), dtype=np.float32)
    val = rng.standard_normal((2, 7, e), dtype=np.float32)
    ref = jattn.multi_head_attention({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(qk), jnp.asarray(qk),
                                     jnp.asarray(val), num_heads=h)
    ipw = np.concatenate([p["q_w"].T, p["k_w"].T, p["v_w"].T])
    ipb = np.concatenate([p["q_b"], p["k_b"], p["v_b"]])
    ours = T.multi_head_attention(
        torch.as_tensor(qk), torch.as_tensor(qk), torch.as_tensor(val),
        torch.as_tensor(ipw), torch.as_tensor(ipb),
        torch.as_tensor(p["out_w"].T.copy()), torch.as_tensor(p["out_b"]), h)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_batch_norm_inference(rng):
    """Running statistics drawn at random (mean 0 / var 1 would hide a
    swapped pair), eps 1e-5."""
    x = rng.standard_normal((2, 5, 6, 7), dtype=np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32),
         "bias": rng.standard_normal(7).astype(np.float32),
         "mean": rng.standard_normal(7).astype(np.float32),
         "var": rng.uniform(0.2, 3.0, 7).astype(np.float32)}
    bn = torch.nn.BatchNorm2d(7).eval().requires_grad_(False)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(p["scale"]))
        bn.bias.copy_(torch.as_tensor(p["bias"]))
        bn.running_mean.copy_(torch.as_tensor(p["mean"]))
        bn.running_var.copy_(torch.as_tensor(p["var"]))
    ref = J.batch_norm(jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in p.items()})
    np.testing.assert_allclose(_nhwc(T.batch_norm(_nchw(x), bn)),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0),
                                                    (3, 1, 1)])
def test_max_pool(rng, window, stride, padding):
    x = rng.standard_normal((2, 9, 11, 3), dtype=np.float32) - 5.0
    ref = J.max_pool(jnp.asarray(x), window, stride, padding)
    np.testing.assert_array_equal(
        _nhwc(T.max_pool(_nchw(x), window, stride, padding)), np.asarray(ref))


@pytest.mark.parametrize("out_hw", [(10, 14), (5, 7), (9, 13), (4, 4)])
def test_resize_nearest(rng, out_hw):
    """floor(dst * in / out), as RetinaFace's FPN upsamples a coarser map to
    a finer one of any size (odd input sides give ratios near 2)."""
    x = rng.standard_normal((1, 5, 7, 3), dtype=np.float32)
    from comfyui_keep_tpu.ops.resample import resize_nearest
    np.testing.assert_array_equal(
        _nhwc(T.resize_nearest(_nchw(x), out_hw)),
        np.asarray(resize_nearest(jnp.asarray(x), out_hw)))


def test_reflect_pad(rng):
    x = rng.standard_normal((1, 4, 5, 2), dtype=np.float32)
    np.testing.assert_array_equal(
        _nhwc(T.reflect_pad(_nchw(x), 1)),
        np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect"))


def _port_files():
    root = os.path.join(REPO, "comfyui_keep_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _importers(banned):
    """Port files (and chip_smoke.py) that import `banned`, at any level of
    any function."""
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", None) == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            if any(n == banned or n.startswith(banned + ".") for n in names):
                offenders.append(os.path.relpath(path, REPO))
    return sorted(set(offenders))


@pytest.mark.parametrize("banned", ["jax", "comfyui_keep_tpu", "jaxlib"])
def test_port_imports_no_jax(banned):
    """No module of the port (nor chip_smoke.py) imports JAX or the JAX
    package, at any level of any function."""
    offenders = _importers(banned)
    assert not offenders, f"{banned} imported by {offenders}"


def test_port_imports_no_opencv():
    """The card machine has no OpenCV: no module of the port (nor
    chip_smoke.py) imports cv2, at any level of any function; the resizes
    are utils/resize.py's, the face toolkit's pixel operations
    utils/cvops.py's."""
    offenders = _importers("cv2")
    assert not offenders, f"cv2 imported by {offenders}"


def test_port_package_imports_without_jax_in_a_fresh_process():
    import subprocess
    import sys
    code = ("import sys\n"
            "import comfyui_keep_torch.api, comfyui_keep_torch.ops.kernels\n"
            "import comfyui_keep_torch.nodes\n"
            "import comfyui_keep_torch.facelib.factory\n"
            "import comfyui_keep_torch.utils.cvops\n"
            "import comfyui_keep_torch.models.retinaface, "
            "comfyui_keep_torch.models.parsenet\n"
            "import comfyui_keep_torch.facelib.yolov5face, "
            "comfyui_keep_torch.facelib.align_trans, "
            "comfyui_keep_torch.facelib.face_utils\n"
            "import comfyui_keep_torch.models.bisenet, "
            "comfyui_keep_torch.models.sr_basic, "
            "comfyui_keep_torch.models.swinir\n"
            "import comfyui_keep_torch.pipeline.tiled, "
            "comfyui_keep_torch.pipeline.realesrganer\n"
            "import comfyui_keep_torch.models.keep, "
            "comfyui_keep_torch.models.gmflow, "
            "comfyui_keep_torch.models.vqgan, "
            "comfyui_keep_torch.pipeline.processor\n"
            "import comfyui_keep_torch.ops.spectral, "
            "comfyui_keep_torch.ops.native, comfyui_keep_torch.ops.conv, "
            "comfyui_keep_torch.ops.resample, "
            "comfyui_keep_torch.utils.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'comfyui_keep_tpu', 'cv2')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_launch_counts_by_shape_count_kernel_launches_only():
    """A launch counts once by form and once by its shape; CPU tensors run
    the plain versions and count nothing; reset_launch_counts clears
    both."""
    from comfyui_keep_torch.ops import kernels as K
    K.reset_launch_counts()
    q = torch.zeros(2, 4, 128)
    K.attention(q, q, q, 1.0)
    K.mlp_fused(q, q, torch.zeros(64, 256), torch.zeros(128, 64),
                torch.ones(128), torch.zeros(128), True)
    assert K.LAUNCHES_BY_SHAPE == {} and set(K.LAUNCHES.values()) == {0}
    K._count("attention[dv128+bias]", "B256 L256")
    K._count("attention[dv128+bias]", "B256 L256")
    K._count("packed_conv2x2")
    assert K.LAUNCHES["attention[dv128+bias]"] == 2
    assert K.LAUNCHES["packed_conv2x2"] == 1
    assert K.LAUNCHES_BY_SHAPE == {"attention[dv128+bias] B256 L256": 2}
    K.reset_launch_counts()
    assert K.LAUNCHES_BY_SHAPE == {} and set(K.LAUNCHES.values()) == {0}
