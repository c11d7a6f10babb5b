"""The port's profiler, IO threads, plot and video helpers, the bf16
fidelity tool and the synthetic zoo, on the CPU at small sizes:
- utils/profiler.py: time_fn's median and samples, trace()'s Chrome trace;
- PrefetchReader / IOConsumer through utils/png.py, bit for bit, against
  cv2.imread(IMREAD_UNCHANGED) / cv2.imwrite (OpenCV as the oracle);
- utils/plot.py against the JAX package's copy on the same log;
- utils/video.py's pipe framing against stand-in `ffmpeg` / `ffprobe`
  scripts put on PATH, which pass raw frames through; the raise without
  them;
- tools/torch_bf16_fidelity.py: its report against the JAX tool's
  formulas on three runs that differ, its f32 run at a tiny config
  against the JAX tool's forward on the same weights, and f32 against
  itself;
- tools/torch_synth_zoo.py's files loaded by the port's loaders and by the
  JAX package's, which give the same weights and, on a small input, the
  same outputs within the golden tolerances (KEEP 5e-3 / 1e-2 with the
  JAX picks forced, tests/test_keep_golden.py:108; the face nets and
  RRDBNet within 1e-4 of their largest magnitude, as
  tests/test_torch_facelib.py and tests/test_torch_upscalers.py hold them).
"""
import importlib.util
import json
import math
import os
import queue
import stat
import sys
import textwrap

import cv2
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu import api as japi
from comfyui_keep_tpu.facelib import factory as jfactory
from comfyui_keep_tpu.models import keep as jkeep
from comfyui_keep_tpu.models import parsenet as jparse
from comfyui_keep_tpu.models import retinaface as jret
from comfyui_keep_tpu.models import sr_basic as jsr
from comfyui_keep_tpu.utils import plot as jplot
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict
from comfyui_keep_torch import api
from comfyui_keep_torch.facelib import factory
from comfyui_keep_torch.models.sr_basic import RRDBNet
from comfyui_keep_torch.pipeline.realesrganer import IOConsumer, PrefetchReader
from comfyui_keep_torch.utils import plot, png, profiler, video
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.torch_port_helpers import rel

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"io_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


zoo = load_tool("torch_synth_zoo")
fidelity = load_tool("torch_bf16_fidelity")

TINY = dict(img_size=64, nf=32, ch_mult=[1, 2, 2], res_blocks=2,
            attn_resolutions=[16], codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=["32", "64"],
            cfa_list=["16"], cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=["32"])


# -- the profiler ----------------------------------------------------------

def test_time_fn_and_trace_on_the_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": (x @ x).sum(), "n": 3}
    x = torch.randn(64, 64)
    med, times = profiler.time_fn(fn, x, iters=5, warmup=2)
    assert len(calls) == 7 and len(times) == 5
    assert med == float(np.median(times)) and med > 0
    with profiler.trace(None) as prof:
        assert prof is None
    assert not os.listdir(tmp_path)
    with profiler.trace(str(tmp_path / "tr")) as prof:
        assert prof is not None
        (x @ x).relu()
    path = tmp_path / "tr" / profiler.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# -- the IO threads ----------------------------------------------------------

IMAGES = {
    "bgr8": lambda rng: rng.integers(0, 256, (20, 24, 3), dtype=np.uint8),
    "gray8": lambda rng: rng.integers(0, 256, (17, 9), dtype=np.uint8),
    "bgra8": lambda rng: rng.integers(0, 256, (12, 16, 4), dtype=np.uint8),
    "bgr16": lambda rng: rng.integers(0, 65536, (8, 10, 3), dtype=np.uint16),
}


def test_prefetch_reader_and_io_consumer_round_trip_bit_for_bit(tmp_path):
    """IOConsumer writes each message's output; the files read back through
    cv2.imread(IMREAD_UNCHANGED) as written, and PrefetchReader hands them
    out in order, equal to OpenCV's reading; a file cv2.imwrite wrote reads
    back equal too; the queue ends at "quit"."""
    rng = np.random.default_rng(0)
    imgs = {k: make(rng) for k, make in IMAGES.items()}
    que = queue.Queue()
    writer = IOConsumer({}, que, 0)
    writer.start()
    paths = []
    for k, img in imgs.items():
        paths.append(str(tmp_path / f"{k}.png"))
        que.put({"output": img, "save_path": paths[-1]})
    que.put("quit")
    writer.join(30)
    assert not writer.is_alive()
    for path, img in zip(paths, imgs.values()):
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    ocv = str(tmp_path / "opencv.png")
    cv2.imwrite(ocv, imgs["bgra8"])
    reader = PrefetchReader(paths + [ocv], 2)
    reader.start()
    got = list(reader)
    reader.join(30)
    assert len(got) == len(paths) + 1
    for g, img in zip(got, list(imgs.values()) + [imgs["bgra8"]]):
        assert g.dtype == img.dtype
        np.testing.assert_array_equal(g, img)


def test_prefetch_reader_raises_a_read_error_where_it_occurs(tmp_path):
    good = str(tmp_path / "a.png")
    png.imwrite_bgr(good, np.zeros((4, 4, 3), np.uint8))
    reader = PrefetchReader([good, str(tmp_path / "missing.png")], 1)
    reader.start()
    assert next(reader).shape == (4, 4, 3)
    with pytest.raises(FileNotFoundError):
        next(reader)
    reader.join(30)


# -- plot ----------------------------------------------------------------

def test_plot_equals_jax(tmp_path):
    log = tmp_path / "train.log"
    rng = np.random.default_rng(1)
    lines = []
    for it in range(1, 40):
        lines.append(f"[iter:{it:6d}] l_pix: {rng.random():.6f} "
                     f"psnr: {20 + rng.random():.4f}")
        if it % 7 == 0:
            lines.append("# a line that matches nothing")
    log.write_text("\n".join(lines) + "\n")
    two = r"\[iter:\s*(\d+)\] l_pix: ([\d.]+)"
    one = r".*psnr: ([\d.]+)"
    for step_one in (False, True):
        assert plot.read_data_from_txt_2v(str(log), two, step_one) == \
            jplot.read_data_from_txt_2v(str(log), two, step_one)
    vals = plot.read_data_from_txt_1v(str(log), one)
    assert vals == jplot.read_data_from_txt_1v(str(log), one)
    assert len(vals) == 39
    for w in (0.0, 0.6, 0.99):
        assert plot.smooth_data(vals, w) == jplot.smooth_data(vals, w)


# -- video over pipes --------------------------------------------------------

FFPROBE = '''\
    #!{python}
    import json, sys
    with open(sys.argv[-1], "rb") as f:
        head = json.loads(f.readline())
    print(json.dumps({{"streams": [{{
        "width": head["w"], "height": head["h"],
        "r_frame_rate": head["rate"], "nb_frames": str(head["n"])}}]}}))
'''
# writer: -s WxH -r fps -i pipe:0 ... <path>: a JSON header line, then the
# raw frames; reader: -i <path> ... pipe:1: the raw frames
FFMPEG = '''\
    #!{python}
    import json, sys
    a = sys.argv[1:]
    if "pipe:0" in a:
        w, h = map(int, a[a.index("-s") + 1].split("x"))
        raw = sys.stdin.buffer.read()
        head = {{"w": w, "h": h, "rate": a[a.index("-r") + 1] + "/1",
                 "n": len(raw) // (w * h * 3), "argv": a}}
        with open(a[-1], "wb") as f:
            f.write((json.dumps(head) + "\\n").encode() + raw)
    else:
        with open(a[a.index("-i") + 1], "rb") as f:
            f.readline()
            sys.stdout.buffer.write(f.read())
'''


def put_on_path(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, body in (("ffprobe", FFPROBE), ("ffmpeg", FFMPEG)):
        p = bin_dir / name
        p.write_text(textwrap.dedent(body.format(python=sys.executable)))
        p.chmod(p.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", str(bin_dir))


def test_video_pipes_frame_raw_bgr24(tmp_path, monkeypatch):
    """VideoWriter hands ffmpeg raw bgr24 frames with -s WxH and -r fps
    (libx264, -crf); VideoReader takes ffprobe's size and rate and cuts
    ffmpeg's raw stream into frames, None at its end."""
    put_on_path(tmp_path, monkeypatch)
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)
              for _ in range(5)]
    path = str(tmp_path / "out" / "clip.mp4")
    w = video.VideoWriter(path, 6, 10, fps=30, crf=20)
    for f in frames:
        w.write_frame(f)
    with pytest.raises(ValueError):
        w.write_frame(frames[0][:, :9])
    w.close()
    with open(path, "rb") as f:
        argv = json.loads(f.readline())["argv"]
    assert argv[argv.index("-c:v") + 1] == "libx264"
    assert argv[argv.index("-crf") + 1] == "20"
    assert argv[argv.index("-pix_fmt") + 1] == "bgr24"
    r = video.VideoReader(path)
    assert (r.width, r.height, r.get_fps(), len(r)) == (10, 6, 30.0, 5)
    got = []
    while (f := r.get_frame()) is not None:
        got.append(f)
    r.close()
    assert len(got) == 5
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)


def test_video_needs_ffmpeg_and_ffprobe(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="`ffmpeg`"):
        video.VideoWriter(str(tmp_path / "a.mp4"), 4, 4)
    with pytest.raises(RuntimeError, match="`ffprobe`"):
        video.VideoReader(str(tmp_path / "a.mp4"))
    assert not os.path.exists(tmp_path / "a.mp4")


# -- the fidelity tool -----------------------------------------------------

def test_fidelity_report_equals_the_jax_tools_formulas():
    """The report of three runs that differ (the serving outputs with
    noise of their own, a few picks flipped, other ones in each) against
    tools/bf16_fidelity.py's to_u8, psnr_u8 and report formulas (its
    main, unrounded) on the same runs: the PSNRs within float32's
    rounding of the JAX tool's mean square, the rest exactly."""
    jtool = load_tool("bf16_fidelity")
    rng = np.random.default_rng(7)
    shape, picks = (1, 3, 16, 16, 3), (1, 3, 16)
    out_ref = rng.uniform(-1.1, 1.1, shape).astype(np.float32)
    out_srv = out_ref + 0.03 * rng.standard_normal(shape, np.float32)
    out_forced = out_ref + 0.004 * rng.standard_normal(shape, np.float32)
    idx_ref = rng.integers(0, 64, picks).astype(np.int32)
    idx_srv, idx_forced = idx_ref.copy(), idx_ref.copy()
    idx_srv.flat[[1, 7, 20, 33, 47]] += 1
    idx_forced.flat[[2, 40]] += 1
    rep = fidelity.report((out_ref, idx_ref), (out_srv, idx_srv),
                          (out_forced, idx_forced))
    a8, b8, c8 = (jtool.to_u8(o) for o in (out_srv, out_ref, out_forced))
    for o, want in ((out_srv, a8), (out_ref, b8), (out_forced, c8)):
        np.testing.assert_array_equal(fidelity.to_u8(o), want)
    want = {
        "psnr_db": jtool.psnr_u8(a8, b8),
        "psnr_db_forced": jtool.psnr_u8(c8, b8),
        "index_agreement": float(np.mean(idx_forced == idx_ref)),
        "index_agreement_free_run": float(np.mean(idx_srv == idx_ref)),
        "max_abs_err_u8_forced": float(np.max(np.abs(c8 - b8))),
        "frac_pixels_exact_u8": float(np.mean(a8 == b8)),
    }
    assert rep.keys() == want.keys()
    assert rep["index_agreement"] == 1 - 2 / 48
    assert rep["index_agreement_free_run"] == 1 - 5 / 48
    assert 0 < rep["frac_pixels_exact_u8"] < 1
    assert math.isfinite(rep["psnr_db"]) and math.isfinite(
        rep["psnr_db_forced"]) and rep["psnr_db_forced"] > rep["psnr_db"]
    # the JAX tool takes the mean square in float32, the port's metrics/
    # in float64: the PSNRs agree to float32's rounding, the rest exactly
    for k in ("psnr_db", "psnr_db_forced"):
        assert rep[k] == pytest.approx(want.pop(k), rel=1e-7, abs=0), k
    assert {k: rep[k] for k in want} == want


def test_fidelity_f32_run_equals_jax_on_converted_weights():
    """The tool's f32 run (flow_from_clip, then KEEP.apply) at the tiny
    config (GMFlow of 2 layers) on the CPU against the JAX tool's forward (flow_from_clip with
    planes, KEEP.apply) on the same weights carried into the port, the
    JAX picks forced: the output within KEEP's golden tolerances
    (5e-3 / 1e-2, tests/test_keep_golden.py:108), and the run's own picks
    equal to JAX's wherever JAX's top two logits lie further apart than
    twice that tolerance."""
    from comfyui_keep_tpu.models import gmflow as jgm
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.keep import KEEP
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items()}
    ktree = jax.tree.map(np.asarray, jkeep.KEEP.init(jax.random.PRNGKey(0),
                                                    **cfg))
    gtree = jax.tree.map(np.asarray, jgm.GMFlow.init(jax.random.PRNGKey(2),
                                                     num_layers=2))
    keep, gm = KEEP(device="cpu", **TINY), GMFlow(num_layers=2, device="cpu")
    keep.load_state_dict(params_from_jax(ktree, keep))
    gm.load_state_dict(params_from_jax(gtree, gm))
    x = (np.random.default_rng(1).standard_normal((1, 3, 64, 64, 3))
         * 0.3).astype(np.float32)
    z = jnp.asarray(x)
    ref, aux = jax.jit(lambda k, g, z: jkeep.KEEP.apply(
        k, z, flows=jgm.flow_from_clip(g, z, planes=True), remat=False,
        return_aux=True, **cfg))(ktree, gtree, z)
    logits = np.asarray(aux["logits"]).reshape(1, 3, -1, cfg["codebook_size"])
    picks = logits.argmax(-1).astype(np.int32)
    out, idx = fidelity.run(keep, gm, torch.as_tensor(x), "f32",
                            force_idx=picks)
    assert out.shape == x.shape and idx.shape == picks.shape
    np.testing.assert_allclose(out, np.asarray(ref), atol=5e-3, rtol=1e-2)
    top2 = np.sort(logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * (5e-3 + 1e-2 * np.abs(
        top2[..., 1]))
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(idx[clear], picks[clear])


def test_fidelity_f32_against_itself():
    """At a tiny config on the CPU, f32 served against f32: every pick
    agrees, the PSNRs are infinite, and the forced run keeps the reference
    run's picks."""
    runs = {}
    rep = fidelity.fidelity(frames=3, serving="f32", device="cpu",
                            cfg_overrides=TINY, runs=runs)
    assert rep["index_agreement"] == rep["index_agreement_free_run"] == 1.0
    assert math.isinf(rep["psnr_db"]) and math.isinf(rep["psnr_db_forced"])
    assert rep["max_abs_err_u8_forced"] == 0.0
    assert rep["frac_pixels_exact_u8"] == 1.0
    ref_out, ref_idx = runs["reference"]
    assert ref_out.shape == (1, 3, 64, 64, 3) and ref_idx.shape[:2] == (1, 3)
    np.testing.assert_array_equal(runs["forced"][1], ref_idx)
    np.testing.assert_array_equal(runs["forced"][0], ref_out)


# -- the synthetic zoo ---------------------------------------------------------

@pytest.fixture(scope="module")
def zoo_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("zoo"))
    made = zoo.synth_all(out, seed=0, cfg_overrides=TINY)
    assert sorted(made) == sorted(zoo.ZOO)
    return out, made


def _tree_to_port_equal(tree, module):
    """The JAX tree, carried into the port, equals the port module's own
    state: both packages read the file alike."""
    sd = params_from_jax(jax.tree.map(np.asarray, tree), module)
    live = module.state_dict()
    assert sd.keys() == live.keys()
    for k, v in live.items():
        np.testing.assert_array_equal(np.asarray(sd[k]), v.numpy(),
                                      err_msg=k)


def test_zoo_keep_loads_into_both_packages(zoo_dir):
    out, made = zoo_dir
    path = made["KEEP-b76feb75.pth"]
    pack = api.load_models(keep_ckpt=path, cfg_overrides=TINY)
    jpack = japi.load_models(keep_ckpt=path, cfg_overrides=TINY,
                             use_cache=False)
    _tree_to_port_equal(jpack.keep_params, pack.keep)
    _tree_to_port_equal(jpack.gmflow_params, pack.gmflow)
    x = np.random.default_rng(3).random((1, 3, 64, 64, 3),
                                        dtype=np.float32) * 2 - 1
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in
           jpack.keep_cfg.items()}
    ref, aux = jkeep.KEEP.apply(jpack.keep_params, jnp.asarray(x),
                                remat=False, return_aux=True, **cfg)
    picks = np.asarray(aux["logits"]).argmax(-1).reshape(1, 3, -1)
    out_t = pack.keep.apply(torch.as_tensor(x),
                            force_indices=torch.as_tensor(picks))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref), atol=5e-3,
                               rtol=1e-2)


def test_zoo_retinaface_loads_into_both_packages(zoo_dir):
    out, made = zoo_dir
    root = os.path.join(out, "facedetection")
    det = factory.init_detection_model("retinaface_resnet50",
                                       model_rootpath=root, device="cpu")
    jfactory.init_detection_model("retinaface_resnet50",
                                  model_rootpath=root)
    tree = convert_state_dict(jfactory._load_sd(
        made["detection_Resnet50_Final.pth"]))
    _tree_to_port_equal(tree, det.model)
    img = zoo.synth_image(np.random.default_rng(0), 640, 640)
    rows = det(img, zoo.DETECT_CONF)
    eye = np.linalg.norm(rows[:, 5:7] - rows[:, 7:9], axis=1)
    assert 1 <= int((eye >= zoo.DETECT_EYE).sum()) <= 50
    x = np.random.default_rng(4).uniform(-120, 130, (1, 64, 96, 3)
                                         ).astype(np.float32)
    ref = jax.jit(jret.RetinaFace.apply, static_argnames="network")(
        tree, jnp.asarray(x), network="resnet50")
    with torch.no_grad():
        got = det.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for r, g in zip(ref, got):
        assert rel(g.numpy(), r) <= 1e-4


def test_zoo_parsenet_loads_into_both_packages(zoo_dir):
    out, made = zoo_dir
    root = os.path.join(out, "facedetection")
    par = factory.init_parsing_model("parsenet", model_rootpath=root,
                                     device="cpu")
    jfactory.init_parsing_model("parsenet", model_rootpath=root)
    tree = jparse.convert_parsenet_checkpoint(
        jfactory._load_sd(made["parsing_parsenet.pth"]))
    _tree_to_port_equal(tree, par.model)
    x = np.random.default_rng(5).uniform(-1, 1, (1, 128, 128, 3)
                                         ).astype(np.float32)
    mask, _ = jax.jit(jparse.ParseNet.apply)(tree, jnp.asarray(x))
    assert rel(par(x).numpy(), mask) <= 1e-4


@pytest.mark.parametrize("name", ["RealESRGAN_x2_bg.pth",
                                  "RealESRGAN_x2_face.pth"])
def test_zoo_rrdbnet_loads_into_both_packages(zoo_dir, name):
    out, made = zoo_dir
    net = factory.load_reference(RRDBNet(scale=2, num_feat=32, num_block=2,
                                         device="cpu"), made[name])
    from comfyui_keep_tpu.utils.checkpoint import read_pth
    tree = convert_state_dict(read_pth(made[name]))
    _tree_to_port_equal(tree, net)
    x = np.random.default_rng(6).random((1, 16, 16, 3), dtype=np.float32)
    ref = jsr.RRDBNet.apply(tree, jnp.asarray(x), scale=2)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (1, 32, 32, 3)
    assert rel(got.numpy(), ref) <= 1e-4
