"""The flow data and evaluation stack of the PyTorch port against the JAX
package (and the sandbox's OpenCV 5.0.0 and PIL, the JAX package's own
backends), on the CPU: .flo / .pfm / PPM / 16-bit PNG files, the quantised
flow PNG, the Middlebury picture, the uint8 HSV round trip and the fx / fy
resizes, the augmentors and a FlyingChairs item with their streams seeded
alike, InputPadder, the validators and inference_on_dir.

Tolerances: files, pictures, RGB -> HSV, the uint8 resize and the float32
resize of a 2-channel flow bit for bit (OpenCV's float32 path for other
channel counts rounds otherwise: an occlusion map within 1e-5 of 255);
OpenCV's HSV -> RGB differs from the port's float form on 14 of the 2^24
triples, by one level (ROADMAP Queue 3): the dense augmentor's jittered
images are held bit for bit (none of those triples occurs there), the
sparse augmentor's and the FlyingChairs items' within one level on at
most 1e-3 of their values, and everything after the jitter (the flow,
valid) bit for bit; metrics within 1e-6 relative.
"""
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from comfyui_keep_tpu.data import flow_datasets as jfd
from comfyui_keep_tpu.training import flow_eval as jfe
from comfyui_keep_tpu.utils import flow as jflow
from comfyui_keep_torch.data import flow_datasets as tfd
from comfyui_keep_torch.training import flow_eval as tfe
from comfyui_keep_torch.utils import cvops, png, ppm
from comfyui_keep_torch.utils import flow as tflow
from comfyui_keep_torch.utils.resize import resize

torch.set_num_threads(2)
JITTER_SHARE = 1e-3   # share of jittered values allowed one level off
METRIC_RTOL = 1e-6


def test_flo_round_trip_both_ways(tmp_path):
    flow = np.random.default_rng(0).standard_normal((17, 23, 2)).astype(
        np.float32) * 30
    a, b = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    tfd.write_flo(a, flow)
    jfd.write_flo(b, flow)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(tfd.read_flo(b), flow)
    np.testing.assert_array_equal(jfd.read_flo(a), flow)
    np.testing.assert_array_equal(tflow.flowread(a), flow)
    tflow.flowwrite(flow, b)
    np.testing.assert_array_equal(jflow.flowread(b), flow)


@pytest.mark.parametrize("color,endian", [(True, "<"), (False, ">")])
def test_pfm_equals_jax(tmp_path, color, endian):
    shape = (8, 10, 3) if color else (8, 10)
    data = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    p = str(tmp_path / "f.pfm")
    with open(p, "wb") as f:
        f.write((b"PF" if color else b"Pf") + b"\n10 8\n"
                + (b"-1.0\n" if endian == "<" else b"1.0\n"))
        np.flipud(data).astype(endian + "f").tofile(f)
    np.testing.assert_array_equal(tfd.read_pfm(p), jfd.read_pfm(p))
    np.testing.assert_array_equal(tfd.read_pfm(p), data)
    np.testing.assert_array_equal(tfd.read_gen(p), jfd.read_gen(p))


def test_ppm_equals_pil(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (13, 19, 3), np.uint8)
    p = str(tmp_path / "a.ppm")
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(ppm.read(p), np.array(Image.open(p)))
    np.testing.assert_array_equal(tfd.read_gen(p), jfd.read_gen(p))
    ppm.write(p, img)
    np.testing.assert_array_equal(np.array(Image.open(p)), img)
    with open(p, "wb") as f:      # a comment in the header
        f.write(b"P6\n# made by hand\n19 13\n255\n" + img.tobytes())
    np.testing.assert_array_equal(ppm.read(p), img)


@pytest.mark.parametrize("shape", [(17, 23), (9, 31, 3), (5, 7, 4)])
def test_png16_decoder_equals_cv2_and_encoder_reads_back(tmp_path, shape):
    a = np.random.default_rng(3).integers(0, 65536, shape, np.uint16)
    p = str(tmp_path / "a.png")
    cv2.imwrite(p, a)                     # OpenCV's writer, BGR(A) order
    ours = png.imread(p)
    assert ours.dtype == np.uint16
    if len(shape) == 2:
        np.testing.assert_array_equal(
            ours[..., 0], cv2.imread(p, cv2.IMREAD_ANYDEPTH))
    else:
        ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(ours[..., 2::-1], ref[..., :3])
        np.testing.assert_array_equal(
            ours[..., 2::-1], cv2.imread(p, cv2.IMREAD_ANYDEPTH
                                         | cv2.IMREAD_COLOR))
    want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    with open(p, "wb") as f:          # the port's writer, read by OpenCV
        f.write(png.encode(ours))
    np.testing.assert_array_equal(png.imread(p), ours)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), want)


def test_kitti_flow_png_both_ways(tmp_path):
    flow = (np.random.default_rng(4).standard_normal((16, 20, 2)) * 50
            ).astype(np.float32)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tfd.write_flow_kitti(a, flow)
    jfd.write_flow_kitti(b, flow)          # through cv2.imwrite
    for p in (a, b):
        tf, tv = tfd.read_flow_kitti(p)
        jf, jv = jfd.read_flow_kitti(p)    # through cv2.imread
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tf, flow, atol=1 / 64.0)


def test_quantized_flow_png_and_picture_equal_jax(tmp_path, monkeypatch):
    flow = np.random.default_rng(5).standard_normal((12, 16, 2)).astype(
        np.float32) * 0.2
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tflow.flowwrite(flow, a, quantize=True)
    jflow.flowwrite(flow, b, quantize=True)   # cv2
    np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(b, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(tflow.flowread(b, quantize=True),
                                  jflow.flowread(b, quantize=True))
    for q in (True, False):
        dq = [np.asarray(x) for x in tflow.quantize_flow(flow, norm=q)]
        for x, y in zip(dq, jflow.quantize_flow(flow, norm=q)):
            np.testing.assert_array_equal(x, y)
    big = flow * 40
    big[3, 4] = 0
    for mf in (None, 5.0):
        np.testing.assert_array_equal(tflow.flow_to_image(big, mf),
                                      jflow.flow_to_image(big, mf))
    # without the lmdb package the builder names it (the builder itself is
    # held against JAX's in tests/test_torch_datasets_extra.py)
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb package"):
        tflow.make_lmdb_from_imgs(str(tmp_path), str(tmp_path), ["a.png"],
                                  ["a"])


def test_hsv_full_forms_against_cv2_on_every_colour():
    """RGB -> HSV bit for bit on all 2^24 colours; HSV -> RGB on all 2^24
    triples differs by one level on 14 (the count recorded in ROADMAP
    Queue 3); in blocks of 2^20 to keep the memory small."""
    a = np.arange(256, dtype=np.uint8)
    off, worst = 0, 0
    for r in range(0, 256, 16):
        block = np.stack(np.meshgrid(a[r:r + 16], a, a, indexing="ij"),
                         -1).reshape(-1, 1, 3)
        np.testing.assert_array_equal(
            cvops.rgb_to_hsv_full(block),
            cv2.cvtColor(block, cv2.COLOR_RGB2HSV_FULL))
        d = np.abs(cvops.hsv_to_rgb_full(block).astype(np.int32)
                   - cv2.cvtColor(block, cv2.COLOR_HSV2RGB_FULL))
        off += int((d.max(-1) > 0).sum())
        worst = max(worst, int(d.max()))
    assert off == 14 and worst == 1


@pytest.mark.parametrize("fx,fy", [(1.37, 0.81), (2.0, 2.0), (0.55, 1.9),
                                   (1.0300001, 1.12)])
def test_fx_fy_resizes_equal_cv2(fx, fy):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    flow = rng.standard_normal((37, 53, 2)).astype(np.float32) * 5
    np.testing.assert_array_equal(
        resize(img, (0, 0), "linear", fx=fx, fy=fy),
        cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(
        cvops.resize_linear_f32(torch.from_numpy(flow), (0, 0), fx=fx,
                                fy=fy).numpy(),
        cv2.resize(flow, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR))


def _close_images(ours, ref):
    d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= JITTER_SHARE, (
        d.max(), (d > 0).mean())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dense_augmentor_equals_jax(seed):
    rng = np.random.default_rng(10 + seed)
    img1 = rng.integers(0, 256, (72, 100, 3), np.uint8)
    img2 = rng.integers(0, 256, (72, 100, 3), np.uint8)
    flow = (rng.standard_normal((72, 100, 2)) * 5).astype(np.float32)
    occ = (rng.random((72, 100)) * 255).astype(np.float32)
    kw = dict(crop_size=(48, 64), min_scale=-0.1, max_scale=1.0,
              do_flip=True, no_eraser_aug=seed % 2 == 0)
    np.random.seed(seed)
    ref = jfd.FlowAugmentor(**kw)(img1, img2, flow, occlusion=occ)
    ours = tfd.FlowAugmentor(**kw)(img1, img2, flow,
                                   np.random.RandomState(seed), occlusion=occ)
    assert [x.shape for x in ours] == [x.shape for x in ref]
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_allclose(ours[3], ref[3], rtol=0, atol=1e-5 * 255)
    assert ours[2].dtype == ref[2].dtype


@pytest.mark.parametrize("seed", [0, 5])
def test_sparse_augmentor_equals_jax(seed):
    rng = np.random.default_rng(20 + seed)
    img1 = rng.integers(0, 256, (60, 100, 3), np.uint8)
    img2 = rng.integers(0, 256, (60, 100, 3), np.uint8)
    flow = rng.standard_normal((60, 100, 2)).astype(np.float32) * 3
    valid = (rng.random((60, 100)) > 0.4).astype(np.float32)
    kw = dict(crop_size=(32, 48), min_scale=-0.2, max_scale=0.4,
              do_flip=True)
    np.random.seed(seed)
    ref = jfd.SparseFlowAugmentor(**kw)(img1, img2, flow, valid)
    ours = tfd.SparseFlowAugmentor(**kw)(img1, img2, flow, valid,
                                         np.random.RandomState(seed))
    _close_images(ours[0], ref[0])
    _close_images(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(ours[3], ref[3])


def write_chairs(root, n=10, hw=(72, 96), seed=0):
    """A FlyingChairs-layout directory: n pairs of .ppm frames (PIL's
    writer) and their .flo flows."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(1, n + 1):
        base = rng.integers(0, 256, hw + (3,), np.uint8)
        for j, img in ((1, base), (2, np.roll(base, 2, axis=1))):
            Image.fromarray(img).save(os.path.join(root,
                                                   f"{i:05d}_img{j}.ppm"))
        jfd.write_flo(os.path.join(root, f"{i:05d}_flow.flo"),
                      (rng.standard_normal(hw + (2,)) * 3).astype(np.float32))
    return root


def test_chairs_training_items_equal_jax(tmp_path):
    root = write_chairs(str(tmp_path / "chairs"))
    ref_ds = jfd.build_train_dataset("chairs", (48, 64),
                                     roots={"chairs": root})
    ds = tfd.build_train_dataset("chairs", (48, 64), roots={"chairs": root})
    assert len(ds) == len(ref_ds) == 9
    np.random.seed(7)
    ds.seed_streams(7)
    for i in (0, 3, 8):
        ref, ours = ref_ds[i], ds[i]
        assert ours.keys() == ref.keys()
        _close_images(ours["img1"], ref["img1"])
        _close_images(ours["img2"], ref["img2"])
        for k in ("flow", "valid"):
            np.testing.assert_array_equal(ours[k], ref[k])
            assert ours[k].dtype == np.float32
    val = tfd.FlyingChairs(split="validation", root=root)
    ref_val = jfd.FlyingChairs(split="validation", root=root)
    assert val.image_list == ref_val.image_list and len(val) == 1
    for k, v in ref_val[0].items():
        np.testing.assert_array_equal(val[0][k], v)


def test_concat_shares_one_stream(tmp_path):
    root = write_chairs(str(tmp_path / "chairs"), n=4)
    aug = dict(crop_size=(48, 64), min_scale=-0.1, max_scale=1.0)
    parts = [tfd.FlyingChairs(aug, root=root) for _ in range(2)]
    cat = tfd.ConcatFlowDataset(parts)
    cat.seed_streams(3)
    assert parts[0].np_rng is parts[1].np_rng is cat.np_rng
    assert len(cat) == 2 * len(parts[0])
    a = cat[len(parts[0])]           # the second part's first item
    parts[1].seed_streams(3)
    np.testing.assert_array_equal(parts[1][0]["flow"], a["flow"])


@pytest.mark.parametrize("shape,mode", [((1, 30, 46, 3), "sintel"),
                                        ((1, 37, 61, 3), "kitti"),
                                        ((1, 32, 48, 3), "sintel")])
def test_input_padder_equals_jax(shape, mode):
    x = np.random.default_rng(8).random(shape).astype(np.float32)
    ours, ref = tfe.InputPadder(shape, mode), jfe.InputPadder(shape, mode)
    (po,), (pr,) = ours.pad(x), ref.pad(x)
    np.testing.assert_array_equal(po, pr)
    assert po.shape[1] % 8 == 0 and po.shape[2] % 8 == 0
    np.testing.assert_array_equal(ours.unpad(po), x)


def fake_flow_fn(img1, img2):
    """A deterministic stand-in for a model: a flow from the images'
    channels (numpy or a tensor in, numpy out)."""
    a, b = np.asarray(img1, np.float32), np.asarray(img2, np.float32)
    return np.stack([(a[..., 0] - b[..., 1]) / 20.0,
                     (a[..., 2] - b[..., 0]) / 37.0], -1)


def _same_metrics(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if np.isnan(v):
            assert np.isnan(ours[k]), k
        else:
            assert abs(ours[k] - v) <= METRIC_RTOL * max(abs(v), 1e-12), k


def test_validate_chairs_equals_jax(tmp_path):
    root = write_chairs(str(tmp_path / "chairs"), n=20)
    for speed in (False, True):
        _same_metrics(tfe.validate_chairs(fake_flow_fn, root=root,
                                          with_speed_metric=speed),
                      jfe.validate_chairs(fake_flow_fn, root=root,
                                          with_speed_metric=speed))


def test_validate_chairs_with_gmflow_equals_jax(tmp_path):
    """make_flow_fn on a 2-layer GMFlow against JAX's GMFlow.apply on the
    same tree: the metrics within the GMFlow golden tolerance's effect
    (1e-3 relative)."""
    from comfyui_keep_tpu.models import gmflow as jg
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.utils.convert import params_from_jax
    root = write_chairs(str(tmp_path / "chairs"), n=10, hw=(64, 96))
    tree = jax.tree.map(np.asarray,
                        jg.GMFlow.init(jax.random.PRNGKey(2), num_layers=2))
    net = GMFlow(num_layers=2, device="cpu")
    net.load_state_dict(params_from_jax(tree, net))
    fn = jax.jit(lambda a, b: jg.GMFlow.apply(tree, a, b))
    ref = jfe.validate_chairs(fn, root=root)
    ours = tfe.validate_chairs(tfe.make_flow_fn(net), root=root)
    assert np.isfinite(ours["chairs_epe"])
    assert abs(ours["chairs_epe"] - ref["chairs_epe"]) \
        <= 1e-3 * ref["chairs_epe"]


def write_sintel(root, frames=3, hw=(30, 46)):
    rng = np.random.default_rng(9)
    for split in ("training", "test"):
        img_dir = os.path.join(root, split, "clean", "alley_1")
        os.makedirs(img_dir)
        for i in range(frames):
            Image.fromarray(rng.integers(0, 256, hw + (3,), np.uint8)).save(
                os.path.join(img_dir, f"frame_{i:04d}.png"))
    flo_dir = os.path.join(root, "training", "flow", "alley_1")
    occ_dir = os.path.join(root, "training", "occlusions", "alley_1")
    os.makedirs(flo_dir), os.makedirs(occ_dir)
    for i in range(frames - 1):
        jfd.write_flo(os.path.join(flo_dir, f"frame_{i:04d}.flo"),
                      (rng.standard_normal(hw + (2,)) * 20).astype(
                          np.float32))
        Image.fromarray(((rng.random(hw) > 0.7) * 255).astype(np.uint8)).save(
            os.path.join(occ_dir, f"frame_{i:04d}.png"))
    return root


def test_validate_sintel_and_submission_equal_jax(tmp_path):
    root = write_sintel(str(tmp_path / "Sintel"))
    for mu, speed in ((False, False), (True, True)):
        _same_metrics(
            tfe.validate_sintel(fake_flow_fn, root=root,
                                evaluate_matched_unmatched=mu,
                                with_speed_metric=speed),
            jfe.validate_sintel(fake_flow_fn, root=root,
                                evaluate_matched_unmatched=mu,
                                with_speed_metric=speed))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    tfe.create_sintel_submission(fake_flow_fn, root=root, output_path=a)
    jfe.create_sintel_submission(fake_flow_fn, root=root, output_path=b)
    for f in ("frame0001.flo", "frame0002.flo"):
        rel = os.path.join("clean", "alley_1", f)
        assert open(os.path.join(a, rel), "rb").read() == \
            open(os.path.join(b, rel), "rb").read()


def test_validate_kitti_and_submission_equal_jax(tmp_path):
    root = str(tmp_path / "KITTI")
    rng = np.random.default_rng(11)
    for split in ("training", "testing"):
        os.makedirs(os.path.join(root, split, "image_2"))
        for i in range(2):
            for t in (10, 11):
                Image.fromarray(rng.integers(0, 256, (37, 61, 3),
                                             np.uint8)).save(
                    os.path.join(root, split, "image_2",
                                 f"{i:06d}_{t}.png"))
    os.makedirs(os.path.join(root, "training", "flow_occ"))
    for i in range(2):
        jfd.write_flow_kitti(os.path.join(root, "training", "flow_occ",
                                          f"{i:06d}_10.png"),
                             (rng.standard_normal((37, 61, 2)) * 30).astype(
                                 np.float32))
    for speed in (False, True):
        _same_metrics(tfe.validate_kitti(fake_flow_fn, root=root,
                                         with_speed_metric=speed),
                      jfe.validate_kitti(fake_flow_fn, root=root,
                                         with_speed_metric=speed))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    tfe.create_kitti_submission(fake_flow_fn, root=root, output_path=a)
    jfe.create_kitti_submission(fake_flow_fn, root=root, output_path=b)
    for f in sorted(os.listdir(b)):
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(a, f), cv2.IMREAD_UNCHANGED),
            cv2.imread(os.path.join(b, f), cv2.IMREAD_UNCHANGED))


def test_inference_on_dir_equals_jax(tmp_path):
    ind = str(tmp_path / "in")
    os.makedirs(ind)
    rng = np.random.default_rng(12)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (30, 45, 3), np.uint8)).save(
            os.path.join(ind, f"{i:03d}.png"))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ours = tfe.inference_on_dir(fake_flow_fn, ind, a, save_flo_flow=True)
    ref = jfe.inference_on_dir(fake_flow_fn, ind, b, save_flo_flow=True)
    assert len(ours) == len(ref) == 2
    for i, (o, r) in enumerate(zip(ours, ref)):
        np.testing.assert_array_equal(o, r)
        np.testing.assert_array_equal(
            np.array(Image.open(os.path.join(a, "%04d_flow.png" % i))),
            np.array(Image.open(os.path.join(b, "%04d_flow.png" % i))))
        np.testing.assert_array_equal(
            tfd.read_flo(os.path.join(a, "%04d_pred.flo" % i)),
            jfd.read_flo(os.path.join(b, "%04d_pred.flo" % i)))


def test_validate_things_equals_jax(tmp_path):
    root = str(tmp_path / "things")
    rng = np.random.default_rng(13)
    for dstype in ("frames_cleanpass",):
        d = os.path.join(root, dstype, "TEST", "A", "0000", "left")
        os.makedirs(d)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (30, 46, 3),
                                         np.uint8)).save(
                os.path.join(d, f"{i:04d}.png"))
    for direction in ("into_future", "into_past"):
        d = os.path.join(root, "optical_flow", "TEST", "A", "0000",
                         direction, "left")
        os.makedirs(d)
        for i in range(3):
            data = rng.standard_normal((30, 46, 3)).astype(np.float32) * 9
            with open(os.path.join(d, f"{i:04d}.pfm"), "wb") as f:
                f.write(b"PF\n46 30\n-1.0\n")
                np.flipud(data).astype("<f").tofile(f)
    _same_metrics(tfe.validate_things(fake_flow_fn, root=root,
                                      with_speed_metric=True),
                  jfe.validate_things(fake_flow_fn, root=root,
                                      with_speed_metric=True))


def test_jpeg_frames_raise_without_pil(tmp_path):
    p = str(tmp_path / "a.jpg")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(p)
    with pytest.raises(ValueError, match="PIL"):
        tfd.read_gen(p)
