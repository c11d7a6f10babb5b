"""The port's YOLOv5-face detector (comfyui_keep_torch/facelib/yolov5face.py)
against the JAX package's, on the CPU in f32.

Weights: the port's seeded init with every BatchNorm's statistics drawn at
random, carried into a JAX tree by the JAX package's own converter
(convert_state_dict, the oracle), and back by params_from_jax; one JAX
init tree (YOLOv5n) goes the other way. Tolerances: the decoded
predictions within 1e-4 of their largest magnitude (the frameworks differ
in summation order only; measured ~2e-8); the letterbox bitwise against
the JAX one, which runs on OpenCV here (its resize and copyMakeBorder);
the NMS equal; the detector's rows within 1e-3 px and 1e-5 in score, at a
threshold no score lies within 1e-5 of.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.facelib import yolov5face as jyolo
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict
from comfyui_keep_torch.facelib import factory
from comfyui_keep_torch.facelib import yolov5face as tyolo
from comfyui_keep_torch.models.bisenet import BiSeNet
from comfyui_keep_torch.models.parsenet import ParseNet
from comfyui_keep_torch.models.retinaface import RetinaFace
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.torch_port_helpers import (assert_trees_equal, randomize_bn, rel,
                                      state_numpy)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["yolov5n", "yolov5l"])
def yolo(request):
    config = request.param
    model = randomize_bn(tyolo.YoloFace(
        config, device="cpu", generator=torch.Generator().manual_seed(0)), 1)
    tree = {"model": convert_state_dict(state_numpy(model))["model"]}
    return config, model, tree


def test_yolo_matches_jax_and_round_trips(yolo):
    config, model, tree = yolo
    x = np.random.default_rng(2).random((2, 64, 96, 3), dtype=np.float32)
    ref = jax.jit(jyolo.YoloFace.apply, static_argnames="config")(
        tree, jnp.asarray(x), config=config)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    # 3 anchors at strides 8 / 16 / 32 of a 64 x 96 input
    assert got.shape == ref.shape == (2, 3 * (96 + 24 + 6), 16)
    assert rel(got.numpy(), ref) <= 1e-4
    again = tyolo.YoloFace(config, device="cpu")
    sd = params_from_jax(tree, again)
    again.load_state_dict(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert_trees_equal(convert_state_dict(state_numpy(again)), tree)
    names = {"yolov5n": ("model.0.stem_1.conv.weight",
                         "model.1.branch1.0.weight",
                         "model.2.2.branch2.3.weight",
                         "model.10.m.0.cv2.bn.running_var",
                         "model.21.m.2.bias"),
             "yolov5l": ("model.0.stem_3.bn.weight", "model.1.m.2.cv1.conv."
                         "weight", "model.7.cv2.conv.weight",
                         "model.23.m.0.weight")}[config]
    for key in names:
        assert key in sd, key


def test_jax_init_tree_loads():
    """A tree from the JAX package's own init (its lists keep None where a
    layer has no weights) carries into the port and back."""
    tree = jax.tree.map(np.asarray, jyolo.YoloFace.init(
        jax.random.PRNGKey(3), config="yolov5n"))
    model = tyolo.YoloFace("yolov5n", device="cpu")
    model.load_state_dict(params_from_jax(tree, model))
    assert_trees_equal(convert_state_dict(state_numpy(model)), tree)
    x = np.random.default_rng(4).random((1, 32, 64, 3), dtype=np.float32)
    ref = jyolo.YoloFace.apply(tree, jnp.asarray(x), config="yolov5n")
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel(got.numpy(), ref) <= 1e-4


def test_channel_shuffle_matches_jax():
    x = np.random.default_rng(5).random((2, 3, 5, 8), dtype=np.float32)
    ref = jyolo._channel_shuffle(jnp.asarray(x), 2)
    got = tyolo.channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("shape,new", [((720, 1280), 640), ((640, 1137), 640),
                                       ((48, 72), 64), ((100, 90), 128),
                                       ((640, 640), 640), ((37, 129), 96)])
def test_letterbox_bitwise(shape, new):
    img = np.random.default_rng(6).integers(0, 256, shape + (3,),
                                            dtype=np.uint8)
    ref, r_ref, pad_ref = jyolo.letterbox(img[..., ::-1], new_shape=new)
    got, r, pad = tyolo.letterbox(img[..., ::-1], new_shape=new)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (new, new, 3)
    np.testing.assert_array_equal(got, ref)
    assert (r, pad) == (r_ref, pad_ref)
    t, _, _ = tyolo.letterbox(torch.from_numpy(img).flip(-1), new_shape=new)
    np.testing.assert_array_equal(t.numpy(), ref)
    if shape == (720, 1280):
        # 140 rows of 114 above and below the 640 x 360 frame
        assert pad == (0.0, 140.0)
        assert (got[:140] == 114).all() and (got[-140:] == 114).all()


def test_nms_matches_jax():
    rng = np.random.default_rng(7)
    n = 400
    pred = np.zeros((n, 16), np.float32)
    pred[:, :2] = rng.uniform(0, 120, (n, 2))
    pred[:, 2:4] = rng.uniform(5, 40, (n, 2))
    pred[:, 4] = rng.uniform(0, 1, n)
    pred[:, 5:15] = rng.uniform(0, 120, (n, 10))
    pred[:, 15] = rng.uniform(0.5, 1, n)
    for conf, iou in ((0.5, 0.5), (0.3, 0.45), (0.99, 0.5)):
        np.testing.assert_array_equal(
            tyolo.non_max_suppression_face(pred, conf, iou),
            jyolo.non_max_suppression_face(pred, conf, iou))


def _threshold_clear_of_scores(scores, quantile):
    """A threshold near `quantile` of the scores with no score within 1e-5
    of it (midway across a gap wider than 2e-5)."""
    s = np.sort(scores)
    i = int(len(s) * quantile)
    while s[i + 1] - s[i] <= 2e-5:
        i += 1
    return float((s[i] + s[i + 1]) / 2)


def test_detector_rows_match_jax(yolo):
    """Letterbox -> network -> decode -> NMS -> undo the letterbox, against
    the JAX detector at a threshold that lets ~1 % of the anchors through
    and that no score lies within 1e-5 of."""
    config, model, tree = yolo
    img = np.random.default_rng(8).integers(0, 256, (90, 120, 3),
                                            dtype=np.uint8)
    det = tyolo.make_yolo_detector_fn(model, target_size=128)
    jdet = jyolo.make_yolo_detector_fn(tree, config=config, target_size=128)
    pred = det.predictions(img)[0].numpy()
    conf = pred[:, 4] * pred[:, 15]
    thres = _threshold_clear_of_scores(conf, 0.99)
    assert np.abs(conf - thres).min() > 1e-5
    got, ref = det(img, thres), jdet(img, thres)
    assert got.dtype == np.float32 and got.shape[1] == 15
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(got[:, :4], ref[:, :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[:, 5:], ref[:, 5:], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[:, 4], ref[:, 4], atol=1e-5, rtol=0)
    # a tensor frame (as the helper hands in) gives the same rows
    np.testing.assert_array_equal(det(torch.from_numpy(img), thres), got)
    assert det(img, 1.0).shape == (0, 15)


def test_factory_builds_all_six(tmp_path):
    """Every name of the factory builds on the CPU with random weights (the
    four detectors, both parsers); YOLO loads a reference .pth carrying the
    reference's anchor buffers; half=True is bf16."""
    det_cls = {"retinaface_resnet50": RetinaFace,
               "retinaface_mobile0.25": RetinaFace,
               "YOLOv5l": tyolo.YoloFace, "YOLOv5n": tyolo.YoloFace}
    for name, cls in det_cls.items():
        d = factory.init_detection_model(name, require_weights=False,
                                         device="cpu")
        assert isinstance(d.model, cls) and callable(d)
    for name, cls in (("parsenet", ParseNet), ("bisenet", BiSeNet)):
        p = factory.init_parsing_model(name, require_weights=False,
                                       half=True, device="cpu")
        assert isinstance(p.model, cls)
        assert next(p.model.parameters()).dtype == torch.bfloat16
    det = factory.init_detection_model("YOLOv5n", require_weights=False,
                                       seed=4, device="cpu")
    sd = {"module." + k: v for k, v in det.model.state_dict().items()}
    sd["module.model.21.anchors"] = torch.zeros(3, 3, 2)
    sd["module.model.21.anchor_grid"] = torch.zeros(3, 1, 3, 1, 1, 2)
    torch.save(sd, tmp_path / "yolov5n-face.pth")
    loaded = factory.init_detection_model(
        "YOLOv5n", model_rootpath=str(tmp_path), device="cpu")
    for k, v in det.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k
    with pytest.raises(NotImplementedError, match="not a detector"):
        factory.init_detection_model("bisenet", require_weights=False,
                                     device="cpu")
    with pytest.raises(NotImplementedError, match="not a parser"):
        factory.init_parsing_model("YOLOv5l", require_weights=False,
                                   device="cpu")
