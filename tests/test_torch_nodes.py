"""The port's ComfyUI nodes against the JAX package's: the same node keys,
display names and input schemas (so saved workflows load unchanged), and
the same behaviour around a call: an invalid pack gives (None,), any error
is trapped and gives (None,), and the pack is offloaded whatever happens.
On the CPU (the nodes' `device` keyword), an aligned face gives the pixels
of api.restore_image; ComfyUI IMAGE arrays (B, H, W, C float32 RGB in
[0, 1]) go in and come out. A whole frame through a pack the loader built
without model_rootpath (no detector, as the JAX node's pack) gives (None,)
and a message that names model_rootpath and the files it must hold; with
model_rootpath the loader builds the detector and ParseNet from the
reference-named .pth files there, and a whole frame is restored as JAX's
api.load_models(detector=..., parser=...) + api.restore_image restores it
from the same files (detection rows within atol 1e-3 / rtol 1e-4 as in
tests/test_torch_facelib.py; the pasted frame within 3 levels, mean <=
0.05 level, as in tests/test_torch_pipeline.py, KEEP's code picks forced
as there).
"""
import sys

import numpy as np
import pytest
import torch

from comfyui_keep_tpu import api as japi
from comfyui_keep_tpu import nodes as jnodes
from comfyui_keep_tpu.facelib import factory as jfactory
from comfyui_keep_torch import api, nodes
from comfyui_keep_torch.facelib import factory
from comfyui_keep_torch.facelib.helper import FFHQ_TEMPLATE_512
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.utils.image import comfy_to_cv2, cv2_to_comfy
from tests.torch_port_helpers import randomize_bn

torch.set_num_threads(2)
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=2,
            attn_resolutions=(16,), codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=("32", "64"),
            cfa_list=("16",), cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=())
PAIRS = [(nodes.KEEP_ModelLoaderNode, jnodes.KEEP_ModelLoaderNode),
         (nodes.KEEP_FaceUpscaleImageNode, jnodes.KEEP_FaceUpscaleImageNode),
         (nodes.KEEP_ProcessImageSequenceNode,
          jnodes.KEEP_ProcessImageSequenceNode)]


@pytest.mark.parametrize("ours,theirs", PAIRS)
def test_node_schemas_equal_jax(ours, theirs):
    assert ours.INPUT_TYPES() == theirs.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    assert getattr(ours, "RETURN_NAMES", None) == getattr(theirs,
                                                          "RETURN_NAMES", None)


def test_node_mappings_equal_jax():
    assert (nodes.NODE_DISPLAY_NAME_MAPPINGS
            == jnodes.NODE_DISPLAY_NAME_MAPPINGS)
    assert list(nodes.NODE_CLASS_MAPPINGS) == list(jnodes.NODE_CLASS_MAPPINGS)
    assert [c.__name__ for c in nodes.NODE_CLASS_MAPPINGS.values()] == [
        c.__name__ for c in jnodes.NODE_CLASS_MAPPINGS.values()]


@pytest.fixture
def pack():
    return api.load_models(seed=1, cfg_overrides=TINY)


def _spy_offload(p):
    calls = []
    offload = p.offload
    p.offload = lambda: calls.append(1) or offload()
    return calls


def _image(seed, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    return rng.random((1,) + shape + (3,)).astype(np.float32)


def test_loader_node_builds_a_pack_and_records_the_detector_name(monkeypatch):
    made = []
    load = api.load_models
    monkeypatch.setattr(api, "load_models", lambda **kw: made.append(kw) or
                        load(cfg_overrides=TINY, **kw))
    pack, = nodes.KEEP_ModelLoaderNode().load_model_pack(
        "Asian", "retinaface_mobile0.25")
    assert made == [{"model_type": "Asian", "keep_ckpt": None,
                     "bg_upscaler": None, "face_upscaler": None}]
    assert pack.detection_model == "retinaface_mobile0.25"
    assert pack.face_helper is None and pack.model_type == "Asian"
    # the upscale models pass through to the pack, as in the JAX node
    bg, face = (lambda img: img), (lambda img: img)
    pack, = nodes.KEEP_ModelLoaderNode().load_model_pack(
        "KEEP", "retinaface_resnet50", bg_upscale_model=bg,
        face_upscale_model=face)
    assert made[-1]["bg_upscaler"] is bg
    assert pack.bg_upscaler is bg and pack.face_upscaler is face


def test_single_image_node_aligned_equals_api(pack):
    image = _image(0)
    calls = _spy_offload(pack)
    out, = nodes.KEEP_FaceUpscaleImageNode().upscale_face_image(
        image, pack, 1.5, True, True, False, device="cpu")
    assert calls == [1]
    assert next(pack.keep.parameters()).device.type == "cpu"
    want = api.restore_image(pack, comfy_to_cv2(image), 1.5, has_aligned=True,
                             device="cpu")
    assert out.dtype == np.float32 and out.shape == (1, 96, 96, 3)
    np.testing.assert_array_equal(out, cv2_to_comfy(want))


def test_sequence_node_aligned_returns_the_upscaled_frames(pack):
    images = np.concatenate([_image(s) for s in range(3)])
    calls = _spy_offload(pack)
    out, = nodes.KEEP_ProcessImageSequenceNode().process_sequence(
        images, pack, 2.0, True, True, False, 2, device="cpu")
    assert calls == [1] and out.shape == (3, 128, 128, 3)
    want = api.restore_sequence(pack, [comfy_to_cv2(f) for f in images], 2.0,
                                has_aligned_frames=True, device="cpu")
    np.testing.assert_array_equal(
        out, np.concatenate([cv2_to_comfy(f) for f in want]))


@pytest.fixture
def tiny_loader(monkeypatch):
    """The loader node with api.load_models at the tiny KEEP width."""
    load = api.load_models
    monkeypatch.setattr(api, "load_models", lambda **kw: load(
        cfg_overrides=TINY, **kw))
    return nodes.KEEP_ModelLoaderNode()


@pytest.mark.parametrize("node,args", [
    (nodes.KEEP_FaceUpscaleImageNode().upscale_face_image,
     (1.0, False, True, False)),
    (nodes.KEEP_ProcessImageSequenceNode().process_sequence,
     (1.0, False, True, False, 20))])
def test_whole_frames_without_a_detector_are_trapped(tiny_loader, capsys,
                                                     node, args):
    """Without model_rootpath the loader builds no detector, so a whole
    frame fails inside the trap, as in the JAX node: (None,), the pack
    offloaded, and the printed error names model_rootpath and the files
    the loader would read there."""
    pack, = tiny_loader.load_model_pack("KEEP", "YOLOv5n")
    assert pack.face_helper is None
    calls = _spy_offload(pack)
    assert node(_image(1, (80, 96)), pack, *args, device="cpu") == (None,)
    assert calls == [1]
    out = capsys.readouterr().out
    assert "model_rootpath" in out and "yolov5n-face.pth" in out
    assert "parsing_parsenet.pth" in out


def test_loader_with_model_rootpath_needs_the_files(tiny_loader, tmp_path):
    """A missing .pth raises FileNotFoundError naming its path; nothing is
    downloaded."""
    with pytest.raises(FileNotFoundError, match="detection_Resnet50_Final"):
        tiny_loader.load_model_pack("KEEP", "retinaface_resnet50",
                                    model_rootpath=str(tmp_path))
    det = factory.init_detection_model("retinaface_mobile0.25",
                                       require_weights=False, device="cpu")
    torch.save(det.model.state_dict(),
               tmp_path / "detection_mobilenet0.25_Final.pth")
    with pytest.raises(FileNotFoundError, match="parsing_parsenet.pth"):
        tiny_loader.load_model_pack("KEEP", "retinaface_mobile0.25",
                                    model_rootpath=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "detection_mobilenet0.25_Final.pth"]


# ---------------------------------------------------------------------------
# a whole frame through the loader's detector and parser, against JAX
# ---------------------------------------------------------------------------

FACE_CONF = 0.97          # the processor's detection threshold


def face_finding_detector(frame_bgr, seed=3):
    """A random RetinaFace-MobileNet that finds a face on `frame_bgr`
    (random weights find none): random BatchNorm statistics; the landmark
    heads' weights zero and their biases the FFHQ template about each
    prior, so every detection carries a face-shaped set of five points;
    the box heads zero (boxes are the priors); the class heads' weights
    scaled by 100, then the face logit's bias moved so that the k top
    anchors on this frame pass FACE_CONF, k in 1..4 where the gap between
    the k-th and the next margin is widest."""
    det = factory.init_detection_model("retinaface_mobile0.25",
                                       require_weights=False, seed=seed,
                                       device="cpu")
    m = det.model
    randomize_bn(m, seed + 1)
    rel = (FFHQ_TEMPLATE_512 - FFHQ_TEMPLATE_512.mean(0)) / 256
    landmark_bias = torch.as_tensor(np.tile(rel.reshape(-1) / 0.1, 2),
                                    dtype=torch.float32)   # variance 0.1
    with torch.no_grad():
        for h in m.LandmarkHead:
            h.conv1x1.weight.zero_()
            h.conv1x1.bias.copy_(landmark_bias)
        for h in m.BboxHead:
            h.conv1x1.weight.zero_()
            h.conv1x1.bias.zero_()
        for h in m.ClassHead:
            h.conv1x1.weight.mul_(100.0)
    raw = []
    hooks = [h.register_forward_hook(lambda mod, a, o: raw.append(o))
             for h in m.ClassHead]
    with torch.no_grad():
        m(m.prepare(torch.from_numpy(frame_bgr[None])))
    for h in hooks:
        h.remove()
    logits = torch.cat(raw, 1)[0].double()
    margin = np.sort((logits[:, 1] - logits[:, 0]).numpy())[::-1]
    k = 1 + int(np.argmax(margin[:4] - margin[1:5]))
    shift = np.log(FACE_CONF / (1 - FACE_CONF)) - (margin[k - 1]
                                                   + margin[k]) / 2
    with torch.no_grad():
        for h in m.ClassHead:
            h.conv1x1.bias[1::2] += shift         # the face logits
    return det, k, margin[k - 1] - margin[k]


def test_loader_node_restores_a_whole_frame_as_jax(tiny_loader, tmp_path,
                                                   monkeypatch):
    """Detector and ParseNet weights as reference-named .pth files; the
    node's pack (model_rootpath) against JAX's api with JAX's factory
    reading the same files: the detection rows, then the frame through
    the single-image node with its default widgets (only the centre face,
    factor 1) and through api.restore_image."""
    rng = np.random.default_rng(30)
    image = rng.random((1, 512, 640, 3)).astype(np.float32)
    frame = comfy_to_cv2(image)
    det, k, gap = face_finding_detector(frame)
    assert gap > 1e-3          # no near-tie at the threshold
    torch.save({"state_dict": {
        "module." + n: v for n, v in det.model.state_dict().items()
        if not n.endswith("num_batches_tracked")}},
        tmp_path / "detection_mobilenet0.25_Final.pth")
    parser = factory.init_parsing_model("parsenet", require_weights=False,
                                        seed=4, device="cpu")
    randomize_bn(parser.model, 5)
    torch.save(parser.model.state_dict(), tmp_path / "parsing_parsenet.pth")
    keep = KEEP(device="cpu", generator=torch.Generator().manual_seed(6),
                **TINY)
    with torch.no_grad():     # KEEP's code picks forced: one code for all
        keep.idx_pred_layer[0].weight.zero_()
    torch.save({"params_ema": keep.state_dict()}, tmp_path / "keep.pth")

    pack, = tiny_loader.load_model_pack(
        "KEEP", "retinaface_mobile0.25", keep_ckpt=str(tmp_path / "keep.pth"),
        model_rootpath=str(tmp_path))
    helper = pack.face_helper
    assert helper is not None and helper.use_parse
    assert all(p.device.type == "cpu" for m in pack.models()
               for p in m.parameters())
    for n, v in det.model.state_dict().items():
        assert torch.equal(helper.detector.model.state_dict()[n], v), n

    jdet = jfactory.init_detection_model("retinaface_mobile0.25",
                                         model_rootpath=str(tmp_path))
    jparse = jfactory.init_parsing_model("parsenet",
                                         model_rootpath=str(tmp_path))
    ref_rows = jdet(frame, FACE_CONF)
    rows = helper.detector(frame, FACE_CONF)
    assert len(rows) == len(ref_rows) >= 1
    np.testing.assert_allclose(rows, ref_rows, atol=1e-3, rtol=1e-4)
    jpack = japi.load_models(keep_ckpt=str(tmp_path / "keep.pth"),
                             detector=jdet, parser=jparse, use_cache=False,
                             cfg_overrides=TINY)
    monkeypatch.setenv("KEEP_TPU_NO_PHASE512", "1")
    ref = japi.restore_image(jpack, frame, 1.0, only_center_face=True)

    monkeypatch.setitem(sys.modules, "cv2", None)    # as on the card
    req = nodes.KEEP_FaceUpscaleImageNode.INPUT_TYPES()["required"]
    widgets = {k: v[1]["default"] for k, v in req.items()
               if len(v) > 1 and "default" in v[1]}
    out, = nodes.KEEP_FaceUpscaleImageNode().upscale_face_image(
        image, pack, **widgets, device="cpu")
    assert out is not None and out.shape == (1, 512, 640, 3)
    got = comfy_to_cv2(out)
    want = api.restore_image(pack, frame, 1.0, only_center_face=True,
                             device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 3 and d.mean() <= 0.05, (d.max(), d.mean())
    # a face was pasted: the frame is not the background alone
    assert not np.array_equal(got, frame)


def test_invalid_pack_and_no_card_are_trapped(pack):
    node = nodes.KEEP_FaceUpscaleImageNode()
    assert node.upscale_face_image(_image(2), object(), 1.0, True, True,
                                   False) == (None,)
    assert nodes.KEEP_ProcessImageSequenceNode().process_sequence(
        _image(2), "not a pack", 1.0, True, True, False, 20) == (None,)
    if not torch.cuda.is_available():
        # the nodes run on the card; where there is none the move fails
        # inside the trap, and the pack still ends on the host
        calls = _spy_offload(pack)
        assert node.upscale_face_image(_image(2), pack, 1.0, True, True,
                                       False) == (None,)
        assert calls == [1]
        assert next(pack.keep.parameters()).device.type == "cpu"
