"""The port's ComfyUI nodes against the JAX package's: the same node keys,
display names and input schemas (so saved workflows load unchanged), and
the same behaviour around a call: an invalid pack gives (None,), any error
is trapped and gives (None,), and the pack is offloaded whatever happens.
On the CPU (the nodes' `device` keyword), an aligned face gives the pixels
of api.restore_image; a whole frame through a loader-made pack, which has
no detector in either package, gives (None,); ComfyUI IMAGE arrays
(B, H, W, C float32 RGB in [0, 1]) go in and come out.
"""
import numpy as np
import pytest
import torch

from comfyui_keep_tpu import nodes as jnodes
from comfyui_keep_torch import api, nodes
from comfyui_keep_torch.utils.image import comfy_to_cv2, cv2_to_comfy

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


@pytest.mark.parametrize("node,args", [
    (nodes.KEEP_FaceUpscaleImageNode().upscale_face_image,
     (1.0, False, True, False)),
    (nodes.KEEP_ProcessImageSequenceNode().process_sequence,
     (1.0, False, True, False, 20))])
def test_whole_frames_without_a_detector_are_trapped(pack, node, args):
    """The loader records no detector, so a whole frame fails inside the
    trap, as in the JAX node: (None,), and the pack offloaded."""
    calls = _spy_offload(pack)
    assert node(_image(1, (80, 96)), pack, *args, device="cpu") == (None,)
    assert calls == [1]


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
