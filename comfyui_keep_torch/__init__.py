"""PyTorch + CUDA port of comfyui_keep_tpu for NVIDIA Hopper.

Slice 1: the aligned-clip restore path (GMFlow + KEEP), with GMFlow's
attention, MLP and correlation kernels hand-written in CUDA (csrc/).
Entry points: `api.load_models`, `KEEPModelPack.processor`,
`KEEPFaceProcessor.restore_face_stream`.

Slice 2: KEEP's stage-II training step (`training/`), with the
nearest-codebook search of its ground-truth codes hand-written in CUDA
(csrc/vq.cu). Entry points: `training.trainers.build_model` /
`KEEPTrainer`, `make_state`, `train_step`.

Slice 3: StyleGAN2 (`models/stylegan2.py`, `stylegan2_bilinear.py`):
generator sampling and the StyleGAN2Model GAN alternation
(`training.trainers.StyleGAN2Trainer`), with the fused bias + leaky ReLU of
every activation hand-written in CUDA (csrc/fused_act.cu). Entry points:
`StyleGAN2Generator(...)(styles)`, `build_model({"model_type":
"StyleGAN2Model", ...})`, `make_state`, `train_step` / `gan_train_step`.

Slice 4: the phase-packed 512-level restore path (`processor(phase512=
True)`), with the packed convolution hand-written in CUDA
(csrc/packed_conv.cu), and carried-state streaming.

Slice 5: whole frames without OpenCV: RetinaFace detection, tracking,
LMedS alignment, ParseNet-masked paste-back (`facelib/`, `models/
retinaface.py`, `models/parsenet.py`, `utils/cvops.py`) and the three
ComfyUI nodes (`nodes.py`); the kernels are GMFlow's. Entry points:
`api.load_models(detector=..., parser=...)`, `api.restore_image`,
`api.restore_sequence`, `facelib.factory.init_detection_model` /
`init_parsing_model`.

Slice 6: every detector, parser and upscaler the nodes name: YOLOv5-face
(`facelib/yolov5face.py`), BiSeNet, the alignment helpers
(`facelib/align_trans.py`, `face_utils.py`, `FaceAligner`,
`retinaface.align_multi`), RRDBNet / SRVGGNetCompact / MSRResNet / EDSR /
SwinIR, ComfyUI's tiled upscale (`pipeline/tiled.py`) and `RealESRGANer`;
no new kernel. Entry points: `init_detection_model("YOLOv5l" | "YOLOv5n")`,
`init_parsing_model("bisenet")`, `pipeline.tiled.make_upscaler_fn`,
`api.load_models(bg_upscaler=..., face_upscaler=...)`.

Slice 9: KEEP stage-III training through the train loop: the VFHQ data
path without OpenCV (`data/`, `utils/png.py`), save / resume
(`training/state.py`), the rest of the losses and optimizers,
`KEEPGANTrainer` with Discriminator3D; no new kernel. Entry point:
`training.train.train_pipeline(opt)`.
"""
