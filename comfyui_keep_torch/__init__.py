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
"""
