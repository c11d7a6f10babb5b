"""PyTorch + CUDA port of comfyui_keep_tpu for NVIDIA Hopper.

Slice 1: the aligned-clip restore path (GMFlow + KEEP), with GMFlow's
attention, MLP and correlation kernels hand-written in CUDA (csrc/).
Entry points: `api.load_models`, `KEEPModelPack.processor`,
`KEEPFaceProcessor.restore_face_stream`.

Slice 2: KEEP's stage-II training step (`training/`), with the
nearest-codebook search of its ground-truth codes hand-written in CUDA
(csrc/vq.cu). Entry points: `training.trainers.build_model` /
`KEEPTrainer`, `make_state`, `train_step`.
"""
