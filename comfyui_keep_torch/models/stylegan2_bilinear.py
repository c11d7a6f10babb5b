"""StyleGAN2 bilinear variant (reference archs/stylegan2_bilinear_arch.py,
the GFPGAN family's face prior), ported from
comfyui_keep_tpu/models/stylegan2_bilinear.py: the parameters and
state_dict names of StyleGAN2Generator, with bilinear up-sampling
(ops/resample.py resize_bilinear) before a plain modulated conv and for the
ToRGB skip, instead of the FIR."""
from comfyui_keep_torch.models.stylegan2 import StyleGAN2Generator
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


@ARCH_REGISTRY.register()
class StyleGAN2GeneratorBilinear(StyleGAN2Generator):
    bilinear = True
