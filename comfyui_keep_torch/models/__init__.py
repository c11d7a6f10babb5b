"""models of the PyTorch port. `build_network(name)` resolves an arch name
of the JAX package's ARCH_REGISTRY to the port's nn.Module class; the arch
modules register their classes when imported, and build_network imports
them all first (reference wm_basicsr/archs/__init__.py imports every
*_arch.py)."""
import importlib

from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

ARCH_MODULES = (
    "models.vqgan", "models.keep", "models.gmflow", "models.sr_basic",
    "models.parsenet", "models.retinaface", "models.vgg", "models.spynet",
    "models.discriminators", "models.sr_extra", "models.video_sr",
    "models.stylegan2", "models.swinir", "models.misc_archs",
    "models.inception", "models.hifacegan", "models.dfdnet",
    "models.stylegan2_bilinear", "models.bisenet", "facelib.yolov5face")


def build_network(name: str):
    """The port's class for arch `name`; raises KeyError listing the
    registered names if there is none."""
    for m in ARCH_MODULES:
        importlib.import_module(f"comfyui_keep_torch.{m}")
    return ARCH_REGISTRY.get(name)
