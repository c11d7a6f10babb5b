#!/usr/bin/env python3
"""Training entry point of the PyTorch port (the counterpart of
tools/train.py; reference wm_basicsr/train.py's CLI):

  python tools/torch_train.py -opt options/train_keep_stage2.yml \
      [--device cuda|cpu] [--auto_resume] [--debug] [--launcher torch] \
      [--force_yml train:total_iter=100] [--seed N]

The options go through comfyui_keep_torch/utils/options.py:parse_options
(the port's own YAML reader: no pyyaml), then train_pipeline runs on
--device (default cuda; it raises without a card). Under torchrun,
--launcher torch joins the process group and training goes data-parallel.

KEEP's trainers (KEEPModel, KEEPGANModel) take two frozen nets besides the
options: the VQHQEncoder that gives the ground-truth codes, from the .pth
at path.pretrain_network_hq (its encoder.* and quantize.* entries), and
GMFlow, from the GMFlow state dict at path.pretrain_network_flow (.pth;
params_ema or params unwrapped).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEEP_MODELS = ("KEEPModel", "KEEPGANModel")


def _state_dict(path):
    """The state dict in the .pth at `path` (params_ema preferred)."""
    from comfyui_keep_torch.utils.convert import read_pth
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return read_pth(path)


def aux_nets(opt):
    """{"hq_vqgan", "gmflow"} for a KEEP trainer's options (on the CPU; the
    trainer moves them), {} for any other model type."""
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.keep import config
    from comfyui_keep_torch.models.vqgan import HQ_KEYS, VQHQEncoder
    if opt.get("model_type") not in KEEP_MODELS:
        return {}
    paths = opt.get("path", {})
    net = {k: v for k, v in opt["network_g"].items()
           if k not in ("type", "fix_modules")}
    cfg = config(net.pop("variant", "KEEP"), **net)
    hq_path, flow_path = (paths.get("pretrain_network_hq"),
                          paths.get("pretrain_network_flow"))
    missing = [k for k, p in (("path.pretrain_network_hq", hq_path),
                              ("path.pretrain_network_flow", flow_path))
               if not p]
    if missing:
        raise ValueError(f"{opt['model_type']} needs {' and '.join(missing)}"
                         " (a .pth each)")
    hq = VQHQEncoder(**{k: cfg[k] for k in HQ_KEYS}, device="cpu")
    sd = _state_dict(hq_path)
    hq.load_state_dict({k: sd[k] for k in hq.state_dict()})
    gm = GMFlow(device="cpu")
    gm.load_state_dict(_state_dict(flow_path))
    return {"hq_vqgan": hq, "gmflow": gm}


def main(argv=None, root_path=None):
    """Parse argv (sys.argv[1:] by default) and train. The experiment goes
    under root_path (the working directory by default)/experiments/<name>.
    Returns train_pipeline's (state, logs)."""
    from comfyui_keep_torch.training.train import train_pipeline
    from comfyui_keep_torch.utils.options import parse_options
    opt, args = parse_options(root_path or os.getcwd(), is_train=True,
                              args=argv)
    kw = {"device": args.device, **aux_nets(opt)}
    return train_pipeline(opt, trainer_kwargs=kw)


if __name__ == "__main__":
    main()
