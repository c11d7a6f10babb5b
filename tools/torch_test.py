#!/usr/bin/env python3
"""Test entry point of the PyTorch port (the counterpart of tools/test.py;
reference wm_basicsr/test.py's CLI):

  python tools/torch_test.py -opt options/test_keep.yml [--device cuda|cpu] \
      [--force_yml path:pretrain_network_g=net_g.pth]

The options go through the port's parse_options (no pyyaml); test_pipeline
runs the network (path.pretrain_network_g: a .pth) through every test* /
val* dataset on --device (default cuda; it raises without a card) and logs
its metrics; results/<name>/visualization holds the images with
val.save_img.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, root_path=None):
    """Parse argv (sys.argv[1:] by default) and test; the results go under
    root_path (the working directory by default)/results/<name>. Returns
    test_pipeline's {dataset: {metric: value}}."""
    from comfyui_keep_torch.training import train as train_mod
    from comfyui_keep_torch.utils.options import parse_options
    opt, args = parse_options(root_path or os.getcwd(), is_train=False,
                              args=argv)
    return train_mod.test_pipeline(opt, trainer_kwargs={"device": args.device})


if __name__ == "__main__":
    main()
