"""The port's command-line tools on the CPU at small sizes:
tools/torch_train.py and tools/torch_test.py against train_pipeline /
test_pipeline on the same options, read independently (pyyaml and the JAX
package's parse_options, JAX-free code); tools/torch_train_flow.py's step,
save and --resume, its argument defaults against tools/train_flow.py's,
and its --launcher torch over two gloo ranks (subprocesses started by this
file, `python -m tests.test_torch_cli <rank> <port> <out> <chairs root>`)
against one process stepping on both ranks' batches.

The KEEP trainers run the shipped stage-II and stage-III ymls with
--force_yml overrides down to a tiny network (64^2, 2-frame clips) on one
thread, so the CLI's run and the direct run are bitwise equal.
"""
import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from comfyui_keep_tpu.utils import options as jopt
from comfyui_keep_torch.models.gmflow import GMFlow
from comfyui_keep_torch.models.vqgan import HQ_KEYS, VQHQEncoder
from comfyui_keep_torch.training import train as train_mod

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its synthetic-data writers)


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"cli_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


train_cli = load_tool("torch_train")
test_cli = load_tool("torch_test")
flow_cli = load_tool("torch_train_flow")

TINY = dict(img_size=64, nf=32, ch_mult=[1, 2, 2], res_blocks=1,
            attn_resolutions=[16], codebook_size=32, emb_dim=32, dim_embd=32,
            n_head=4, n_layers=1, latent_size=256, cft_list=["32"],
            cfa_list=[], cfa_nhead=2, cfa_dim=8, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=["32"])


def yml(name):
    return os.path.join(REPO, "options", name)


def keep_force(gt_root, meta):
    """--force_yml entries: the tiny network and the synthetic clip."""
    return ([f"network_g:{k}={v!r}" for k, v in TINY.items()]
            + [f"datasets:train:dataroot_gt={gt_root}",
               f"datasets:train:meta_info_file={meta}",
               "datasets:train:num_frame=2", "datasets:train:scale=1",
               "datasets:train:num_worker_per_gpu=0",
               "datasets:train:batch_size_per_gpu=1", "train:total_iter=2",
               "logger:print_freq=1", "logger:save_checkpoint_freq=2"])


def same_run(ours, ref, ours_root, ref_root, name):
    """Equal losses; equal saved weights, EMA and training state."""
    (st_o, logs_o), (st_r, logs_r) = ours, ref
    run_o, run_r = logs_o.pop("run"), logs_r.pop("run")
    for k in ("time", "data_time"):
        logs_o.pop(k), logs_r.pop(k)
    assert logs_o == logs_r and logs_o
    assert st_o.iter == st_r.iter == 2
    assert run_o["start_iter"] == run_r["start_iter"] == 0
    exp_o = os.path.join(ours_root, "experiments", name)
    exp_r = os.path.join(ref_root, "experiments", name)
    assert os.listdir(os.path.join(exp_o, "models")) == ["net_g_2.pth"]
    a = torch.load(os.path.join(exp_o, "models", "net_g_2.pth"),
                   weights_only=True)
    b = torch.load(os.path.join(exp_r, "models", "net_g_2.pth"),
                   weights_only=True)
    assert a.keys() == b.keys()
    for group in a:
        assert a[group].keys() == b[group].keys()
        for k, v in a[group].items():
            assert torch.equal(v, b[group][k]), (group, k)
    assert os.listdir(os.path.join(exp_o, "training_states")) == ["2.state"]


def frozen_nets(root, hq_seed):
    """The frozen VQHQEncoder (seeded `hq_seed`) and GMFlow (seed 2) of a
    KEEP trainer, saved under `root` as .pth files; (nets, --force_yml
    entries naming the files)."""
    hq = VQHQEncoder(**{k: TINY[k] for k in HQ_KEYS}, device="cpu",
                     generator=torch.Generator().manual_seed(hq_seed))
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(2))
    hq_path, flow_path = (os.path.join(root, "vqgan.pth"),
                          os.path.join(root, "gmflow.pth"))
    torch.save({"params_ema": hq.state_dict()}, hq_path)
    torch.save({"params": gm.state_dict()}, flow_path)
    return {"hq_vqgan": hq, "gmflow": gm}, [
        f"path:pretrain_network_hq={hq_path}",
        f"path:pretrain_network_flow={flow_path}"]


def test_train_cli_stage2_equals_train_pipeline(tmp_path):
    """options/train_keep_stage2.yml through tools/torch_train.py: the
    VQHQEncoder and GMFlow from the .pth files at path.pretrain_network_hq
    and path.pretrain_network_flow; the same as train_pipeline, given the
    same nets, on the options pyyaml and the JAX package's parse_options
    give for the same argv."""
    gt_root, meta = chip_smoke.write_vfhq_clip(str(tmp_path), 4, 64)
    nets, paths = frozen_nets(str(tmp_path), 5)
    argv = ["-opt", yml("train_keep_stage2.yml"), "--force_yml",
            *keep_force(gt_root, meta), *paths]
    ours = train_cli.main(argv + ["--device", "cpu"],
                          root_path=str(tmp_path / "cli"))
    opt, _ = jopt.parse_options(str(tmp_path / "ref"), True, argv)
    ref = train_mod.train_pipeline(opt, trainer_kwargs={"device": "cpu",
                                                        **nets})
    same_run(ours, ref, str(tmp_path / "cli"), str(tmp_path / "ref"),
             "keep_stage2")


def test_train_cli_stage3_yml_equals_train_pipeline(tmp_path):
    """options/train_keep_stage3_gan.yml with --force_yml overrides (the
    tiny network, D at nf 8, the dataset's scale 1, the frozen nets' .pth
    files: VQHQEncoder from seed 1, GMFlow from 2, as chip_smoke.py's
    train_gan phase saves them) through tools/torch_train.py, against
    train_pipeline given the same nets."""
    gt_root, meta = chip_smoke.write_vfhq_clip(str(tmp_path), 4, 64)
    nets, paths = frozen_nets(str(tmp_path), 1)
    argv = ["-opt", yml("train_keep_stage3_gan.yml"), "--force_yml",
            *keep_force(gt_root, meta), "network_d:args={'nf': 8}", *paths]
    ours = train_cli.main(argv + ["--device", "cpu"],
                          root_path=str(tmp_path / "cli"))
    opt, _ = jopt.parse_options(str(tmp_path / "ref"), True, argv)
    ref = train_mod.train_pipeline(opt, trainer_kwargs={"device": "cpu",
                                                        **nets})
    assert {"l_g_gan", "l_d"} <= ours[1].keys()
    same_run(ours, ref, str(tmp_path / "cli"), str(tmp_path / "ref"),
             "keep_stage3_gan")


def test_keep_cli_needs_its_frozen_nets(tmp_path):
    """Without a .pth for the VQHQEncoder and GMFlow, a KEEP yml raises
    naming the options; a named .pth that is missing raises too; the
    files load into the trainer's frozen nets."""
    argv = ["-opt", yml("train_keep_stage3_gan.yml"), "--device", "cpu"]
    with pytest.raises(ValueError, match="pretrain_network_hq and "
                                         "path.pretrain_network_flow"):
        train_cli.main(argv, root_path=str(tmp_path))
    stage2 = ["-opt", yml("train_keep_stage2.yml"), "--device", "cpu"]
    with pytest.raises(ValueError, match="needs path.pretrain_network_flow "
                                         r"\(a .pth each\)"):
        train_cli.main(stage2, root_path=str(tmp_path))
    nets, paths = frozen_nets(str(tmp_path), 1)
    with pytest.raises(FileNotFoundError, match="vqgan_code1024"):
        train_cli.main(stage2 + ["--force_yml", paths[1]],
                       root_path=str(tmp_path))
    opt, _ = jopt.parse_options(str(tmp_path), True, [
        "-opt", yml("train_keep_stage3_gan.yml"), "--force_yml",
        *[f"network_g:{k}={v!r}" for k, v in TINY.items()], *paths])
    got = train_cli.aux_nets(opt)
    for name, net in nets.items():
        live = got[name].state_dict()
        assert live.keys() == net.state_dict().keys()
        assert all(torch.equal(live[k], v)
                   for k, v in net.state_dict().items()), name


def test_test_cli_equals_test_pipeline(tmp_path):
    """options/test_keep.yml (MSRResNet narrowed to 16 / 2) through
    tools/torch_test.py: the metrics and the saved images of test_pipeline
    on the same options."""
    lq, gt = chip_smoke.write_sr_pairs(str(tmp_path / "pairs"), 2, 16)
    force = ["network_g:num_feat=16", "network_g:num_block=2",
             f"datasets:test_1:dataroot_lq={lq}",
             f"datasets:test_1:dataroot_gt={gt}", "val:save_img=true"]
    opt, _ = jopt.parse_options(str(tmp_path / "ref"), False,
                                ["-opt", yml("test_keep.yml"),
                                 "--force_yml", *force])
    from comfyui_keep_torch.training.trainers import build_model
    pth = str(tmp_path / "net_g.pth")
    net = build_model(opt, device="cpu").init_model()
    torch.save({"params": net.state_dict()}, pth)
    force.append(f"path:pretrain_network_g={pth}")
    argv = ["-opt", yml("test_keep.yml"), "--force_yml", *force]
    ours = test_cli.main(argv + ["--device", "cpu"],
                         root_path=str(tmp_path / "cli"))
    opt, _ = jopt.parse_options(str(tmp_path / "ref"), False, argv)
    ref = train_mod.test_pipeline(opt, trainer_kwargs={"device": "cpu"})
    assert ours == ref and np.isfinite(ours["demo"]["psnr"])
    vis = [os.path.join(str(tmp_path / d), "results", "keep_test",
                        "visualization", "demo") for d in ("cli", "ref")]
    assert sorted(os.listdir(vis[0])) == sorted(os.listdir(vis[1])) == [
        "0000_keep_test.png", "0001_keep_test.png"]
    for f in os.listdir(vis[0]):
        with open(os.path.join(vis[0], f), "rb") as a, \
                open(os.path.join(vis[1], f), "rb") as b:
            assert a.read() == b.read()


def test_train_flow_cli_steps_saves_and_resumes(tmp_path):
    """tools/torch_train_flow.py on a synthetic FlyingChairs directory (64^2
    crops, B = 2, 10 steps over two epochs): finite losses, one save at the
    last step holding the trained weights, and --resume of that file
    giving those weights back."""
    root = chip_smoke.write_chairs(str(tmp_path / "chairs"), 12, (96, 128))
    ckpt = str(tmp_path / "ckpt")
    argv = ["--chairs_root", root, "--image_size", "64", "64",
            "--batch_size", "2", "--num_steps", "10", "--save_freq", "10",
            "--summary_freq", "5", "--checkpoint_dir", ckpt, "--device",
            "cpu"]
    _, state, run = flow_cli.main(argv)
    assert state.iter == 10 and len(run["logs"]) == 10
    assert all(np.isfinite(v) for lg in run["logs"] for v in lg.values())
    path = os.path.join(ckpt, "gmflow_chairs_10.pth")
    assert run["saved"] == [path] and os.listdir(ckpt) == [
        "gmflow_chairs_10.pth"]
    saved = torch.load(path, weights_only=True)["params"]
    live = state.model.state_dict()
    assert saved.keys() == live.keys()
    assert all(torch.equal(saved[k], v) for k, v in live.items())
    _, fresh = flow_cli.setup(flow_cli.parse_args(argv))
    assert not all(torch.equal(saved[k], v)
                   for k, v in fresh.model.state_dict().items())
    _, resumed = flow_cli.setup(flow_cli.parse_args(argv + ["--resume",
                                                            path]))
    assert all(torch.equal(saved[k], v)
               for k, v in resumed.model.state_dict().items())


def test_train_flow_defaults_equal_jax(monkeypatch):
    """The arguments and defaults of tools/train_flow.py, plus --device,
    --num_workers and --launcher; the trainer's options as the JAX tool
    builds them."""
    jtool = load_tool("train_flow")
    monkeypatch.setattr(sys, "argv", ["train_flow.py"])
    ref = vars(jtool.parse_args())
    ours = vars(flow_cli.parse_args([]))
    assert set(ours) - set(ref) == {"device", "num_workers", "launcher"}
    assert {k: ours[k] for k in ref} == ref
    assert (ours["device"], ours["num_workers"], ours["launcher"]) == (
        "cuda", 0, "none")
    opt = flow_cli.flow_opt(flow_cli.parse_args([]))
    assert opt == {"model_type": "GMFlowModel",
                   "network_g": {"attn_splits": 2, "corr_radius": -1,
                                 "prop_radius": -1},
                   "train": {"lr": 4e-4, "weight_decay": 1e-4,
                             "grad_clip": 1.0, "gamma": 0.9,
                             "num_steps": 100000}}


# -- the flow CLI over two gloo ranks -----------------------------------------

# the data-parallel gradient against one process's on the whole batch:
# the same sums in another order (each rank's backward, then the mean over
# the ranks), f32; the absolute part relative to the largest gradient
# element of the net (a bias ahead of a norm layer has a gradient of
# rounding noise alone); both sides on one thread, the largest difference
# reads 0.46 of this limit
FLOW_DP_RTOL, FLOW_DP_ATOL = 1e-4, 1e-6
FLOW_CHILD_TIMEOUT = 300


def flow_dp_argv(root, ckpt):
    """10 steps (the schedule's least) at the global batch of 2 (one pair
    a rank), saved at the last."""
    return ["--chairs_root", root, "--image_size", "64", "64",
            "--batch_size", "2", "--num_steps", "10", "--save_freq", "10",
            "--summary_freq", "5", "--checkpoint_dir", ckpt, "--device",
            "cpu"]


def first_step(trainer):
    """{"batch": the first step's batch, "grads": {name: the gradient the
    optimizer applies at it (after the mean over the ranks, before the
    clip)}}, filled as the trainer takes that step."""
    first, clip, step = {}, trainer.before_step, trainer.train_step

    def before_step(state):
        if "grads" not in first:
            first["grads"] = {n: p.grad.detach().clone()
                              for n, p in state.model.named_parameters()}
        clip(state)

    def train_step(state, batch):
        first.setdefault("batch", batch)
        return step(state, batch)
    trainer.before_step, trainer.train_step = before_step, train_step
    return first


def flow_child(rank, port, out, root):
    """One rank of the two-rank flow CLI run: torchrun's environment, then
    setup and train; the gradient, weights and batch to out/flow<rank>.npz,
    the run's facts on the last line of stdout."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    args = flow_cli.parse_args(flow_dp_argv(root, os.path.join(out, "ckpt"))
                               + ["--launcher", "torch"])
    trainer, state = flow_cli.setup(args)
    first = first_step(trainer)
    run = flow_cli.train(args, trainer, state)
    arrays = {**{f"g.{k}": v.numpy() for k, v in first["grads"].items()},
              **{f"w.{k}": v.numpy()
                 for k, v in state.model.state_dict().items()},
              **{f"b.{k}": v.numpy() for k, v in first["batch"].items()}}
    np.savez(os.path.join(out, f"flow{rank}.npz"), **arrays)
    print(json.dumps({"logs": run["logs"], "saved": run["saved"],
                      "data": trainer.mesh.size("data"),
                      "local": trainer.batch_is_local}))


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_train_flow_cli_two_ranks_equal_one_process(tmp_path):
    """--launcher torch over two gloo ranks at a global batch of 2, 10
    steps: a ("data",) mesh of 2; at the first step one pair a rank and
    not the same pair, the averaged gradient equal on both ranks and,
    within FLOW_DP_RTOL / FLOW_DP_ATOL of the net's largest element, to one
    process's gradient on the two ranks' pairs as one batch, the logged
    losses (the mean over the ranks) that process's; every step's logs
    and the final weights the same on both ranks; one save, rank 0's."""
    root = chip_smoke.write_chairs(str(tmp_path / "chairs"), 12, (96, 128))
    out = str(tmp_path)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_cli", str(r), str(port),
         out, root], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=env) for r in range(2)]
    results = []
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=FLOW_CHILD_TIMEOUT)
            assert p.returncode == 0, f"rank {r}:\n{stdout}\n{stderr[-4000:]}"
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [np.load(os.path.join(out, f"flow{r}.npz")) for r in (0, 1)]
    assert [r["data"] for r in results] == [2, 2]
    assert all(r["local"] for r in results)
    assert results[0]["logs"] == results[1]["logs"]
    ckpt = os.path.join(out, "ckpt")
    assert results[0]["saved"] == [os.path.join(ckpt,
                                                "gmflow_chairs_10.pth")]
    assert results[1]["saved"] == [] and os.listdir(ckpt) == [
        "gmflow_chairs_10.pth"]
    assert len(results[0]["logs"]) == 10
    names = sorted(k for k in ranks[0].files)
    assert ranks[0]["b.img1"].shape == (1, 64, 64, 3)
    assert not np.array_equal(ranks[0]["b.img1"], ranks[1]["b.img1"])
    for k in names:
        if not k.startswith("b."):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                          err_msg=k)
    # one process on both ranks' pairs, from the same seeded weights
    batch = {k[2:]: torch.from_numpy(np.concatenate([ranks[0][k],
                                                     ranks[1][k]]))
             for k in names if k.startswith("b.")}
    trainer, state = flow_cli.setup(flow_cli.parse_args(
        flow_dp_argv(root, os.path.join(out, "one"))))
    first = first_step(trainer)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # as the ranks run
    try:
        state, logs = trainer.train_step(state, batch)
    finally:
        torch.set_num_threads(threads)
    grads = first["grads"]
    for k, v in logs.items():
        np.testing.assert_allclose(results[0]["logs"][0][k], v,
                                   rtol=FLOW_DP_RTOL)
    assert grads.keys() == {k[2:] for k in names if k.startswith("g.")}
    scale = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        np.testing.assert_allclose(ranks[0][f"g.{k}"], g.numpy(),
                                   rtol=FLOW_DP_RTOL,
                                   atol=FLOW_DP_ATOL * scale, err_msg=k)


def test_clis_default_to_the_card(tmp_path):
    """--device defaults to cuda, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main(["-opt", yml("test_keep.yml")],
                      root_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["-opt", yml("train_keep_stage3_gan.yml")],
                       root_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow_cli.setup(flow_cli.parse_args([]))


if __name__ == "__main__":
    flow_child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
