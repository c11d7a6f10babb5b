"""The port's parallel layer (comfyui_keep_torch/parallel/) on the CPU.

World 1, against the JAX package at tests/test_parallel.py's tiny KEEP:
restore_chunks_parallel against JAX's with mesh=None, ragged tail
included, within KEEP's golden tolerances 5e-3 / 1e-2 (and bit for bit
against the processor's own chunk body on the whole chunks and on the
padded tail), and the carried-state ring against JAX's
restore_stream_pipeline on a one-device "seq" mesh, within the same
tolerances, and against the port's own streaming bit for bit.

Then one two-rank and one four-rank gloo run (and train_pipeline over
the two ranks), each in subprocesses started
by this file (`python tests/test_torch_parallel.py <world> <rank> <port>
<out>`), each subprocess with its own time limit: the data-parallel SR
step against the one-process step on the whole batch within 1e-6 relative
/ 1e-7, and so two StyleGAN2 alternations (their draws each rank's rows of
the whole batch's) and the Real-ESRGAN feed's per-rank seeds; the
chunk-parallel restore at two ranks against one rank bit for
bit; the ring at two ranks against carried streaming on one process bit
for bit; the tensor-parallel KEEPTrainer step on a (1, 2) mesh, and the
data x tensor one on (2, 2), against the unsharded step within the JAX
test's 2e-4 / 2e-5: the losses, every gradient the optimizer applies and
the split parameters after the Adam step (_tp_check says why not the
others).
"""
import contextlib
import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from comfyui_keep_torch.models.gmflow import GMFlow  # noqa: E402
from comfyui_keep_torch.models.keep import KEEP  # noqa: E402
from comfyui_keep_torch.models.stylegan2 import \
    StyleGAN2Discriminator  # noqa: E402
from comfyui_keep_torch.models.vqgan import VQHQEncoder  # noqa: E402
from comfyui_keep_torch.parallel import (  # noqa: E402
    broadcast_module, get_dist_info, init_distributed, make_mesh,
    reduce_loss_dict, restore_chunks_parallel, restore_stream_pipeline,
    shard_batch)
from comfyui_keep_torch.parallel.tensor import (  # noqa: E402
    shard_params, tp_param_specs)
from comfyui_keep_torch.pipeline.processor import \
    KEEPFaceProcessor  # noqa: E402
from comfyui_keep_torch.training.trainers import (  # noqa: E402
    KEEPTrainer, RealESRNetTrainer, SRTrainer, StyleGAN2Trainer)

KEEP_TOL = dict(atol=5e-3, rtol=1e-2)
DP_TOL = dict(rtol=1e-6, atol=1e-7)
TP_TOL = dict(rtol=2e-4, atol=2e-5)
CHILD_TIMEOUT = 120

# tests/test_parallel.py's chunk-parallel KEEP and its ring KEEP
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=1,
            attn_resolutions=(16,), codebook_size=32, emb_dim=32,
            dim_embd=32, n_head=4, n_layers=1, latent_size=256,
            cft_list=("32",), cfa_list=(), cfa_nhead=2, cfa_dim=8,
            kalman_attn_head_dim=8, num_uncertainty_layers=1,
            temp_reg_list=())
RING = dict(img_size=64, nf=32, ch_mult=(1, 2), res_blocks=1,
            attn_resolutions=(32,), codebook_size=32, emb_dim=32,
            dim_embd=32, n_head=4, n_layers=1, latent_size=1024,
            cft_list=("64",), cfa_list=("32",), cfa_nhead=2, cfa_dim=8,
            kalman_attn_head_dim=8, num_uncertainty_layers=1,
            temp_reg_list=())
SR_OPT = {"model_type": "SRModel", "manual_seed": 0,
          "network_g": {"type": "MSRResNet", "num_feat": 8, "num_block": 1,
                        "upscale": 2},
          "train": {"pixel_opt": {"type": "L1Loss"},
                    "optim_g": {"type": "Adam", "lr": 1e-3}}}
KEEP_OPT = {"model_type": "KEEPModel", "manual_seed": 0,
            "network_g": {"type": "KEEP", **RING,
                          "fix_modules": ["quantize", "generator"]},
            "train": {"use_hq_feat_loss": True, "cross_entropy_loss": True,
                      "entropy_loss_weight": 0.5,
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "optim_g": {"type": "Adam", "lr": 1e-3},
                      "ema_decay": 0.99}}

# tests/test_torch_stylegan2.py's narrow G at 32^2; R1 every 2nd iteration,
# the path penalty (not a mean over samples) never in iterations 1-2
SG2_OPT = {"model_type": "StyleGAN2Model", "manual_seed": 0,
           "network_g": {"out_size": 32, "num_style_feat": 16, "num_mlp": 2,
                         "channel_multiplier": 1, "narrow": 0.25},
           "network_d": {"out_size": 32, "channel_multiplier": 1},
           "train": {"optim_g": {"lr": 2e-3}, "optim_d": {"lr": 2e-3},
                     "net_d_reg_every": 2, "net_g_reg_every": 3}}


@contextlib.contextmanager
def one_thread():
    """torch on one thread within the block, as the ranks run: CPU
    reductions split over threads round otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def seeded(cls, seed, **cfg):
    return cls(device="cpu", generator=torch.Generator().manual_seed(seed),
               **cfg)


def processor(cfg, gmflow=False):
    return KEEPFaceProcessor(
        seeded(KEEP, 0, **cfg),
        seeded(GMFlow, 1, num_layers=1) if gmflow else None, device="cpu")


def faces(n=5):
    return (np.random.default_rng(0).random((n, 64, 64, 3), np.float32)
            - 0.5)


def ring_clips(n_clips=2, t=4):
    return (np.random.default_rng(1).standard_normal(
        (n_clips, 1, t, 64, 64, 3)).astype(np.float32) * 0.3)


def sr_batch():
    rng = np.random.default_rng(2)
    return {"lq": torch.from_numpy(rng.random((4, 8, 8, 3), np.float32)),
            "gt": torch.from_numpy(rng.random((4, 16, 16, 3), np.float32))}


def keep_batch():
    rng = np.random.default_rng(3)
    return {k: torch.from_numpy(rng.random((2, 2, 64, 64, 3), np.float32)
                                - 0.5) for k in ("lq", "gt")}


def hq_encoder():
    return seeded(VQHQEncoder, 4, **{k: RING[k] for k in (
        "img_size", "nf", "ch_mult", "res_blocks", "attn_resolutions",
        "codebook_size", "emb_dim")})


def carried_streaming(proc, clips, n_chunks):
    """Each clip through the processor's carried chunk loop, one process."""
    out = []
    for clip in clips[:, 0]:
        tc = clip.shape[0] // n_chunks
        res, carry = proc.restore_clip(clip[:tc], return_carry=True)
        parts = [res]
        for d in range(1, n_chunks):
            res, carry = proc.restore_clip(
                clip[d * tc:(d + 1) * tc], carry, clip[d * tc - 1],
                return_carry=True)
            parts.append(res)
        out.append(np.concatenate(parts)[None])
    return np.stack(out)


def sg2_batch():
    rng = np.random.default_rng(5)
    return {"gt": torch.from_numpy(rng.random((4, 3, 32, 32), np.float32)
                                   - 0.5)}


def sg2_steps(mesh=None):
    """Alternations 1 (D and G) and 2 (D, R1 and G) of a StyleGAN2Trainer
    on sg2_batch(): (state, [each alternation's losses], [the gradients of
    each optimizer step, after the data group's mean]). Its discriminator
    takes the minibatch-stddev channel over groups of one sample: over
    larger groups the channel couples the samples of a rank's batch, and a
    rank's groups are not one process's (as in the reference's DDP)."""
    tr = StyleGAN2Trainer(copy.deepcopy(SG2_OPT), device="cpu", mesh=mesh)
    grads = []
    sync = tr.sync_grads

    def record(params):
        sync(params)
        grads.append([p.grad.clone() for p in params])
    tr.sync_grads = record
    state = tr.make_state(disc=StyleGAN2Discriminator(
        32, channel_multiplier=1, stddev_group=1, device="cpu",
        generator=torch.Generator().manual_seed(99)))
    logs = []
    for it in (1, 2):
        state, lg = tr.gan_train_step(state, sg2_batch(), current_iter=it)
        logs.append(reduce_loss_dict(lg, mesh))
    return state, logs, grads


def keep_step(mesh=None):
    """One KEEPTrainer step on keep_batch(): (state, logs, {name: the
    gradient the optimizer applied})."""
    tr = KEEPTrainer(copy.deepcopy(KEEP_OPT), hq_vqgan=hq_encoder(),
                     device="cpu", mesh=mesh)
    grads = {}
    tr.before_step = lambda st: grads.update(
        (n, p.grad.clone()) for n, p in st.model.named_parameters()
        if p.grad is not None)
    state = tr.make_state()
    state, logs = tr.train_step(state, keep_batch())
    return state, logs, grads


def violation(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)): <= 0 where allclose."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


# ---------------------------------------------------------------------------
# the subprocess side
# ---------------------------------------------------------------------------

def write_pairs(root, n=4):
    """n PNG pairs, GT 16^2 and LQ 8^2, in root/gt and root/lq."""
    from comfyui_keep_torch.utils import png
    rng = np.random.default_rng(5)
    for sub, size in (("gt", 16), ("lq", 8)):
        os.makedirs(os.path.join(root, sub))
        for i in range(n):
            png.imwrite_bgr(os.path.join(root, sub, f"{i:03d}.png"),
                            rng.integers(0, 256, (size, size, 3), np.uint8))
    return os.path.join(root, "lq"), os.path.join(root, "gt")


def pipeline_opt(root):
    lq, gt = os.path.join(root, "lq"), os.path.join(root, "gt")
    exp = os.path.join(root, "exp")
    return {**copy.deepcopy(SR_OPT), "name": "dp", "is_train": True,
            "datasets": {"train": {
                "type": "PairedImageDataset", "dataroot_lq": lq,
                "dataroot_gt": gt, "scale": 2, "phase": "train",
                "gt_size": 8, "batch_size_per_gpu": 2}},
            "logger": {"print_freq": 1, "save_checkpoint_freq": 2},
            "path": {"experiments_root": exp,
                     "models": os.path.join(exp, "models"),
                     "training_states": os.path.join(exp, "states"),
                     "log": exp}}


def _tp_check(mesh, res, prefix):
    """The (data x) tensor-parallel KEEP step on `mesh` against the
    unsharded one on the whole batch, as worst allclose violations: the
    losses, every gradient the optimizer applies (this rank's slice of a
    split one), and the split parameters after the Adam step. The other
    parameters after Adam are left out: where a gradient is near Adam's
    eps, g / (|g| + eps) turns a rounding difference of g into one of the
    update (two conv-bias entries of this run)."""
    st, logs, grads = keep_step(mesh)
    logs = reduce_loss_dict(logs, mesh)
    st0, logs0, grads0 = keep_step(None)
    split = sorted(k for k, d in tp_param_specs(
        st0.model, mesh.size("model")).items() if d is not None)

    def sliced(tensors):
        model = copy.deepcopy(st0.model)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in tensors:
                    p.copy_(tensors[n])
        return dict(shard_params(model, mesh).named_parameters())

    want_g = sliced(grads0)
    want_p = sliced(dict(st0.model.named_parameters()))
    got = dict(st.model.named_parameters())
    res[prefix + "logs"] = max(violation(logs[k], logs0[k], **TP_TOL)
                               for k in logs0)
    res[prefix + "grads"] = max(
        violation(g.numpy(), want_g[n].detach().numpy(), **TP_TOL)
        for n, g in grads.items())
    res[prefix + "params"] = max(
        violation(got[k].detach().numpy(), want_p[k].detach().numpy(),
                  **TP_TOL) for k in split)
    res[prefix + "split"] = split
    res[prefix + "local_shapes_differ"] = all(
        got[k].shape != grads0[k].shape for k in split)


def _contiguity_check(res):
    """NCCL takes contiguous tensors only (gloo copies others itself, so
    the CPU ranks never see the strided gradients a card's backward can
    give): all_reduce_ and broadcast_module must hand a strided tensor to
    torch.distributed as a contiguous copy and write the result back."""
    import torch.distributed as dist
    from comfyui_keep_torch.parallel.mesh import all_reduce_
    seen = []

    def strict(fn):
        def call(t, *a, **k):
            seen.append(t.is_contiguous())
            return fn(t, *a, **k)
        return call
    saved = dist.all_reduce, dist.broadcast
    dist.all_reduce, dist.broadcast = (strict(f) for f in saved)
    try:
        t = torch.arange(12.0).reshape(3, 4).t()
        all_reduce_(t)
        lin = torch.nn.Linear(4, 3)
        with torch.no_grad():
            lin.weight.data = lin.weight.data.t().contiguous().t()
            lin.weight.fill_(float(dist.get_rank() + 1))
        broadcast_module(lin)
    finally:
        dist.all_reduce, dist.broadcast = saved
    res["contiguous"] = {"all": all(seen), "calls": len(seen),
                         "reduced": t.tolist(),
                         "broadcast": lin.weight.unique().tolist()}


def child(world: int, rank: int, port: int, out: str):
    torch.set_num_threads(1)
    got = init_distributed(device="cpu", world_size=world, rank=rank,
                           init_method=f"tcp://127.0.0.1:{port}")
    res = {"rank_world": list(got)}
    if world == 2:
        mesh = make_mesh()
        res["reduced"] = reduce_loss_dict({"b": 2.0 * rank, "a": rank + 1.0})
        _contiguity_check(res)
        tr = SRTrainer(copy.deepcopy(SR_OPT), device="cpu", mesh=mesh)
        st = tr.make_state()
        st, logs = tr.train_step(st, sr_batch())
        res["sr_logs"] = reduce_loss_dict(logs, mesh)
        np.savez(os.path.join(out, f"sr{rank}.npz"),
                 **{k: v.numpy() for k, v in st.model.state_dict().items()})
        st, res["sg2_logs"], grads = sg2_steps(mesh)
        tr = StyleGAN2Trainer(copy.deepcopy(SG2_OPT), device="cpu",
                              mesh=mesh)
        dr = tr.draw(3, 2, tr.init_model())
        res["sg2_draw_rows"] = {
            k: (v if torch.is_tensor(v) else v[0]).flatten()[:8].tolist()
            for k, v in dr.items()}
        np.savez(os.path.join(out, f"sg2_{rank}.npz"),
                 **{f"{i}.{j}": g.numpy() for i, gs in enumerate(grads)
                    for j, g in enumerate(gs)})
        feed = RealESRNetTrainer({**copy.deepcopy(SR_OPT),
                                  "model_type": "RealESRNetModel"},
                                 device="cpu", mesh=mesh)
        res["feed"] = [feed._feed_seed, feed.py_rng.random(),
                       float(feed.np_rng.random_sample())]
        with torch.no_grad():
            np.save(os.path.join(out, f"chunks{rank}.npy"),
                    restore_chunks_parallel(processor(TINY), faces(), 2,
                                            mesh))
            np.save(os.path.join(out, f"ring{rank}.npy"),
                    restore_stream_pipeline(processor(RING, gmflow=True),
                                            ring_clips(),
                                            make_mesh(axes=("seq",))))
        _tp_check(make_mesh(("data", "model"), (1, 2)), res, "tp_")
        from comfyui_keep_torch.training import train as train_mod
        st, logs = train_mod.train_pipeline(
            pipeline_opt(os.path.join(out, "pipe")), max_iters=2,
            trainer_kwargs={"device": "cpu"})
        tr = logs["run"]["trainer"]
        res["pipe"] = {"iter": st.iter, "l_pix": logs["l_pix"],
                       "data": tr.mesh.size("data"),
                       "local": tr.batch_is_local,
                       "batch": list(logs["run"]["batch"]["lq"].shape)}
        np.save(os.path.join(out, f"pipe{rank}.npy"),
                next(iter(st.model.parameters())).detach().numpy())
    else:
        _tp_check(make_mesh(("data", "model"), (2, 2)), res, "dtp_")
    print(json.dumps(res))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, out: str):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(world), str(r),
         str(port), out], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=env) for r in range(world)]
    results = []
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, f"rank {r}:\n{stdout}\n{stderr[-4000:]}"
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("two_ranks"))
    write_pairs(os.path.join(out, "pipe"))
    return run_ranks(2, out), out


# ---------------------------------------------------------------------------
# world 1
# ---------------------------------------------------------------------------

def test_world_one_mesh_forms(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == get_dist_info() == (0, 1)
    mesh = make_mesh(("data", "model"))
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group("data") is None and mesh.index("model") == 0
    with pytest.raises(ValueError, match="holds 2 ranks"):
        make_mesh(shape=(2,))
    assert reduce_loss_dict({"b": torch.tensor(2.5), "a": 1}) == {
        "a": 1.0, "b": 2.5}
    batch = sr_batch()
    assert shard_batch(batch, mesh) is batch
    keep = seeded(KEEP, 0, **RING)
    assert broadcast_module(keep, mesh) is keep
    specs = tp_param_specs(keep, 2)
    split = {k: d for k, d in specs.items() if d is not None}
    assert split["ft_layers.0.self_attn.in_proj_weight"] == 0
    assert split["ft_layers.0.self_attn.out_proj.weight"] == 1
    assert split["cfa.32.ff.net.0.proj.weight"] == 0
    assert split["cfa.32.ff.net.2.weight"] == 1
    assert split["kalman_filter.uncertainty_estimator.0.attn1.to_q.weight"] \
        == 0
    assert "ft_layers.0.norm1.weight" not in split
    # 3 ranks divide no head count (4 and 2) nor any hidden width
    assert not any(d is not None for d in tp_param_specs(keep, 3).values())
    assert shard_params(keep, mesh) is keep


def test_chunks_parallel_world_one_equals_jax_and_the_chunk_body():
    import jax
    from comfyui_keep_tpu.models.keep import KEEP as JKEEP
    from comfyui_keep_tpu.parallel.inference import \
        restore_chunks_parallel as jrestore
    from comfyui_keep_torch.utils.convert import params_from_jax

    tree = JKEEP.init(jax.random.PRNGKey(0), **TINY)
    keep = KEEP(device="cpu", **TINY)
    keep.load_state_dict(params_from_jax(tree, keep))
    proc = KEEPFaceProcessor(keep, device="cpu")
    x = faces(5)
    ours = restore_chunks_parallel(proc, x, max_clip_length=2)
    ref = jrestore(tree, TINY, x, max_clip_length=2, mesh=None)
    assert ours.shape == ref.shape == (5, 64, 64, 3)
    np.testing.assert_allclose(ours, ref, **KEEP_TOL)
    # the whole chunks are the chunk body's, the tail its padded chunk's
    for s in (0, 2):
        np.testing.assert_array_equal(ours[s:s + 2],
                                      proc.restore_clip(x[s:s + 2]))
    np.testing.assert_array_equal(ours[4:], proc.restore_clip(x[[4, 4]])[:1])


def test_ring_world_one_equals_jax_and_carried_streaming():
    import jax
    from jax.sharding import Mesh
    from comfyui_keep_tpu.models.keep import KEEP as JKEEP
    from comfyui_keep_tpu.parallel.sequence import \
        restore_stream_pipeline as jring
    from comfyui_keep_torch.utils.convert import params_from_jax

    tree = JKEEP.init(jax.random.PRNGKey(0), **RING)
    keep = KEEP(device="cpu", **RING)
    keep.load_state_dict(params_from_jax(tree, keep))
    proc = KEEPFaceProcessor(keep, device="cpu")
    clips = ring_clips(2, 3)
    ours = restore_stream_pipeline(proc, clips)
    ref = jring(tree, RING, clips, Mesh(np.array(jax.devices()[:1]),
                                        ("seq",)))
    assert ours.shape == clips.shape
    np.testing.assert_allclose(ours, np.asarray(ref), **KEEP_TOL)
    np.testing.assert_array_equal(ours, carried_streaming(proc, clips, 1))


# ---------------------------------------------------------------------------
# two and four gloo ranks
# ---------------------------------------------------------------------------

def test_two_rank_data_parallel_sr_step_equals_one_process(two_ranks):
    results, out = two_ranks
    assert [r["rank_world"] for r in results] == [[0, 2], [1, 2]]
    for r in results:
        assert r["reduced"] == {"a": 1.5, "b": 1.0}
    with one_thread():
        tr = SRTrainer(copy.deepcopy(SR_OPT), device="cpu")
        st = tr.make_state()
        st, logs = tr.train_step(st, sr_batch())
    for r in results:
        for k, v in logs.items():
            np.testing.assert_allclose(r["sr_logs"][k], v, **DP_TOL)
    ranks = [np.load(os.path.join(out, f"sr{i}.npz")) for i in (0, 1)]
    for k, v in st.model.state_dict().items():
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        np.testing.assert_allclose(ranks[0][k], v.numpy(), **DP_TOL,
                                   err_msg=k)


def test_two_rank_stylegan2_steps_equal_one_process(two_ranks):
    """Two data ranks draw the global batch's style codes and noise and
    take their rows, so their D, R1 and G steps are one process's on the
    whole batch: the mean losses within 1e-6 / 1e-7, and every gradient
    an optimizer applies the same on both ranks and within 1e-6 / 1e-7 of
    one process's. A rank's draws, path inputs included, are its rows of
    one process's draws for the whole batch, bit for bit."""
    results, out = two_ranks
    with one_thread():
        _, logs, grads = sg2_steps()
    tr = StyleGAN2Trainer(copy.deepcopy(SG2_OPT), device="cpu")
    g = tr.init_model()
    whole = tr.draw(3, 4, g)
    assert sorted(results[0]["sg2_draw_rows"]) == sorted(whole) == [
        "d_styles", "g_styles", "noise", "path_latents", "path_layer_noise",
        "path_noise"]
    for k in whole:
        want = whole[k] if torch.is_tensor(whole[k]) else whole[k][0]
        for rank, r in enumerate(results):
            n = want.shape[0] // 2
            np.testing.assert_array_equal(
                r["sg2_draw_rows"][k],
                want[rank * n:(rank + 1) * n].flatten()[:8].tolist())
    assert [sorted(lg) for lg in logs] == [["l_d", "l_g"],
                                           ["l_d", "l_d_r1", "l_g"]]
    for r in results:
        assert len(r["sg2_logs"]) == 2
        for got, want in zip(r["sg2_logs"], logs):
            assert got.keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, **DP_TOL, err_msg=k)
    ranks = [np.load(os.path.join(out, f"sg2_{i}.npz")) for i in (0, 1)]
    assert len(ranks[0].files) == sum(len(gs) for gs in grads)
    for i, gs in enumerate(grads):
        for j, g in enumerate(gs):
            k = f"{i}.{j}"
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
            np.testing.assert_allclose(ranks[0][k], g.numpy(), **DP_TOL,
                                       err_msg=k)


def test_two_rank_realesrgan_feed_streams_fold_the_rank_in(two_ranks):
    """Each data rank's degradation streams are seeded manual_seed + its
    data index (the reference's seed + rank): rank 0's are one process's,
    rank 1's differ."""
    results, _ = two_ranks
    one = RealESRNetTrainer({**copy.deepcopy(SR_OPT),
                             "model_type": "RealESRNetModel"}, device="cpu")
    want = [0, one.py_rng.random(), float(one.np_rng.random_sample())]
    assert results[0]["feed"] == want
    assert results[1]["feed"][0] == 1
    assert results[1]["feed"][1:] != want[1:]


def test_two_rank_collectives_take_contiguous_tensors(two_ranks):
    results, _ = two_ranks
    want = (torch.arange(12.0).reshape(3, 4).t() * 2).tolist()
    for r in results:
        assert r["contiguous"] == {"all": True, "calls": 3, "reduced": want,
                                   "broadcast": [1.0]}


def test_two_rank_chunk_parallel_equals_one_rank(two_ranks):
    _, out = two_ranks
    with torch.no_grad(), one_thread():
        one = restore_chunks_parallel(processor(TINY), faces(), 2)
    for i in (0, 1):
        np.testing.assert_array_equal(
            np.load(os.path.join(out, f"chunks{i}.npy")), one)


def test_two_rank_ring_equals_carried_streaming(two_ranks):
    _, out = two_ranks
    with torch.no_grad(), one_thread():
        want = carried_streaming(processor(RING, gmflow=True), ring_clips(),
                                 2)
    for i in (0, 1):
        np.testing.assert_array_equal(
            np.load(os.path.join(out, f"ring{i}.npy")), want)


def test_two_rank_tensor_parallel_keep_step_equals_unsharded(two_ranks):
    results, _ = two_ranks
    for r in results:
        assert max(r["tp_logs"], r["tp_grads"], r["tp_params"]) <= 0, r
        assert r["tp_local_shapes_differ"]
        assert any("ft_layers" in k for k in r["tp_split"])
        assert any("linear1" in k for k in r["tp_split"])
        assert any(k.startswith("cfa.") for k in r["tp_split"])


def test_two_rank_train_pipeline_is_data_parallel(two_ranks):
    """train_pipeline in a two-rank group: a ("data",) mesh of 2, each rank
    fed batch_size_per_gpu items of its own, the same weights on both,
    the logged loss their mean, one save (rank 0's)."""
    results, out = two_ranks
    pipes = [r["pipe"] for r in results]
    for p in pipes:
        assert p == {"iter": 2, "l_pix": pipes[0]["l_pix"], "data": 2,
                     "local": True, "batch": [2, 4, 4, 3]}
    np.testing.assert_array_equal(np.load(os.path.join(out, "pipe0.npy")),
                                  np.load(os.path.join(out, "pipe1.npy")))
    exp = os.path.join(out, "pipe", "exp")
    assert sorted(os.listdir(os.path.join(exp, "models"))) == [
        "net_g_2.pth"]
    assert sorted(os.listdir(os.path.join(exp, "states"))) == ["2.state"]


def test_four_rank_data_tensor_parallel_keep_step_equals_unsharded(
        tmp_path):
    results = run_ranks(4, str(tmp_path))
    assert sorted(r["rank_world"][0] for r in results) == [0, 1, 2, 3]
    for r in results:
        assert max(r["dtp_logs"], r["dtp_grads"], r["dtp_params"]) <= 0, r
        assert r["dtp_local_shapes_differ"]


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
