"""Trainers of the PyTorch port, ported from
comfyui_keep_tpu/training/trainers.py. Slice 2 brings the KEEP stage-II
step (reference models/keep_model.py): frozen VQHQEncoder ground-truth
codes through the nearest-codebook kernel, GMFlow flows through GMFlow's
kernels, the codebook-feature, cross-entropy, temporal, pixel and
perceptual losses, fix_modules, the LR schedule, EMA, gradient
accumulation and bf16 mixed precision. Slice 3 brings StyleGAN2's GAN
alternation (StyleGAN2Model, reference models/stylegan2_model.py); slice 9
KEEP stage III (KEEPGANModel, reference models/keep_gan_model.py) with
Discriminator3D; slice 10 the SR trainers (SRModel, SRGANModel and their
aliases, RealESRNetModel / RealESRGANModel with the on-device degradation
feed), the recurrent video trainer (VideoRecurrentModel and its aliases)
and GMFlow's (GMFlowModel). Each trainer is in MODEL_REGISTRY under the JAX
package's model_type. The SR and video trainers take the datasets' NHWC
batches and run their networks NCHW.

A step is eager: forward, losses, backward and, at the end of each
accumulation window, the optimizer update; the EMA moves on every
micro-step, as the JAX package's does.
"""
import contextlib
import functools
import random
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from comfyui_keep_torch.models import build_network
from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
from comfyui_keep_torch.models.keep import KEEP, config, upscale_clip
from comfyui_keep_torch.models.stylegan2 import (StyleGAN2Discriminator,
                                                 StyleGAN2Generator)
from comfyui_keep_torch.models.vqgan import Discriminator3D, VQHQEncoder
from comfyui_keep_torch.ops import flow_warp, resize_flow
from comfyui_keep_torch.parallel.mesh import (all_reduce_, broadcast_module,
                                              shard_batch)
from comfyui_keep_torch.parallel.tensor import shard_params
from comfyui_keep_torch.training.losses import (build_loss, g_path_regularize,
                                                r1_penalty)
from comfyui_keep_torch.training.flow_losses import flow_loss_func
from comfyui_keep_torch.training.schedulers import (build_scheduler,
                                                    cosine_onecycle,
                                                    with_warmup)
from comfyui_keep_torch.training.state import (TrainState, build_optimizer,
                                               cast_parameters, ema_init,
                                               ema_update, freeze)
from comfyui_keep_torch.utils.logger import get_root_logger
from comfyui_keep_torch.utils.registry import MODEL_REGISTRY


def _perceptual(t: Dict, feature_fn: Optional[Callable]):
    if not t.get("perceptual_opt"):
        return None
    if feature_fn is None:
        raise ValueError("perceptual_opt needs a feature_fn (e.g. a "
                         "VGGFeatureExtractor)")
    return build_loss(t["perceptual_opt"], feature_fn=feature_fn)


class BaseTrainer:
    """Schedule, mixed precision, accumulation, optimizer and EMA around a
    subclass's `init_model()` and `loss_fn(model, batch) -> (total,
    {name: loss})`.

    train.mixed_precision (true or a torch dtype name): the network sees a
    bf16 (or that dtype's) copy of the parameters and the batch, while the
    master weights, the optimizer and the EMA stay f32; the losses are
    upcast to f32. train.accumulate_steps k: gradients are averaged over k
    micro-steps and the optimizer and the schedule advance once per k.
    network_g.fix_modules: the top-level submodules that stay frozen
    (`default_fix_modules` when the options do not say). A param group's
    "lr_mul" scales the LR it gets; `before_step(state)` runs on the
    gradients just before each optimizer step.

    mesh (parallel/mesh.py:Mesh, the JAX trainers' mesh=): with a "data"
    axis of D > 1 ranks, make_state broadcasts the weights from rank 0,
    each rank takes its share of the batch (shard_batch; a loader that
    already gives each rank its own, as train_pipeline's does, sets
    batch_is_local), and before every optimizer step (the discriminators'
    too) the gradients are averaged over the data group: with equal
    shards, the gradient of the global batch's mean loss, as JAX's step
    takes it. The EMA and the schedules are unchanged. train_step returns
    this rank's losses (reduce_loss_dict gives their mean). With a "model"
    axis of M > 1, make_state splits KEEP's transformer layers over it
    (parallel/tensor.py:shard_params) before the optimizer and the EMA are
    made.
    """
    default_fix_modules = ()

    def __init__(self, opt: Dict, device="cuda", mesh=None):
        self.opt = opt
        self.device = torch.device(device)
        self.mesh = mesh
        self.batch_is_local = False
        t = opt.get("train", {})
        self.ema_decay = t.get("ema_decay", 0)
        self.schedule = None
        if t.get("scheduler"):
            self.schedule = with_warmup(build_scheduler(t["scheduler"]),
                                        t.get("warmup_iter", -1))
        mp = t.get("mixed_precision", False)
        self.compute_dtype = (getattr(torch, "bfloat16" if mp is True
                                      else str(mp)) if mp else None)
        self.accumulate_steps = int(t.get("accumulate_steps", 1))
        self.fix_modules = tuple(opt.get("network_g", {}).get(
            "fix_modules", self.default_fix_modules) or ())
        self.seed = int(opt.get("manual_seed", 0))

    def current_lr(self, it: int) -> float:
        """LR of the update that micro-step `it` belongs to: base *
        schedule(it // accumulate_steps)."""
        t = self.opt.get("train", {})
        base = float(t.get("optim_g", {}).get("lr", t.get("lr", 0.0)))
        if self.schedule is not None:
            return base * float(self.schedule(it // self.accumulate_steps))
        return base

    def make_state(self, model=None) -> TrainState:
        """Master weights (`model`, or `init_model()` from the options'
        manual_seed) on the trainer's device, fix_modules frozen, the
        optimizer over what trains, and the EMA."""
        model = self._replicate(
            (self.init_model() if model is None else model).to(self.device))
        if self.mesh is not None:
            shard_params(model, self.mesh)
        optimizer = self.make_optimizer(model, freeze(model,
                                                      self.fix_modules))
        ema = ema_init(model) if self.ema_decay > 0 else None
        return TrainState(model=model, optimizer=optimizer, ema=ema)

    def make_optimizer(self, model, trainable) -> torch.optim.Optimizer:
        """optim_g over the trainable parameters."""
        return build_optimizer(
            self.opt.get("train", {}).get("optim_g",
                                          {"type": "Adam", "lr": 1e-4}),
            trainable)

    def before_step(self, state: TrainState):
        """Hook on the window's gradients before the optimizer step."""

    def _replicate(self, module):
        """`module` with rank 0's weights on every rank (with a mesh)."""
        if self.mesh is not None:
            broadcast_module(module, self.mesh)
        return module

    def _local_batch(self, batch):
        """This rank's share of a global batch along the mesh's data axis
        (the batch itself without a mesh, or when batch_is_local)."""
        return batch if self.batch_is_local else shard_batch(batch,
                                                             self.mesh)

    def sync_grads(self, params):
        """The .grad of `params` averaged over the mesh's data group, in
        one all_reduce in f32 (float64 where a gradient is), nothing
        without a data group of more than one.
        A parameter without a gradient is left out: it has none on any
        rank."""
        group = None if self.mesh is None else self.mesh.group("data")
        if group is None:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        dtype = functools.reduce(torch.promote_types,
                                 (g.dtype for g in grads), torch.float32)
        flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
        all_reduce_(flat, group)
        flat /= self.mesh.size("data")
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def _cast_batch(self, batch):
        batch = self._local_batch(batch)
        dt = self.compute_dtype
        return {k: v.to(self.device, dt if dt and v.is_floating_point()
                        else v.dtype) for k, v in batch.items()}

    def _compute(self, *models):
        """The networks' parameters in the compute dtype for the block (no
        cast without mixed precision)."""
        stack = contextlib.ExitStack()
        if self.compute_dtype:
            for m in models:
                stack.enter_context(cast_parameters(m, self.compute_dtype))
        return stack

    def backward(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Forward, losses and backward of one micro-batch: adds 1/k of its
        gradient to the trainable parameters' .grad. Returns the f32 loss
        terms (detached), with "l_total"."""
        with self._compute(state.model):
            total, loss_dict = self.loss_fn(state.model,
                                            self._cast_batch(batch))
            total = total.float()
            (total / self.accumulate_steps).backward()
        logs = {k: v.detach().float() for k, v in loss_dict.items()}
        logs["l_total"] = total.detach()
        return logs

    def train_step(self, state: TrainState, batch):
        """One micro-step -> (state, {name: float loss})."""
        logs = self.backward(state, batch)
        self.update(state)
        return state, {k: float(v) for k, v in logs.items()}

    def update(self, state: TrainState):
        """After a micro-step's backward: the optimizer step at the end of
        an accumulation window (LR = current_lr), the EMA, the count."""
        if (state.iter + 1) % self.accumulate_steps == 0:
            lr = self.current_lr(state.iter)
            for group in state.optimizer.param_groups:
                group["lr"] = lr * group.get("lr_mul", 1.0)
                for p in group["params"]:
                    # optax updates every trainable leaf, reached or not
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            self.sync_grads([p for group in state.optimizer.param_groups
                             for p in group["params"]])
            self.before_step(state)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        if state.ema is not None:
            ema_update(state.ema, state.model, self.ema_decay)
        state.iter += 1


@MODEL_REGISTRY.register(name="KEEPModel")
class KEEPTrainer(BaseTrainer):
    """KEEP stage II/III trainer (reference models/keep_model.py): the
    codebook-feature L2 of the encoder's latents against the ground-truth
    codes, cross-entropy of the code logits against those codes, the
    flow-warped temporal consistency of the generator features, the pixel
    loss and the perceptual loss.

    hq_vqgan: the frozen VQHQEncoder that gives the ground-truth codes;
    gmflow: the frozen flow net (zero flows without it). Both are moved to
    the trainer's device and compute dtype. feature_fn: the perceptual
    loss's features, feature_fn(x NCHW, layers) -> {layer: NCHW} (e.g. a
    VGGFeatureExtractor on the trainer's device), needed with
    perceptual_opt. The trainer runs on "cuda" unless given device="cpu".

    The LQ clip is at img_size (a dataset at scale 1) or img_size / 4 (the
    datasets' default scale 4, as the reference trains): KEEP then runs
    with need_upscale, the flows taken on the upscaled clip
    (check_lq_scale, need_upscale).
    """
    default_fix_modules = ("quantize", "generator")

    def __init__(self, opt: Dict, hq_vqgan: Optional[VQHQEncoder] = None,
                 gmflow: Optional[GMFlow] = None, device="cuda",
                 feature_fn: Optional[Callable] = None, mesh=None):
        super().__init__(opt, device, mesh)
        cfg = dict(opt["network_g"])
        cfg.pop("type", None)
        cfg.pop("fix_modules", None)
        self.cfg = config(cfg.pop("variant", "KEEP"), **cfg)
        t = opt.get("train", {})
        self.hq_feat_loss = t.get("use_hq_feat_loss", False)
        self.feat_loss_weight = t.get("feat_loss_weight", 1.0)
        self.cross_entropy_loss = t.get("cross_entropy_loss", False)
        self.entropy_loss_weight = t.get("entropy_loss_weight", 0.5)
        self.cri_pix = build_loss(t["pixel_opt"]) if t.get("pixel_opt") \
            else None
        self.cri_perceptual = _perceptual(t, feature_fn)
        self.cri_temporal = build_loss(t["temporal_opt"]) \
            if t.get("temporal_opt") else None
        self.temporal_type = t.get("temporal_warp_type", "GT")
        if (self.hq_feat_loss or self.cross_entropy_loss) and hq_vqgan is None:
            raise ValueError("the feature and cross-entropy losses need the "
                             "frozen hq_vqgan")
        # the frozen aux nets ride the compute dtype
        self.hq_vqgan, self.gmflow = (
            None if m is None else m.to(self.device, self.compute_dtype)
            .eval().requires_grad_(False) for m in (hq_vqgan, gmflow))

    def init_model(self) -> KEEP:
        return KEEP(device="cpu",
                    generator=torch.Generator().manual_seed(self.seed),
                    **self.cfg)

    @torch.no_grad()
    def _gt_indices(self, gt):
        """Ground-truth codes (B*T, h*w) of the GT frames: the frozen
        VQHQEncoder's latents, one nearest-codebook launch for all."""
        return self.hq_vqgan.indices(gt.reshape((-1,) + gt.shape[2:])).long()

    def _flows(self, clip):
        """Flows of a clip as (fx, fy) planes, each (B, T-1, H, W); zeros
        without GMFlow."""
        if self.gmflow is None:
            b, t, h, w, _ = clip.shape
            zero = torch.zeros((b, t - 1, h, w), dtype=clip.dtype,
                               device=clip.device)
            return zero, zero
        return flow_from_clip(self.gmflow, clip.detach())

    @staticmethod
    def check_lq_scale(scale):
        """The training dataset's scale: 1 (LQ at img_size) or 4 (LQ at
        img_size / 4, which KEEP upscales); another raises."""
        if scale not in (1, 4):
            raise ValueError(
                f"datasets.train.scale is {scale}: KEEP trains on LQ clips at "
                "img_size (scale 1) or img_size / 4 (scale 4, upscaled inside "
                "KEEP as the reference's need_upscale)")

    def need_upscale(self, lq) -> bool:
        """True for an LQ clip (B, T, h, w, 3) at img_size / 4, False at
        img_size; another size raises."""
        size, hw = self.cfg["img_size"], tuple(lq.shape[2:4])
        if hw == (size // 4, size // 4) and size % 4 == 0:
            return True
        if hw == (size, size):
            return False
        raise ValueError(f"LQ frames of {hw[0]}x{hw[1]}: KEEP at img_size "
                         f"{size} takes {size} or {size // 4} (need_upscale)")

    @torch.no_grad()
    def forward(self, model: KEEP, lq):
        """Eval forward (validation): the network on the LQ clip with its
        flows (upscaled by KEEP when the clip is at img_size / 4)."""
        up = self.need_upscale(lq)
        return model.apply(lq, flows=self._flows(upscale_clip(lq) if up
                                                  else lq), need_upscale=up)

    def loss_fn(self, model: KEEP, batch):
        total, loss_dict, _ = self._loss_outs(model, batch)
        return total, loss_dict

    def _loss_outs(self, model: KEEP, batch):
        """(total, {name: loss}, restored frames)."""
        lq, gt = batch["lq"], batch["gt"]
        up = self.need_upscale(lq)
        # the flows of the clip KEEP sees: the upscaled one when up
        flows = (self._flows(upscale_clip(lq) if up else lq)
                 if self.gmflow is not None else None)
        outs, aux = model(lq, flows, need_upscale=up)
        total, loss_dict = 0.0, {}
        b, t = gt.shape[:2]

        if self.hq_feat_loss or self.cross_entropy_loss:
            idx_gt = self._gt_indices(gt)

        if self.hq_feat_loss:
            lq_feat = aux["lq_feat"]
            quant_gt = model.quantize.lookup(idx_gt).reshape(lq_feat.shape)
            l_feat = torch.mean((quant_gt.detach() - lq_feat) ** 2) \
                * self.feat_loss_weight
            total = total + l_feat
            loss_dict["l_feat_encoder"] = l_feat

        if self.cross_entropy_loss:
            logits = aux["logits"]
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 idx_gt.reshape(-1)) * self.entropy_loss_weight
            total = total + ce
            loss_dict["l_cross_entropy"] = ce

        if self.cri_temporal is not None and aux["gen_feat_dict"]:
            def dense(clip):
                return torch.stack(self._flows(clip), dim=-1)
            if self.temporal_type == "GT":
                flows_a = dense(gt)
            elif self.temporal_type == "HR":
                flows_a = dense(outs)
            else:  # Diff
                flows_a, flows_b = dense(gt), dense(outs)
            l_temporal = 0.0
            for feat in aux["gen_feat_dict"].values():
                _, _, fh, fw, fc = feat.shape
                prev = feat[:, :-1].reshape(-1, fh, fw, fc).permute(0, 3, 1, 2)
                curr = feat[:, 1:].reshape(-1, fh, fw, fc).permute(0, 3, 1, 2)

                def warped(fl):
                    return flow_warp(prev, resize_flow(
                        fl.reshape((-1,) + fl.shape[2:]), (fh, fw)))
                if self.temporal_type in ("GT", "HR"):
                    l_temporal = l_temporal + self.cri_temporal(
                        curr, warped(flows_a))
                else:
                    l_temporal = l_temporal + self.cri_temporal(
                        warped(flows_a), warped(flows_b))
            total = total + l_temporal
            loss_dict["l_temporal"] = l_temporal

        if self.cri_pix is not None:
            l_pix = self.cri_pix(outs, gt)
            total = total + l_pix
            loss_dict["l_pix"] = l_pix

        if self.cri_perceptual is not None:
            l_p, l_s = self.cri_perceptual(
                outs.reshape((-1,) + outs.shape[2:]).permute(0, 3, 1, 2),
                gt.reshape((-1,) + gt.shape[2:]).permute(0, 3, 1, 2))
            if l_p is not None:
                total = total + l_p
                loss_dict["l_percep"] = l_p
            if l_s is not None:
                total = total + l_s
                loss_dict["l_style"] = l_s
        return total, loss_dict, outs


@MODEL_REGISTRY.register(name="KEEPGANModel")
class KEEPGANTrainer(KEEPTrainer):
    """KEEP stage III (reference models/keep_gan_model.py; the JAX
    package's KEEPGANTrainer): stage II's generator step plus a
    Discriminator3D on the clips, alternating. From iteration
    net_d_start_iter on, the generator's objective adds the GAN loss of
    D(restored) as real, and D then takes one step on (gt as real, the
    restored clip detached as fake): l_d = l_d_real + l_d_fake. Before it,
    neither term nor D's step runs.

    D is built from network_d.args under its own generator (manual_seed +
    777), trains in f32 masters with its own optimizer (optim_d, the LR
    times the schedule at D's own update count, no accumulation), and sees
    the compute dtype under mixed precision, as the generator does. D runs
    in training mode, so each of its forwards (on the restored clip in the
    generator's step, then on gt and on the restored clip in its own)
    advances its spectral-norm vectors weight_u and weight_v in place, as
    the reference's spectral_norm does (the JAX package keeps u fixed);
    they are buffers that no optimizer holds. D, these buffers included,
    and its optimizer are the trainer's extra_state, saved and resumed
    with the generator's state."""

    def __init__(self, opt: Dict, hq_vqgan: Optional[VQHQEncoder] = None,
                 gmflow: Optional[GMFlow] = None, device="cuda",
                 feature_fn: Optional[Callable] = None, mesh=None):
        super().__init__(opt, hq_vqgan, gmflow, device, feature_fn, mesh)
        t = opt.get("train", {})
        self.cri_gan = build_loss(t["gan_opt"]) if t.get("gan_opt") else None
        self.net_d_start_iter = t.get("net_d_start_iter", 0)
        self.d_args = dict(opt.get("network_d", {}).get("args", {}))

    def make_state(self, model: Optional[KEEP] = None,
                   disc: Optional[Discriminator3D] = None) -> TrainState:
        """The generator's state (KEEPTrainer.make_state), and on the
        trainer the discriminator (`disc`, or one from network_d.args
        seeded from manual_seed + 777) with its optimizer."""
        state = super().make_state(model)
        disc = self.init_disc() if disc is None else disc
        self.disc = self._replicate(disc.to(self.device)).train(
            ).requires_grad_(True)
        self.d_optimizer = build_optimizer(
            self.opt.get("train", {}).get("optim_d",
                                          {"type": "Adam", "lr": 1e-4}),
            self.disc.parameters())
        return state

    def init_disc(self) -> Discriminator3D:
        return Discriminator3D(
            **self.d_args, device="cpu",
            generator=torch.Generator().manual_seed(self.seed + 777))

    def extra_state(self) -> Dict:
        """The discriminator (its weight_u and weight_v buffers included)
        and its optimizer, for TrainState.save."""
        return {"d_params": self.disc.state_dict(),
                "d_opt_state": self.d_optimizer.state_dict()}

    def load_extra_state(self, data: Optional[Dict]):
        if not data:
            get_root_logger().warning(
                "resume state has no discriminator snapshot; the "
                "discriminator continues from its fresh init")
            return
        self.disc.load_state_dict(data["d_params"])
        self.d_optimizer.load_state_dict(data["d_opt_state"])

    def d_lr(self, current_iter: int) -> float:
        """LR of D's update at iteration current_iter: optim_d's lr times
        the schedule at the number of updates D has taken before it (one an
        iteration from net_d_start_iter on; optax counts D's own steps)."""
        base = float(self.opt.get("train", {}).get("optim_d", {}).get(
            "lr", 1e-4))
        if self.schedule is None:
            return base
        taken = max(0, current_iter - max(1, self.net_d_start_iter))
        return base * float(self.schedule(taken))

    def gan_train_step(self, state: TrainState, batch, current_iter: int):
        """One g/d alternation (keep_gan_model.py:262-296): the generator
        micro-step with the GAN term once current_iter >= net_d_start_iter
        (D frozen for it), its update, then D's step on (gt, restored).
        Returns (state, {name: float loss})."""
        use_gan = (self.cri_gan is not None
                   and current_iter >= self.net_d_start_iter)
        batch = self._cast_batch(batch)
        self.disc.requires_grad_(False)
        with self._compute(state.model, self.disc):
            total, loss_dict, outs = self._loss_outs(state.model, batch)
            if use_gan:
                l_g_gan = self.cri_gan(self.disc(outs), True, is_disc=False)
                total = total + l_g_gan
                loss_dict["l_g_gan"] = l_g_gan
            total = total.float()
            (total / self.accumulate_steps).backward()
        logs = {k: v.detach().float() for k, v in loss_dict.items()}
        logs["l_total"] = total.detach()
        self.update(state)

        if use_gan:
            self.disc.requires_grad_(True)
            with self._compute(self.disc):
                l_real = self.cri_gan(self.disc(batch["gt"]), True,
                                      is_disc=True).float()
                l_fake = self.cri_gan(self.disc(outs.detach()), False,
                                      is_disc=True).float()
                l_d = l_real + l_fake
                l_d.backward()
            for group in self.d_optimizer.param_groups:
                group["lr"] = self.d_lr(current_iter)
            self.sync_grads(self.disc.parameters())
            self.d_optimizer.step()
            self.d_optimizer.zero_grad(set_to_none=True)
            logs.update(l_d=l_d.detach(), l_d_real=l_real.detach(),
                        l_d_fake=l_fake.detach())
        return state, {k: float(v) for k, v in logs.items()}

    def train_step(self, state: TrainState, batch):
        """The train loop's entry point: the alternation of iteration
        state.iter + 1."""
        return self.gan_train_step(state, batch, current_iter=state.iter + 1)


@MODEL_REGISTRY.register(name="StyleGAN2Model")
class StyleGAN2Trainer(BaseTrainer):
    """StyleGAN2 trainer (reference models/stylegan2_model.py, the JAX
    package's StyleGAN2Model): the non-saturating logistic GAN
    (wgan_softplus), style mixing, lazy R1 every net_d_reg_every iterations
    and path-length regularisation every net_g_reg_every, with the
    reference's reg-adjusted Adam: lr * r, betas (0, 0.99 ** r), r =
    reg_every / (reg_every + 1), for G and D each. Each R1 or path update is
    an optimizer step of its own, as the JAX package calls tx.update again;
    every parameter takes part in every step (a zero gradient where it is
    not reached), as optax updates every leaf.

    The batch is {"gt": (B, 3, H, W)} real images, NCHW as the models. The
    random inputs of an alternation (style codes, noise, path latents) come
    from `draw(current_iter, b)`, seeded from manual_seed and the iteration
    as the JAX package keys it by PRNGKey(current_iter); a caller may pass
    its own (`gan_train_step(draws=...)`). The discriminator, its optimizer
    and the running mean path length live on the trainer (`extra_state`,
    in memory only). Runs on "cuda" unless given device="cpu"."""

    def __init__(self, opt: Dict, device="cuda", mesh=None):
        super().__init__(opt, device, mesh)
        if self.accumulate_steps > 1:
            # the lazy R1 / path updates are extra optimizer steps, which an
            # accumulation window would mis-count
            raise ValueError("train.accumulate_steps is not supported for "
                             "StyleGAN2Model (lazy-regularization double "
                             "updates)")
        if self.compute_dtype is not None:
            raise ValueError("train.mixed_precision is not supported for "
                             "StyleGAN2Model")
        g = opt.get("network_g", {})
        self.g_cfg = {k: g[k] for k in ("num_mlp", "channel_multiplier",
                                        "narrow") if k in g}
        self.out_size = g.get("out_size", 64)
        self.num_style_feat = g.get("num_style_feat", 512)
        self.d_cfg = opt.get("network_d", {})
        t = opt.get("train", {})
        self.r1_reg_weight = t.get("r1_reg_weight", 10.0)
        self.path_reg_weight = t.get("path_reg_weight", 2.0)
        self.net_g_reg_every = t.get("net_g_reg_every", 4)
        self.net_d_reg_every = t.get("net_d_reg_every", 16)
        self.mixing_prob = t.get("mixing_prob", 0.9)
        self.mean_path_length = 0.0
        self.cri_gan = build_loss(t.get("gan_opt", {
            "type": "GANLoss", "gan_type": "wgan_softplus"}))

    def current_lr(self, it: int) -> float:
        """The applied generator LR: the reg-adjusted constant lr * r."""
        base = float(self.opt.get("train", {}).get("optim_g", {}).get(
            "lr", 2e-3))
        return base * self.net_g_reg_every / (self.net_g_reg_every + 1)

    def init_model(self) -> StyleGAN2Generator:
        return StyleGAN2Generator(
            self.out_size, num_style_feat=self.num_style_feat, device="cpu",
            generator=torch.Generator().manual_seed(self.seed), **self.g_cfg)

    def _adam(self, params, which: str, reg_every: int):
        lr = float(self.opt.get("train", {}).get(which, {}).get("lr", 2e-3))
        r = reg_every / (reg_every + 1)
        return torch.optim.Adam(params, lr=lr * r, betas=(0.0, 0.99 ** r))

    def make_state(self, model: Optional[StyleGAN2Generator] = None,
                   disc: Optional[StyleGAN2Discriminator] = None
                   ) -> TrainState:
        """The generator (`model`, or one seeded from manual_seed), the
        discriminator (`disc`, or one of network_d's out_size and
        channel_multiplier seeded from manual_seed + 99), both trainable on
        the trainer's device, their ratio'd Adams and the EMA."""
        model = self._replicate(
            (self.init_model() if model is None else model).to(
                self.device)).train().requires_grad_(True)
        if disc is None:
            disc = StyleGAN2Discriminator(
                self.d_cfg.get("out_size", self.out_size),
                channel_multiplier=self.d_cfg.get("channel_multiplier", 2),
                device="cpu",
                generator=torch.Generator().manual_seed(self.seed + 99))
        self.disc = self._replicate(disc.to(self.device)).train(
            ).requires_grad_(True)
        self.d_optimizer = self._adam(list(self.disc.parameters()), "optim_d",
                                      self.net_d_reg_every)
        optimizer = self._adam(list(model.parameters()), "optim_g",
                               self.net_g_reg_every)
        ema = ema_init(model) if self.ema_decay > 0 else None
        return TrainState(model=model, optimizer=optimizer, ema=ema)

    def extra_state(self) -> Dict:
        """The discriminator, its optimizer and the running path length."""
        return {"d_params": self.disc.state_dict(),
                "d_opt_state": self.d_optimizer.state_dict(),
                "mean_path_length": self.mean_path_length}

    def load_extra_state(self, data: Dict):
        self.disc.load_state_dict(data["d_params"])
        self.d_optimizer.load_state_dict(data["d_opt_state"])
        self.mean_path_length = float(data["mean_path_length"])

    def _mixing_noise(self, b: int, gen: torch.Generator
                      ) -> List[torch.Tensor]:
        """One (B, S) code, and a second one with probability mixing_prob."""
        def code():
            return torch.randn((b, self.num_style_feat), generator=gen,
                               device=self.device)
        n1 = code()
        mix = torch.rand((), generator=gen, device=self.device).item()
        return [n1, code()] if mix < self.mixing_prob else [n1]

    def draw(self, current_iter: int, b: int, model: StyleGAN2Generator
             ) -> Dict:
        """The random inputs of one alternation for this rank's b rows: D's
        and G's style codes, the per-layer noise both use, and at a path
        iteration its latents (max(1, b // 2) codes a rank), their
        per-layer noise and the image-shaped noise. With a "data" axis of D
        ranks, the draws are made for the global batch (b * D rows, the
        same on every rank) and this rank takes its rows, so
        D ranks draw what one process draws for b * D rows (for the path
        inputs, where b is even)."""
        d_size = 1 if self.mesh is None else self.mesh.size("data")
        gb = b * d_size
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + current_iter)
        d = {"d_styles": self._mixing_noise(gb, gen),
             "g_styles": self._mixing_noise(gb, gen),
             "noise": model.make_noise(gb, gen)}
        if current_iter % self.net_g_reg_every == 0:
            pb = max(1, b // 2) * d_size
            d["path_latents"] = torch.randn((pb, self.num_style_feat),
                                            generator=gen, device=self.device)
            d["path_layer_noise"] = model.make_noise(pb, gen)
            d["path_noise"] = torch.randn((pb, 3, self.out_size,
                                           self.out_size), generator=gen,
                                          device=self.device)
        if d_size == 1:
            return d
        i = self.mesh.index("data")

        def rows(t):
            n = t.shape[0] // d_size
            return t[i * n:(i + 1) * n]
        return {k: [rows(t) for t in v] if isinstance(v, list) else rows(v)
                for k, v in d.items()}

    def _step(self, optimizer: torch.optim.Optimizer, loss):
        """One optimizer step on d loss / d (every parameter it holds),
        averaged over the mesh's data group."""
        params = [p for grp in optimizer.param_groups for p in grp["params"]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        self.sync_grads(params)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def gan_train_step(self, state: TrainState, batch, current_iter: int,
                       draws: Optional[Dict] = None):
        """One alternation (stylegan2_model.py:185-254, the JAX package's
        order): D step, lazy R1, G step, lazy path regularisation, EMA.
        Returns (state, {name: float loss})."""
        g_net, d_net = state.model, self.disc
        real = self._local_batch(batch)["gt"].to(self.device)
        b = real.shape[0]
        dr = self.draw(current_iter, b, g_net) if draws is None else {
            k: ([t.to(self.device) for t in v] if isinstance(v, list)
                else v.to(self.device)) for k, v in draws.items()}
        logs = {}

        with torch.no_grad():
            fake, _ = g_net(dr["d_styles"], noise=dr["noise"])
        l_d = (self.cri_gan(d_net(real), True, is_disc=True)
               + self.cri_gan(d_net(fake), False, is_disc=True))
        self._step(self.d_optimizer, l_d)
        logs["l_d"] = l_d.detach()

        if current_iter % self.net_d_reg_every == 0:
            l_r1 = r1_penalty(d_net, real) * (
                self.r1_reg_weight / 2 * self.net_d_reg_every)
            self._step(self.d_optimizer, l_r1)
            logs["l_d_r1"] = l_r1.detach()

        img, _ = g_net(dr["g_styles"], noise=dr["noise"])
        l_g = self.cri_gan(d_net(img), True, is_disc=False)
        self._step(state.optimizer, l_g)
        logs["l_g"] = l_g.detach()

        if current_iter % self.net_g_reg_every == 0:
            pen, path_mean, _ = g_path_regularize(
                lambda lat: g_net([lat], noise=dr["path_layer_noise"])[0],
                dr["path_latents"], self.mean_path_length,
                noise=dr["path_noise"])
            l_path = pen * self.path_reg_weight * self.net_g_reg_every
            self._step(state.optimizer, l_path)
            self.mean_path_length = float(path_mean)
            logs["l_g_path"] = l_path.detach()

        if state.ema is not None:
            ema_update(state.ema, g_net, self.ema_decay)
        state.iter += 1
        return state, {k: float(v) for k, v in logs.items()}

    def train_step(self, state: TrainState, batch):
        """The train-loop entry point: the alternation of iteration
        state.iter + 1."""
        return self.gan_train_step(state, batch, current_iter=state.iter + 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _seeded(name: str, cfg: Dict, seed: int):
    """build_network(name)(**cfg), its weights drawn on the CPU from a
    torch.Generator seeded with `seed`."""
    return build_network(name)(**cfg, device="cpu",
                               generator=torch.Generator().manual_seed(seed))


@MODEL_REGISTRY.register(name="SRModel")
class SRTrainer(BaseTrainer):
    """Single-image SR (reference models/sr_model.py): the pixel and
    perceptual losses on network_g's output; `forward` for validation and
    `test_selfensemble`, the x8 flip / transpose ensemble. Batches: "lq"
    and "gt", (B, H, W, 3) in [0, 1]. feature_fn as KEEPTrainer's, needed
    with perceptual_opt. Runs on "cuda" unless given device="cpu"."""

    def __init__(self, opt: Dict, device="cuda",
                 feature_fn: Optional[Callable] = None, mesh=None):
        super().__init__(opt, device, mesh)
        t = opt.get("train", {})
        self.cri_pix = build_loss(t["pixel_opt"]) if t.get("pixel_opt") \
            else None
        self.cri_perceptual = _perceptual(t, feature_fn)
        net = dict(opt["network_g"])
        self.arch_type = net.pop("type")
        net.pop("fix_modules", None)
        self.net_cfg = net

    def init_model(self):
        return _seeded(self.arch_type, self.net_cfg, self.seed)

    def net(self, model, lq):
        """The network on an NHWC batch, NHWC out."""
        return _nhwc(model(_nchw(lq)))

    @torch.no_grad()
    def forward(self, model, lq):
        """Eval forward: lq (B, H, W, 3) on the trainer's device."""
        return self.net(model, lq.to(self.device))

    def test_selfensemble(self, model, lq):
        """The mean of the 8 flips / transposes of lq, each mapped back
        (sr_model.py self-ensemble), summed in the JAX package's order."""
        outs = []
        for hf in (False, True):
            for vf in (False, True):
                for tr in (False, True):
                    x = lq.flip(2) if hf else lq
                    x = x.flip(1) if vf else x
                    y = self.forward(model, x.transpose(1, 2) if tr else x)
                    y = y.transpose(1, 2) if tr else y
                    y = y.flip(1) if vf else y
                    outs.append(y.flip(2) if hf else y)
        return sum(outs) / len(outs)

    def _g_losses(self, out, gt, prefix: str):
        total, d = 0.0, {}
        if self.cri_pix is not None:
            d[f"l_{prefix}pix"] = self.cri_pix(out, gt)
        if self.cri_perceptual is not None:
            l_p, l_s = self.cri_perceptual(_nchw(out), _nchw(gt))
            if l_p is not None:
                d[f"l_{prefix}percep"] = l_p
            if l_s is not None:
                d[f"l_{prefix}style"] = l_s
        for v in d.values():
            total = total + v
        return total, d

    def loss_fn(self, model, batch):
        return self._g_losses(self.net(model, batch["lq"]), batch["gt"], "")


@MODEL_REGISTRY.register(name="SRGANModel")
class SRGANTrainer(SRTrainer):
    """GAN SR (reference models/srgan_model.py, the base of ESRGAN, Real-
    ESRGAN and HiFaceGAN): generator steps (pixel, perceptual and GAN
    losses) at iterations where current_iter % net_d_iters == 0 and
    current_iter >= net_d_init_iters, a plain forward at the others; then,
    with gan_opt, one step of the discriminator (network_d, default
    UNetDiscriminatorSN; seeded from manual_seed + 777) on (gt real, the
    output detached fake). D's LR is optim_d's times the schedule at D's
    own update count, as optax counts it. D and its optimizer are the
    trainer's extra_state."""

    def __init__(self, opt: Dict, device="cuda",
                 feature_fn: Optional[Callable] = None, mesh=None):
        super().__init__(opt, device, feature_fn, mesh)
        t = opt.get("train", {})
        self.cri_gan = build_loss(t["gan_opt"]) if t.get("gan_opt") else None
        self.net_d_iters = t.get("net_d_iters", 1)
        self.net_d_init_iters = t.get("net_d_init_iters", 0)
        d = dict(opt.get("network_d", {"type": "UNetDiscriminatorSN"}))
        self.d_type = d.pop("type")
        self.d_cfg = d
        self.d_updates = 0

    def init_disc(self):
        return _seeded(self.d_type, self.d_cfg, self.seed + 777)

    def make_state(self, model=None, disc=None) -> TrainState:
        """The generator's state, and on the trainer the discriminator
        (`disc`, or init_disc()) with optim_d (default Adam 1e-4)."""
        state = super().make_state(model)
        disc = self.init_disc() if disc is None else disc
        self.disc = self._replicate(disc.to(self.device)).train(
            ).requires_grad_(True)
        self.d_optimizer = build_optimizer(
            self.opt.get("train", {}).get("optim_d",
                                          {"type": "Adam", "lr": 1e-4}),
            self.disc.parameters())
        self.d_updates = 0
        return state

    def extra_state(self) -> Dict:
        return {"d_params": self.disc.state_dict(),
                "d_opt_state": self.d_optimizer.state_dict(),
                "d_updates": self.d_updates}

    def load_extra_state(self, data: Optional[Dict]):
        if not data:
            get_root_logger().warning(
                "resume state has no discriminator snapshot; the "
                "discriminator continues from its fresh init")
            return
        self.disc.load_state_dict(data["d_params"])
        self.d_optimizer.load_state_dict(data["d_opt_state"])
        self.d_updates = int(data.get("d_updates", 0))

    def gan_train_step(self, state: TrainState, batch, current_iter: int):
        """One iteration (srgan_model.py optimize_parameters, the JAX
        package's order). Returns (state, {name: float loss})."""
        train_g = (current_iter % self.net_d_iters == 0
                   and current_iter >= self.net_d_init_iters)
        batch = self._cast_batch(batch)
        logs = {}
        if train_g:
            self.disc.requires_grad_(False)
            with self._compute(state.model, self.disc):
                out = self.net(state.model, batch["lq"])
                total, d = self._g_losses(out, batch["gt"], "g_")
                if self.cri_gan is not None:
                    d["l_g_gan"] = self.cri_gan(self.disc(_nchw(out)), True,
                                                is_disc=False)
                    total = total + d["l_g_gan"]
                (total.float() / self.accumulate_steps).backward()
            logs = {k: v.detach().float() for k, v in d.items()}
            self.update(state)
        else:
            with torch.no_grad(), self._compute(state.model):
                out = self.net(state.model, batch["lq"])
            state.iter += 1
        if self.cri_gan is not None:
            self.disc.requires_grad_(True)
            with self._compute(self.disc):
                l_real = self.cri_gan(self.disc(_nchw(batch["gt"])), True,
                                      is_disc=True).float()
                l_fake = self.cri_gan(self.disc(_nchw(out.detach())), False,
                                      is_disc=True).float()
                l_d = l_real + l_fake
                l_d.backward()
            base = float(self.opt.get("train", {}).get("optim_d", {}).get(
                "lr", 1e-4))
            lr = base * (float(self.schedule(self.d_updates))
                         if self.schedule is not None else 1.0)
            for group in self.d_optimizer.param_groups:
                group["lr"] = lr
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            self.sync_grads(self.disc.parameters())
            self.d_optimizer.step()
            self.d_optimizer.zero_grad(set_to_none=True)
            self.d_updates += 1
            logs.update(l_d=l_d.detach(), l_d_real=l_real.detach(),
                        l_d_fake=l_fake.detach())
        return state, {k: float(v) for k, v in logs.items()}

    def train_step(self, state: TrainState, batch):
        return self.gan_train_step(state, batch, current_iter=state.iter + 1)


class _RealESRGANFeed:
    """The on-device two-order degradation feed (realesrgan_feed.py) of the
    Real-ESRNet / Real-ESRGAN trainers: a batch with blur kernels
    ("kernel1", as RealESRGANDataset gives) is synthesised into (lq, gt),
    gt the unsharp-masked one unless l1_gt_usm is false; other batches
    (paired, validation) pass through. Its streams: a random.Random and a
    np.random.RandomState seeded with manual_seed, and a torch.Generator on
    the trainer's device seeded with manual_seed * 1,000,003 + the feed's
    call count for the noise (the JAX package keys PRNGKey(count)). It
    synthesises the batch it is given, which under data parallelism is
    this rank's own (train_pipeline's loaders): a "data" axis's rank i
    seeds all three with manual_seed + i in place of manual_seed, as the
    reference seeds each rank with seed + rank, so the ranks' degradations
    differ (ranks along "model" alone share them)."""

    def _init_feed(self, opt: Dict):
        from comfyui_keep_torch.training.realesrgan_feed import \
            TrainingPairPool
        self._degrade_opt = opt
        self._feed_seed = self.seed + (0 if self.mesh is None
                                       else self.mesh.index("data"))
        self.py_rng = random.Random(self._feed_seed)
        self.np_rng = np.random.RandomState(self._feed_seed)
        self._pool = TrainingPairPool(opt.get("queue_size", 180),
                                      np_rng=self.np_rng)
        self._feed_counter = 0
        self._l1_gt_usm = opt.get("l1_gt_usm", True)

    def feed_data(self, batch: Dict) -> Dict:
        if "kernel1" not in batch:
            return batch
        from comfyui_keep_torch.training.realesrgan_feed import \
            realesrgan_synthesize
        self._feed_counter += 1
        gen = torch.Generator(device=self.device).manual_seed(
            self._feed_seed * 1_000_003 + self._feed_counter)
        out = realesrgan_synthesize(
            {k: v.to(self.device) for k, v in batch.items()
             if torch.is_tensor(v)}, self._degrade_opt, gen,
            pool=self._pool, py_rng=self.py_rng, np_rng=self.np_rng)
        gt = out["gt_usm"] if self._l1_gt_usm else out["gt"]
        return {"lq": out["lq"], "gt": gt, "gt_raw": out["gt"],
                "gt_usm": out["gt_usm"]}


@MODEL_REGISTRY.register(name="RealESRNetModel")
class RealESRNetTrainer(_RealESRGANFeed, SRTrainer):
    """Real-ESRNet (reference models/realesrnet_model.py): SRTrainer's
    losses on synthesised pairs."""

    def __init__(self, opt: Dict, device="cuda",
                 feature_fn: Optional[Callable] = None, mesh=None):
        SRTrainer.__init__(self, opt, device, feature_fn, mesh)
        self._init_feed(opt)


@MODEL_REGISTRY.register(name="RealESRGANModel")
class RealESRGANTrainer(_RealESRGANFeed, SRGANTrainer):
    """Real-ESRGAN (reference models/realesrgan_model.py): SRGANTrainer on
    synthesised pairs."""

    def __init__(self, opt: Dict, device="cuda",
                 feature_fn: Optional[Callable] = None, mesh=None):
        SRGANTrainer.__init__(self, opt, device, feature_fn, mesh)
        self._init_feed(opt)


# the reference's per-family wrapper classes, sharing the trainers above
MODEL_REGISTRY.register(SRGANTrainer, name="ESRGANModel")
MODEL_REGISTRY.register(SRTrainer, name="SwinIRModel")
MODEL_REGISTRY.register(SRGANTrainer, name="HiFaceGANModel")


@MODEL_REGISTRY.register(name="VideoRecurrentModel")
class VideoRecurrentTrainer(BaseTrainer):
    """Recurrent video SR (reference models/video_recurrent_model.py):
    the pixel loss on network_g's clip. The flow net (top-level `spynet`)
    trains in a second param group at flow_lr_mul times the LR; while
    the iteration is below train.fix_flow, the flow net's (and an `edvr`
    module's) gradients are zeroed after the backward. They still take the
    optimizer step, as optax's multi_transform updates every leaf: with a
    zero gradient Adam's moments decay and weight decay still moves the
    weights, as in the JAX package, whose warm-up stops only the gradient.
    Batches: "lq" (B, T, H, W, 3) and "gt" (B, T, sH, sW, 3), or (B, sH, sW,
    3) for a centre-frame net (EDVR)."""

    def __init__(self, opt: Dict, device="cuda", flow_prefix="spynet",
                 mesh=None):
        super().__init__(opt, device, mesh)
        t = opt.get("train", {})
        self.cri_pix = build_loss(t["pixel_opt"]) if t.get("pixel_opt") \
            else None
        self.flow_lr_mul = t.get("flow_lr_mul", 0.125)
        self.fix_flow_iter = t.get("fix_flow", 0)
        self.flow_prefix = flow_prefix
        net = dict(opt["network_g"])
        self.arch_type = net.pop("type")
        self.net_cfg = net

    def init_model(self):
        return _seeded(self.arch_type, self.net_cfg, self.seed)

    def make_optimizer(self, model, trainable):
        """optim_g over two param groups: the flow net's at flow_lr_mul
        times the LR, the rest."""
        flow = {id(p) for n, p in model.named_parameters()
                if n.split(".")[0] == self.flow_prefix}
        groups = [{"params": [p for p in trainable if id(p) not in flow]}]
        if flow:
            groups.append({"params": [p for p in trainable if id(p) in flow],
                           "lr_mul": self.flow_lr_mul})
        return super().make_optimizer(model, groups)

    def net(self, model, lq):
        out = model(lq.permute(0, 1, 4, 2, 3))
        return (out.permute(0, 1, 3, 4, 2) if out.dim() == 5
                else _nhwc(out))

    @torch.no_grad()
    def forward(self, model, lq):
        return self.net(model, lq.to(self.device))

    def loss_fn(self, model, batch):
        l_pix = self.cri_pix(self.net(model, batch["lq"]), batch["gt"])
        return l_pix, {"l_pix": l_pix}

    def backward(self, state: TrainState, batch):
        """BaseTrainer.backward, then the fix_flow warm-up: at iteration
        state.iter + 1 below fix_flow the flow net's and edvr's gradients
        are zeroed (the window's earlier micro-steps were below it too)."""
        logs = super().backward(state, batch)
        if self.fix_flow_iter and state.iter + 1 < self.fix_flow_iter:
            for n, p in state.model.named_parameters():
                if n.split(".")[0] in (self.flow_prefix, "edvr") \
                        and p.grad is not None:
                    p.grad.zero_()
        return logs


MODEL_REGISTRY.register(VideoRecurrentTrainer, name="VideoBaseModel")
MODEL_REGISTRY.register(VideoRecurrentTrainer, name="VideoGANModel")
MODEL_REGISTRY.register(VideoRecurrentTrainer, name="VideoRecurrentGANModel")
MODEL_REGISTRY.register(VideoRecurrentTrainer, name="EDVRModel")


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the parameters' .grad, in place: with
    n = sqrt(sum of every gradient's squares), each g becomes g / n *
    max_norm where n >= max_norm (torch's clip_grad_norm_ scales by max /
    (n + 1e-6) instead). Returns n."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


@MODEL_REGISTRY.register(name="GMFlowModel")
class GMFlowTrainer(BaseTrainer):
    """GMFlow (reference archs/gmflow/main.py:180-420): AdamW (train.lr 4e-4,
    weight_decay 1e-4) after optax's global-norm clip (grad_clip 1.0) on
    optax's one-cycle cosine schedule over num_steps + 10 updates
    (pct_start 0.05), and flow_loss_func (gamma 0.9) on the reference's two
    predictions, GMFlow.forward(return_preds=True): the matched flow before
    propagation upsampled bilinearly (weight gamma), then the final flow
    (weight 1), so the correlation and the f1 half of the last cross
    attention get a gradient; the metrics are the final flow's (the JAX
    package passes the final flow alone). network_g:
    attn_splits, corr_radius, prop_radius; the net is GMFlow's default
    (128 channels, 6 layers), as the JAX package's init. Batches: "img1",
    "img2" (B, H, W, 3) in [0, 255], "flow" (B, H, W, 2), "valid" (B, H,
    W). The transformer's kernels run forward on the card and take their
    plain versions' gradients (ops/kernels.py PlainBackward)."""

    def __init__(self, opt: Dict, device="cuda", mesh=None):
        super().__init__(opt, device, mesh)
        t = opt.get("train", {})
        self.lr = t.get("lr", 4e-4)
        self.weight_decay = t.get("weight_decay", 1e-4)
        self.grad_clip = t.get("grad_clip", 1.0)
        self.gamma = t.get("gamma", 0.9)
        self.num_steps = t.get("num_steps", 100000)
        g = opt.get("network_g", {})
        self.attn_splits = g.get("attn_splits", 2)
        self.corr_radius = g.get("corr_radius", -1)
        self.prop_radius = g.get("prop_radius", -1)
        self.lr_schedule = cosine_onecycle(self.num_steps + 10, self.lr,
                                           pct_start=0.05)

    def current_lr(self, it: int) -> float:
        return self.lr_schedule(it // self.accumulate_steps)

    def init_model(self) -> GMFlow:
        return GMFlow(device="cpu",
                      generator=torch.Generator().manual_seed(self.seed))

    def make_optimizer(self, model, trainable):
        return torch.optim.AdamW(trainable, lr=self.lr,
                                 weight_decay=self.weight_decay)

    def before_step(self, state: TrainState):
        clip_by_global_norm_(list(state.model.parameters()), self.grad_clip)

    def loss_fn(self, model: GMFlow, batch):
        preds = model(batch["img1"], batch["img2"], self.attn_splits,
                      self.corr_radius, self.prop_radius, return_preds=True)
        loss, metrics = flow_loss_func(preds, batch["flow"],
                                       valid=batch.get("valid"),
                                       gamma=self.gamma)
        return loss, {**metrics, "l_flow": loss}


def build_model(opt: Dict, **kw):
    """The trainer MODEL_REGISTRY holds for opt["model_type"] (reference
    models/__init__.py:18-29), every model type of the JAX package's
    registry; an unknown name raises its KeyError."""
    return MODEL_REGISTRY.get(opt["model_type"])(opt, **kw)
