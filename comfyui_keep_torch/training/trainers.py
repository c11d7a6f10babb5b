"""Trainers of the PyTorch port, ported from
comfyui_keep_tpu/training/trainers.py. Slice 2 brings the KEEP stage-II
step (reference models/keep_model.py): frozen VQHQEncoder ground-truth
codes through the nearest-codebook kernel, GMFlow flows through GMFlow's
kernels, the codebook-feature, cross-entropy, temporal and pixel losses,
Adam with fix_modules, the LR schedule, EMA, gradient accumulation and bf16
mixed precision. The other trainers are ROADMAP Queue 1 item 12.

A step is eager: forward, losses, backward and, at the end of each
accumulation window, the optimizer update; the EMA moves on every
micro-step, as the JAX package's does.
"""
import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
from comfyui_keep_torch.models.keep import KEEP, config
from comfyui_keep_torch.models.vqgan import VQHQEncoder
from comfyui_keep_torch.ops import flow_warp, resize_flow
from comfyui_keep_torch.training.losses import build_loss
from comfyui_keep_torch.training.schedulers import (build_scheduler,
                                                    with_warmup)
from comfyui_keep_torch.training.state import (TrainState, build_optimizer,
                                               cast_parameters, ema_init,
                                               ema_update, freeze)


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
    (`default_fix_modules` when the options do not say).
    """
    default_fix_modules = ()

    def __init__(self, opt: Dict, device="cuda"):
        self.opt = opt
        self.device = torch.device(device)
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
        model = (self.init_model() if model is None else model).to(
            self.device)
        trainable = freeze(model, self.fix_modules)
        optimizer = build_optimizer(
            self.opt.get("train", {}).get("optim_g",
                                          {"type": "Adam", "lr": 1e-4}),
            trainable)
        ema = ema_init(model) if self.ema_decay > 0 else None
        return TrainState(model=model, optimizer=optimizer, ema=ema)

    def _cast_batch(self, batch):
        dt = self.compute_dtype
        return {k: v.to(self.device, dt if dt and v.is_floating_point()
                        else v.dtype) for k, v in batch.items()}

    def backward(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Forward, losses and backward of one micro-batch: adds 1/k of its
        gradient to the trainable parameters' .grad. Returns the f32 loss
        terms (detached), with "l_total"."""
        model = state.model
        ctx = (cast_parameters(model, self.compute_dtype)
               if self.compute_dtype else contextlib.nullcontext(model))
        with ctx:
            total, loss_dict = self.loss_fn(model, self._cast_batch(batch))
            total = total.float()
            (total / self.accumulate_steps).backward()
        logs = {k: v.detach().float() for k, v in loss_dict.items()}
        logs["l_total"] = total.detach()
        return logs

    def train_step(self, state: TrainState, batch):
        """One micro-step -> (state, {name: float loss})."""
        logs = self.backward(state, batch)
        if (state.iter + 1) % self.accumulate_steps == 0:
            lr = self.current_lr(state.iter)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
                for p in group["params"]:
                    # optax updates every trainable leaf, reached or not
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        if state.ema is not None:
            ema_update(state.ema, state.model, self.ema_decay)
        state.iter += 1
        return state, {k: float(v) for k, v in logs.items()}


class KEEPTrainer(BaseTrainer):
    """KEEP stage II/III trainer (reference models/keep_model.py): the
    codebook-feature L2 of the encoder's latents against the ground-truth
    codes, cross-entropy of the code logits against those codes, the
    flow-warped temporal consistency of the generator features, and the
    pixel loss.

    hq_vqgan: the frozen VQHQEncoder that gives the ground-truth codes;
    gmflow: the frozen flow net (zero flows without it). Both are moved to
    the trainer's device and compute dtype. The trainer runs on "cuda"
    unless given device="cpu".
    """
    default_fix_modules = ("quantize", "generator")

    def __init__(self, opt: Dict, hq_vqgan: Optional[VQHQEncoder] = None,
                 gmflow: Optional[GMFlow] = None, device="cuda"):
        super().__init__(opt, device)
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
        if t.get("perceptual_opt"):
            raise NotImplementedError("the perceptual loss waits for VGG "
                                      "(ROADMAP Queue 1 item 10)")
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

    @torch.no_grad()
    def forward(self, model: KEEP, lq):
        """Eval forward (validation): the network on the LQ clip with its
        flows."""
        return model.apply(lq, flows=self._flows(lq))

    def loss_fn(self, model: KEEP, batch):
        total, loss_dict, _ = self._loss_outs(model, batch)
        return total, loss_dict

    def _loss_outs(self, model: KEEP, batch):
        """(total, {name: loss}, restored frames)."""
        lq, gt = batch["lq"], batch["gt"]
        flows = self._flows(lq) if self.gmflow is not None else None
        outs, aux = model(lq, flows)
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
        return total, loss_dict, outs


def build_model(opt: Dict, **kw):
    """opt["model_type"] -> its trainer; only KEEPModel is ported yet."""
    if opt["model_type"] == "KEEPModel":
        return KEEPTrainer(opt, **kw)
    raise NotImplementedError(f"model_type {opt['model_type']} is not "
                              f"ported yet (ROADMAP Queue 1 item 12)")
