"""Trainers of the PyTorch port, ported from
comfyui_keep_tpu/training/trainers.py. Slice 2 brings the KEEP stage-II
step (reference models/keep_model.py): frozen VQHQEncoder ground-truth
codes through the nearest-codebook kernel, GMFlow flows through GMFlow's
kernels, the codebook-feature, cross-entropy, temporal and pixel losses,
Adam with fix_modules, the LR schedule, EMA, gradient accumulation and bf16
mixed precision. Slice 3 brings StyleGAN2's GAN alternation
(StyleGAN2Model, reference models/stylegan2_model.py). The other trainers
are ROADMAP Queue 1 item 12.

A step is eager: forward, losses, backward and, at the end of each
accumulation window, the optimizer update; the EMA moves on every
micro-step, as the JAX package's does.
"""
import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
from comfyui_keep_torch.models.keep import KEEP, config
from comfyui_keep_torch.models.stylegan2 import (StyleGAN2Discriminator,
                                                 StyleGAN2Generator)
from comfyui_keep_torch.models.vqgan import VQHQEncoder
from comfyui_keep_torch.ops import flow_warp, resize_flow
from comfyui_keep_torch.training.losses import (build_loss, g_path_regularize,
                                                r1_penalty)
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

    def __init__(self, opt: Dict, device="cuda"):
        super().__init__(opt, device)
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
        model = (self.init_model() if model is None else model).to(
            self.device).train().requires_grad_(True)
        if disc is None:
            disc = StyleGAN2Discriminator(
                self.d_cfg.get("out_size", self.out_size),
                channel_multiplier=self.d_cfg.get("channel_multiplier", 2),
                device="cpu",
                generator=torch.Generator().manual_seed(self.seed + 99))
        self.disc = disc.to(self.device).train().requires_grad_(True)
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
        """The random inputs of one alternation: D's and G's style codes,
        the per-layer noise both use, and at a path iteration its latents
        (B // 2 codes), their per-layer noise and the image-shaped noise."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + current_iter)
        d = {"d_styles": self._mixing_noise(b, gen),
             "g_styles": self._mixing_noise(b, gen),
             "noise": model.make_noise(b, gen)}
        if current_iter % self.net_g_reg_every == 0:
            pb = max(1, b // 2)
            d["path_latents"] = torch.randn((pb, self.num_style_feat),
                                            generator=gen, device=self.device)
            d["path_layer_noise"] = model.make_noise(pb, gen)
            d["path_noise"] = torch.randn((pb, 3, self.out_size,
                                           self.out_size), generator=gen,
                                          device=self.device)
        return d

    @staticmethod
    def _step(optimizer: torch.optim.Optimizer, loss):
        """One optimizer step on d loss / d (every parameter it holds)."""
        params = [p for grp in optimizer.param_groups for p in grp["params"]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def gan_train_step(self, state: TrainState, batch, current_iter: int,
                       draws: Optional[Dict] = None):
        """One alternation (stylegan2_model.py:185-254, the JAX package's
        order): D step, lazy R1, G step, lazy path regularisation, EMA.
        Returns (state, {name: float loss})."""
        g_net, d_net = state.model, self.disc
        real = batch["gt"].to(self.device)
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


def build_model(opt: Dict, **kw):
    """opt["model_type"] -> its trainer: KEEPModel or StyleGAN2Model."""
    if opt["model_type"] == "KEEPModel":
        return KEEPTrainer(opt, **kw)
    if opt["model_type"] == "StyleGAN2Model":
        return StyleGAN2Trainer(opt, **kw)
    raise NotImplementedError(f"model_type {opt['model_type']} is not "
                              f"ported yet (ROADMAP Queue 1 item 12)")
