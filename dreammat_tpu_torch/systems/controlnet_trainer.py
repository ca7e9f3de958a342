"""ControlNet training: epsilon-MSE fine-tuning of the 22-channel ControlNet.

Counterpart of ``dreammat_tpu/systems/controlnet_trainer.py``.
Frozen VAE, UNet and CLIP text encoder; a trainable ControlNet seeded from
the UNet (``controlnet_from_unet``, diffusers' ``from_unet`` semantics). Per
step: VAE-encode the target, draw t and the noise, add noise, CLIP-encode
the prompts (all under ``no_grad``), then ControlNet + UNet forward, the
eps-MSE, ``backward``, gradient clipping by global norm and AdamW.

Precision: as in the JAX trainer (flax ``dtype=bf16`` with the default fp32
``param_dtype``), the ControlNet's parameters are fp32 master weights that
AdamW updates, and every step runs the ControlNet on a bf16 cast of them
(``torch.func.functional_call``), so autograd brings the bf16 gradient back
to fp32 through the cast. The frozen UNet, VAE and CLIP text encoder are
stored and run in bf16 (the same values flax computes with). Every D=64 attention goes through the CUDA
kernels on the card: the forward (kernel A) everywhere, and the backward
(kernels C and D) in the ControlNet and in the UNet's up path, where the
ControlNet's residuals enter. ``model_size: tiny`` runs in fp32 throughout,
as the JAX trainer does.

Weights are random unless ``sd_cache_dir`` holds diffusers-layout ``unet``,
``vae`` and ``text_encoder`` checkpoints. Checkpoints are torch-native
(``utils/ckpt.py``); ``export_diffusers`` writes the diffusers-layout
safetensors that the guidance loads through ``controlnet_path``.

More than one process (``fit(..., mesh=make_mesh(...))`` under a process
group, as the JAX trainer takes a mesh): the batch splits over the mesh's
data axis, each rank reading only its rows of the global batch and keeping
its rows of the global batch's draws (``vae_eps``, ``t``, ``noise`` from the
same seeded generator on every rank), so a run on ``n_data`` ranks takes
the steps of the one-process run at the same global batch. Only the
trainable ControlNet is wrapped in ``DistributedDataParallel``, whose
all-reduce averages the gradient before the clip by global norm; under
``n_model > 1`` the frozen UNet is split by ``tp_shard_params`` (the JAX
trainer's tensor-parallel placement). The logged loss is the global mean;
rank 0 alone writes ``metrics.csv``, the checkpoints and the export.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion import convert
from dreammat_tpu_torch.models.diffusion.clip_text import CLIPTextConfig, CLIPTextModel
from dreammat_tpu_torch.models.diffusion.controlnet import ControlNet, ControlNetConfig
from dreammat_tpu_torch.models.diffusion.scheduler import (
    SchedulerConfig, add_noise, ddim_step, ddim_timesteps, make_schedule,
)
from dreammat_tpu_torch.models.diffusion.tokenizer import CLIPTokenizer
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from dreammat_tpu_torch.parallel import distributed as dist
from dreammat_tpu_torch.parallel.mesh import Mesh, shard_batch, tp_shard_params
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.ckpt import save_checkpoint
from dreammat_tpu_torch.utils.hw import resolve_device


@torch.no_grad()
def controlnet_from_unet(controlnet: torch.nn.Module, unet: torch.nn.Module) -> int:
    """Copy every UNet state-dict entry whose key and shape match into the
    ControlNet (time embedding, conv_in, down and mid blocks). Returns the
    number of entries copied."""
    usd = unet.state_dict()
    n = 0
    for key, dst in controlnet.state_dict().items():
        src = usd.get(key)
        if src is not None and src.shape == dst.shape:
            dst.copy_(src)
            n += 1
    return n


@torch.no_grad()
def zero_controlnet_outputs_(controlnet: ControlNet) -> None:
    """Zero the convs the JAX ControlNet initializes to zero: the 1x1 output
    convs and the conditioning stem's last conv."""
    for conv in [*controlnet.controlnet_down_blocks, controlnet.controlnet_mid_block,
                 controlnet.controlnet_cond_embedding.conv_out]:
        conv.weight.zero_()
        conv.bias.zero_()


class CastForward(nn.Module):
    """``module`` run on a ``dtype`` cast of its parameters
    (``torch.func.functional_call``): autograd brings the gradient back to
    the stored (fp32) parameters through the cast, where DDP's hooks see it."""

    def __init__(self, module: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.module = module
        self.dtype = dtype

    def forward(self, *args):
        params = {n: p.to(self.dtype) for n, p in self.module.named_parameters()}
        return torch.func.functional_call(self.module, params, args)


def _nchw(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device).permute(0, 3, 1, 2)


@dreammat_tpu_torch.register("controlnet-trainer")
class ControlNetTrainer(BaseObject):
    @dataclass
    class Config:
        sd_cache_dir: Optional[str] = None
        controlnet_dir: str = "model/controlnet"
        resolution: int = 256
        train_batch_size: int = 32
        num_train_epochs: int = 3
        learning_rate: float = 1e-5
        adam_beta1: float = 0.9
        adam_beta2: float = 0.999
        adam_weight_decay: float = 1e-2
        adam_epsilon: float = 1e-8
        max_grad_norm: float = 1.0
        lr_scheduler: str = "constant"
        lr_warmup_steps: int = 500
        checkpointing_steps: int = 10000
        use_cfg: bool = False
        seed: int = 0
        model_size: str = "sd21"  # "sd21" | "tiny"
        half_precision_weights: bool = True
        conditioning_channels: int = 22

    cfg: Config

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        tiny = cfg.model_size == "tiny"
        self.dtype = torch.bfloat16 if (cfg.half_precision_weights and not tiny) else torch.float32
        self.unet_cfg = UNetConfig.tiny() if tiny else UNetConfig.sd21()
        self.vae_cfg = VAEConfig.tiny() if tiny else VAEConfig.sd()
        self.clip_cfg = CLIPTextConfig.tiny() if tiny else CLIPTextConfig.sd21()
        self.cnet_cfg = ControlNetConfig(
            unet=self.unet_cfg, conditioning_channels=cfg.conditioning_channels,
            conditioning_embedding_channels=(16, 32) if tiny else (16, 32, 96, 256),
        )
        self.tokenizer = CLIPTokenizer(
            vocab_dir=os.path.join(cfg.sd_cache_dir, "tokenizer") if cfg.sd_cache_dir else None,
            max_length=self.clip_cfg.max_length, vocab_size=self.clip_cfg.vocab_size,
        )
        self.schedule = make_schedule(SchedulerConfig(), device=self.device)
        self.num_train_timesteps = SchedulerConfig().num_train_timesteps
        self.unet = self.vae = self.clip = self.controlnet = None
        self.controlnet_compute = self.controlnet_ddp = None
        self.mesh: Optional[Mesh] = None
        self.grad_allreduces = 0
        self.optimizer = self.lr_scheduler = None
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.step = 0
        self.step_seconds: List[float] = []

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)

    # ------------------------------------------------------------------
    def _build(self) -> None:
        def frozen(fn, dtype):
            return convert.build_on(fn, self.device, dtype).eval().requires_grad_(False)

        self.unet = frozen(lambda: UNet2DCondition(self.unet_cfg), self.dtype)
        self.vae = frozen(lambda: AutoencoderKL(self.vae_cfg), self.dtype)
        self.clip = frozen(lambda: CLIPTextModel(self.clip_cfg), self.dtype)
        self.controlnet = convert.build_on(lambda: ControlNet(self.cnet_cfg), self.device,
                                           torch.float32).train()
        self.controlnet_compute = CastForward(self.controlnet, self.dtype)
        self.controlnet_ddp = None
        self.optimizer = self.lr_scheduler = None

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights (normal 0.02, norms 1, biases 0; the ControlNet's
        output convs 0), the frozen models from ``sd_cache_dir`` when it
        exists, then the ControlNet seeded from the UNet."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._build()
        for m in (self.unet, self.vae, self.clip, self.controlnet):
            convert.random_init_(m, generator)
        zero_controlnet_outputs_(self.controlnet)
        if cfg.sd_cache_dir:
            for sub, module, kind in (("unet", self.unet, "unet"), ("vae", self.vae, "vae"),
                                      ("text_encoder", self.clip, "clip")):
                convert.load_model_dir(module, os.path.join(cfg.sd_cache_dir, sub), kind)
        controlnet_from_unet(self.controlnet, self.unet)

    def load_state_dicts(self, sds: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Load ``{"unet", "vae", "clip", "controlnet"}`` state dicts strictly
        (e.g. from ``convert.controlnet_trainer_state_from_flax``)."""
        self._build()
        for name in ("unet", "vae", "clip", "controlnet"):
            getattr(self, name).load_state_dict(sds[name], strict=True)

    def make_optimizer(self) -> None:
        """Clip by global norm, then AdamW; ``constant_with_warmup`` ramps the
        lr linearly from 0 at step 0 (optax ``linear_schedule``)."""
        cfg = self.cfg
        self.optimizer = torch.optim.AdamW(
            self.controlnet.parameters(), lr=cfg.learning_rate,
            betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_epsilon,
            weight_decay=cfg.adam_weight_decay)
        self.lr_scheduler = None
        if cfg.lr_scheduler == "constant_with_warmup":
            warm = cfg.lr_warmup_steps
            # optax's linear_schedule keeps its initial value (0) when the
            # transition is empty
            self.lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, lambda s: min(s / warm, 1.0) if warm > 0 else 0.0)

    # ------------------------------------------------------------------
    def controlnet_forward(self, noisy, t, ctx, cond, scale: float = 1.0):
        """The ControlNet on a compute-dtype cast of its fp32 parameters."""
        return self.controlnet_compute(noisy, t, ctx, cond, scale)

    def distribute(self, mesh: Optional[Mesh]) -> None:
        """Train over ``mesh``: the ControlNet wrapped in DDP over the data
        axis where ``n_data > 1`` (its gradient all-reduces counted in
        ``grad_allreduces``; the model ranks of one data block hold the same
        gradient, as the JAX trainer's reduction over ``data`` assumes), the
        frozen UNet split over the model axis where ``n_model > 1``. Without
        a process group, one process as before."""
        if self.controlnet is None:
            self.init_params()
        self.mesh = mesh
        if mesh is None or not torch.distributed.is_initialized():
            return
        from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
        from torch.nn.parallel import DistributedDataParallel

        if mesh.n_model > 1:
            n = tp_shard_params(mesh, self.unet)
            dreammat_tpu_torch.info("tensor parallel: %d UNet layers split over %d ranks", n,
                                    mesh.n_model)
        if mesh.n_data == 1:
            return
        self.controlnet_ddp = DistributedDataParallel(
            self.controlnet_compute, process_group=mesh.data_group,
            device_ids=[self.device] if self.device.type == "cuda" else None)

        def counted_allreduce(state, bucket):
            self.grad_allreduces += 1
            return default_hooks.allreduce_hook(state, bucket)

        self.controlnet_ddp.register_comm_hook(mesh.data_group, counted_allreduce)

    def encode_prompts(self, prompts: List[str]) -> torch.Tensor:
        ids = torch.as_tensor(self.tokenizer.batch(prompts), dtype=torch.long, device=self.device)
        with torch.no_grad():
            return self.clip(ids).float()

    def compute_loss(self, batch: Mapping[str, Any],
                     draws: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """The eps-MSE of the ControlNet-conditioned UNet on ``batch``, with
        autograd through the ControlNet and the UNet. ``batch``: this rank's rows
        of the global batch, ``target`` [B,H,W,3] in [0,1], ``condition``
        [B,H,W,22] (the dataset's NHWC arrays) and ``prompts``. ``draws`` may
        hold the global batch's (n_data x B rows) VAE posterior noise
        ``vae_eps`` [.,4,h,w], timesteps ``t`` [.] and latent noise ``noise``
        [.,4,h,w]; otherwise they come from the trainer's generator. This rank
        keeps its rows of them."""
        dev, gen = self.device, self.generator
        target = _nchw(batch["target"], dev)
        cond = _nchw(batch["condition"], dev)
        Bg = target.shape[0] * (self.mesh.n_data if self.mesh else 1)
        f = self.vae_factor
        lat_shape = (Bg, self.vae_cfg.latent_channels, target.shape[2] // f, target.shape[3] // f)
        if draws is None:
            draws = {
                "vae_eps": torch.randn(lat_shape, generator=gen, device=dev),
                "t": torch.randint(0, self.num_train_timesteps, (Bg,), generator=gen, device=dev),
                "noise": torch.randn(lat_shape, generator=gen, device=dev),
            }
        draws = shard_batch(self.mesh, draws)
        with torch.no_grad():
            latents = self.vae.encode(target * 2.0 - 1.0, draws["vae_eps"].to(dev)).float()
            t = draws["t"].to(dev).long()
            noise = draws["noise"].to(dev).float()
            noisy = add_noise(self.schedule, latents, noise, t)
        ctx = self.encode_prompts(list(batch["prompts"]))
        down, mid = (self.controlnet_ddp or self.controlnet_compute)(noisy, t, ctx, cond, 1.0)
        eps = self.unet(noisy, t, ctx, down_block_additional_residuals=down,
                        mid_block_additional_residual=mid)
        return torch.mean((eps - noise) ** 2)

    def train_step(self, batch: Mapping[str, Any],
                   draws: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One optimization step (see ``compute_loss`` for the arguments); the
        loss it returns is the global batch's mean."""
        self.optimizer.zero_grad(set_to_none=True)
        lr = self.optimizer.param_groups[0]["lr"]
        loss = self.compute_loss(batch, draws)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None and self.mesh.n_data > 1:
            torch.distributed.all_reduce(loss, group=self.mesh.data_group)
            loss = loss / self.mesh.n_data
        grad_norm = torch.nn.utils.clip_grad_norm_(self.controlnet.parameters(),
                                                   self.cfg.max_grad_norm)
        self.optimizer.step()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self.step += 1
        return {"loss": loss, "grad_norm": grad_norm.detach(), "lr": lr}

    # ------------------------------------------------------------------
    def fit(self, dataset, out_dir: str, max_steps: Optional[int] = None,
            log_every: int = 10, mesh: Optional[Mesh] = None) -> Dict[str, Any]:
        """Train over ``dataset.batches`` (over ``mesh``, see ``distribute``);
        logs to the console and ``<out_dir>/logs/metrics.csv``, checkpoints
        (with the optimizer) every ``checkpointing_steps``, and ends with
        ``controlnet_final.pt`` (weights and step) and the diffusers export in
        ``<out_dir>/controlnet``. Returns the ControlNet, the step, the
        export's path and the logged losses."""
        cfg = self.cfg
        if self.controlnet is None:
            self.init_params()
        if mesh is not None and self.mesh is None:
            self.distribute(mesh)
        if self.optimizer is None:
            self.make_optimizer()
        log_dir = os.path.join(out_dir, "logs")
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        shard = (self.mesh.data_index, self.mesh.n_data) if self.mesh else (0, 1)
        losses: List[float] = []
        with contextlib.ExitStack() as stack:
            fcsv = writer = None
            if dist.is_rank_zero():
                os.makedirs(log_dir, exist_ok=True)
                fcsv = stack.enter_context(
                    open(os.path.join(log_dir, "metrics.csv"), "w", newline=""))
            for batch in dataset.batches(cfg.train_batch_size, epochs=cfg.num_train_epochs,
                                         shard=shard):
                t0 = time.time()
                metrics = self.train_step(batch)
                sync()
                self.step_seconds.append(time.time() - t0)
                m = {k: float(v) for k, v in metrics.items()}
                losses.append(m["loss"])
                if self.step % log_every == 0 or self.step == max_steps:
                    dreammat_tpu_torch.info("controlnet step %d loss=%.5f grad_norm=%.4g "
                                            "(%.3f s/step)", self.step, m["loss"],
                                            m["grad_norm"], self.step_seconds[-1])
                row = {"step": self.step, **m, "seconds": self.step_seconds[-1]}
                if fcsv is not None:
                    if writer is None:
                        writer = csv.DictWriter(fcsv, fieldnames=list(row))
                        writer.writeheader()
                    writer.writerow(row)
                if cfg.checkpointing_steps and self.step % cfg.checkpointing_steps == 0:
                    self.save(os.path.join(out_dir, f"checkpoint-{self.step}"))
                if max_steps and self.step >= max_steps:
                    break
        self.save(os.path.join(out_dir, "controlnet_final"), with_optimizer=False)
        export = self.export_diffusers(os.path.join(out_dir, "controlnet"))
        return {"controlnet": self.controlnet, "step": self.step, "export": export,
                "losses": losses}

    def save(self, path: str, with_optimizer: bool = True) -> str:
        """A checkpoint of the ControlNet and the step, with the optimizer's
        state for resuming unless ``with_optimizer`` is False (the final save,
        which, as in the JAX trainer, holds the weights only)."""
        opt = self.optimizer.state_dict() if (with_optimizer and self.optimizer) else None
        return save_checkpoint(path, self.controlnet.state_dict(), opt, self.step)

    def export_diffusers(self, out_dir: str) -> str:
        """``diffusion_pytorch_model.safetensors`` in the diffusers ControlNet
        layout (fp32), readable by diffusers, the JAX package and the port's
        guidance (``controlnet_path``); written by rank 0, every rank returns
        once it is complete."""
        from dreammat_tpu_torch.utils.safetensors_io import save_file

        path = os.path.join(out_dir, "diffusion_pytorch_model.safetensors")
        if dist.is_rank_zero():
            os.makedirs(out_dir, exist_ok=True)
            save_file(self.controlnet.state_dict(), path, metadata={"format": "pt"})
        dist.barrier("controlnet_export")
        return path

    # ------------------------------------------------------------------
    @torch.no_grad()
    def validate(self, batch: Mapping[str, Any], n_steps: int = 20,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM sampling (eta 0, CFG scale 7.5) conditioned on ``batch``;
        returns images [B,H,W,3] in [0,1] on the device."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        prompts = list(batch["prompts"])
        ctx = self.encode_prompts(prompts)
        uctx = self.encode_prompts([""] * len(prompts))
        B = ctx.shape[0]
        lat = self.cfg.resolution // self.vae_factor
        x = torch.randn((B, self.vae_cfg.latent_channels, lat, lat), generator=generator,
                        device=self.device)
        cond = _nchw(batch["condition"], self.device)
        ts = ddim_timesteps(self.num_train_timesteps, n_steps)
        guidance_scale = 7.5
        for i, t in enumerate(ts):
            tb = torch.full((B,), int(t), dtype=torch.long, device=self.device)
            down, mid = self.controlnet_forward(x, tb, ctx, cond)
            eps_c = self.unet(x, tb, ctx, down_block_additional_residuals=down,
                              mid_block_additional_residual=mid)
            eps_u = self.unet(x, tb, uctx)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
            t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
            x = ddim_step(self.schedule, x, eps, tb, torch.full_like(tb, t_prev))
        img = self.vae.decode(x).float()
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
