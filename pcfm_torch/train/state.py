"""Model bundle and train state — port of pcfm/train/state.py and the
update rule of pcfm/train/flat_opt.py.

``ModelBundle`` builds the encoder, point flow and latent flow from a
``Config`` with the dtype policy of the JAX package (``amp and use_bf16``
-> bf16 compute, fp32 parameters; the hybrid's ContextNet island in
``ctx_dtype``), plus EMA shadows that start equal to the live weights (as
``init_state`` does).  ``pf_backbone`` is ``mlp`` or ``hybrid``.  The
hybrid's ``voxel_backend`` flag selects nothing in the port: on CUDA
tensors the voxel kernels run at every stage, on CPU tensors their plain
versions (pcfm_torch/ops/voxel_sorted.py); the flag stays in the Config,
and so in the checkpoint, as it was given.  The live modules train in
training mode (the hybrid's BatchNorms on batch statistics); the EMA
shadows average every float parameter and buffer, the running statistics
too, as the JAX package's EMA averages ``batch_stats``.

With ``lambda_adv > 0`` and a condition the bundle also holds the
``CondAdversary`` (``adv``; trained, not averaged).

The optimizer is torch's AdamW (fused on CUDA) with the reference's three
parameter groups (enc / pf / lf, train.py:249-253), plus ``adv`` at
``lr_enc`` as the JAX package's fourth, over the parameters the JAX
package has: the hybrid's reference conv biases that feed a BatchNorm
(``dead_conv_biases``; each BatchNorm keeps its bias in the running mean,
the reference's convention) are left out, so no weight decay moves them
and the clip's norm does not count them.  b1 0.9, b2 0.999,
eps 1e-8 and decoupled weight decay: the same update as optax.adamw and the
JAX package's flat AdamW, with each group's warmup + cosine LR evaluated at
the pre-increment step and held at ``min_lr`` past the end.  The joint
global-norm clip runs on the gradients before the moments, with pcfm's
formula ``g * clip / max(gnorm, clip)`` (flat_opt.py:62-64).  There is no
raveled parameter vector, so ``cfg.flat_optimizer`` selects nothing here.

Under data or point-axis parallelism the gradients are averaged over the
world before the clip, in one all-reduce of a flat buffer, after the
whole backward, as the JAX package's psum-mean comes after its whole
backward (pcfm_torch/parallel/collectives.py says why the mean is the
single-device gradient).  Every rank then takes the same update and its
parameters stay equal to every other rank's; ``broadcast_state`` makes
them equal at the start.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, List

import torch
from torch import nn

from pcfm_torch.config import Config
from pcfm_torch.models.adversary import CondAdversary
from pcfm_torch.models.encoder import ShapeEncoder
from pcfm_torch.models.hybrid import HybridMLP
from pcfm_torch.models.latent import ConditionalLatentVelocityNet
from pcfm_torch.models.velocity import VelocityNet
from pcfm_torch.nn.pvconv import dead_conv_biases
from pcfm_torch.parallel import sp_context
from pcfm_torch.parallel.collectives import all_reduce_, broadcast_


class ModelBundle:
    """The port's modules for one Config: ``enc``, ``pf``, ``lf`` and the
    EMA shadows ``ema_pf``, ``ema_lf``, all on ``device``."""

    def __init__(self, cfg: Config, device, generator: torch.Generator):
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = torch.bfloat16 if (cfg.amp and cfg.use_bf16) \
            else torch.float32
        self.dtype = dtype
        kw = dict(generator=generator, device=self.device)
        self.enc = ShapeEncoder(latent_dim=cfg.latent_dim,
                                width=cfg.enc_width, depth=cfg.enc_depth,
                                in_channels=cfg.enc_in_channels, dtype=dtype,
                                **kw)
        if cfg.pf_backbone == "mlp":
            self.pf = VelocityNet(
                cond_dim=cfg.pf_cond_dim, width=cfg.pf_width,
                depth=cfg.pf_depth, emb_dim=cfg.pf_emb_dim,
                point_dim=cfg.pf_point_dim, dtype=dtype,
                fused_trunk=cfg.fused_trunk, film_every=cfg.pf_film_every,
                **kw)
        elif cfg.pf_backbone == "hybrid":
            self.pf = HybridMLP(
                cond_dim=cfg.pf_cond_dim, point_dim=cfg.pf_point_dim,
                ctx_dim=cfg.ctx_dim, ctx_emb_dim=cfg.ctx_emb_dim,
                stage_channels=tuple(cfg.ctx_stage_channels),
                stage_blocks=tuple(cfg.ctx_stage_blocks),
                stage_res=tuple(cfg.ctx_stage_res),
                with_se=cfg.ctx_with_se, norm_type=cfg.ctx_norm,
                gn_groups=cfg.ctx_gn_groups,
                with_global=cfg.ctx_with_global,
                voxel_normalize=cfg.ctx_voxel_normalize, use_t_gate=True,
                t_gate_k=cfg.ctx_t_gate_k, t_gate_tau=cfg.ctx_t_gate_tau,
                pf_width=cfg.pf_width, pf_depth=cfg.pf_depth,
                pf_emb_dim=cfg.pf_emb_dim, dtype=dtype,
                fused_trunk=cfg.fused_trunk, film_every=cfg.pf_film_every,
                ctx_island_dtype=(torch.bfloat16 if cfg.ctx_dtype == "bf16"
                                  else torch.float32),
                grid_bn=cfg.grid_bn, **kw)
        else:
            raise ValueError(f"unknown pf_backbone '{cfg.pf_backbone}' "
                             "(mlp | hybrid)")
        self.lf = ConditionalLatentVelocityNet(
            latent_dim=cfg.latent_dim, cond_dim=0, width=cfg.lf_width,
            depth=cfg.lf_depth, emb_dim=cfg.lf_emb_dim, dtype=dtype, **kw)
        # fp32 whatever the compute dtype, as the JAX bundle builds it
        self.adv = (CondAdversary(cfg.latent_dim, cfg.cond_dim, **kw)
                    if cfg.lambda_adv > 0 and cfg.cond_dim > 0 else None)
        self.ema_pf = copy.deepcopy(self.pf)
        self.ema_lf = copy.deepcopy(self.lf)

    def modules(self) -> dict:
        mods = {"encoder": self.enc, "pf": self.pf, "lf": self.lf,
                "ema_pf": self.ema_pf, "ema_lf": self.ema_lf}
        if self.adv is not None:
            mods["adv"] = self.adv
        return mods

    def pf_velocity_fn(self, use_ema: bool) -> Callable:
        """v(x, t, cond) for the samplers: the EMA or the live point flow
        (the module itself is the velocity function; the samplers run it
        in eval mode, ``train.evaluate.eval_mode``)."""
        return self.ema_pf if use_ema else self.pf

    def lf_velocity_fn(self, use_ema: bool) -> Callable:
        """v(y, t, cond) of the EMA or the live latent flow."""
        return self.ema_lf if use_ema else self.lf


GROUP_LR = {"enc": "lr_enc", "pf": "lr_pf", "lf": "lr_lf", "adv": "lr_enc"}


def cosine_lr(step: int, total: int, base_lr: float, min_lr: float = 1e-6,
              warmup: int = 0) -> float:
    """Linear warmup from ``min_lr``, then cosine to ``min_lr``, held there
    past ``total`` (pcfm/train/state.py:cosine_lr)."""
    if step < warmup:
        return min_lr + (base_lr - min_lr) * step / max(1, warmup)
    t = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
    return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t))


def count_parameters(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def trainable_parameters(module: nn.Module) -> List[torch.Tensor]:
    """The parameters of ``module`` that the JAX package has: all but the
    dead conv biases."""
    dead = {id(bias) for bias, _ in dead_conv_biases(module)}
    return [p for p in module.parameters() if id(p) not in dead]


def make_optimizer(bundle: ModelBundle) -> torch.optim.AdamW:
    """AdamW over the live enc / pf / lf (and, with ``lambda_adv``, adv)
    trainable parameters, one group each; each group keeps its name and
    base LR, ``lr`` is set before every step."""
    cfg = bundle.cfg
    groups = [{"params": trainable_parameters(getattr(bundle, name)),
               "name": name, "base_lr": getattr(cfg, attr),
               "lr": getattr(cfg, attr)} for name, attr in GROUP_LR.items()
              if getattr(bundle, name) is not None]
    cuda = bundle.device.type == "cuda"
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay, fused=cuda,
                             foreach=not cuda)


def clip_by_global_norm_(grads: List[torch.Tensor], clip: float
                         ) -> torch.Tensor:
    """Joint global-norm clip in place, ``g * clip / max(gnorm, clip)``;
    returns the pre-clip norm (the ``grad_norm`` metric), on the device."""
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if clip and clip > 0:
        torch._foreach_mul_(grads, clip / torch.clamp_min(gnorm, clip))
    return gnorm


@torch.no_grad()
def ema_update(shadow: nn.Module, live: nn.Module, decay: float) -> None:
    """shadow <- shadow * d + live * (1 - d) on every float parameter and
    buffer (pcfm/train/state.py:ema_update), in the form
    shadow + (1 - d) * (live - shadow): a value that live and shadow share
    stays as it is (the running statistics that distillation freezes),
    where shadow * d + live * (1 - d) moves ~15 % of them by an fp32 ulp
    a step."""
    def floats(m):
        return [x for x in (*m.parameters(), *m.buffers())
                if x.is_floating_point()]
    torch._foreach_lerp_(floats(shadow), floats(live), 1.0 - decay)


@dataclasses.dataclass
class TrainState:
    """What one training run updates: the modules with their EMA shadows,
    the optimizer, and the global step (a host integer: the LR schedule
    needs no device sync)."""
    bundle: ModelBundle
    opt: torch.optim.AdamW
    total_steps: int
    step: int = 0

    def trainable(self) -> List[torch.Tensor]:
        return [p for g in self.opt.param_groups for p in g["params"]]

    def apply_gradients(self) -> torch.Tensor:
        """From the ``.grad`` of every trainable parameter: joint clip,
        AdamW, EMA, step + 1.  Returns the pre-clip global norm."""
        cfg = self.bundle.cfg
        params = self.trainable()
        for p in params:
            if p.grad is None:  # JAX differentiates every leaf: zero, not skip
                p.grad = torch.zeros_like(p)
        average_gradients([p.grad for p in params])
        gnorm = clip_by_global_norm_([p.grad for p in params],
                                     cfg.grad_clip_norm or 0.0)
        for g in self.opt.param_groups:  # LR at the pre-increment step
            g["lr"] = (cosine_lr(self.step, self.total_steps, g["base_lr"],
                                 cfg.min_lr, cfg.warmup_steps)
                       if cfg.use_cosine_lr else g["base_lr"])
        self.opt.step()
        ema_update(self.bundle.ema_pf, self.bundle.pf, cfg.ema_decay)
        ema_update(self.bundle.ema_lf, self.bundle.lf, cfg.ema_decay)
        self.step += 1
        return gnorm


def average_gradients(grads: List[torch.Tensor]) -> None:
    """The world's mean of each gradient, in place (nothing on one rank):
    one all-reduce of the gradients flattened into one buffer."""
    world = sp_context.world_axis()
    if world is None:
        return
    flat = all_reduce_(torch._utils._flatten_dense_tensors(grads), world)
    flat /= world.size
    for g, mean in zip(grads, torch._utils._unflatten_dense_tensors(
            flat, grads)):
        g.copy_(mean)


def broadcast_state(state: "TrainState") -> None:
    """Rank 0's parameters and buffers (the EMA shadows' too) into every
    rank's modules."""
    broadcast_([t for m in state.bundle.modules().values()
                for t in (*m.parameters(), *m.buffers())])


def init_state(cfg: Config, device, total_steps: int,
               generator: torch.Generator) -> TrainState:
    """Fresh modules (drawn from ``generator``; in training mode, as built),
    EMA = init, a zero-step optimizer."""
    bundle = ModelBundle(cfg, device, generator)
    return TrainState(bundle=bundle, opt=make_optimizer(bundle),
                      total_steps=total_steps)
