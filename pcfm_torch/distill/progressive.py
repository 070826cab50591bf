"""Progressive velocity-field distillation (few-NFE sampling) — port of
pcfm/distill/progressive.py.

Phase p trains a student for N_p = N / 2^p Euler steps.  At a grid time
t = k / N_p and the flow-matching point x_t = (1 - t) x0 + t x1 (x0 the
prior, x1 the data, the training interpolant) the teacher advances one
student step dt = 1 / N_p with two sub-steps of dt / 2 to x''; the student
regresses its velocity onto the secant

    v*(x_t, t) = (x'' - x_t) / dt,

so that one student Euler step reproduces the teacher's two-sub-step
jump.  After each phase the student's EMA becomes the next teacher.  The
distilled field samples with ``sampler="euler"`` at ``sample_steps=N_p``.
Only the point flow is distilled.

The encoder, the teacher and the student run in eval mode: the hybrid's
BatchNorms normalise with their running statistics, which are the
teacher's (the student starts as a copy of it) and stay frozen through
every phase.  The draws (prior, grid index, condition keep mask) come from
a ``torch.Generator`` or are handed in as ``draws``, so a test can give
both frameworks the same numbers.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from pcfm_torch.sample.integrators import make_guided
from pcfm_torch.sample.priors import make_pf_prior
from pcfm_torch.train.evaluate import _cond_full, eval_mode
from pcfm_torch.train.state import (ModelBundle, ema_update,
                                    trainable_parameters)


def _teacher_two_heun(vf: Callable, x, t, dt):
    """Two Heun (RK2) sub-steps of size dt / 2 from (x, t) -> x'': the
    rollout of a continuous velocity field (the phase-0 teacher, and the
    default for later phases)."""
    h = dt / 2.0
    v1 = vf(x, t)
    v2 = vf(x + h * v1, t + h)
    x_mid = x + 0.5 * h * (v1 + v2)
    v3 = vf(x_mid, t + h)
    v4 = vf(x_mid + h * v3, t + dt)
    return x_mid + 0.5 * h * (v3 + v4)


def _teacher_two_euler(vf: Callable, x, t, dt):
    """Two Euler sub-steps of size dt / 2 from (x, t) -> x'': exact on a
    secant field (a converged previous-phase student); the
    ``teacher_rollout="euler"`` option, which the JAX package measured
    worse end to end than Heun re-integration
    (docs/genq/distill_guided6_run5_ab.json)."""
    h = dt / 2.0
    x1 = x + h * vf(x, t)
    return x1 + h * vf(x1, t + h)


ROLLOUTS = {"heun": _teacher_two_heun, "euler": _teacher_two_euler}


@dataclasses.dataclass
class DistillState:
    """One phase's student: the live module, its EMA shadow (the next
    phase's teacher), their AdamW and the step count."""
    params: nn.Module
    ema_params: nn.Module
    opt: torch.optim.AdamW
    step: int = 0


def init_distill_state(student: nn.Module, lr: float) -> DistillState:
    """A fresh phase for ``student`` (trained in place): EMA = a copy of
    it, AdamW with optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8,
    decay 1e-4 on every trainable parameter; the dead conv biases are not
    trainable)."""
    cuda = next(student.parameters()).is_cuda
    opt = torch.optim.AdamW(trainable_parameters(student), lr=lr,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
                            fused=cuda, foreach=not cuda)
    return DistillState(params=student, ema_params=copy.deepcopy(student),
                        opt=opt)


def make_distill_draws(cfg, batch: Dict[str, torch.Tensor],
                       generator: torch.Generator, phase_steps: int,
                       cond_drop_p: float) -> Dict[str, torch.Tensor]:
    """Every random number of one distill step, from ``generator``: ``x0``
    the point prior (B, N, pf_point_dim), ``k`` the grid index (B,) in
    [0, phase_steps), ``keep`` (B, 1) = 1 where the condition is kept
    (U[0, 1) >= cond_drop_p)."""
    b, n = batch["pts"].shape[:2]
    dev = generator.device
    x0 = make_pf_prior(generator, (b, n, cfg.pf_point_dim),
                       cfg.point_prior_std, cfg.color_prior,
                       cfg.color_prior_std)
    k = torch.randint(0, phase_steps, (b,), generator=generator, device=dev)
    keep = (torch.rand((b, 1), generator=generator, device=dev)
            >= cond_drop_p).to(torch.float32)
    return {"x0": x0, "k": k, "keep": keep}


def make_distill_step(bundle: ModelBundle, phase_steps: int,
                      ema_decay: float = 0.999, guidance_scale: float = 0.0,
                      teacher_rollout: str = "heun",
                      cond_drop_p: float = 0.0):
    """The distillation step of one phase (student grid = phase_steps):
    ``distill_step(teacher, dstate, batch, generator=None, draws=None)``
    updates ``dstate`` in place and returns ``{"loss_distill": 0-d device
    tensor}``.  ``teacher`` is a point-flow module; ``bundle.enc`` encodes
    the condition.

    ``guidance_scale > 0`` distills the classifier-free-guided field
    ``v_c + s (v_c - v_u)`` (one 2B teacher call an evaluation) into a
    student that sees only the conditional input.  ``cond_drop_p > 0``
    zeroes the condition of a Bernoulli row subset for the teacher and the
    student alike, keeping the student's unconditional branch
    supervised."""
    cfg = bundle.cfg
    two_step = ROLLOUTS[teacher_rollout]
    dt = 1.0 / float(phase_steps)

    def loss_fn(teacher, student, batch, draws):
        pts = batch["pts"].to(torch.float32)
        # x1 / encoder input as the train step builds them, rgb zero-filled
        # when the batch has none
        rgb = batch.get("rgb")
        rgb = rgb.to(torch.float32) if rgb is not None \
            else torch.zeros_like(pts)
        x1 = torch.cat([pts, rgb], -1) if cfg.pf_point_dim == 6 else pts
        enc_in = torch.cat([pts, rgb], -1) if cfg.enc_in_channels == 6 \
            else pts
        with torch.no_grad():
            z, _ = bundle.enc(enc_in)
            cond_full = _cond_full(cfg, z, batch.get("cond"))
            if cond_drop_p > 0:
                cond_full = cond_full * draws["keep"].to(cond_full.dtype)
            t = draws["k"].to(torch.float32) / float(phase_steps)
            tb = t[:, None, None]
            x_t = (1.0 - tb) * draws["x0"] + tb * x1
            x_pp = two_step(make_guided(teacher, cond_full, guidance_scale),
                            x_t, t, dt)
            v_star = (x_pp - x_t) / dt
        v_s = student(x_t, t, cond_full, None)
        return torch.mean((v_s.to(torch.float32) - v_star) ** 2)

    def distill_step(teacher: nn.Module, dstate: DistillState,
                     batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = make_distill_draws(cfg, batch, generator, phase_steps,
                                       cond_drop_p)
        student = dstate.params
        dstate.opt.zero_grad(set_to_none=True)
        with eval_mode(bundle.enc, teacher, student):
            loss = loss_fn(teacher, student, batch, draws)
            loss.backward()
        dstate.opt.step()
        ema_update(dstate.ema_params, student, ema_decay)
        dstate.step += 1
        return {"loss_distill": loss.detach()}

    return distill_step


def distill_pf(bundle: ModelBundle,
               batches: Callable[[int], Iterable[dict]],
               base_steps: int = 50, phases: int = 3,
               steps_per_phase: int = 400, lr: float = 1e-4,
               ema_decay: float = 0.999,
               generator: Optional[torch.Generator] = None,
               verbose: bool = True,
               guidance_scale: float = 0.0, cond_drop_p: float = 0.0,
               teacher_rollout: str = "heun"):
    """Run ``phases`` halvings from the bundle's trained point flow (its
    EMA, whose running statistics the students keep).

    ``batches(phase)`` yields the model batches (pts / rgb / cond on the
    bundle's device) of a phase; ``base_steps`` is the teacher's step count
    at phase 0.  Guidance (``guidance_scale``) applies to phase 0 only:
    later phases distill a student with it baked in.  Phase 0 rolls the
    teacher out with Heun, later phases with ``teacher_rollout``.  Returns
    (student, student EMA, steps): modules in eval mode, their running
    statistics the teacher's, and the Euler step count
    base_steps // 2^phases (at least 1).  Sample the student at guidance
    0."""
    if phases < 1:
        raise ValueError(f"distill_pf: phases must be >= 1, got {phases} "
                         "(each phase halves the NFE; 0 phases would be a "
                         "no-op)")
    if generator is None:
        generator = torch.Generator(device=bundle.device).manual_seed(0)
    teacher = bundle.ema_pf
    student = copy.deepcopy(teacher)
    steps = base_steps
    for phase in range(phases):
        steps = max(1, steps // 2)
        dstate = init_distill_state(student, lr)
        dstep = make_distill_step(
            bundle, steps, ema_decay,
            guidance_scale=guidance_scale if phase == 0 else 0.0,
            teacher_rollout="heun" if phase == 0 else teacher_rollout,
            cond_drop_p=cond_drop_p)
        m = None
        for batch in batches(phase):
            m = dstep(teacher, dstate, batch, generator)
            if dstate.step >= steps_per_phase:
                break
        if m is None:
            raise ValueError(f"distill phase {phase}: batches() yielded "
                             "no batches")
        if verbose:
            print(f"[distill] phase {phase + 1}/{phases}: student at "
                  f"{steps} Euler steps, {dstate.step} opt steps, final "
                  f"loss {float(m['loss_distill']):.5f}", flush=True)
        # the student's EMA graduates to teacher for the next halving
        teacher = dstate.ema_params
        student = copy.deepcopy(teacher)
    return dstate.params.eval(), dstate.ema_params.eval(), steps
