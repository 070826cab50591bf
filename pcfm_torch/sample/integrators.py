"""Fixed-grid ODE integrators for flow sampling — port of
pcfm/sample/integrators.py.

The JAX package runs each trajectory as one ``lax.scan``; here it is a
Python loop of eager network calls.  ``make_guided`` implements
classifier-free guidance ``v_c + s (v_c - v_u)`` as ONE batched 2B call
whose unconditional half has a zeroed condition.

Samplers: euler, midpoint (t = (k + 0.5) dt), heun (the reference default,
NFE = 2 * steps) and rk4 (NFE = 4 * steps).  The time grid is computed in
fp32 as the JAX package computes it (``float32(k) * dt``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

VelocityFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                      torch.Tensor]


def make_guided(vf: VelocityFn, cond: Optional[torch.Tensor],
                guidance_scale: float) -> Callable:
    """Wrap a velocity fn into v(x, t) with optional CFG; vf(x, t, cond)
    accepts cond=None or a (B, C) tensor."""
    if guidance_scale <= 0.0 or cond is None:
        return lambda x, t: vf(x, t, cond)

    def guided(x, t):
        v2 = vf(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0),
                torch.cat([cond, torch.zeros_like(cond)], dim=0))
        v_c, v_u = v2.chunk(2, dim=0)
        return v_c + guidance_scale * (v_c - v_u)

    return guided


def _grid(x0: torch.Tensor, k: float, dt: float) -> torch.Tensor:
    """(B,) times ``float32(k) * dt`` on x0's device."""
    return torch.full((x0.shape[0],), k, dtype=x0.dtype,
                      device=x0.device) * dt


@torch.no_grad()
def euler_sample(vf: VelocityFn, x0: torch.Tensor, steps: int,
                 cond: Optional[torch.Tensor] = None,
                 guidance_scale: float = 0.0) -> torch.Tensor:
    """Plain Euler on t = k / steps."""
    v = make_guided(vf, cond, guidance_scale)
    dt = 1.0 / steps
    x = x0
    for k in range(steps):
        x = x + v(x, _grid(x0, k, dt)) * dt
    return x


@torch.no_grad()
def midpoint_euler_sample(vf: VelocityFn, x0: torch.Tensor, steps: int,
                          cond: Optional[torch.Tensor] = None,
                          guidance_scale: float = 0.0) -> torch.Tensor:
    """Euler on the midpoint grid t = (k + 0.5) / steps — the reference
    ``euler_sample`` (models.py:277-290)."""
    v = make_guided(vf, cond, guidance_scale)
    dt = 1.0 / steps
    x = x0
    for k in range(steps):
        x = x + v(x, _grid(x0, k + 0.5, dt)) * dt
    return x


@torch.no_grad()
def heun_sample(vf: VelocityFn, x0: torch.Tensor, steps: int,
                cond: Optional[torch.Tensor] = None,
                guidance_scale: float = 0.0) -> torch.Tensor:
    """Heun (RK2) predictor-corrector on t0 = k / steps -> t1 = (k+1) /
    steps — the reference sampler (train.py:332-341)."""
    v = make_guided(vf, cond, guidance_scale)
    dt = 1.0 / steps
    x = x0
    for k in range(steps):
        v1 = v(x, _grid(x0, k, dt))
        v2 = v(x + v1 * dt, _grid(x0, k + 1.0, dt))
        x = x + 0.5 * dt * (v1 + v2)
    return x


@torch.no_grad()
def rk4_sample(vf: VelocityFn, x0: torch.Tensor, steps: int,
               cond: Optional[torch.Tensor] = None,
               guidance_scale: float = 0.0) -> torch.Tensor:
    """Classic RK4 fixed-grid integrator (NFE = 4 * steps)."""
    v = make_guided(vf, cond, guidance_scale)
    dt = 1.0 / steps
    x = x0
    for k in range(steps):
        t = _grid(x0, k, dt)
        k1 = v(x, t)
        k2 = v(x + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = v(x + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = v(x + dt * k3, t + dt)
        x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


SAMPLERS = {
    "euler": euler_sample,
    "midpoint": midpoint_euler_sample,
    "heun": heun_sample,
    "rk4": rk4_sample,
}


def get_sampler(name: str):
    if name == "dopri5":
        raise NotImplementedError("the dopri5 sampler is not yet ported to "
                                  "pcfm_torch")
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler '{name}' "
                         f"(choices: {sorted(SAMPLERS)})")
    return SAMPLERS[name]
