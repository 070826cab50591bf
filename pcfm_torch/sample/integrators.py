"""Fixed-grid ODE integrators for flow sampling — port of
pcfm/sample/integrators.py.

The JAX package runs each trajectory as one ``lax.scan``; here it is a
Python loop of eager network calls.  ``make_guided`` implements
classifier-free guidance ``v_c + s (v_c - v_u)`` as ONE batched 2B call
whose unconditional half has a zeroed condition.

Samplers: euler, midpoint (t = (k + 0.5) dt), heun (the reference default,
NFE = 2 * steps), rk4 (NFE = 4 * steps) and the adaptive dopri5.  The time
grid is computed in fp32 as the JAX package computes it
(``float32(k) * dt``).
"""
from __future__ import annotations

import warnings
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


_DOPRI5_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DOPRI5_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI5_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
              11 / 84, 0.0)
_DOPRI5_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
              187 / 2100, 1 / 40)


@torch.no_grad()
def dopri5_sample(vf: VelocityFn, x0: torch.Tensor, steps: int = 50,
                  cond: Optional[torch.Tensor] = None,
                  guidance_scale: float = 0.0, rtol: float = 1e-3,
                  atol: float = 1e-4, max_steps: Optional[int] = None
                  ) -> torch.Tensor:
    """Adaptive Dormand-Prince RK45 on t in [0, 1] (the JAX package's
    ``dopri5_sample``): ``steps`` seeds the first dt (1 / steps),
    ``max_steps`` bounds the attempts (default 8 * steps), a step is
    accepted when the RMS over the whole batch of the scaled error is
    <= 1.  t and dt are fp32 host scalars, computed as JAX computes them;
    each attempt reads the error norm back from the device.  If the budget
    runs out before t reaches 1 the partial state is returned with a
    UserWarning, never silently."""
    v = make_guided(vf, cond, guidance_scale)
    max_steps = int(max_steps or 8 * max(1, steps))
    f32 = dict(dtype=torch.float32)
    t = torch.tensor(0.0, **f32)
    dt = torch.tensor(1.0 / max(1, steps), **f32)
    end = torch.tensor(1.0 - 1e-8, **f32)
    x, it = x0, 0
    while t < end and it < max_steps:
        dt = torch.minimum(dt, 1.0 - t)
        ks = []
        for i in range(7):
            xi = x
            for j, a in enumerate(_DOPRI5_A[i]):
                xi = xi + dt * a * ks[j]
            ti = float(t + _DOPRI5_C[i] * dt)            # exact in fp32
            ks.append(v(xi, torch.full((x0.shape[0],), ti, dtype=x0.dtype,
                                       device=x0.device)))
        x5, x4 = x, x
        for i in range(7):
            x5 = x5 + dt * _DOPRI5_B5[i] * ks[i]
            x4 = x4 + dt * _DOPRI5_B4[i] * ks[i]
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        err_norm = torch.sqrt((((x5 - x4) / scale) ** 2).mean()).cpu()
        factor = (0.9 * (1.0 / err_norm.clamp_min(1e-10)) ** 0.2).clamp(
            0.2, 5.0)
        if err_norm <= 1.0:
            x, t = x5, t + dt
        dt, it = dt * factor, it + 1
    if t < end:
        warnings.warn(
            f"dopri5: max_steps={max_steps} exhausted at t={float(t):.5f} "
            f"< 1 after {it} attempts — the returned state is a PARTIAL "
            "integration; raise max_steps or loosen rtol/atol", stacklevel=2)
    return x


SAMPLERS = {
    "euler": euler_sample,
    "midpoint": midpoint_euler_sample,
    "heun": heun_sample,
    "rk4": rk4_sample,
    "dopri5": dopri5_sample,
}


def get_sampler(name: str):
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler '{name}' "
                         f"(choices: {sorted(SAMPLERS)})")
    return SAMPLERS[name]
