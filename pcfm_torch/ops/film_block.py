"""Fused FiLM residual block — the velocity-net trunk hot path.

Port of pcfm/ops/pallas/film_block.py (forward).  One trunk block is

    u = LayerNorm(h; s, t)          # eps 1e-5, two-pass variance, fp32
    f = u * (1 + gamma) + beta      # per-cloud FiLM, gamma/beta (B, C)
    y = f + silu(f) @ w.T + b       # residual Linear, w (C_out, C_in)

``w`` is the torch ``Linear`` weight (out, in), the transpose of the JAX
kernel's (in, out) operand.

``film_block`` launches the hand-written CUDA kernel
(pcfm_torch/csrc/film_block.cu) for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it runs ``film_block_reference``, the
plain-torch version that the CPU tests and the on-card comparison use.
Forward only: the backward kernel is not ported yet, so CUDA inputs that
require grad raise instead of differentiating through the plain version.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

LN_EPS = 1e-5
MAX_C = 1024          # the 64 x C bf16 A operand must fit in shared memory

launches = 0


def _stats(h32: torch.Tensor):
    mean = h32.mean(dim=-1, keepdim=True)
    var = torch.square(h32 - mean).mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + LN_EPS)


def film_block_reference_forward(h, s, t, gamma, beta, w, b):
    """Unfused plain-torch version in fp32 math: (y in h.dtype, mean,
    rstd), the kernel's outputs."""
    h32 = h.to(torch.float32)
    mean, rstd = _stats(h32)
    u = (h32 - mean) * rstd * s + t
    f = u * (1.0 + gamma[:, None, :].to(torch.float32)) \
        + beta[:, None, :].to(torch.float32)
    y = f + torch.nn.functional.silu(f) @ w.to(torch.float32).T + b
    return y.to(h.dtype), mean, rstd


def film_block_reference(h, s, t, gamma, beta, w, b) -> torch.Tensor:
    """Unfused plain-torch version (fp32 math, y in h.dtype)."""
    return film_block_reference_forward(h, s, t, gamma, beta, w, b)[0]


def _check_shapes(h, s, t, gamma, beta, w, b):
    if h.dim() != 3:
        raise ValueError(f"film_block: h must be (B, N, C), got "
                         f"{tuple(h.shape)}")
    bsz, _, c = h.shape
    if c % 128 != 0:
        raise ValueError(f"film_block needs C % 128 == 0, got C={c}")
    want = {"s": (c,), "t": (c,), "b": (c,), "gamma": (bsz, c),
            "beta": (bsz, c), "w": (c, c)}
    got = {"s": s, "t": t, "b": b, "gamma": gamma, "beta": beta, "w": w}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"film_block: {name} must be {shape}, got "
                             f"{tuple(got[name].shape)}")


@functools.lru_cache(maxsize=None)
def _lib():
    from pcfm_torch.ops import build
    lib = build.load_library()
    ptr = ctypes.c_void_p
    lib.pcfm_film_block_fwd.argtypes = [ptr] * 10 + [ctypes.c_int] * 4 + [ptr]
    lib.pcfm_film_block_fwd.restype = ctypes.c_int
    lib.pcfm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcfm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(h, s, t, gamma, beta, w, b):
    global launches
    args = {"h": h, "s": s, "t": t, "gamma": gamma, "beta": beta, "w": w,
            "b": b}
    for name, x in args.items():
        if x.device != h.device:
            raise ValueError(f"film_block: {name} is on {x.device}, h on "
                             f"{h.device}")
        if not x.is_contiguous():
            raise ValueError(f"film_block: {name} must be contiguous")
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in args.values()):
        raise RuntimeError("film_block: the backward kernel is not yet "
                           "ported; call the CUDA kernel under "
                           "torch.no_grad()")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"film_block: h must be bf16 or fp32, got {h.dtype}")
    for name in ("gamma", "beta"):
        if args[name].dtype != h.dtype:
            raise TypeError(f"film_block: {name} must have h's dtype "
                            f"{h.dtype}, got {args[name].dtype}")
    for name in ("s", "t", "w", "b"):
        if args[name].dtype != torch.float32:
            raise TypeError(f"film_block: {name} must be fp32, got "
                            f"{args[name].dtype}")
    bsz, n, c = h.shape
    if c > MAX_C or bsz > 65535 or n == 0:
        raise ValueError(f"film_block kernel takes C <= {MAX_C}, "
                         f"B <= 65535, N > 0; got {tuple(h.shape)}")
    if w.data_ptr() % 16:
        raise ValueError("film_block: w must be 16-byte aligned")

    y = torch.empty_like(h)
    mean = torch.empty((bsz, n, 1), dtype=torch.float32, device=h.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib().pcfm_film_block_fwd(
            h.data_ptr(), s.data_ptr(), t.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), bsz, n, c,
            int(h.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = _lib().pcfm_cuda_error_string(err).decode()
        raise RuntimeError(f"film_block kernel launch failed: {msg} ({err})")
    launches += 1
    return y, mean, rstd


def film_block_forward(h, s, t, gamma, beta, w, b):
    """(y, mean, rstd): y (B, N, C) in h.dtype, per-row LayerNorm mean and
    rstd (B, N, 1) fp32.  CUDA tensors run the kernel, CPU tensors the
    plain version."""
    _check_shapes(h, s, t, gamma, beta, w, b)
    if h.is_cuda:
        return _launch(h, s, t, gamma, beta, w, b)
    if h.device.type != "cpu":
        raise ValueError(f"film_block: no kernel for device {h.device}")
    return film_block_reference_forward(h, s, t, gamma, beta, w, b)


def film_block(h, s, t, gamma, beta, w, b) -> torch.Tensor:
    """Fused trunk block: h (B, N, C); s, t, b (C,); gamma, beta (B, C);
    w (C, C) torch Linear weight.  Returns y (B, N, C) in h.dtype.
    C must be a multiple of 128."""
    return film_block_forward(h, s, t, gamma, beta, w, b)[0]
