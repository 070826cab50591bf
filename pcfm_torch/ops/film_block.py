"""Fused FiLM residual block — the velocity-net trunk hot path.

Port of pcfm/ops/pallas/film_block.py (forward).  One trunk block is

    u = LayerNorm(h; s, t)          # eps 1e-5, two-pass variance, fp32
    f = u * (1 + gamma) + beta      # per-cloud FiLM, gamma/beta (B, C)
    y = f + silu(f) @ w.T + b       # residual Linear, w (C_out, C_in)

``w`` is the torch ``Linear`` weight (out, in), the transpose of the JAX
kernel's (in, out) operand.

``film_block`` is a ``torch.autograd.Function``.  For CUDA tensors its
forward launches the hand-written CUDA kernel (pcfm_torch/csrc/
film_block.cu) and its backward the backward kernel (pcfm_torch/csrc/
film_block_bwd.cu, port of ``_bwd_kernel``); both raise on what the
kernels do not take.  For CPU tensors the two directions run
``film_block_reference_forward`` and ``film_block_reference_backward``,
the plain-torch versions that the CPU tests and the on-card comparison use.

Each direction has two paths in its C entry point, chosen by C.  The
forward keeps a 64- or 128-row tile's whole bf16 silu(f) in shared memory
up to ``NARROW_C``; the backward keeps a 64-row tile's fp32 dp in
registers up to ``NARROW_C_BWD``.  Above those, up to ``MAX_C`` (both
directions; the JAX kernel takes any C % 128 == 0 that fits its VMEM
budget), the wide paths stream both operands of their product through
shared memory (pcfm_torch/csrc/film_wide.cuh): the forward packs silu(f)
in ``rows_packed_index`` order first, the backward packs dy the same way
and writes dp in fp32 to its workspace.

The forward kernel reads W as bf16 in the byte order of its wgmma B
operand; ``pack_w`` makes that copy (a small kernel that the forward's C
entry point launches first, once per call) and ``pack_w_reference`` is its
plain version.  The backward reads Wᵀ the same way (``packed_t_index``,
``pack_wt_reference``), and its dW pass reads dy and silu(f) in 64-row
tiles packed by its rows pass (``rows_packed_index``,
``pack_rows_reference``).

``launches`` and ``bwd_launches`` count calls of each direction's C entry
point (each launches several kernels; never plain-version calls), so a
run can show that its path went through the kernels.  Inside a FLOP count
(pcfm_torch/utils/flops.py) each call adds its model math: 2·B·N·C²
forward (``silu(f) @ W``), 4·B·N·C² backward (``dy @ W``, ``dyᵀ @ p``),
as many as the plain versions' products.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pcfm_torch.ops.build import check_launch, load_library, use_kernel
from pcfm_torch.utils.flops import kernel_flops

LN_EPS = 1e-5
MAX_C = 2048          # both directions' kernels (their wide paths)
NARROW_C = 1024       # the forward's one-kernel path: the 64 x C bf16 A
                      # operand fits in shared memory
N_TILE = 128          # output rows of W in one packed tile (wgmma n)
K_TILE = 64           # k of one packed tile: one 128-byte swizzle row
MAX_C_BWD = MAX_C
NARROW_C_BWD = 512    # the backward's register path: a 64-row tile's fp32
                      # dp in two warpgroups' registers
ROWS_BWD = 64         # rows of one cloud in a backward tile

launches = 0
bwd_launches = 0


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


def film_block_reference_backward(dy, h, s, t, gamma, beta, w, mean, rstd):
    """Plain-torch restatement of ``_bwd_kernel``
    (pcfm/ops/pallas/film_block.py:93-123) in fp32 math, from the forward's
    saved statistics.  Returns the seven gradients in the forward's argument
    order: (dh in h.dtype, ds, dt, dgamma and dbeta in gamma's dtype, dW
    (out, in) like ``w``, db), the small ones fp32."""
    h32, dy32 = h.to(torch.float32), dy.to(torch.float32)
    g = gamma[:, None, :].to(torch.float32)
    xhat = (h32 - mean) * rstd
    u = xhat * s + t
    f = u * (1.0 + g) + beta[:, None, :].to(torch.float32)
    sig = torch.sigmoid(f)
    dp = dy32 @ w.to(torch.float32)
    df = dy32 + sig * (1.0 + f * (1.0 - sig)) * dp
    c = h.shape[-1]
    dw = dy32.reshape(-1, c).T @ (f * sig).reshape(-1, c)
    du = df * (1.0 + g)
    dxhat = du * s
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dh = rstd * (dxhat - m1 - xhat * m2)
    return (dh.to(h.dtype), (du * xhat).sum(dim=(0, 1)), du.sum(dim=(0, 1)),
            (df * u).sum(dim=1).to(gamma.dtype),
            df.sum(dim=1).to(beta.dtype), dw, dy32.sum(dim=(0, 1)))


def packed_index(c: int, n_tile: int = N_TILE) -> torch.Tensor:
    """(c, c) int64: where W[n, k] lies in the packed buffer.  Tiles of
    ``n_tile`` output rows x 64 k, stored one after the other with the
    output tile outer (the order the kernel's product reads them); inside
    a tile, row r takes 128 bytes and its 16-byte chunk j (k = 8j..8j+7)
    goes to chunk j ^ (r % 8), the 128-byte swizzle of wgmma's K-major
    layout (pcfm_torch/csrc/wgmma_common.cuh)."""
    if c % n_tile or c % K_TILE:
        raise ValueError(f"pack: C={c} must be a multiple of {n_tile} and "
                         f"{K_TILE}")
    n = torch.arange(c)[:, None]
    k = torch.arange(c)[None, :]
    r = n % n_tile
    stage = (n // n_tile) * (c // K_TILE) + k // K_TILE
    chunk = ((k % K_TILE) // 8) ^ (r % 8)
    return (stage * n_tile + r) * K_TILE + chunk * 8 + k % 8


def pack_w_reference(w: torch.Tensor, n_tile: int = N_TILE) -> torch.Tensor:
    """Plain version of the pack kernel: w (C, C) fp32 -> (C * C,) bf16,
    ``w.bfloat16()`` permuted as ``packed_index`` says."""
    c = w.shape[0]
    out = torch.empty(c * c, dtype=torch.bfloat16, device=w.device)
    out[packed_index(c, n_tile).to(w.device).reshape(-1)] = \
        w.to(torch.bfloat16).reshape(-1)
    return out


def packed_t_index(c: int) -> torch.Tensor:
    """(c, c) int64: where W[o, i] lies in the backward's packed Wᵀ, the B
    operand of dp = dy @ W.  Its rows are W's input columns and its k runs
    over W's output rows, so it is ``packed_index`` of Wᵀ: tiles of 128
    input columns x 64 output rows, K-major, swizzled, in the product's
    order."""
    return packed_index(c).T


def pack_wt_reference(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward's pack kernel: w (C, C) fp32 ->
    (C * C,) bf16, ``w.bfloat16()`` permuted as ``packed_t_index`` says."""
    return pack_w_reference(w.T)


def rows_packed_index(bsz: int, n: int, c: int) -> torch.Tensor:
    """(bsz, n, c) int64: where x[b, n, k] lies in the backward's packed
    copies of dy and silu(f), the dW pass's operands.  Tile
    b * ceil(N / 64) + n // 64 holds 64 rows of one cloud (rows past N are
    zeros) as C / 64 regions of 64 columns; in a region, row r takes 128
    bytes and its 16-byte chunk j goes to chunk j ^ (r % 8), the 128-byte
    swizzle (the rows pass's A operand, byte for byte)."""
    if c % K_TILE:
        raise ValueError(f"rows_packed_index: C={c} must be a multiple of "
                         f"{K_TILE}")
    tiles = -(-n // ROWS_BWD)
    b = torch.arange(bsz)[:, None, None]
    row = torch.arange(n)[None, :, None]
    k = torch.arange(c)[None, None, :]
    r = row % ROWS_BWD
    tile = b * tiles + row // ROWS_BWD
    chunk = ((k % K_TILE) // 8) ^ (r % 8)
    return (tile * ROWS_BWD * c + (k // K_TILE) * ROWS_BWD * K_TILE
            + r * K_TILE + chunk * 8 + k % 8)


def pack_rows_reference(x: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) -> (B * ceil(N / 64) * 64 * C,) bf16 laid out as
    ``rows_packed_index`` says, zeros in the rows past N."""
    bsz, n, c = x.shape
    out = torch.zeros(bsz * -(-n // ROWS_BWD) * ROWS_BWD * c,
                      dtype=torch.bfloat16, device=x.device)
    out[rows_packed_index(bsz, n, c).to(x.device).reshape(-1)] = \
        x.to(torch.bfloat16).reshape(-1)
    return out


def pack_w(w: torch.Tensor) -> torch.Tensor:
    """The forward kernel's bf16 copy of w (C, C) fp32: the pack kernel for
    a CUDA tensor, ``pack_w_reference`` for a CPU tensor."""
    if w.dim() != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"pack_w: w must be (C, C), got {tuple(w.shape)}")
    if not use_kernel(w, "pack_w"):
        return pack_w_reference(w)
    c = w.shape[0]
    if w.dtype != torch.float32 or not w.is_contiguous() or c > MAX_C \
            or c % N_TILE or w.data_ptr() % 16:
        raise ValueError(f"pack_w takes a contiguous, 16-byte aligned fp32 "
                         f"(C, C), C % {N_TILE} == 0, C <= {MAX_C}; got "
                         f"{w.dtype} {tuple(w.shape)}")
    out = torch.empty(c * c, dtype=torch.bfloat16, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = _lib().pcfm_film_block_pack_w(w.data_ptr(), out.data_ptr(), c,
                                            stream)
    check_launch(err, "film_block pack_w")
    return out


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
    lib = load_library()
    ptr = ctypes.c_void_p
    lib.pcfm_film_block_fwd.argtypes = [ptr] * 11 + [ctypes.c_int] * 4 + [ptr]
    lib.pcfm_film_block_pack_w.argtypes = [ptr, ptr, ctypes.c_int, ptr]
    lib.pcfm_film_block_pack_w.restype = ctypes.c_int
    lib.pcfm_film_block_fwd.restype = ctypes.c_int
    lib.pcfm_film_block_fwd_workspace.argtypes = [ctypes.c_int] * 3
    lib.pcfm_film_block_fwd_workspace.restype = ctypes.c_longlong
    lib.pcfm_film_block_bwd.argtypes = [ptr] * 17 + [ctypes.c_int] * 4 + [ptr]
    lib.pcfm_film_block_bwd.restype = ctypes.c_int
    lib.pcfm_film_block_bwd_workspace.argtypes = [ctypes.c_int] * 3
    lib.pcfm_film_block_bwd_workspace.restype = ctypes.c_longlong
    return lib


def _check_operands(h, args: dict, max_c: int):
    """What both kernels need of their operands: one device, contiguous,
    h's dtype for the per-row and per-cloud tensors, fp32 for the rest."""
    for name, x in args.items():
        if x.device != h.device:
            raise ValueError(f"film_block: {name} is on {x.device}, h on "
                             f"{h.device}")
        if not x.is_contiguous():
            raise ValueError(f"film_block: {name} must be contiguous")
        want = h.dtype if name in ("h", "dy", "gamma", "beta") \
            else torch.float32
        if name == "h" and h.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"film_block: h must be bf16 or fp32, got "
                            f"{h.dtype}")
        if x.dtype != want:
            raise TypeError(f"film_block: {name} must be {want}, got "
                            f"{x.dtype}")
    bsz, n, c = h.shape
    if c > max_c or bsz > 65535 or n == 0:
        raise ValueError(f"film_block kernel takes C <= {max_c} (MAX_C), "
                         f"B <= 65535, N > 0; got {tuple(h.shape)}")
    for name, x in args.items():       # the kernels' 16-byte loads
        if x.data_ptr() % 16:
            raise ValueError(f"film_block: {name} must be 16-byte aligned")


def film_block_flops(h, *_) -> int:
    """The forward's model math: ``silu(f) @ W`` over B·N rows."""
    bsz, n, c = h.shape
    return 2 * bsz * n * c * c


def film_block_bwd_flops(dy, *_) -> int:
    """The backward's: ``dy @ W`` and ``silu(f)ᵀ @ dy``."""
    return 2 * film_block_flops(dy)


@kernel_flops(film_block_flops)
def _launch(h, s, t, gamma, beta, w, b):
    global launches
    _check_operands(h, {"h": h, "s": s, "t": t, "gamma": gamma,
                        "beta": beta, "w": w, "b": b}, MAX_C)
    bsz, n, c = h.shape
    y = torch.empty_like(h)
    mean = torch.empty((bsz, n, 1), dtype=torch.float32, device=h.device)
    rstd = torch.empty_like(mean)
    # W packed, and for C > NARROW_C the packed silu(f) tiles
    scratch = _lib().pcfm_film_block_fwd_workspace(bsz, n, c)
    if scratch < 0:
        raise ValueError(f"film_block kernel does not take "
                         f"{tuple(h.shape)}")
    packed = torch.empty(scratch, dtype=torch.bfloat16, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib().pcfm_film_block_fwd(
            h.data_ptr(), s.data_ptr(), t.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), w.data_ptr(), b.data_ptr(), packed.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), bsz, n, c,
            int(h.dtype == torch.bfloat16), stream)
    check_launch(err, "film_block")
    launches += 1
    return y, mean, rstd


@kernel_flops(film_block_bwd_flops)
def _launch_bwd(dy, h, s, t, gamma, beta, w, mean, rstd):
    global bwd_launches
    _check_operands(h, {"dy": dy, "h": h, "s": s, "t": t, "gamma": gamma,
                        "beta": beta, "w": w, "mean": mean, "rstd": rstd},
                    MAX_C_BWD)
    bsz, n, c = h.shape
    if dy.shape != h.shape or mean.shape != (bsz, n, 1) \
            or rstd.shape != (bsz, n, 1):
        raise ValueError("film_block backward: dy must be h's shape and "
                         "mean, rstd (B, N, 1)")
    f32 = dict(dtype=torch.float32, device=h.device)
    dh = torch.empty_like(h)
    dw = torch.empty((c, c), **f32)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    db, ds, dt = (torch.empty(c, **f32) for _ in range(3))
    floats = _lib().pcfm_film_block_bwd_workspace(bsz, n, c)
    if floats < 0:
        raise ValueError(f"film_block backward kernel does not take "
                         f"{tuple(h.shape)}")
    work = torch.empty(floats, **f32)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib().pcfm_film_block_bwd(
            dy.data_ptr(), h.data_ptr(), s.data_ptr(), t.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dh.data_ptr(), dw.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), db.data_ptr(), ds.data_ptr(), dt.data_ptr(),
            work.data_ptr(), bsz, n, c, int(h.dtype == torch.bfloat16),
            stream)
    check_launch(err, "film_block backward")
    bwd_launches += 1
    return dh, ds, dt, dgamma, dbeta, dw, db


def film_block_forward(h, s, t, gamma, beta, w, b):
    """(y, mean, rstd): y (B, N, C) in h.dtype, per-row LayerNorm mean and
    rstd (B, N, 1) fp32.  CUDA tensors run the kernel, CPU tensors the
    plain version."""
    _check_shapes(h, s, t, gamma, beta, w, b)
    if use_kernel(h, "film_block"):
        return _launch(h, s, t, gamma, beta, w, b)
    return film_block_reference_forward(h, s, t, gamma, beta, w, b)


def film_block_backward(dy, h, s, t, gamma, beta, w, mean, rstd):
    """The seven gradients of ``film_block`` (see
    ``film_block_reference_backward``) from dy (B, N, C) in h.dtype and the
    forward's saved statistics.  CUDA tensors run the backward kernel, CPU
    tensors the plain version."""
    if use_kernel(h, "film_block backward"):
        return _launch_bwd(dy, h, s, t, gamma, beta, w, mean, rstd)
    return film_block_reference_backward(dy, h, s, t, gamma, beta, w, mean,
                                         rstd)


class FilmBlockFunction(torch.autograd.Function):
    """The fused block with its backward (JAX: the ``custom_vjp`` of
    pcfm/ops/pallas/film_block.py).  Saves h, mean and rstd, as ``_film_fwd``
    saves them, and recomputes f in the backward."""

    @staticmethod
    def forward(ctx, h, s, t, gamma, beta, w, b):
        y, mean, rstd = film_block_forward(h, s, t, gamma, beta, w, b)
        ctx.save_for_backward(h, s, t, gamma, beta, w, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        h, s, t, gamma, beta, w, mean, rstd = ctx.saved_tensors
        # the JAX rule: dy in h's dtype (film_block.py:192); autograd may
        # hand over a strided dy, the kernel takes a contiguous one
        dy = dy.to(h.dtype).contiguous()
        return film_block_backward(dy, h, s, t, gamma, beta, w, mean, rstd)


def film_block(h, s, t, gamma, beta, w, b) -> torch.Tensor:
    """Fused trunk block: h (B, N, C); s, t, b (C,); gamma, beta (B, C);
    w (C, C) torch Linear weight.  Returns y (B, N, C) in h.dtype and is
    differentiable in every argument.  C must be a multiple of 128."""
    return FilmBlockFunction.apply(h, s, t, gamma, beta, w, b)
