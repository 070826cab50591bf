"""Chamfer distance (any point dimension) — port of pcfm/ops/chamfer.py and
of the TPU chamfer kernel (pcfm/ops/pallas/chamfer_v3.py: ``_kernel``).

``chamfer_nn`` is the nearest-neighbour search in the pairs form: for P
(query cloud, target cloud) pairs ``(qi[p], ti[p])`` of a (Q, N, D) query
stack and a (T, M, D) target stack, each query point's least squared
distance to the target cloud and the target's index, ``(dist (P, N) fp32,
idx (P, N) int32)``.  The distance is taken in difference form,
``sum_d (a_d - b_d)^2`` in fp32, and ties go to the lowest index.
``chamfer_distance`` is the pairs ``qi = ti = arange(B)``, both ways;
``pcfm_torch.eval.metrics.cd_matrix`` all pairs of two sets.

A CUDA tensor launches the hand-written kernel (pcfm_torch/csrc/
chamfer_nn.cu; D = 1..8, raises on what it does not take); a CPU tensor
runs ``chamfer_nn_reference``, the plain chunked difference-form version
that the CPU tests and the on-card comparison use.  ``launches`` counts
kernel launches, never plain-version calls.

The JAX package picks the neighbour with the dot trick ``|a|^2 + |b|^2 -
2 a.b`` and recomputes its distance in difference form; the port picks it
in difference form too, so near ties are decided exactly.  The kernel
scores ``|a~ - b~|^2`` on the tensor cores (TF32 coordinates relative to
the pair's first target point) only as a screen, and checks in difference
form every target whose screen passes a threshold proven to admit the
nearest one and its ties; ``screen`` returns those scores for one pair,
so that the card's error can be held against the margin the threshold
allows (``SCREEN_KAPPA``).  As in JAX the
argmin is constant under differentiation: when an input requires grad,
``chamfer_distance`` recomputes the returned distances in torch from the
indices, so gradients flow to both clouds.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from pcfm_torch.ops.build import check_launch, load_library, use_kernel

MAX_D = 8                   # the kernel's point width, as the TPU kernel pads
MAX_GRID_PAIRS = 65535      # pairs a launch (the grid's y extent)
PLAIN_ELEMS = 1 << 26       # the plain version's (pairs, rows, M, D) chunk
# the kernel's bound on its screen's error over (|a~| + |b~|)^2 (KAPPA in
# chamfer_nn.cu), which its margin is derived from
SCREEN_KAPPA = 2.0 ** -17

launches = 0


@contextlib.contextmanager
def full_fp32_matmul():
    """fp32 matmuls in full precision (TF32 off) for the block, as the JAX
    package's HIGHEST precision."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, D), (B, M, D) -> (B, N, M) squared L2 distances by the dot
    trick, clamped >= 0 (pcfm/ops/chamfer.py:pairwise_sqdist)."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    with full_fp32_matmul():
        cross = torch.bmm(a, b.transpose(1, 2))
    d2 = (a * a).sum(-1)[:, :, None] + (b * b).sum(-1)[:, None, :] \
        - 2.0 * cross
    return d2.clamp_min(0.0)


def _pair_ids(ids, count: int, what: str) -> torch.Tensor:
    """A host int64 vector of cloud indices, each checked to lie in
    [0, count) (the kernel reads the clouds they name)."""
    ids = torch.as_tensor(ids).to("cpu", torch.int64).reshape(-1)
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= count):
        raise ValueError(f"chamfer_nn: {what} indices must lie in "
                         f"[0, {count})")
    return ids


def _pairs(query: torch.Tensor, target: torch.Tensor, qi, ti):
    """Check the stacks; the pairs' host index vectors (qi, ti)."""
    if query.dim() != 3 or target.dim() != 3 \
            or query.shape[2] != target.shape[2]:
        raise ValueError(f"chamfer_nn: query (Q, N, D) and target (T, M, D)"
                         f" with one D; got {tuple(query.shape)} / "
                         f"{tuple(target.shape)}")
    if query.shape[1] == 0 or target.shape[1] == 0:
        raise ValueError("chamfer_nn: clouds must hold at least one point")
    qi = _pair_ids(qi, query.shape[0], "query")
    ti = _pair_ids(ti, target.shape[0], "target")
    if qi.numel() != ti.numel():
        raise ValueError("chamfer_nn: qi and ti must have one length")
    return qi, ti


# ------------------------------------------------------------ plain version

def chamfer_nn_reference(query: torch.Tensor, target: torch.Tensor, qi, ti,
                         chunk: int = 4096):
    """Plain version of the kernel: chunked difference-form distances in
    fp32, ``argmin`` (the first minimal index).  Chunks of at most
    ``chunk`` queries keep the (pairs, rows, M, D) block under
    PLAIN_ELEMS."""
    qi, ti = _pairs(query, target, qi, ti)
    q, t = query.to(torch.float32), target.to(torch.float32)
    p, (_, n, d), m = qi.numel(), q.shape, t.shape[1]
    dist = torch.empty((p, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((p, n), dtype=torch.int32, device=q.device)
    rows = max(1, min(n, chunk, PLAIN_ELEMS // (m * d)))
    pairs = max(1, PLAIN_ELEMS // (rows * m * d))
    for ps in range(0, p, pairs):
        qq = q[qi[ps:ps + pairs].to(q.device)]                  # (pc, N, D)
        tt = t[ti[ps:ps + pairs].to(q.device)]                  # (pc, M, D)
        for s in range(0, n, rows):
            diff = qq[:, s:s + rows, None, :] - tt[:, None, :, :]
            d2 = (diff * diff).sum(-1)                          # (pc, r, M)
            imin = d2.argmin(-1)
            dist[ps:ps + pairs, s:s + rows] = d2.gather(
                -1, imin[..., None])[..., 0]
            idx[ps:ps + pairs, s:s + rows] = imin.to(torch.int32)
    return dist, idx


# ------------------------------------------------------------ kernel

@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pcfm_chamfer_nn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr] * 3
    lib.pcfm_chamfer_nn.restype = i32
    lib.pcfm_chamfer_screen.argtypes = [ptr] * 2 + [i32] * 3 + [ptr] * 2
    lib.pcfm_chamfer_screen.restype = i32
    return lib


def _launch(query, target, qi, ti, dist, idx):
    global launches
    p, n, m, d = qi.numel(), query.shape[1], target.shape[1], query.shape[2]
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = _lib().pcfm_chamfer_nn(
            query.data_ptr(), target.data_ptr(), qi.data_ptr(),
            ti.data_ptr(), p, n, m, d, dist.data_ptr(), idx.data_ptr(),
            stream)
    check_launch(err, "chamfer_nn")
    launches += 1


def _check_stacks(query: torch.Tensor, target: torch.Tensor) -> None:
    """What the kernels take: contiguous fp32 on one device, D <= 8."""
    for name, x in {"query": query, "target": target}.items():
        if x.dtype != torch.float32:
            raise TypeError(f"chamfer_nn: {name} must be fp32, got "
                            f"{x.dtype}")
        if x.device != query.device or not x.is_contiguous():
            raise ValueError(f"chamfer_nn: {name} must be contiguous on "
                             f"{query.device}")
    if query.shape[-1] > MAX_D:
        raise ValueError(f"chamfer_nn kernel takes D <= {MAX_D}, got "
                         f"D={query.shape[-1]}")


def chamfer_nn(query: torch.Tensor, target: torch.Tensor, qi, ti,
               chunk: int = 4096):
    """Nearest target point of each query point, for the pairs
    ``(qi[p], ti[p])``: ``(dist (P, N) fp32, idx (P, N) int32)``.

    ``qi`` / ``ti`` are host integer vectors (sequences or CPU tensors) of
    cloud indices.  On the card: one launch per 65 535 pairs; the stacks
    must be contiguous fp32 on one device with D <= 8.  ``chunk`` is the
    plain version's query chunk (CPU tensors)."""
    if not use_kernel(query, "chamfer_nn"):
        return chamfer_nn_reference(query, target, qi, ti, chunk)
    qi, ti = _pairs(query, target, qi, ti)
    _check_stacks(query, target)
    dev, p, n = query.device, qi.numel(), query.shape[1]
    dist = torch.empty((p, n), dtype=torch.float32, device=dev)
    idx = torch.empty((p, n), dtype=torch.int32, device=dev)
    # pinned, so that the copy does not wait for the card
    ids = torch.stack([qi, ti]).to(torch.int32).pin_memory().to(
        dev, non_blocking=True)
    for s in range(0, p, MAX_GRID_PAIRS):
        e = min(p, s + MAX_GRID_PAIRS)
        _launch(query, target, ids[0, s:e], ids[1, s:e], dist[s:e],
                idx[s:e])
    return dist, idx


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties
    away from zero, 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)


def screen_reference(query: torch.Tensor, target: torch.Tensor):
    """Plain version of ``screen``: ``|a~ - b~|^2`` (N, M) in float64 from
    the kernel's TF32 coordinates, and ``(|a~| + |b~|)^2``, the scale that
    the kernel's error bound ``SCREEN_KAPPA`` is relative to."""
    at = _tf32(query - target[0]).double()
    bt = _tf32(target - target[0]).double()
    na, nb = (at * at).sum(-1), (bt * bt).sum(-1)
    exact = na[:, None] + nb[None, :] - 2.0 * at @ bt.T
    scale = (na.sqrt()[:, None] + nb.sqrt()[None, :]) ** 2
    return exact, scale


def screen(query: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The kernel's screen for one pair on the card, (N, D) queries
    against (M, D) targets: ``|a~ - b~|^2`` (N, M) fp32 from the tensor
    cores, where ``x~`` is ``x - target[0]`` rounded to TF32.  Not on any
    path: it lets a check hold the card's screen error against the
    kernel's margin (``SCREEN_KAPPA``)."""
    if query.dim() != 2 or target.dim() != 2 or not query.is_cuda \
            or query.shape[1] != target.shape[1]:
        raise ValueError("screen: (N, D) and (M, D) CUDA tensors")
    _check_stacks(query, target)
    n, m = query.shape[0], target.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = _lib().pcfm_chamfer_screen(
            query.data_ptr(), target.data_ptr(), n, m, query.shape[1],
            out.data_ptr(), stream)
    check_launch(err, "chamfer_screen")
    return out


# ------------------------------------------------------------ chamfer

def _gathered_sqdist(x: torch.Tensor, y: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """|x - y[idx]|^2 per row of x (differentiable in x and y)."""
    ynn = torch.gather(y, 1, idx.long()[..., None].expand(-1, -1,
                                                          y.shape[-1]))
    return ((x - ynn) ** 2).sum(dim=-1)


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096):
    """Bidirectional nearest-neighbour squared-L2 Chamfer distance of a
    (B, N, D) and b (B, M, D): (dist1 (B, N), dist2 (B, M), idx1, idx2),
    the interface of the reference's ``chamfer_3DDist``.  Two kernel
    launches on the card."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    pairs = torch.arange(a.shape[0])
    with torch.no_grad():
        ac, bc = a.detach().contiguous(), b.detach().contiguous()
        dist1, idx1 = chamfer_nn(ac, bc, pairs, pairs, chunk)
        dist2, idx2 = chamfer_nn(bc, ac, pairs, pairs, chunk)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        dist1 = _gathered_sqdist(a, b, idx1)
        dist2 = _gathered_sqdist(b, a, idx2)
    return dist1, dist2, idx1, idx2


def chamfer_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Train-time CD of the reference (train.py:80-84): per cloud, the sum
    of the two direction means of the min squared distance.  (B,)."""
    dist1, dist2, _, _ = chamfer_distance(pred, target)
    return dist1.mean(dim=1) + dist2.mean(dim=1)


def fscore(dist1: torch.Tensor, dist2: torch.Tensor,
           threshold: float = 0.001):
    """F-score at a squared-distance threshold from Chamfer outputs:
    (fscore, precision1, precision2), each (B,)."""
    precision_1 = (dist1 < threshold).to(torch.float32).mean(dim=1)
    precision_2 = (dist2 < threshold).to(torch.float32).mean(dim=1)
    denom = precision_1 + precision_2
    f = torch.where(denom > 0, 2 * precision_1 * precision_2
                    / denom.clamp_min(1e-30), torch.zeros_like(denom))
    return f, precision_1, precision_2
