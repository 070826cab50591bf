"""Record the choices a forward pass makes at the kinks of its function,
and make another forward pass take the same ones.

A network's gradient is continuous in its inputs except at its kinks: a
ReLU or leaky ReLU input at 0 (the slope is 1 on one side, 0 or the leak
on the other), the elements that attain an ``amax`` (the gradient goes to
them alone), and the voxel a point is rounded into (``normalize_coords``:
another voxel, other neighbours).  Two computations of the same step that
round differently (the card's kernels and orders of summation against the
CPU's plain versions, bf16 against fp32) take another side of a kink
wherever an input lies within rounding distance of it, and the gradients
then differ by that element's whole contribution, which a following
normalisation spreads over its channel.

``record(kinks)`` notes each choice in call order: the sign mask of every
``torch.relu`` and ``leaky_relu`` (``pcfm_torch.nn.pvconv``'s), the mask
of the elements that attain every ``Tensor.amax``, and the outputs of
every ``normalize_coords`` of the voxel ops.  ``replay(kinks)`` runs a
forward pass with the recorded choices instead of its own: a ReLU passes
exactly the recorded elements (``where(mask, x, 0)``, so its gradient is
the recorded mask), a leaky ReLU leaks exactly at the recorded elements,
an ``amax`` is the mean of the recorded elements (its gradient split over
them, as over ties), and the voxel coordinates are the recorded ones.
Between the choices, the replayed pass computes as it would.  Replaying a
pass's own record reproduces it; replaying another device's or
precision's record leaves only the differences between the choices, the
rounding itself.  ``flips(a, b)`` counts the elements whose choice differs.

Masks are kept on the CPU and moved to the replayed tensor's device.
Nothing here is on a training or sampling path: it serves the checks that
hold one computation of the hybrid step against another.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch
from torch.nn import functional as F

from pcfm_torch.nn import pvconv
from pcfm_torch.ops import voxel_sorted

# every patched name: (owner, attribute, kind)
SITES = ((torch, "relu", "relu"), (pvconv, "leaky_relu", "leaky_relu"),
         (torch.Tensor, "amax", "amax"),
         (voxel_sorted, "normalize_coords", "coords"))


class Kinks:
    """The choices of one forward pass, in call order: ``(kind, data)``
    with ``data`` a bool mask (relu, leaky_relu, amax) or the
    (norm_coords, vox_coords) pair (coords), on the CPU."""

    def __init__(self):
        self.sites: List[Tuple[str, object]] = []

    def counts(self) -> dict:
        out: dict = {}
        for kind, _ in self.sites:
            out[kind] = out.get(kind, 0) + 1
        return out


def _dims(x: torch.Tensor, dim) -> tuple:
    dims = tuple(dim) if isinstance(dim, (tuple, list)) else (dim,)
    return tuple(sorted(d % x.dim() for d in dims)) or tuple(range(x.dim()))


@contextlib.contextmanager
def _patched(fns: dict) -> Iterator[None]:
    # a name a class inherits is deleted again, not set on the class
    saved = [(owner, attr, vars(owner).get(attr)) for owner, attr, _ in SITES]
    try:
        for owner, attr, kind in SITES:
            setattr(owner, attr, fns[kind])
        yield
    finally:
        for owner, attr, fn in saved:
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)


@contextlib.contextmanager
def record(kinks: Kinks) -> Iterator[Kinks]:
    """Run the forward passes inside as they are, noting their choices in
    ``kinks``."""
    relu, amax = torch.relu, torch.Tensor.amax
    coords = voxel_sorted.normalize_coords
    in_coords = []          # the amax inside normalize_coords is its own

    def rec_relu(x):
        kinks.sites.append(("relu", (x > 0).cpu()))
        return relu(x)

    def rec_leaky(x, negative_slope=0.01, inplace=False):
        kinks.sites.append(("leaky_relu", (x > 0).cpu()))
        return F.leaky_relu(x, negative_slope, inplace)

    def rec_amax(x, dim=(), keepdim=False):
        out = amax(x, dim, keepdim)
        if in_coords:
            return out
        top = out
        if not keepdim:
            for d in _dims(x, dim):
                top = top.unsqueeze(d)
        kinks.sites.append(("amax", (x == top).cpu()))
        return out

    def rec_coords(*args, **kwargs):
        in_coords.append(True)
        try:
            nc, vc = coords(*args, **kwargs)
        finally:
            in_coords.pop()
        kinks.sites.append(("coords", (nc.cpu(), vc.cpu())))
        return nc, vc

    with _patched({"relu": rec_relu, "leaky_relu": rec_leaky,
                   "amax": rec_amax, "coords": rec_coords}):
        yield kinks


@contextlib.contextmanager
def replay(kinks: Kinks) -> Iterator[None]:
    """Run the forward passes inside with the choices of ``kinks``, taken
    in call order; raises if a pass reaches a kink the record does not
    have (another kind, another shape, or past its end)."""
    it = iter(kinks.sites)

    def take(kind: str, shape) -> object:
        got, data = next(it, (None, None))
        have = data[1].shape if kind == "coords" and got == kind else \
            getattr(data, "shape", None)
        if got != kind or tuple(have) != tuple(shape):
            have = None if have is None else tuple(have)
            raise RuntimeError(f"kinks: the pass reached a {kind} of shape "
                               f"{tuple(shape)}, the record has {got} of "
                               f"shape {have}")
        return data

    def rep_relu(x):
        mask = take("relu", x.shape).to(x.device)
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    def rep_leaky(x, negative_slope=0.01, inplace=False):
        mask = take("leaky_relu", x.shape).to(x.device)
        return torch.where(mask, x, x * negative_slope)

    def rep_amax(x, dim=(), keepdim=False):
        mask = take("amax", x.shape).to(x.device)
        dims = _dims(x, dim)
        top = torch.where(mask, x.to(torch.float32), 0.0).sum(dims, keepdim)
        return (top / mask.sum(dims, keepdim)).to(x.dtype)

    def rep_coords(coords, resolution, *args, **kwargs):
        nc, vc = take("coords", coords.shape)
        return nc.to(coords.device), vc.to(coords.device)

    with _patched({"relu": rep_relu, "leaky_relu": rep_leaky,
                   "amax": rep_amax, "coords": rep_coords}):
        yield
    if next(it, None) is not None:
        raise RuntimeError("kinks: the pass ended before the record did")


def flips(a: Kinks, b: Kinks) -> dict:
    """Per kind, the number of elements whose choice differs between two
    records of the same pass (for coords: the points in another voxel),
    and the number of elements compared."""
    if [k for k, _ in a.sites] != [k for k, _ in b.sites]:
        raise ValueError("kinks: the records are of different passes")
    out: dict = {}
    for (kind, x), (_, y) in zip(a.sites, b.sites):
        if kind == "coords":
            x, y = x[1], y[1]
            diff = int((x != y).any(-1).sum())
            n = x.shape[0] * x.shape[1]
        else:
            diff, n = int((x != y).sum()), x.numel()
        d, m = out.get(kind, (0, 0))
        out[kind] = (d + diff, m + n)
    return out
