"""Evaluation metrics over datasets: CD / EMD / F-score per cloud, and the
MMD / COV / 1-NNA suite over sets — port of pcfm/eval/metrics.py.

The chamfer terms go through ``pcfm_torch.ops.chamfer`` (the CUDA
nearest-neighbour kernel on the card): ``cloud_metrics`` through
``chamfer_distance`` (two launches a batch), ``cd_matrix`` through the
kernel's pairs form, all pairs of two sets in two launches per block of at
most ``MATRIX_PAIR_ELEMS / max(N, M)`` pairs (two at the suite's
32 x 2048).  EMD is the plain-torch ``pcfm_torch.ops.emd``.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from pcfm_torch.ops.chamfer import chamfer_distance, chamfer_nn, fscore
from pcfm_torch.ops.emd import (earth_mover_distance,
                                earth_mover_distance_streamed)

# (pairs x points) a cd_matrix block holds: its (P, N) distances and
# indices both ways, 2 x 2 x 4 B x 2^24 = 256 MiB
MATRIX_PAIR_ELEMS = 1 << 24


@functools.lru_cache(maxsize=None)
def _pick_chunk(n: int, m: int, target: int = 2048) -> int:
    """Largest common divisor chunk of (n, m) not exceeding target."""
    best = 1
    for c in range(1, min(target, n, m) + 1):
        if n % c == 0 and m % c == 0:
            best = c
    return best


def _subsample_generator(pxyz: torch.Tensor,
                         gxyz: torch.Tensor) -> torch.Generator:
    """A generator seeded from the clouds' bits (the first point of every
    cloud, summed): the same inputs give the same subsample, other inputs
    another one, as the JAX package derives its default key."""
    s = (pxyz[:, 0].sum() + gxyz[:, 0].sum()).to(torch.float32).item()
    mix = int(np.float32(s).view(np.int32))
    return torch.Generator(device=pxyz.device).manual_seed(mix & 0xFFFFFFFF)


def cloud_metrics(pred: torch.Tensor, gt: torch.Tensor,
                  emd_max_points: int = 4096,
                  fscore_threshold: float = 0.001,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """Per-cloud metrics between (B, N, 3[+]) predictions and ground truth:
    {'cd', 'emd', 'fscore', 'precision', 'recall'}, each (B,).

    Clouds larger than ``emd_max_points`` take the streamed EMD over the
    full clouds when N and M have a common chunk >= 256; otherwise EMD
    (only) runs on a random subsample of ``emd_max_points`` points, drawn
    from ``generator`` or, without one, from a generator seeded by the
    clouds' values.  The port's draws are not the JAX package's
    (``jax.random.choice``): the subsample, hence that EMD, differs."""
    pxyz = pred[..., :3].to(torch.float32)
    gxyz = gt[..., :3].to(torch.float32)
    d1, d2, _, _ = chamfer_distance(pxyz, gxyz)
    cd = d1.mean(dim=1) + d2.mean(dim=1)
    f, p1, p2 = fscore(d1, d2, threshold=fscore_threshold)

    def result(emd):
        return {"cd": cd, "emd": emd, "fscore": f, "precision": p1,
                "recall": p2}

    n, m = pxyz.shape[1], gxyz.shape[1]
    if max(n, m) > emd_max_points:
        chunk = _pick_chunk(n, m)
        if chunk >= 256:
            return result(earth_mover_distance_streamed(pxyz, gxyz,
                                                        chunk=chunk))
        if generator is None:
            generator = _subsample_generator(pxyz, gxyz)

        def pick(k):
            return torch.randperm(k, generator=generator,
                                  device=pxyz.device)[:emd_max_points]
        if n > emd_max_points:
            pxyz = pxyz[:, pick(n)]
        if m > emd_max_points:
            gxyz = gxyz[:, pick(m)]
    return result(earth_mover_distance(pxyz, gxyz))


def aggregate(metric_batches: Iterable[Dict]) -> Dict[str, float]:
    """Means over every cloud of a list of per-batch metric dicts."""
    sums: Dict[str, float] = {}
    count = 0
    for mb in metric_batches:
        count += int(np.asarray(mb["cd"]).shape[0])
        for k, v in mb.items():
            sums[k] = sums.get(k, 0.0) + float(np.asarray(v).sum())
    return {k: v / max(1, count) for k, v in sums.items()}


# ---------------------------------------------------------------------------
# Generative-quality suite: MMD / Coverage / 1-NN accuracy (the PointFlow /
# ShapeGF protocol for a SET of generated clouds against a SET of
# references)
# ---------------------------------------------------------------------------

def _cd_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Ga, Gb) chamfer_l2 of every pair, through the kernel's pairs form."""
    ga, gb = a.shape[0], b.shape[0]
    qi = torch.arange(ga).repeat_interleave(gb)
    ti = torch.arange(gb).repeat(ga)
    block = max(1, MATRIX_PAIR_ELEMS // max(a.shape[1], b.shape[1]))
    out = []
    for s in range(0, ga * gb, block):
        d1, _ = chamfer_nn(a, b, qi[s:s + block], ti[s:s + block])
        d2, _ = chamfer_nn(b, a, ti[s:s + block], qi[s:s + block])
        out.append(d1.mean(dim=1) + d2.mean(dim=1))
    return torch.cat(out).reshape(ga, gb)


def _emd_pairs(a: torch.Tensor, b: torch.Tensor,
               pair_block: int) -> torch.Tensor:
    """(Ga, Gb) approxmatch EMD / N of every pair, ``pair_block`` pairs
    (one row cloud against a block of column clouds) a call."""
    rows = []
    for x in a:
        rows.append(torch.cat([
            earth_mover_distance(x[None].expand(len(ys), -1, -1), ys)
            for ys in b.split(pair_block)]))
    return torch.stack(rows)


def cd_matrix(a, b, pair_block: int = 8, metric: str = "cd") -> np.ndarray:
    """Pairwise cloud-distance matrix between sets: a (Ga, N, 3[+]),
    b (Gb, M, 3[+]) -> (Ga, Gb) float64 numpy.  Tensors stay on their
    device (numpy arrays go to the CPU).

    metric="cd": mean(min-d2 a->b) + mean(min-d2 b->a) (the train-time
    chamfer_l2, train.py:80-84); metric="emd": approxmatch EMD cost / N
    (PyTorchEMD emd.py:27-51)."""
    a = torch.as_tensor(a)[..., :3].to(torch.float32).contiguous()
    b = torch.as_tensor(b)[..., :3].to(a.device, torch.float32).contiguous()
    with torch.no_grad():
        if metric == "cd":
            d = _cd_pairs(a, b)
        elif metric == "emd":
            d = _emd_pairs(a, b, pair_block)
        else:
            raise ValueError(f"unknown metric '{metric}'")
    return d.cpu().numpy().astype(np.float64)


def generative_metrics(gen, ref, pair_block: int = 8,
                       metrics: tuple = ("cd",)) -> Dict[str, float]:
    """MMD / COV / 1-NNA between generated and reference sets, per distance
    metric in ``metrics`` ("cd" and / or "emd").

    * MMD (quality): mean over reference clouds of the distance to their
      nearest generated cloud; lower is better.
    * COV (diversity): the share of reference clouds that are the nearest
      neighbour of at least one generated cloud; higher is better.
    * 1-NNA (both): leave-one-out 1-NN two-sample accuracy over the union;
      0.5 is ideal.  ``nna_*_se`` is its binomial standard error over the
      n classifications (treated as independent)."""
    out: Dict[str, float] = {}
    for m in metrics:
        d_gr = cd_matrix(gen, ref, pair_block, metric=m)      # (G, R)
        out[f"mmd_{m}"] = float(d_gr.min(axis=0).mean())
        out[f"cov_{m}"] = float(len(np.unique(d_gr.argmin(axis=1)))
                                / d_gr.shape[1])
        d_gg = cd_matrix(gen, gen, pair_block, metric=m)
        d_rr = cd_matrix(ref, ref, pair_block, metric=m)
        np.fill_diagonal(d_gg, np.inf)
        np.fill_diagonal(d_rr, np.inf)
        correct = (d_gg.min(axis=1) < d_gr.min(axis=1)).sum() \
            + (d_rr.min(axis=1) < d_gr.min(axis=0)).sum()
        n = d_gr.shape[0] + d_gr.shape[1]
        p = float(correct / n)
        out[f"nna_{m}"] = p
        out[f"nna_{m}_se"] = float(np.sqrt(max(p * (1.0 - p), 1e-12) / n))
    return out
