#!/usr/bin/env python3
"""Widest C at which the JAX package's FiLM-block kernel compiles for a TPU.

    python scripts/film_jax_limits.py [--topology v5e:2x2] [--points 20000]

Compiles ``pcfm.ops.pallas.film_block.film_block`` ahead of time for a TPU
topology with no TPU attached (libtpu's compiler, the package's own chip by
default: a v5e, as bench.py's ``V5E_BF16_PEAK``), at (B, N, C) = (8,
20000, C), the forward alone and the backward (``jax.vjp`` through the
kernel's custom VJP, so the forward too), in bf16 and fp32, and bisects C in
steps of 128.  A width fails when the compiler runs out of VMEM
(``RESOURCE_EXHAUSTED``); W's (C, C) fp32 window sets that limit, not B or
N (the grid tiles the rows).  Any other error is raised.

Each compile takes ~15 s on a host CPU; the four bisections take ~10
minutes.  The port's FiLM kernels take the forward's limits
(pcfm_torch/ops/film_block.py ``MAX_C_BF16`` / ``MAX_C_F32``).  This is a
record tool: it is not a test and needs jax with libtpu installed.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

# a v5e slice of 4 chips described to libtpu without one attached: no
# metadata server, no TPU device, only the compiler
os.environ.setdefault("TPU_ACCELERATOR_TYPE", "v5litepod-4")
os.environ.setdefault("TPU_WORKER_HOSTNAMES", "localhost")
os.environ.setdefault("ALLOW_MULTIPLE_LIBTPU_LOAD", "1")
os.environ.setdefault("TPU_SKIP_MDS_QUERY", "1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.topologies import get_topology_desc  # noqa: E402
from jax.sharding import SingleDeviceSharding  # noqa: E402

from pcfm.ops.pallas.film_block import film_block  # noqa: E402

STEP = 128          # the kernel's C % 128 == 0
BATCH = 8


def _structs(device, n: int, c: int, dtype, backward: bool) -> list:
    """ShapeDtypeStructs of the kernel's arguments on ``device``: h, s, t,
    gamma, beta, w, b (and dy first for the backward)."""
    sh = SingleDeviceSharding(device)

    def sds(shape, dt):
        return jax.ShapeDtypeStruct(shape, dt, sharding=sh)
    f32 = jnp.float32
    args = [sds((BATCH, n, c), dtype), sds((c,), f32), sds((c,), f32),
            sds((BATCH, c), dtype), sds((BATCH, c), dtype), sds((c, c), f32),
            sds((c,), f32)]
    return [sds((BATCH, n, c), dtype)] + args if backward else args


def _forward(*a):
    return film_block(*a)


def _backward(dy, *a):
    return jax.vjp(lambda *x: film_block(*x), *a)[1](dy)


def compiles(device, n: int, c: int, dtype, backward: bool) -> bool:
    """True if the kernel compiles at (BATCH, n, c); False if the compiler
    runs out of VMEM."""
    fn = _backward if backward else _forward
    try:
        jax.jit(fn).trace(*_structs(device, n, c, dtype,
                                    backward)).lower().compile()
    except Exception as e:  # noqa: BLE001 - only VMEM exhaustion is a "no"
        if "RESOURCE_EXHAUSTED" in str(e):
            return False
        raise
    return True


def widest(device, n: int, dtype, backward: bool, lo: int, hi: int) -> tuple:
    """(widest C that compiles, narrowest C that fails) by bisection over
    multiples of STEP; ``lo`` must compile and ``hi`` fail."""
    if not compiles(device, n, lo, dtype, backward):
        raise RuntimeError(f"C = {lo} does not compile: lower --lo")
    if compiles(device, n, hi, dtype, backward):
        raise RuntimeError(f"C = {hi} compiles: raise --hi")
    while hi - lo > STEP:
        mid = (lo + hi) // 2 // STEP * STEP
        if compiles(device, n, mid, dtype, backward):
            lo = mid
        else:
            hi = mid
    return lo, hi


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--topology", default="v5e:2x2")
    p.add_argument("--points", type=int, default=20000)
    p.add_argument("--lo", type=int, default=2048)
    p.add_argument("--hi", type=int, default=8192)
    args = p.parse_args()
    topo = get_topology_desc(platform="tpu", topology_name=args.topology)
    device = topo.devices[0]
    import libtpu
    print(f"jax {jax.__version__}, libtpu "
          f"{getattr(libtpu, '__version__', '?')}, topology "
          f"{args.topology} ({device.device_kind}), (B, N) = ({BATCH}, "
          f"{args.points}), C in steps of {STEP}")
    for backward in (False, True):
        for dtype in (jnp.bfloat16, jnp.float32):
            t0 = time.perf_counter()
            ok, bad = widest(device, args.points, dtype, backward, args.lo,
                             args.hi)
            print(f"{'backward' if backward else 'forward'} "
                  f"{jnp.dtype(dtype).name}: compiles at C = {ok}, runs out "
                  f"of VMEM at C = {bad} ({time.perf_counter() - t0:.0f} s)",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
