#!/usr/bin/env python3
"""Do torch.profiler sessions keep their kernel records late in a long
process on the card?

    python scripts/torch_profile_probe.py [--probes 5] [--gap 60]
    python scripts/torch_profile_probe.py --flush_period 10

One process on one CUDA card: builds the kernels, then every ``--gap``
seconds of matmuls on the card profiles 3 calls of the FiLM-block
forward at (8, 20000, 640) bf16 and a cuBLAS product in sessions that
differ in what they add after the calls: nothing, CUPTI's records flushed
by force (``cuptiActivityFlushAll``), or a wait of 0.1 to 5 s with the
session open.  ``--flush_period`` sets CUPTI's periodic flush
(``cuptiActivityFlushPeriod``, ms) after the first session.  Each line
gives the probe's time in the process and, for each session, its kernel
records against its runtime + driver launch records.  Imports nothing of
JAX.  chip_smoke.py's ``profile_kernels`` retries a short profile with
the trail this probe showed to keep every record (PERF.md §6).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _cupti(name: str):
    """A function of the libcupti that the profiler loaded."""
    import ctypes
    with open("/proc/self/maps") as f:
        path = sorted({line.split()[-1] for line in f
                       if "libcupti" in line.split()[-1]})[0]
    fn = getattr(ctypes.CDLL(path), name)
    fn.argtypes, fn.restype = [ctypes.c_uint32], ctypes.c_int
    return fn


def session(torch, fn, calls: int, trace: str, trail: float = 0.0,
            flush: bool = False) -> str:
    """One profiler session around ``calls`` calls of ``fn`` and ``trail``
    seconds idle after them (``flush``: CUPTI flushed by force before the
    stop): "kernel records/runtime+driver launch records"."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(trail)
        if flush:
            _cupti("cuptiActivityFlushAll")(1)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    launches = [sum(e.get("cat") == cat and "LaunchKernel" in e.get("name", "")
                    for e in events) for cat in ("cuda_runtime",
                                                 "cuda_driver")]
    return f"{kernels}/{launches[0]}+{launches[1]}"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probes", type=int, default=12)
    p.add_argument("--gap", type=float, default=60.0)
    p.add_argument("--flush_period", type=int, default=0)
    args = p.parse_args(argv)
    import torch

    from pcfm_torch.ops import build
    from pcfm_torch.ops import film_block as fb

    if not torch.cuda.is_available():
        raise SystemExit("probe: this run needs a CUDA device")
    build.build()
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    bsz, n, c = 8, 20000, 640

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale
    # the forward's (h, s, t, gamma, beta, w, b), h / gamma / beta bf16
    film = (rnd(bsz, n, c, scale=0.7).bfloat16(), 1.0 + rnd(c, scale=0.1),
            rnd(c, scale=0.1), rnd(bsz, c, scale=0.2).bfloat16(),
            rnd(bsz, c, scale=0.2).bfloat16(), rnd(c, c, scale=c ** -0.5),
            rnd(c, scale=0.1))
    x = torch.randn(4096, 4096, device="cuda")
    run_dir = os.path.join(ROOT, "runs", "profile_probe")
    trace = os.path.join(run_dir, "probe_trace.json")
    os.makedirs(run_dir, exist_ok=True)
    for i in range(args.probes):
        if i:
            end = time.perf_counter() + args.gap
            while time.perf_counter() < end:
                for _ in range(20):
                    x = x @ x * (1.0 / 4096)
                torch.cuda.synchronize()
        def work():
            fb.film_block_forward(*film)
            torch.matmul(film[0][0], film[5].bfloat16())    # cuBLAS

        def run(**kw):
            return session(torch, work, 3, trace, **kw)
        line = (f"[probe] {time.perf_counter() - t0:7.1f} s (flush period "
                f"{args.flush_period} ms): as it is {run()}; flushed "
                f"{run(flush=True)}; "
                + "; ".join(f"{w} s after {run(trail=w)}"
                            for w in (0.1, 1.0, 2.0, 5.0)))
        print(line, flush=True)
        if i == 0 and args.flush_period:
            _cupti("cuptiActivityFlushPeriod")(args.flush_period)


if __name__ == "__main__":
    main()
