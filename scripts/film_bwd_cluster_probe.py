#!/usr/bin/env python3
"""Shapes for the FiLM-block backward's cluster kernel above C = 2048, on
the card: clusters at once and product-only times.

    python3 scripts/film_bwd_cluster_probe.py [--c 2688] [--epi 0,40000]

Builds ``scripts/film_bwd_cluster_probe.cu`` (nvcc, sm_90a, with
``pcfm_torch/csrc`` on the include path) into ``runs/probe/`` and
drives its two skeletons at (8, 20 000, C) with zero operands (the time
of a bf16 product does not depend on the values):

* mode 0, the kernel's shape: clusters of ceil(C / 256) CTAs, each a pair
  of 64-row tiles x 256 columns, 4 stages of 48 KB;
* mode 1: clusters of ceil(C / 512) CTAs, each one 64-row tile x 512
  columns, 2 stages of 72 KB.

For each: the clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``) at the shared memory a full kernel of
that shape needs (bf16 and fp32 rows), and CUDA-event ms of one launch
over every task, with the epilogue replaced by a spin of each ``--epi``
count of clock cycles a task.  A skeleton's CTAs take whole chunks, so a
cluster computes ncta x chunks a CTA >= C / 128 chunks; the times are
also given scaled by (C / 128) / that, the real kernel's share of the
work.  Prints the card and one JSON line.  Needs a CUDA device and nvcc;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "scripts", "film_bwd_cluster_probe.cu")
OUT = os.path.join(ROOT, "runs", "probe")
BSZ, POINTS = 8, 20000
# (rows a CTA, chunks a CTA) of each mode
MODES = {0: (128, 2), 1: (64, 4)}


def full_smem(mode: int, c_cta: int, es: int) -> int:
    """Shared memory of a full cluster kernel of the mode's shape with h
    rows of ``es`` bytes: the ring (or the epilogue's packed dy and
    padded h rows, if larger), the warps' column sums, the row sums,
    means, statistics, parameters and barriers, as
    film_block_bwd.cu's cluster_smem_bytes counts them."""
    rows, _ = MODES[mode]
    stages, stage = (4, 48 * 1024) if mode == 0 else (2, 72 * 1024)
    epilogue = c_cta * rows * 2 + rows * (c_cta + 8) * es
    ring = max(stages * stage, epilogue)
    colsum = 8 * 2 * (c_cta if mode == 0 else c_cta // 2) * 4
    return (1024 + ring + colsum + rows * 2 * 4 * 2 + 2 * rows * 4
            + (2 if mode == 0 else 1) * c_cta * 16 + 72)


def build() -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libprobe.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    got = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
         "-I", os.path.join(ROOT, "pcfm_torch", "csrc"), "-o", lib, SRC],
        capture_output=True, text=True)
    for line in (got.stdout + got.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[probe build] {line.strip()}")
    if got.returncode:
        raise SystemExit(f"nvcc failed:\n{got.stdout}\n{got.stderr}")
    so = ctypes.CDLL(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    so.probe_min_smem.argtypes = [i32]
    so.probe_max_clusters.argtypes = [i32, i32, i32]
    so.probe_launch.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, i32,
                                ctypes.c_longlong, ptr]
    return so


def capacity(so, torch, sms: int) -> int:
    """Clusters of ncta CTAs that run at once, found by timing: n clusters
    that each spin 4e6 cycles take one spin's time while they all fit, two
    once one has to wait; beside cudaOccupancyMaxActiveClusters."""
    spin, c = 4_000_000, 128
    smem = full_smem(0, 256, 2)
    a = torch.zeros(4096 * 64 * c, dtype=torch.bfloat16, device="cuda")
    w = torch.zeros(c * c, dtype=torch.bfloat16, device="cuda")
    result = {}
    for ncta in (8, 9, 10, 11):
        held = so.probe_max_clusters(0, ncta, smem)
        times = {}
        for n in range(max(1, held - 1), held + 4):
            out = torch.empty(ncta * n * 256, device="cuda")

            def run():
                err = so.probe_launch(0, a.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), c, ncta, n, smem, spin,
                                      torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"probe launch: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            times[n] = e0.elapsed_time(e1)
        one = times[min(times)]
        at_once = max(n for n, t in times.items() if t < 1.5 * one)
        print(f"[capacity] {ncta} CTAs a cluster, {smem} bytes each: "
              f"cudaOccupancyMaxActiveClusters {held}; ms for n clusters "
              + ", ".join(f"{n}: {t:.3f}" for n, t in times.items())
              + f" -> {at_once} at once ({at_once * ncta} of {sms} SMs)")
        result[ncta] = {"occupancy_api": held, "ms": times,
                        "at_once": at_once}
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "capacity.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"capacity": result}))
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--c", type=int, nargs="+", default=[2688])
    p.add_argument("--epi", default="0",
                   help="comma list of clock cycles a task in place of "
                        "the epilogue")
    p.add_argument("--capacity", action="store_true",
                   help="instead: how many clusters of 8, 9, 10 and 11 "
                        "CTAs (the kernel's shared memory) run at once")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("film_bwd_cluster_probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    so = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if args.capacity:
        return capacity(so, torch, sms)
    tiles = BSZ * -(-POINTS // 64)
    tiles += tiles % 2
    result = {"sms": sms, "widths": {}}
    for c in args.c:
        nch = c // 128
        a = torch.zeros(tiles * 64 * c, dtype=torch.bfloat16, device="cuda")
        w = torch.zeros(c * c, dtype=torch.bfloat16, device="cuda")
        rows = {}
        for mode, (rows_cta, ch_cta) in MODES.items():
            ncta = -(-nch // ch_cta)
            tasks = tiles * 64 // rows_cta
            smem = {dt: full_smem(mode, ch_cta * 128, es)
                    for dt, es in (("bf16", 2), ("fp32", 4))}
            held = {dt: so.probe_max_clusters(mode, ncta, s)
                    for dt, s in smem.items()}
            out = torch.empty(ncta * tasks * 256, device="cuda")
            share = nch / (ncta * ch_cta)
            times = {}
            for epi in (int(x) for x in args.epi.split(",")):
                def run():
                    err = so.probe_launch(
                        mode, a.data_ptr(), w.data_ptr(), out.data_ptr(), c,
                        ncta, tasks, smem["bf16"], epi,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"probe launch: CUDA error {err}")
                run()
                torch.cuda.synchronize()
                ms = []
                for _ in range(5):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    run()
                    e1.record()
                    torch.cuda.synchronize()
                    ms.append(e0.elapsed_time(e1))
                times[epi] = {"ms": statistics.median(ms),
                              "ms_scaled": statistics.median(ms) * share,
                              "runs": ms}
            rows[mode] = {"ctas": ncta, "rows_a_cta": rows_cta,
                          "columns_a_cta": ch_cta * 128, "tasks": tasks,
                          "smem": smem, "clusters_at_once": held,
                          "sms_busy_bf16": held["bf16"] * ncta,
                          "work_share": share, "times": times}
            for epi, v in times.items():
                print(f"[probe] C {c} mode {mode}: {ncta} CTAs a cluster "
                      f"({rows_cta} rows x {ch_cta * 128} columns a CTA), "
                      f"clusters at once bf16 {held['bf16']} / fp32 "
                      f"{held['fp32']} ({held['bf16'] * ncta} of {sms} SMs)"
                      f", smem {smem}; spin {epi} cycles: {v['ms']:.4f} ms,"
                      f" scaled to the real work {v['ms_scaled']:.4f} ms")
        result["widths"][c] = rows
        del a, w
        torch.cuda.empty_cache()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
