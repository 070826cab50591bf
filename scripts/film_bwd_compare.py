#!/usr/bin/env python3
"""The FiLM block's backward at its wide widths, for several source trees
on one card, in turns.

    python3 scripts/film_bwd_compare.py --tree tree_check/parent --tree . \\
        --tree . --tree tree_check/parent

Each ``--tree`` (a checkout of this repository, e.g. the parent commit
unpacked with ``git archive``) is measured in a process of its own, in the
order given, with ``pcfm_torch`` imported and its kernels built from that
tree (into the tree's own ``pcfm_torch/_build``), measured by the helpers
of the ``chip_smoke.py`` beside this script for every tree; give parent,
change, change, parent to compare two commits within one call.  For each tree:

* the backward at (8, 20 000, C) bf16 for C = 640, 1024, 2048: CUDA-event
  ms a call (median of 5 timings of 10 calls, after a warm-up), its
  workspace bytes (``pcfm_film_block_bwd_workspace``) and the device
  memory one call takes beyond its inputs (peak over the allocated
  before);
* the mlp train step at ``pf_width`` 1024 and 2048 with the kernel trunk
  at bench.py's workload, timed as chip_smoke.py's phase 27 times it
  (``kernel_step_ms``: ms/step on the host clock, the median of runs of
  synchronised steps after warm-up steps) with the peak device memory of
  the timed steps (not with ``--kernel_only``).

Prints the card, one JSON line per tree, then a table.  Needs a CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BSZ, POINTS = 8, 20000
WIDTHS = (640, 1024, 2048)
STEP_WIDTHS = (1024, 2048)


def measure(tree: str, steps: bool) -> dict:
    """One tree's numbers (runs in a process of its own)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pcfm_torch.ops import build
    from pcfm_torch.ops import film_block as fb
    if not build.LIB_PATH.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"pcfm_torch came from {build.LIB_PATH}, not "
                           f"{tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build.build()
    out = {"tree": tree, "build_s": built["seconds"], "bwd": {},
           "step": {}}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    for c in WIDTHS:
        args = cs.backward_inputs(fb, torch, g, BSZ, POINTS, c,
                                  torch.bfloat16)
        fb.film_block_backward(*args)
        ms = statistics.median(
            cs.cuda_ms(lambda: fb.film_block_backward(*args), 10)
            for _ in range(5))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fb.film_block_backward(*args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        out["bwd"][c] = {"ms": ms, "workspace_bytes": 4 * fb._lib()
                         .pcfm_film_block_bwd_workspace(BSZ, POINTS, c),
                         "call_bytes_beyond_inputs": extra}
        del args
        torch.cuda.empty_cache()
    batch = cs.train_batch(torch)
    for width in STEP_WIDTHS if steps else ():
        state = cs.train_state(torch, "on", pf_width=width)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        out["step"][width] = cs.kernel_step_ms(torch, state, batch, gen)
        del state
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", action="append", required=True,
                   help="a checkout of this repository (repeat, in turns)")
    p.add_argument("--kernel_only", action="store_true",
                   help="the backward's times alone, no train steps")
    p.add_argument("--one", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        print(json.dumps(measure(args.one, not args.kernel_only)))
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("film_bwd_compare: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rows = []
    for tree in args.tree:
        got = subprocess.run([sys.executable, __file__, "--tree", tree,
                              "--one", tree,
                              *(["--kernel_only"] if args.kernel_only
                                else [])], capture_output=True, text=True)
        if got.returncode:
            sys.stderr.write(got.stdout[-4000:] + got.stderr[-4000:])
            raise SystemExit(f"film_bwd_compare: {tree} failed")
        rows.append(json.loads(got.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]))
    for r in rows:
        bwd = ", ".join(f"C {c}: {v['ms']:.4f} ms, workspace "
                        f"{v['workspace_bytes'] / 1e9:.3f} GB"
                        for c, v in r["bwd"].items())
        step = ", ".join(f"pf_width {w}: {v['ms']:.3f} ms, peak "
                         f"{v['peak_gib']:.3f} GiB"
                         for w, v in r["step"].items())
        print(f"[compare] {r['tree']}: backward {bwd}; train step {step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
