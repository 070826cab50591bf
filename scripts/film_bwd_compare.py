#!/usr/bin/env python3
"""The FiLM block's backward at its wide widths (and, by ``--parts``, its
forward and the voxel kernels), for several source trees on one card, in
turns.

    python3 scripts/film_bwd_compare.py --tree tree_check/parent --tree . \\
        --tree . --tree tree_check/parent
    python3 scripts/film_bwd_compare.py --parts fwd,bwd,step \\
        --tree tree_check/parent --tree . --tree . --tree tree_check/parent

Each ``--tree`` (a checkout of this repository, e.g. the parent commit
unpacked with ``git archive``) is measured in a process of its own, in the
order given, with ``pcfm_torch`` imported and its kernels built from that
tree (into the tree's own ``pcfm_torch/_build``), measured by the helpers
of the ``chip_smoke.py`` beside this script for every tree; give parent,
change, change, parent to compare two commits within one call.  For each tree:

* the backward at (8, 20 000, C) bf16 for C = 512 (the register path),
  640, 1024, 2048 and the widths above 2048, 2176, 2304, 2432, 2560,
  2688, and in fp32 at 2688: CUDA-event ms a call (median of 5 timings
  of 10 calls, after a warm-up), a SHA-1 of its seven gradients' bits,
  its workspace bytes (``pcfm_film_block_bwd_workspace``) and the device
  memory one call takes beyond its inputs (peak over the allocated
  before); on the wide path one profile of 3 calls: each part's device
  time a call (the W and dy packs, the rows pass's cluster kernel, the
  dW pass, the reductions), the time the cluster kernel and the dW pass
  ran at once, the clusters the card holds at once and, where the tree
  has it, its plan (``bwd_plan``: row chunks, the dW pass's blocks);
* the mlp train step at ``pf_width`` 1024, 2048 and 2688 with the kernel
  trunk
  at bench.py's workload, timed as chip_smoke.py's phase 27 times it
  (``kernel_step_ms``: ms/step on the host clock, the median of runs of
  synchronised steps after warm-up steps) with the peak device memory of
  the timed steps and each run's last loss (equal losses: the same bits
  through the step) (``step``);
* ``fwd``: the forward at (8, 20 000, C) for C = 512 and 1024 (the
  one-kernel path) and 2048, 2560, 4608 in bf16 and 4352 in fp32 (the
  wide path): ms a call as the backward's, a SHA-1 of its output bits (y,
  mean, rstd), so that equal digests show the same output from both
  trees, and on the wide path one profile of its kernels (the W pack,
  the statistics kernel, the product with its epilogue);
* ``voxel``: the gather and the scatter at the hybrid's stage shapes
  (chip_smoke.py VOXEL_STAGES, 8 clouds, the R = 32 entry sort): the main
  path's cases (K = 8 gather and K = 1 scatter of bf16 rows) and the
  backward's (K = 1 gather and K = 8 scatter of fp32 rows), each one's
  device time (chip_smoke.py ``queued_ms``) and output digest.

``--parts`` takes a comma list of ``bwd``, ``step``, ``fwd`` and ``voxel``
(default ``bwd,step``; ``--parts bwd``: the backward's times alone).

Prints the card, one JSON line per tree, then a table.  Needs a CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BSZ, POINTS = 8, 20000
WIDTHS = ((512, "bfloat16"), (640, "bfloat16"), (1024, "bfloat16"),
          (2048, "bfloat16"), (2176, "bfloat16"), (2304, "bfloat16"),
          (2432, "bfloat16"), (2560, "bfloat16"), (2688, "bfloat16"),
          (2688, "float32"))
STEP_WIDTHS = (1024, 2048, 2688)
FWD_WIDTHS = ((512, "bfloat16"), (1024, "bfloat16"), (2048, "bfloat16"),
              (2560, "bfloat16"), (4608, "bfloat16"), (4352, "float32"))


def digest(tensors) -> str:
    """SHA-1 of the tensors' bits, in order."""
    import torch
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def measure_fwd(cs, fb, torch) -> dict:
    out = {}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    for c, dtype in FWD_WIDTHS:
        args = cs.film_inputs(torch, g, BSZ, POINTS, c, getattr(torch, dtype))
        got = fb.film_block_forward(*args)
        ms = statistics.median(
            cs.cuda_ms(lambda: fb.film_block_forward(*args), 10)
            for _ in range(5))
        key = f"{c} {dtype}"
        out[key] = {"ms": ms, "digest": digest(got)}
        if c > fb.NARROW_C:
            prof = cs.profile_kernels(
                torch, lambda: fb.film_block_forward(*args), 3,
                {"pack": ("pack_w",), "stats": ("wide_stats",),
                 "product": ("film_block_fwd",)},
                os.path.join(ROOT, "chiprun_out", "compare",
                             f"fwd_c{c}_{dtype}_trace.json"))
            out[key]["parts_ms"] = {k: prof[k][0] for k in
                                    ("pack", "stats", "product")}
        del args, got
        torch.cuda.empty_cache()
    return out


def measure_voxel(cs, tvs, torch) -> dict:
    from pcfm_torch.models.context import VOXEL_EPS
    out = {}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    pts = torch.randn(BSZ, POINTS, 3, device="cuda", generator=g)
    perm, inv = tvs.sort_perm_by_voxel(pts, cs.VOXEL_STAGES[0][0],
                                       eps=VOXEL_EPS)
    pts = tvs.permute_points(pts, perm, inv)
    for r, c in cs.VOXEL_STAGES:
        cache = tvs.build_stage_cache(pts, r, eps=VOXEL_EPS)
        ids8, w8 = cache["corners"]
        plan1, plan8 = cache["plan"], tvs.corner_plan(cache)
        w1 = cache["inv_pt"][:, None, :]
        for dtype in (torch.bfloat16, torch.float32):
            grid = torch.randn(BSZ, r ** 3, c, device="cuda",
                               generator=g).to(dtype)
            upd = torch.randn(BSZ, POINTS, c, device="cuda",
                              generator=g).to(dtype)
            # bf16: the main path's forward; fp32: the backward's transposes
            k_gather, k_scatter = (8, 1) if dtype == torch.bfloat16 \
                else (1, 8)
            cases = {
                f"gather K={k_gather}": lambda: tvs.voxel_gather(
                    grid, *((ids8, w8) if k_gather == 8
                            else (plan1.ids, w1))),
                f"scatter K={k_scatter}": lambda: tvs.voxel_scatter(
                    upd, *((w1, plan1) if k_scatter == 1 else (w8, plan8)))}
            for name, fn in cases.items():
                key = f"R={r} C={c} {str(dtype)[6:]} {name}"
                out[key] = {"device_ms": cs.queued_ms(torch, fn),
                            "digest": digest([fn()])}
            del grid, upd
        del cache
        torch.cuda.empty_cache()
    return out


def measure(tree: str, parts: tuple) -> dict:
    """One tree's numbers (runs in a process of its own)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pcfm_torch.ops import build
    from pcfm_torch.ops import film_block as fb
    from pcfm_torch.ops import voxel_sorted as tvs
    if not build.LIB_PATH.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"pcfm_torch came from {build.LIB_PATH}, not "
                           f"{tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build.build()
    out = {"tree": tree, "build_s": built["seconds"], "bwd": {},
           "step": {}}
    # the tree's traces apart from the other trees'
    tag = "".join(ch if ch.isalnum() else "_" for ch in tree).strip("_") \
        or "here"
    if "fwd" in parts:
        out["fwd"] = measure_fwd(cs, fb, torch)
    if "voxel" in parts:
        out["voxel"] = measure_voxel(cs, tvs, torch)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    for c, dtype in WIDTHS if "bwd" in parts else ():
        args = cs.backward_inputs(fb, torch, g, BSZ, POINTS, c,
                                  getattr(torch, dtype))
        out_digest = digest(fb.film_block_backward(*args))
        ms = statistics.median(
            cs.cuda_ms(lambda: fb.film_block_backward(*args), 10)
            for _ in range(5))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fb.film_block_backward(*args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        key = f"{c} {dtype}"
        out["bwd"][key] = {"ms": ms, "digest": out_digest,
                           "workspace_bytes": 4 * fb._lib()
                           .pcfm_film_block_bwd_workspace(BSZ, POINTS, c),
                           "call_bytes_beyond_inputs": extra}
        if c > fb.NARROW_C_BWD:
            trace = os.path.join(cs.RUN_DIR, "compare",
                                 f"bwd_{tag}_c{c}_{dtype}_trace.json")
            prof = cs.profile_kernels(
                torch, lambda: fb.film_block_backward(*args), 3,
                {"pack": ("bwd_pack", "wide_pack"), "cluster": ("cluster",),
                 "dw": ("bwd_dw",), "reduce": ("bwd_sum", "bwd_finalize")},
                trace)
            out["bwd"][key].update(
                parts_ms={k: prof[k][0] for k in
                          ("pack", "cluster", "dw", "reduce")},
                cluster_dw_overlap_ms=cs.kernel_overlap_ms(
                    trace, ("cluster",), ("bwd_dw",), prof["calls_run"]),
                clusters_at_once=fb.bwd_max_clusters(
                    c, dtype == "bfloat16", torch.cuda.current_device()),
                cluster_ctas=len(fb.cluster_split(c)),
                plan=fb.bwd_plan(BSZ, POINTS, c)
                if hasattr(fb, "bwd_plan") else None)
        del args
        torch.cuda.empty_cache()
    batch = cs.train_batch(torch)
    for width in STEP_WIDTHS if "step" in parts else ():
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
    p.add_argument("--parts", default="bwd,step",
                   help="comma list of bwd, step, fwd, voxel")
    p.add_argument("--one", help=argparse.SUPPRESS)
    args = p.parse_args()
    parts = tuple(args.parts.split(","))
    if args.one:
        print(json.dumps(measure(args.one, parts)))
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
                              "--one", tree, "--parts", ",".join(parts)],
                             capture_output=True, text=True)
        if got.returncode:
            sys.stderr.write(got.stdout[-4000:] + got.stderr[-4000:])
            raise SystemExit(f"film_bwd_compare: {tree} failed")
        rows.append(json.loads(got.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r in rows:
        for c, v in r["bwd"].items():
            parts = ""
            if "parts_ms" in v:
                busy = v["clusters_at_once"] * v["cluster_ctas"]
                parts = ("; profiled (packs, cluster kernel, dW, "
                         "reductions) " + " / ".join(
                             f"{x:.4f}" for x in v["parts_ms"].values())
                         + f" ms, cluster kernel and dW at once "
                         f"{v['cluster_dw_overlap_ms']:.4f} ms; "
                         f"{v['clusters_at_once']} clusters of "
                         f"{v['cluster_ctas']} at once ({busy} of {sms} "
                         f"SMs)")
                if v["plan"]:
                    p = v["plan"]
                    parts += (f"; {p['chunks']} row chunk(s), the dW "
                              f"pass's {p['dw_blocks']} blocks a chunk: "
                              f"{p['dw_blocks'] / sms:.2f} waves")
            print(f"[compare] {r['tree']}: backward C {c}: "
                  f"{v['ms']:.4f} ms, output {v['digest'][:12]}, workspace "
                  f"{v['workspace_bytes'] / 1e9:.3f} GB{parts}")
        for w, v in r["step"].items():
            print(f"[compare] {r['tree']}: train step pf_width {w}: "
                  f"{v['ms']:.3f} ms, peak {v['peak_gib']:.3f} GiB, losses "
                  f"{v['losses']}")
        for c, v in r.get("fwd", {}).items():
            parts = "; profiled (W pack, statistics, product and " \
                "epilogue) " + " / ".join(f"{x:.4f}" for x in
                                          v["parts_ms"].values()) + \
                " ms" if "parts_ms" in v else ""
            print(f"[compare] {r['tree']}: forward C {c}: {v['ms']:.4f} ms, "
                  f"output {v['digest'][:12]}{parts}")
        for key, v in r.get("voxel", {}).items():
            print(f"[compare] {r['tree']}: {key}: {v['device_ms']:.4f} ms "
                  f"device, output {v['digest'][:12]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
