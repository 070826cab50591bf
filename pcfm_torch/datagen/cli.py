"""Dataset generation CLI — mirrors the reference
`dataset/make_dataset.py` argparse surface (make_dataset.py:733-765).

The port's copy of ``pcfm/datagen/cli.py``: it imports nothing of ``pcfm``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Sequence

from pcfm_torch.datagen.core import include_row_by_cats, read_index_csv
from pcfm_torch.datagen.simulate import GenConfig, process_one_model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Build multi-joint colored dataset by random joint "
                    "combinations (PartNet-Mobility URDFs via pybullet).")
    ap.add_argument("--index", type=Path, required=True)
    ap.add_argument("--dataset-dir", type=Path, required=True)
    ap.add_argument("--out-dir", type=Path,
                    default=Path("MobilityMultiColored"))
    ap.add_argument("--filter-cats", type=str, default="")
    ap.add_argument("--joint-types", type=str, default="revolute")
    ap.add_argument("--joint-regex", type=str, default=r"joint_\d+")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--steps-per", type=str, default="")
    ap.add_argument("--num-combos", type=int, default=200)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--group-by-cat", action="store_true")
    ap.add_argument("--allow-duplicate-combos", action="store_true")
    ap.add_argument("--ply-ascii", action="store_true")
    ap.add_argument("--no-glb", action="store_true",
                    help="skip mesh.glb export per pose")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--init-only", action="store_true")
    ap.add_argument("--point-sampling", type=str, default="random",
                    choices=["random", "even", "fps"])
    ap.add_argument("--fps-oversample", type=int, default=8)
    return ap


def _worker(row, payload):
    args = SimpleNamespace(**payload["args"])
    cfg = GenConfig(**payload["cfg"])
    return process_one_model(row, args, cfg, Path(payload["out_root"]))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = GenConfig(points_per_pose=args.points, ply_ascii=args.ply_ascii,
                    glb_export=not args.no_glb,
                    point_sampling=args.point_sampling,
                    fps_oversample=args.fps_oversample)

    cats = ([c.strip() for c in args.filter_cats.split(",") if c.strip()]
            if args.filter_cats else None)
    rows = [r for r in read_index_csv(args.index)
            if include_row_by_cats(r, cats)]
    if not rows:
        print("no rows after category filtering", file=sys.stderr)
        return 1
    out_root = args.out_dir.resolve()
    out_root.mkdir(parents=True, exist_ok=True)

    ns = SimpleNamespace(dataset_dir=args.dataset_dir,
                         joint_types=args.joint_types,
                         joint_regex=args.joint_regex, steps=args.steps,
                         steps_per=args.steps_per,
                         num_combos=args.num_combos,
                         group_by_cat=args.group_by_cat,
                         allow_duplicate_combos=args.allow_duplicate_combos,
                         seed=args.seed, init_only=args.init_only)

    ok = fail = 0
    if args.workers <= 1:
        for row in rows:
            _, ok_i, fail_i = process_one_model(row, ns, cfg, out_root)
            ok += 1 if ok_i > 0 else 0
            fail += fail_i
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed
        payload = {"args": vars(ns) | {"dataset_dir": str(args.dataset_dir)},
                   "cfg": cfg.__dict__, "out_root": str(out_root)}
        # spawned, not forked: the caller may hold threads (torch's)
        with ProcessPoolExecutor(
                max_workers=max(1, args.workers),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = [ex.submit(_worker, r, payload) for r in rows]
            for fut in as_completed(futs):
                try:
                    _, ok_i, fail_i = fut.result()
                    ok += 1 if ok_i > 0 else 0
                    fail += fail_i
                except Exception as e:
                    print(f"[worker] failed: {e}", file=sys.stderr)
                    fail += 1
    print(f"done: {ok} model(s) with >=1 pose, {fail} failure(s). "
          f"output: {out_root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
