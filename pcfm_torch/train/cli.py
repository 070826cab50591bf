"""Training CLI — the port's ``python -m pcfm_torch.train.cli``, with the
argv of pcfm/train/cli.py.

The parser IS the JAX package's: ``build_parser`` is loaded from the file
pcfm/train/cli.py (its top level imports only argparse and pcfm.config;
importing it as ``pcfm.train.cli`` would run pcfm/train/__init__.py, which
imports jax), so the two CLIs cannot drift.  Runs on the GPU when there is
one, else on the CPU.

    python -m pcfm_torch.train.cli --dataset_type synthetic --epochs 1 \\
        --batch_size 8 --tr_max_sample_points 20000 --latent_dim 128 \\
        --fused_trunk on --out_dir runs/port
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import os
from typing import Optional, Sequence

import pcfm
from pcfm.config import Config


@functools.lru_cache(maxsize=None)
def _jax_cli_module():
    path = os.path.join(os.path.dirname(pcfm.__file__), "train", "cli.py")
    spec = importlib.util.spec_from_file_location("_pcfm_train_cli", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parser():
    return _jax_cli_module().build_parser()


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in known})


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from pcfm_torch.train.loop import train
    cfg = parse_config(argv)
    if cfg.dataset_type != "synthetic" and not cfg.data_dir:
        raise SystemExit("--data_dir is required for H5 datasets")
    return train(cfg)


if __name__ == "__main__":
    main()
