"""Sampling quality of the port against the JAX package on one checkpoint,
and the learning runs (pcfm_torch.quality) at a tiny size on the CPU.

A tiny JAX ``mlp`` run (tests/test_torch_port_jax_run.py's configuration,
on the synthetic set) trains a few steps with the JAX package's own code,
is saved by its checkpointing and converted by scripts/jax_run_to_torch.py;
then both eval CLIs (``--mode both``) evaluate the same weights over
SEEDS sampling seeds each.  Their draws come from different generators, so
the port's mean recon and gen CD must lie within the range of JAX's seeds,
widened by WIDEN (a factor below the least, above the greatest).  Each
quality CLI then runs at a tiny size with ``--device cpu`` and must write
its JSON with finite metrics."""
import contextlib
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm.config import Config as JaxConfig  # noqa: E402
from pcfm.eval.cli import main as jax_eval_main  # noqa: E402
from pcfm.train import checkpoint as jax_ckpt  # noqa: E402
from pcfm.train.step import train_step as jax_train_step  # noqa: E402
from pcfm_torch.data import DataLoader, to_model_batch  # noqa: E402
from pcfm_torch.data.synthetic import SyntheticDataset  # noqa: E402
from pcfm_torch.eval import cli as eval_cli  # noqa: E402
from pcfm_torch.quality import (convergence_full, distill_demo,  # noqa: E402
                                gen_quality)
from scripts import jax_run_to_torch  # noqa: E402
from tests.test_torch_port_jax_run import TINY, jax_init_state  # noqa: E402

SEEDS = 5
WIDEN = 0.2
RUN = dict(TINY, dataset_type="synthetic", tr_max_sample_points=48,
           te_max_sample_points=48, batch_size=8)
STEPS = 24


def _jax_run(path: str) -> str:
    """STEPS train steps of the JAX package on synthetic batches, saved
    as a JAX run at ``path``."""
    jcfg = JaxConfig(**RUN, out_dir=path)
    jb, jst, tx = jax_init_state(jcfg)
    jstep = jax.jit(lambda s, b, k: jax_train_step(
        jb, tx, s, b, k, jnp.float32(1.0), jnp.float32(jcfg.cfg_drop_p)))
    ds = SyntheticDataset(split="train", size=64, n_points=2048,
                          tr_sample_size=48, te_sample_size=48)
    loader = DataLoader(ds, 8, shuffle=True, drop_last=True, seed=0,
                        num_workers=0)
    batches = [b for ep in range(STEPS // len(loader) + 1)
               for b in loader.epoch_batches(ep)][:STEPS]
    for i, b in enumerate(batches):
        mb = to_model_batch(b, has_rgb=True, cond_dim=1)
        jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in mb.items()},
                       jax.random.PRNGKey(100 + i))
    jax_ckpt.save(path, 1, jst, jcfg, async_save=False)
    return path


def test_eval_metrics_of_one_checkpoint_match_jax(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_run(jax_dir)
    with contextlib.redirect_stdout(io.StringIO()):
        jax_run_to_torch.main([jax_dir, "--out_dir", port_dir])
    common = ["--mode", "both", "--max_batches", "2",
              "--emd_max_points", "48"]
    got = {"jax": [], "port": []}
    with contextlib.redirect_stdout(io.StringIO()):
        for s in range(SEEDS):
            seed = ["--seed", str(s)]
            got["jax"].append(jax_eval_main(["--out_dir", jax_dir]
                                            + common + seed))
            got["port"].append(eval_cli.main(["--out_dir", port_dir]
                                             + common + seed
                                             + ["--device", "cpu"]))
    for key in ("recon_cd", "gen_cd"):
        jx = [float(r[key]) for r in got["jax"]]
        mean = float(np.mean([float(r[key]) for r in got["port"]]))
        lo, hi = min(jx) * (1 - WIDEN), max(jx) * (1 + WIDEN)
        assert all(math.isfinite(v) for v in jx) and math.isfinite(mean)
        assert lo <= mean <= hi, (key, mean, jx)


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


SMALL_HYBRID = dict(latent_dim=16, enc_width=32, pf_width=128, pf_depth=2,
                    pf_emb_dim=16, lf_width=32, lf_emb_dim=16, ctx_dim=8,
                    ctx_emb_dim=16, ctx_gn_groups=4)


def test_gen_quality_runs_on_the_cpu_and_resumes(tmp_path):
    out = str(tmp_path / "genq")
    argv = ["--device", "cpu", "--eval_every", "2", "--size", "8",
            "--test", "6", "--npts", "64", "--batch", "4", "--out", out,
            "--ctx_res", "8,4", "--ctx_ch", "16,16", "--ctx_blocks", "1,1",
            "--latent", "16", "--pf_width", "128", "--pf_depth", "2",
            "--ctx_dim", "8", "--sample_steps", "2", "--geom_warmup", "1",
            "--final_seeds", "1,2", "--sweep_seeds", "1",
            "--guidance_sweep", "1.0"]
    kw = dict(overrides=dict(SMALL_HYBRID, ctx_emb_dim=16))
    with contextlib.redirect_stdout(io.StringIO()):
        gen_quality.main(argv + ["--epochs", "2"], **kw)
        res = gen_quality.main(argv + ["--epochs", "3", "--resume",
                                       f"{out}/state_latest.pt"], **kw)
    with open(f"{out}/history.json") as f:
        hist = json.load(f)
    with open(f"{out}/final_suite.json") as f:
        final = json.load(f)
    assert [r["epoch"] for r in hist] == [1, 2, 3]
    assert "nna_cd" in hist[1] and "nna_cd" in hist[2]
    assert final == json.loads(json.dumps(res)) and _finite(final)
    for k in ("mmd_cd", "cov_cd", "nna_cd", "mmd_emd", "cov_emd",
              "nna_emd"):
        band = final["default"][k]
        assert band["min"] <= band["mean"] <= band["max"], k
        assert len(final["default_per_seed"]) == 2
    assert 0.0 <= final["default"]["nna_cd"]["mean"] <= 1.0
    assert final["best_emd_recipe"] == {"guidance": 1.0}
    assert np.load(f"{out}/gen_final.npy").shape == (6, 64, 3)


def test_convergence_full_runs_on_the_cpu(tmp_path):
    out = str(tmp_path / "conv")
    with contextlib.redirect_stdout(io.StringIO()):
        hist = convergence_full.main(
            ["--device", "cpu", "--epochs", "2", "--eval_every", "1",
             "--size", "4", "--npts", "64", "--batch", "2", "--out", out],
            overrides=dict(SMALL_HYBRID, ctx_stage_channels=[16, 16],
                           ctx_stage_blocks=[1, 1], ctx_stage_res=[8, 4],
                           sample_steps=2))
    with open(f"{out}/history.json") as f:
        assert json.load(f) == hist
    with open(f"{out}/summary.json") as f:
        summary = json.load(f)
    assert [r["epoch"] for r in hist] == [1, 2] and _finite(hist)
    assert all(r["recon_cd"] > 0 for r in hist)
    assert summary["steps"] == 4 and summary["device"] == "cpu"


def test_distill_demo_runs_on_the_cpu(tmp_path):
    out = str(tmp_path / "distill")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        res = distill_demo.main(
            ["--device", "cpu", "--epochs", "1", "--out", out],
            overrides=dict(tr_max_sample_points=64,
                           te_max_sample_points=64),
            steps_per_phase=3)
    with open(f"{out}/distill.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    cds = res["recon_cd"]
    assert list(cds) == [
        "teacher heun x32 (NFE 64)", "UNdistilled euler x16 (NFE 16)",
        "UNdistilled euler x8 (NFE 8)", "UNdistilled euler x4 (NFE 4)",
        "distilled euler x16 (NFE 16)", "distilled euler x8 (NFE 8)",
        "distilled euler x4 (NFE 4)"]
    assert _finite(res) and all(v > 0 for v in cds.values())
    assert "| distilled euler x4 (NFE 4) |" in log.getvalue()
