"""scripts/torch_seed_spread.py at a tiny size on the CPU, and the port's
truncated-normal initialiser.

The script runs distill_demo once a seed through both packages and
writes finite per-seed rows; its CPU-draws leg (the teacher trained by
the script's copy of the training loop with draws from a CPU generator)
run on the CPU equals the harness's own CPU run bit for bit, so on the
card the leg changes only where the draws come from.

The port draws flax's ``lecun_normal`` by the inverse CDF itself, never
through ``torch.nn.init.trunc_normal_``, whose method (and so its values
from one generator) depends on the installed torch: the same seed gives
the same weights on every host, and the draws follow JAX's distribution.
"""
import contextlib
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.nn.common import _TRUNC_STD, lecun_normal_tensor_  # noqa: E402
from pcfm_torch.quality import distill_demo  # noqa: E402
from pcfm_torch.train import checkpoint as ckpt  # noqa: E402
from pcfm_torch.train.loop import train  # noqa: E402
from pcfm_torch.train.state import ModelBundle  # noqa: E402
from scripts import torch_seed_spread as spread  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

# no halving: the JAX package's distillation compiles would double the
# test's time (the whole recipe runs in docs/torch_quality's spreads)
TINY = ["--epochs", "1", "--npts", "64", "--halvings", "0", "--config",
        "enc_depth=1", "pf_depth=1", "lf_depth=1", "sample_steps=4"]


def _finite(obj) -> bool:
    return all(math.isfinite(v) for v in obj.values())


def test_spread_writes_finite_rows_for_both_packages(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        blob = spread.main(["--recipe", "distill_demo", "--packages",
                            "jax,torch", "--seeds", "1,2", "--device", "cpu",
                            "--out_dir", str(tmp_path), "--work",
                            str(tmp_path / "work")] + TINY)
    with open(tmp_path / "seed_spread_distill_demo_cpu.json") as f:
        assert json.load(f) == json.loads(json.dumps(blob))
    keys = None
    for pkg in ("jax", "torch"):
        rows = blob["packages"][pkg]["rows"]
        assert [r["seed"] for r in rows] == [1, 2]
        assert all(r["device"] == "cpu" and _finite(r["metrics"])
                   for r in rows)
        assert rows[0]["metrics"] != rows[1]["metrics"]
        keys = keys or list(rows[0]["metrics"])
        assert list(rows[0]["metrics"]) == keys      # one table, both
        for k, s in blob["packages"][pkg]["summary"].items():
            assert s["n"] == 2 and s["min"] <= s["mean"] <= s["max"], k
    assert keys == [spread.TEACHER] + [
        f"UNdistilled euler x{s} (NFE {s})" for s in (16, 8, 4)]


def test_cpu_draws_leg_equals_the_default_cpu_run(tmp_path):
    args = distill_demo.build_parser().parse_args(["--epochs", "2"])
    cfg = distill_demo.make_config(args).replace(
        seed=3, tr_max_sample_points=64, te_max_sample_points=64)
    cpu = torch.device("cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        train(cfg.replace(out_dir=str(tmp_path / "loop")), verbose=False,
              device="cpu")
        spread.train_cpu_draws(cfg.replace(out_dir=str(tmp_path / "leg")),
                               cpu)
    a = torch.load(ckpt.find_latest(str(tmp_path / "loop"))[0],
                   weights_only=True)
    b = torch.load(ckpt.find_latest(str(tmp_path / "leg"))[0],
                   weights_only=True)
    assert a["global_step"] == b["global_step"] > 0
    for key in ("encoder", "pf", "lf", "ema_pf", "ema_lf"):
        assert a[key].keys() == b[key].keys()
        for name, t in a[key].items():
            assert torch.equal(t, b[key][name]), f"{key}.{name}"
    for i, st in a["opt"]["state"].items():
        for name, t in st.items():
            assert torch.equal(t, b["opt"]["state"][i][name]), (i, name)
    # the leg's own read on the CPU is the harness's read of the loop's run
    with contextlib.redirect_stdout(io.StringIO()):
        leg = spread.split_leg(spread.build_parser().parse_args(
            ["--recipe", "distill_demo", "--seeds", "3", "--work",
             str(tmp_path / "work"), "--epochs", "2", "--npts", "64"]),
            "cpu_draws_recipe", 3, cpu)
    lcfg, bundle, _ = ckpt.load(ckpt.find_latest(str(tmp_path / "loop"))[0],
                                cpu)
    rows = distill_demo.teacher_rows(bundle,
                                     distill_demo.fixed_batch(lcfg, cpu))
    assert leg["recon_cd"][f"{spread.TEACHER} | cpu prior"] == rows[0][1]


def _forbidden(*a, **k):
    raise AssertionError("torch.nn.init.trunc_normal_ was called")


def test_lecun_normal_is_the_inverse_cdf_draw_of_jax(monkeypatch):
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", _forbidden)
    fan_in, fan_out = 256, 512
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(fan_out, fan_in)
    lecun_normal_tensor_(w, fan_in, torch.Generator().manual_seed(0))
    # one uniform an element mapped through erfinv, whatever torch is
    lo = math.erf(-2.0 / math.sqrt(2.0))
    u = torch.empty(fan_out, fan_in).uniform_(
        lo, -lo, generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, (torch.erfinv(u) * (std * math.sqrt(2.0)))
                       .clamp(-2.0 * std, 2.0 * std))
    # JAX's lecun_normal (flax variance_scaling, truncated normal) on the
    # same layer: the same law (std, bounds, mass within one sigma)
    j = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, fan_out)), np.float64)
    p = w.double().numpy()
    assert abs(p.std() / j.std() - 1.0) < 0.01
    assert np.abs(p).max() <= 2.0 * std * (1 + 1e-6)
    assert np.abs(j).max() <= 2.0 * std * (1 + 1e-6)
    assert abs(p.mean()) < 3 * std / math.sqrt(p.size)
    within = [np.mean(np.abs(x) < std * _TRUNC_STD) for x in (p, j)]
    assert abs(within[0] - within[1]) < 0.01


def test_fresh_modules_never_call_torch_trunc_normal(monkeypatch):
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", _forbidden)
    for backbone in ("mlp", "hybrid"):
        cfg = Config(pf_backbone=backbone, latent_dim=16, pf_width=128,
                     pf_depth=2, enc_width=32, lf_width=32,
                     ctx_stage_channels=[16, 16], ctx_stage_blocks=[1, 1],
                     ctx_stage_res=[8, 4], ctx_gn_groups=4, ctx_dim=8)
        ModelBundle(cfg, "cpu", torch.Generator().manual_seed(0))
