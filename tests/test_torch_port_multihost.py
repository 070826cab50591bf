"""The port's train CLI in several processes, as torchrun starts them
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), on the CPU over
gloo — the counterpart of tests/test_multihost.py — and its asynchronous
checkpoint saves.

Two processes train dp = 2 (the mlp) and sp = 2 (the hybrid): rank 0
alone writes the checkpoint, the metrics line and the validation dumps,
and a second run resumes from the saved step.
"""
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.train import checkpoint  # noqa: E402
from pcfm_torch.train.state import ModelBundle  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--dataset_type", "synthetic", "--batch_size", "8",
        "--tr_max_sample_points", "64", "--te_max_sample_points", "64",
        "--latent_dim", "16", "--enc_width", "16", "--pf_width", "32",
        "--pf_depth", "3", "--pf_emb_dim", "16", "--lf_width", "32",
        "--lf_depth", "3", "--lf_emb_dim", "16", "--warmup_steps", "2",
        "--sample_steps", "2", "--geom_warmup_epochs", "0",
        "--vis_count", "1", "--num_workers", "0", "--save_every", "1",
        "--async_save", "--device", "cpu"]
HYBRID = ["--pf_backbone", "hybrid", "--ctx_stage_channels", "8",
          "--ctx_stage_blocks", "1", "--ctx_stage_res", "4",
          "--ctx_gn_groups", "4", "--ctx_dim", "8", "--ctx_emb_dim", "16",
          "--ctx_dtype", "fp32"]
# the synthetic training split: 64 clouds
TRAIN_CLOUDS = 64


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(argv, world: int, timeout: int = 240) -> list:
    """Start ``world`` CLI processes with torchrun's variables; returns
    each one's stdout."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pcfm_torch.train.cli", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("layout,extra", [
    ("dp2", ["--dp", "2"]),
    ("sp2", ["--dp", "1", "--sp", "2"] + HYBRID)])
def test_two_process_cli_trains_saves_and_resumes(tmp_path, layout, extra):
    out_dir = str(tmp_path / layout)
    argv = ARGV + extra + ["--out_dir", out_dir]
    logs = _torchrun(argv + ["--epochs", "1"], 2)
    assert "Ep1: lp=" in logs[0] and "Ep1:" not in logs[1]
    assert "[Mesh]" in logs[0] and "[Val ep0001] random-z CD" in logs[0]
    ckpts = sorted(os.listdir(checkpoint.ckpt_dir(out_dir)))
    assert ckpts == ["hybrid_ep0001.pt"]
    for name in ("samples_recon_ep0001", "samples_ep0001"):
        assert sorted(os.listdir(os.path.join(out_dir, name))) == [
            "gt_0.ply", "pred_0.ply"]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"])
    dp = 2 if layout == "dp2" else 1
    steps = TRAIN_CLOUDS // dp // 8          # each data shard: 8 clouds
    ck = torch.load(os.path.join(checkpoint.ckpt_dir(out_dir), ckpts[0]),
                    weights_only=True)
    assert ck["global_step"] == steps and ck["args"]["dp"] == dp

    logs = _torchrun(argv + ["--epochs", "2"], 2)
    assert "Resume from epoch 1" in logs[0] and "RESET" not in logs[0]
    assert "Ep2: lp=" in logs[0]
    ck = torch.load(os.path.join(checkpoint.ckpt_dir(out_dir),
                                 "hybrid_ep0002.pt"), weights_only=True)
    assert ck["global_step"] == 2 * steps and ck["epoch"] == 2


def test_async_save_is_complete_after_wait(tmp_path, monkeypatch):
    """The copy is taken on the caller's thread (a change of the live
    weights after ``save`` returns is not in the file), the file is
    written on another thread, and ``wait_for_saves`` returns once it is
    on disk; the readers wait for it themselves."""
    bundle = ModelBundle(Config(latent_dim=8, enc_width=16, pf_width=32,
                                pf_depth=3, pf_emb_dim=16, lf_width=32,
                                lf_depth=3, lf_emb_dim=16),
                         "cpu", torch.Generator().manual_seed(0))
    writers, started, release = [], threading.Event(), threading.Event()
    save = torch.save

    def slow_save(obj, path):
        writers.append(threading.get_ident())
        started.set()
        release.wait(30)
        save(obj, path)

    monkeypatch.setattr(checkpoint.torch, "save", slow_save)
    out = str(tmp_path)
    want = bundle.pf.state_dict()["input.weight"].clone()
    path = checkpoint.save(out, 1, bundle, global_step=5, async_save=True)
    assert started.wait(30)
    with torch.no_grad():                       # the next step's update
        bundle.pf.input.weight.add_(1.0)
    assert not os.path.exists(path)             # still in flight
    release.set()
    checkpoint.wait_for_saves()
    assert os.path.exists(path) and writers[0] != threading.get_ident()
    ck = torch.load(path, weights_only=True)
    assert torch.equal(ck["pf"]["input.weight"], want)
    assert ck["global_step"] == 5

    release.clear()
    started.clear()
    checkpoint.save(out, 2, bundle, async_save=True, keep_last=1)
    assert started.wait(30)
    threading.Timer(0.2, release.set).start()
    found, ep = checkpoint.find_latest(out)     # waits for the save
    assert ep == 2 and os.listdir(checkpoint.ckpt_dir(out)) == [
        "hybrid_ep0002.pt"]
