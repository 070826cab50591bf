"""Progressive distillation of the hybrid point flow in the port against
the JAX package, on the CPU: one distill step with BatchNorm frozen (eval
mode, the running statistics of the teacher's EMA), and the distill CLI's
statistics (pcfm/distill/progressive.py:211-220, cli.py:80-99).

JAX runs its ``sorted`` voxel route (its Pallas kernels in interpret mode,
exact HIGHEST window tiles, ``SORTED_N_MIN`` / ``SORTED_R3_MIN`` at 0),
which sorts the points as the port does, and takes the port's choices at
the kinks (``_jax_takes``; the port's side is pcfm_torch/kinks.py): the
teacher's four evaluations and the student's forward, in call order.
Tolerances as tests/test_torch_port_hybrid_train.py holds the hybrid
train step: the loss to RTOL 1e-5, each gradient within ATOL 5e-4 of its
max, the updated student to 1e-3 lr for 99.9 % of the elements and 2 lr
for all, its EMA to 2e-3 lr; the running statistics bitwise.
"""
import contextlib
import copy
import io

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pcfm.nn.pvconv as jpvconv  # noqa: E402
import pcfm.ops.voxel_sorted as jvs  # noqa: E402
from pcfm.distill import progressive as jprog  # noqa: E402
from pcfm.train.state import ModelBundle as JaxBundle  # noqa: E402
from pcfm_torch import interop, kinks  # noqa: E402
from pcfm_torch.distill import cli as dcli  # noqa: E402
from pcfm_torch.distill import progressive as prog  # noqa: E402
from pcfm_torch.nn.pvconv import dead_conv_biases  # noqa: E402
from pcfm_torch.sample import cli as scli  # noqa: E402
from pcfm_torch.train import checkpoint, state  # noqa: E402
from pcfm_torch.train import cli as tcli  # noqa: E402
from tests.test_torch_port_distill import (_jax_distill_draws,  # noqa: E402
                                           _student_close, _t)
from tests.test_torch_port_hybrid import (_jax_hybrid_state,  # noqa: E402
                                          _port_hybrid_bundle, _small_cfg)
from tests.test_torch_port_hybrid_train import (ATOL, RTOL,  # noqa: E402
                                                _buffers, _jax_takes)
from tests.test_torch_port_train import _capturing, _close_to_max  # noqa: E402

LR = 1e-3


@pytest.fixture
def sorted_route(monkeypatch):
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)
    monkeypatch.setattr(jpvconv, "SORTED_N_MIN", 0)
    monkeypatch.setattr(jpvconv, "SORTED_R3_MIN", 0)
    monkeypatch.setattr(jvs, "DOT_PRECISION", jax.lax.Precision.HIGHEST)


def without_encoder(rec: kinks.Kinks, enc_width: int) -> kinks.Kinks:
    """The record without the encoder's max pool (its first site), which
    ``_jax_takes`` leaves to the JAX encoder."""
    kind, mask = rec.sites[0]
    assert kind == "amax" and mask.shape[-1] == enc_width
    out = kinks.Kinks()
    out.sites = rec.sites[1:]
    return out


def test_hybrid_distill_step_matches_jax(sorted_route, monkeypatch):
    # one stage and one case (guided: the teacher at 2B rows; cond
    # dropout): JAX compiles each interpreted kernel call of the five
    # evaluations and the backward, ~25 s a stage.  The unguided step and
    # no dropout are held on the mlp (tests/test_torch_port_distill.py)
    guidance, drop_p = 0.25, 0.5
    cfg, jcfg = _small_cfg(voxel_backend="sorted", ctx_stage_channels=[16],
                           ctx_stage_blocks=[1], ctx_stage_res=[8])
    js = _jax_hybrid_state(jcfg, seed=20)     # live pf, its EMA apart
    steps, b, n = 4, 2, 200
    rng = np.random.RandomState(21)
    batch = {"pts": rng.randn(b, n, 3).astype(np.float32) * 0.5,
             "rgb": rng.rand(b, n, 3).astype(np.float32),
             "cond": rng.rand(b, 1).astype(np.float32)}
    key = jax.random.PRNGKey(22)
    draws = _jax_distill_draws(cfg, key, b, n, steps, drop_p)
    assert 0 < float(draws["keep"].sum()) < b           # both branches

    # the port: the student is the live params with the teacher's EMA
    # statistics, as JAX applies it (progressive.py:147)
    bundle = _port_hybrid_bundle(cfg, js)
    teacher = bundle.ema_pf
    ema_sd = interop.hybrid_to_sd(js["ema_pf"], js["ema_pf_stats"])
    student = copy.deepcopy(teacher)
    student.load_state_dict(interop.hybrid_to_sd(js["pf"],
                                                 js["ema_pf_stats"]))
    ds = prog.init_distill_state(student, LR)
    ds.ema_params.load_state_dict(ema_sd)        # JAX's EMA: the teacher
    stats0 = _buffers(teacher)
    rec = kinks.Kinks()
    with kinks.record(rec):
        m = prog.make_distill_step(bundle, steps, guidance_scale=guidance,
                                   cond_drop_p=drop_p)(
            teacher, ds, {k: _t(v) for k, v in batch.items()}, draws=draws)

    jb = JaxBundle(jcfg)
    tx = _capturing(optax.adamw(LR, weight_decay=1e-4))
    jd = jprog.DistillState(params=js["pf"], ema_params=js["ema_pf"],
                            opt_state=tx.init(js["pf"]),
                            step=jnp.zeros((), jnp.int32))
    left = _jax_takes(monkeypatch, without_encoder(rec, cfg.enc_width))
    new_j, m_j = jprog.make_distill_step(
        jb, tx, steps, guidance_scale=guidance, cond_drop_p=drop_p)(
        {"params": js["ema_pf"], "batch_stats": js["ema_pf_stats"]}, jd,
        js["enc"], {}, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    assert not any(left.values())       # JAX took every recorded choice

    np.testing.assert_allclose(float(m["loss_distill"]),
                               float(m_j["loss_distill"]), rtol=RTOL)
    stats = js["ema_pf_stats"]
    want = interop.hybrid_to_sd(jax.device_get(new_j.opt_state.grads),
                                stats)
    dead = {id(bias) for bias, _ in dead_conv_biases(student)}
    n_grads = 0
    for name, p in student.named_parameters():
        if id(p) in dead:               # a statistic in JAX: no gradient
            assert p.grad is None, name
            continue
        _close_to_max(p.grad.numpy(), want[name].numpy(), ATOL, name)
        n_grads += 1
    assert n_grads == len(jax.tree_util.tree_leaves(js["pf"]))
    _student_close(student, interop.hybrid_to_sd(
        jax.device_get(new_j.params), stats), LR, "student")
    got_ema = ds.ema_params.state_dict()
    names = {id(p): k for k, p in ds.ema_params.named_parameters()}
    for name, w in interop.hybrid_to_sd(jax.device_get(new_j.ema_params),
                                        stats).items():
        if name in {names[id(bb)] for bb, _ in dead_conv_biases(
                ds.ema_params)}:
            continue
        atol = 0 if name.endswith(("running_mean", "running_var")) \
            else 2e-3 * LR
        np.testing.assert_allclose(got_ema[name].numpy(), w.numpy(),
                                   atol=atol, rtol=0, err_msg=name)
    # frozen: the teacher's, the student's and its EMA's statistics stay
    # the teacher's EMA statistics, bitwise
    for module in (teacher, student, ds.ema_params):
        for name, v in _buffers(module).items():
            assert torch.equal(v, stats0[name]), name
    for name in stats0:
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(stats0[name], ema_sd[name]), name


def test_ema_update_keeps_shared_statistics_bitwise():
    """The port's EMA also averages buffers (JAX's averages params only):
    where live and shadow hold the same statistics they stay as they are,
    step after step, as JAX's untouched batch_stats do."""
    cfg, _ = _small_cfg()
    st = state.init_state(cfg, "cpu", 10, torch.Generator().manual_seed(5))
    live, shadow = st.bundle.pf, st.bundle.ema_pf
    with torch.no_grad():
        for v in live.buffers():
            if v.is_floating_point():
                v.uniform_(0.5, 1.5, generator=torch.Generator()
                           .manual_seed(v.numel()))
        shadow.load_state_dict(live.state_dict())
        for p in live.parameters():
            p.add_(0.01)
    before = _buffers(shadow)
    p0 = {k: p.detach().clone() for k, p in shadow.named_parameters()}
    for _ in range(50):
        state.ema_update(shadow, live, 0.999)
    for name, v in _buffers(shadow).items():
        assert torch.equal(v, before[name]), name
    for name, p in shadow.named_parameters():      # the params do move
        assert not torch.equal(p, p0[name]), name


HYB_ARGV = ["--pf_backbone", "hybrid", "--dataset_type", "synthetic",
            "--batch_size", "8", "--tr_max_sample_points", "48",
            "--te_max_sample_points", "48", "--latent_dim", "16",
            "--enc_width", "32", "--pf_width", "128", "--pf_depth", "3",
            "--pf_emb_dim", "16", "--lf_width", "32", "--lf_depth", "3",
            "--lf_emb_dim", "16", "--ctx_dim", "8", "--ctx_emb_dim", "16",
            "--ctx_stage_channels", "16", "--ctx_stage_blocks", "1",
            "--ctx_stage_res", "8", "--ctx_gn_groups", "4",
            "--sample_steps", "4", "--vis_count", "1", "--num_workers", "0",
            "--fused_trunk", "on", "--epochs", "1", "--save_every", "1",
            "--no_amp", "--ctx_dtype", "fp32", "--device", "cpu"]


def test_distill_cli_hybrid_bn_stats(tmp_path):
    """As tests/test_distill.py:184: the distilled checkpoint's live pf
    carries the EMA statistics the student was distilled against, not the
    run's live ones; its EMA carries them too; the run's statistics are
    untouched; the sampling CLI reads it."""
    run, save = str(tmp_path / "run"), str(tmp_path / "distilled")
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(HYB_ARGV + ["--out_dir", run])
        _, steps = dcli.main(["--out_dir", run, "--save_dir", save,
                              "--phases", "1", "--steps_per_phase", "4",
                              "--device", "cpu"])
    assert steps == 2
    src = torch.load(checkpoint.find_latest(run)[0], weights_only=True)
    ck = torch.load(checkpoint.find_latest(save)[0], weights_only=True)
    names = [k for k in src["ema_pf"]
             if k.endswith(("running_mean", "running_var"))]
    assert names
    # non-vacuous: training moved the live statistics off the EMA's
    assert any(not torch.equal(src["pf"][k], src["ema_pf"][k])
               for k in names)
    for k in names:
        assert torch.equal(ck["pf"][k], src["ema_pf"][k]), k
        assert torch.equal(ck["ema_pf"][k], src["ema_pf"][k]), k
    assert ck["args"]["sampler"] == "euler" and \
        ck["args"]["sample_steps"] == 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        x = scli.main(["--out_dir", save, "--save_dir", str(tmp_path / "g"),
                       "--num_samples", "2", "--n_points", "48",
                       "--device", "cpu"])
    assert x.shape == (2, 48, 6) and np.isfinite(x).all()
    assert "euler x2" in buf.getvalue()
