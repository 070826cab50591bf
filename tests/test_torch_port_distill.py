"""Progressive distillation in the port (pcfm_torch.distill) against the
JAX package (pcfm.distill), in fp32 on the CPU: the teacher rollouts, one
distill step, whole ``distill_pf`` runs, and the distill CLI with its
checkpoint read back by the port's sampling CLI and by the JAX package.

Weights go JAX -> port through pcfm_torch.interop; a step's draws (prior,
grid index, condition keep mask) are rebuilt from the JAX step's own key
splits (pcfm/distill/progressive.py:118-140), and ``distill_pf``'s from
its per-step ``split(rng)``.  The JAX fused trunk runs its Pallas kernel
in interpret mode; the port's runs its plain versions.  Tolerances: the
rollouts to 1e-6 (the same fp32 arithmetic); the loss to rtol 1e-5 and
each gradient within 1e-4 of its max (another summation order); the
updated student as tests/test_torch_port_train.py holds a train step
(Adam's first update is ~lr * sign(g): 99.9 % of the elements to 1e-3 lr,
all to 2 lr), its EMA to 2e-3 lr; Euler samples of the distilled
checkpoint to 1e-4, as tests/test_torch_port_sample.py holds sampling.
"""
import contextlib
import copy
import io
import os

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm.distill import progressive as jprog  # noqa: E402
from pcfm.interop.torch_ckpt import (config_from_reference_args,  # noqa: E402
                                     state_from_reference_ckpt)
from pcfm.sample import integrators as jint  # noqa: E402
from pcfm.sample import make_pf_prior as jax_prior  # noqa: E402
from pcfm.train.evaluate import _cond_full as jax_cond_full  # noqa: E402
from pcfm.train.state import ModelBundle as JaxBundle  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.distill import cli as dcli  # noqa: E402
from pcfm_torch.distill import progressive as prog  # noqa: E402
from pcfm_torch.sample import cli as scli  # noqa: E402
from pcfm_torch.train import checkpoint  # noqa: E402
from pcfm_torch.train import cli as tcli  # noqa: E402
from pcfm_torch.train.evaluate import make_sample_fn  # noqa: E402
from tests.test_torch_port_sample import (_field_jax, _field_torch,  # noqa: E402
                                          _jax_state, _port_bundle,
                                          _small_cfgs)
from tests.test_torch_port_train import _capturing, _close_to_max  # noqa: E402

ROLLOUT_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
SAMPLE_ATOL = 1e-4
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------ rollouts

@pytest.mark.parametrize("rollout", ["heun", "euler"])
@pytest.mark.parametrize("guidance", [0.0, 0.5])
def test_teacher_rollouts_match_jax(rollout, guidance):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 11, 6).astype(np.float32)
    t = rng.rand(3).astype(np.float32) * 0.7
    cond = rng.randn(3, 4).astype(np.float32)
    want = getattr(jprog, f"_teacher_two_{rollout}")(
        jint.make_guided(_field_jax, jnp.asarray(cond), guidance),
        jnp.asarray(x), jnp.asarray(t), 0.25)
    got = prog.ROLLOUTS[rollout](
        prog.make_guided(_field_torch, _t(cond), guidance), _t(x), _t(t),
        0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ROLLOUT_ATOL)


def test_teacher_two_euler_exact_on_secant_field():
    """As tests/test_distill.py:221: two Euler sub-steps recover a secant
    field's own rollout exactly; Heun sub-steps miss it by O(h dS)."""
    h = 1.0 / 8

    def traj(t):
        return torch.sin(3.0 * t)

    def vf(x, t):
        tb = t[:, None, None]
        return (traj(tb + h) - traj(tb)) / h * torch.ones_like(x)

    x0 = torch.zeros(2, 4, 3) + traj(torch.tensor(0.25))
    t = torch.full((2,), 0.25)
    want = torch.zeros_like(x0) + traj(torch.tensor(0.25 + 2 * h))
    torch.testing.assert_close(prog._teacher_two_euler(vf, x0, t, 2 * h),
                               want, atol=ROLLOUT_ATOL, rtol=0)
    assert float((prog._teacher_two_heun(vf, x0, t, 2 * h)
                  - want).abs().max()) > 1e-3


# ------------------------------------------------------------ one step

def _batch(rng, b=3, n=40, cond_dim=2):
    return {"pts": rng.randn(b, n, 3).astype(np.float32) * 0.5,
            "rgb": rng.rand(b, n, 3).astype(np.float32),
            "cond": rng.rand(b, cond_dim).astype(np.float32)}


def _jax_distill_draws(cfg, key, b, n, phase_steps, drop_p):
    """The JAX step's draws from its key (progressive.py:118-140)."""
    k_prior, k_t, k_drop = jax.random.split(key, 3)
    d = {"x0": jax_prior(k_prior, (b, n, cfg.pf_point_dim),
                         cfg.point_prior_std, cfg.color_prior,
                         cfg.color_prior_std),
         "k": jax.random.randint(k_t, (b,), 0, phase_steps),
         "keep": (jax.random.uniform(k_drop, (b, 1)) >= drop_p).astype(
             jnp.float32)}
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in d.items()}


def _student_close(student, want_sd, lr, what):
    diffs = torch.cat([(p.detach() - want_sd[name]).abs().flatten()
                       for name, p in student.named_parameters()])
    assert float((diffs <= 1e-3 * lr).float().mean()) >= 0.999, what
    assert float(diffs.max()) <= 2 * lr, what


@pytest.mark.parametrize("fused,guidance,drop_p", [
    ("on", 0.0, 0.0), ("off", 0.25, 0.0), ("on", 0.25, 0.5),
    ("off", 0.0, 0.5)])
def test_distill_step_matches_jax(fused, guidance, drop_p):
    cfg, jcfg = _small_cfgs(fused_trunk=fused)
    state = _jax_state(jcfg, seed=3)    # live pf != its EMA (the teacher)
    jb = JaxBundle(jcfg)
    steps, b, n = 4, 3, 40
    batch = _batch(np.random.RandomState(4), b, n, cfg.cond_dim)
    teacher = {"params": state.ema_pf["params"], "batch_stats": {}}
    tx = _capturing(optax.adamw(LR, weight_decay=1e-4))
    student = state.params["pf"]
    jd = jprog.DistillState(params=student, ema_params=teacher["params"],
                            opt_state=tx.init(student),
                            step=jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(5)
    new_j, m_j = jprog.make_distill_step(
        jb, tx, steps, guidance_scale=guidance, cond_drop_p=drop_p)(
        teacher, jd, state.params["enc"], {},
        {k: jnp.asarray(v) for k, v in batch.items()}, key)

    bundle = _port_bundle(cfg, state)
    ds = prog.init_distill_state(bundle.pf, LR)
    ds.ema_params.load_state_dict(bundle.ema_pf.state_dict())
    draws = _jax_distill_draws(cfg, key, b, n, steps, drop_p)
    if drop_p:
        assert 0 < float(draws["keep"].sum()) < b       # both branches
    m = prog.make_distill_step(bundle, steps, guidance_scale=guidance,
                               cond_drop_p=drop_p)(
        bundle.ema_pf, ds, {k: _t(v) for k, v in batch.items()},
        draws=draws)
    np.testing.assert_allclose(float(m["loss_distill"]),
                               float(m_j["loss_distill"]), rtol=LOSS_RTOL)
    assert ds.step == 1
    want = interop.velocity_net_to_sd(jax.device_get(new_j.opt_state.grads))
    for name, p in ds.params.named_parameters():
        _close_to_max(p.grad.numpy(), want[name].numpy(), GRAD_REL, name)
    _student_close(ds.params, interop.velocity_net_to_sd(
        jax.device_get(new_j.params)), LR, "student")
    ema = interop.velocity_net_to_sd(jax.device_get(new_j.ema_params))
    for name, v in ds.ema_params.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ema[name].numpy(),
                                   atol=2e-3 * LR, rtol=0, err_msg=name)
    # the teacher did not move
    for name, v in _port_bundle(cfg, state).ema_pf.state_dict().items():
        assert torch.equal(v, bundle.ema_pf.state_dict()[name]), name


def test_cond_dropout_makes_the_loss_blind_to_the_condition():
    """As tests/test_distill.py:273: with cond_drop_p = 1 every row takes
    the unconditional branch, so the loss ignores the condition's values;
    with 0 it does not."""
    cfg, jcfg = _small_cfgs()
    bundle = _port_bundle(cfg, _jax_state(jcfg, seed=6))
    batch = {k: _t(v) for k, v in _batch(np.random.RandomState(7)).items()}
    moved = dict(batch, cond=batch["cond"] + 5.0)

    def loss(drop_p, bt):
        ds = prog.init_distill_state(copy.deepcopy(bundle.pf), LR)
        draws = prog.make_distill_draws(
            cfg, bt, torch.Generator().manual_seed(9), 2, drop_p)
        return float(prog.make_distill_step(bundle, 2, cond_drop_p=drop_p)(
            bundle.ema_pf, ds, bt, draws=draws)["loss_distill"])

    assert loss(1.0, batch) == pytest.approx(loss(1.0, moved), rel=1e-6)
    assert loss(0.0, batch) != pytest.approx(loss(0.0, moved), rel=1e-3)


def test_distill_draws():
    cfg = _small_cfgs(color_prior="uniform")[0]
    batch = {"pts": torch.zeros(4000, 5, 3)}
    d = prog.make_distill_draws(cfg, batch, torch.Generator().manual_seed(0),
                                4, 0.25)
    assert d["x0"].shape == (4000, 5, 6) and d["k"].shape == (4000,)
    assert set(d["k"].tolist()) == {0, 1, 2, 3}
    assert 0.0 <= float(d["x0"][..., 3:].min()) and \
        float(d["x0"][..., 3:].max()) <= 1.0              # uniform colour
    np.testing.assert_allclose(float(d["keep"].mean()), 0.75, atol=0.03)
    assert d["keep"].shape == (4000, 1)


# ------------------------------------------------------------ distill_pf

def test_distill_pf_matches_jax(monkeypatch):
    """Two phases (8 -> 4 -> 2 Euler steps), two steps each, guided phase
    0 with Heun, unguided phase 1 with the Euler rollout, cond dropout:
    the port's student and EMA against pcfm.distill.distill_pf on the same
    batches and draws.  The plain trunk: the step cases hold the fused one,
    and JAX would compile its interpreted kernel once a phase."""
    cfg, jcfg = _small_cfgs(fused_trunk="off")
    state = _jax_state(jcfg, seed=10)
    rng = np.random.RandomState(11)
    batches = [_batch(rng) for _ in range(3)]
    kw = dict(base_steps=8, phases=2, steps_per_phase=2, lr=LR,
              ema_decay=0.9, guidance_scale=0.25, cond_drop_p=0.5,
              teacher_rollout="euler", verbose=False)

    def jax_batches(phase):
        for i in range(10):
            yield {k: jnp.asarray(v) for k, v in batches[i % 3].items()}

    pf, pf_ema, steps = jprog.distill_pf(JaxBundle(jcfg), state, jax_batches,
                                         rng=jax.random.PRNGKey(12), **kw)
    assert steps == 2

    # distill_pf's keys: rng, sk = split(rng) a step, across phases
    draws, key = [], jax.random.PRNGKey(12)
    for phase_steps in (4, 4, 2, 2):
        key, sk = jax.random.split(key)
        draws.append(_jax_distill_draws(cfg, sk, 3, 40, phase_steps, 0.5))
    monkeypatch.setattr(prog, "make_distill_draws",
                        lambda *a: draws.pop(0))
    bundle = _port_bundle(cfg, state)
    student, ema, got_steps = prog.distill_pf(
        bundle, lambda phase: ({k: _t(v) for k, v in batches[i % 3].items()}
                               for i in range(10)), **kw)
    assert got_steps == 2 and not draws
    # four Adam steps: an element flipped at one step moves later ones
    _student_close(student, interop.velocity_net_to_sd(jax.device_get(pf)),
                   4 * LR, "student")
    _student_close(ema, interop.velocity_net_to_sd(jax.device_get(pf_ema)),
                   4 * LR, "EMA")
    # the bundle's own modules are untouched: the teacher was copied
    for name, v in _port_bundle(cfg, state).ema_pf.state_dict().items():
        assert torch.equal(v, bundle.ema_pf.state_dict()[name]), name


def test_distill_pf_phases_and_clamping(capsys, monkeypatch):
    cfg, jcfg = _small_cfgs()
    bundle = _port_bundle(cfg, _jax_state(jcfg, seed=13))
    batch = {k: _t(v) for k, v in _batch(np.random.RandomState(14)).items()}
    calls = []
    real = prog.make_distill_step

    def spy(bundle_, steps, *a, **kw):
        calls.append((steps, kw["guidance_scale"], kw["teacher_rollout"]))
        return real(bundle_, steps, *a, **kw)

    monkeypatch.setattr(prog, "make_distill_step", spy)
    student, ema, steps = prog.distill_pf(
        bundle, lambda phase: iter([batch] * 5), base_steps=2, phases=3,
        steps_per_phase=2, guidance_scale=0.5, teacher_rollout="euler")
    assert steps == 1                                   # 2 -> 1 -> 1 -> 1
    assert calls == [(1, 0.5, "heun"), (1, 0.0, "euler"), (1, 0.0, "euler")]
    out = capsys.readouterr().out
    assert out.count("2 opt steps") == 3 and "phase 3/3" in out
    assert student is not bundle.pf and ema is not bundle.ema_pf
    with pytest.raises(ValueError, match="phases must be >= 1"):
        prog.distill_pf(bundle, lambda phase: iter([batch]), phases=0)
    with pytest.raises(ValueError, match="yielded no batches"):
        prog.distill_pf(bundle, lambda phase: iter(()), phases=1,
                        verbose=False)


# ------------------------------------------------------------ the CLI

RUN_ARGV = ["--dataset_type", "synthetic", "--batch_size", "4",
            "--tr_max_sample_points", "32", "--te_max_sample_points", "32",
            "--latent_dim", "16", "--enc_width", "32", "--pf_width", "128",
            "--pf_depth", "3", "--pf_emb_dim", "16", "--lf_width", "32",
            "--lf_depth", "3", "--lf_emb_dim", "16", "--sample_steps", "8",
            "--sampler", "heun", "--guidance_scale", "0.5", "--vis_count",
            "1", "--num_workers", "0", "--fused_trunk", "on", "--epochs",
            "1", "--save_every", "1", "--no_amp", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_distill") / "run")
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(RUN_ARGV + ["--out_dir", out])
    return out


def _distill(run, save, extra=(), monkeypatch=None):
    seen = {}
    real = dcli.distill_pf

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(dcli, "distill_pf", spy)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = dcli.main(["--out_dir", run, "--save_dir", save, "--phases",
                         "2", "--steps_per_phase", "3", "--device", "cpu",
                         *extra])
    return out, seen, buf.getvalue()


@pytest.fixture(scope="module")
def distilled_run(trained_run, tmp_path_factory):
    save = str(tmp_path_factory.mktemp("port_distill") / "distilled")
    with pytest.MonkeyPatch.context() as mp:
        out = _distill(trained_run, save, monkeypatch=mp)
    return save, out


def test_distill_cli_round_trip(trained_run, distilled_run, tmp_path):
    save, ((save_dir, steps), seen, log) = distilled_run
    assert save_dir == save and steps == 2                  # 8 -> 4 -> 2
    assert seen["guidance_scale"] == 0.5 and seen["cond_drop_p"] == 0.0
    assert "euler x2, 8x fewer NFE" in log and log.count("[distill]") == 3
    src_path, ep = checkpoint.find_latest(trained_run)
    src = torch.load(src_path, weights_only=True)
    path, ep2 = checkpoint.find_latest(save)
    ck = torch.load(path, weights_only=True)
    assert ep2 == ep and ck["global_step"] == src["global_step"] > 0
    assert ck["args"]["sampler"] == "euler"
    assert ck["args"]["sample_steps"] == 2
    assert ck["args"]["guidance_scale"] == 0.0              # baked in
    assert ck["opt"]["param_groups"] == src["opt"]["param_groups"]
    torch.testing.assert_close(ck["opt"]["state"], src["opt"]["state"],
                               rtol=0, atol=0)           # carried over
    for key in ("encoder", "lf", "ema_lf"):
        torch.testing.assert_close(ck[key], src[key], rtol=0, atol=0)
    for key in ("pf", "ema_pf"):
        assert any(not torch.equal(v, src[key][k])
                   for k, v in ck[key].items()), key
    # the port's sampling CLI takes the fast path as it is
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        x = scli.main(["--out_dir", save, "--save_dir", str(tmp_path),
                       "--num_samples", "2", "--n_points", "32",
                       "--device", "cpu"])
    assert "euler x2" in buf.getvalue()
    assert x.shape == (2, 32, 6) and np.isfinite(x).all()
    assert os.path.isfile(os.path.join(tmp_path, "sample_1.ply"))


def test_unguided_distill_of_a_guided_run_keeps_cfg(trained_run, tmp_path,
                                                    monkeypatch):
    """--guidance_scale 0 on a run trained for guidance 0.5: the run's
    cfg_drop_p supervises the unconditional branch, and the saved config
    keeps the run's guidance for sampling (pcfm/distill/cli.py:66-71)."""
    (_, steps), seen, _ = _distill(trained_run, str(tmp_path / "d"),
                                   ["--guidance_scale", "0"], monkeypatch)
    assert steps == 2
    assert seen["guidance_scale"] == 0.0 and seen["cond_drop_p"] == 0.1
    ck = torch.load(checkpoint.find_latest(str(tmp_path / "d"))[0],
                    weights_only=True)
    assert ck["args"]["guidance_scale"] == 0.5


def test_distilled_checkpoint_samples_alike_in_jax(distilled_run):
    """The distilled mlp checkpoint through pcfm/interop/torch_ckpt.py:
    Euler x 2 samples from the same priors in JAX and in the port."""
    save, _ = distilled_run
    path, _ = checkpoint.find_latest(save)
    ck = torch.load(path, weights_only=True)
    jcfg = config_from_reference_args(ck["args"], cond_dim=ck["cond_dim"])
    assert (jcfg.sampler, jcfg.sample_steps) == ("euler", 2)
    jb, jst, _ = state_from_reference_ckpt(ck, jcfg)
    cfg, bundle, _ = checkpoint.load(path, "cpu")
    rng = np.random.RandomState(15)
    b, n = 2, 30
    z0 = rng.randn(b, cfg.latent_dim).astype(np.float32)
    x0 = rng.randn(b, n, cfg.pf_point_dim).astype(np.float32)
    cond = rng.rand(b, cfg.cond_dim).astype(np.float32)
    js = jint.get_sampler("euler")
    z = js(jb.lf_velocity_fn(jst.ema_lf["params"]), jnp.asarray(z0), 2,
           cond=None, guidance_scale=0.0)
    cf = jax_cond_full(jcfg, z, jnp.asarray(cond))
    want = np.asarray(js(jb.pf_velocity_fn(jst.ema_pf["params"], {}),
                         jnp.asarray(x0), 2, cond=cf, guidance_scale=0.0))
    got = make_sample_fn(bundle)(_t(cond), None, b, n, z0=_t(z0),
                                 x0=_t(x0)).numpy()
    np.testing.assert_allclose(got, want, atol=SAMPLE_ATOL)
