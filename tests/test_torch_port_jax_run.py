"""scripts/jax_run_to_torch.py: a JAX run (orbax checkpoints) converted
into a port run.  A tiny JAX run (width 32, 2 steps, each optimizer
layout; the ``mlp`` here, the ``hybrid`` in
tests/test_torch_port_jax_run_hybrid.py) is saved with the JAX package's
own checkpointing and converted; the port's run must generate the JAX
run's clouds on the same priors (SLICE_ATOL), and the port's next train
step from it, on the same batch and draws, must give JAX's next
parameters within 2e-3 x lr: the AdamW moments and the step were
carried.  The same step with the moments zeroed must miss."""
import contextlib
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pcfm.nn.pvconv as jpvconv  # noqa: E402
from pcfm.config import Config as JaxConfig  # noqa: E402
from pcfm.sample import make_latent_prior as jax_latent_prior  # noqa: E402
from pcfm.sample import make_pf_prior as jax_pf_prior  # noqa: E402
from pcfm.train import checkpoint as jax_ckpt  # noqa: E402
from pcfm.train.evaluate import make_sample_fn as jax_sample_fn  # noqa: E402
from pcfm.train import state as jax_state  # noqa: E402
from pcfm.train.step import train_step as jax_train_step  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.sample.cli import load_run  # noqa: E402
from pcfm_torch.train import checkpoint, state, step  # noqa: E402
from pcfm_torch.train.evaluate import make_sample_fn  # noqa: E402
from scripts import jax_run_to_torch  # noqa: E402
from tests.test_torch_port_train import _jax_draws  # noqa: E402

SLICE_ATOL = 1e-4          # tests/test_torch_port_sample.py
TOTAL = 20
BSZ, N, DROP_P = 2, 48, 0.5
TINY = dict(latent_dim=16, enc_width=32, enc_depth=4, pf_width=32,
            pf_depth=3, pf_emb_dim=16, lf_width=32, lf_depth=3,
            lf_emb_dim=16, amp=False, has_rgb=True, cond_dim=1,
            fused_trunk="off", warmup_steps=0, epochs=TOTAL,
            sampler="heun", sample_steps=2, latent_sample_steps=1,
            cfg_drop_p=DROP_P, seed=0)
HYBRID = dict(pf_backbone="hybrid", ctx_dtype="fp32", ctx_dim=8,
              ctx_emb_dim=16, ctx_stage_channels=[16], ctx_stage_blocks=[1],
              ctx_stage_res=[4], ctx_gn_groups=4, voxel_backend="xla")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"pts": rng.randn(BSZ, N, 3).astype(np.float32) * 0.5,
            "rgb": rng.rand(BSZ, N, 3).astype(np.float32),
            "cond": rng.rand(BSZ, 1).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _initial_state(backbone: str):
    """pcfm.train.state.init_state's state for TINY (flat optimizer), made
    in one jitted call (the eager initialisers compile op by op)."""
    jcfg = JaxConfig(**TINY, **(HYBRID if backbone == "hybrid" else {}))
    return jax.jit(lambda k: jax_state.init_state(jcfg, k, TOTAL)[1])(
        jax.random.PRNGKey(0))


def jax_init_state(jcfg):
    """(bundle, state, tx) of init_state for ``jcfg`` (TINY with either
    optimizer layout): the shared initial weights, the layout's fresh
    optimizer state."""
    tx = jax_state.make_optimizer(jcfg, TOTAL)
    st = _initial_state(jcfg.pf_backbone)
    return (jax_state.ModelBundle(jcfg),
            st.replace(opt_state=jax.jit(tx.init)(st.params)), tx)


def _port_params(st) -> dict:
    return {f"{g}/{n}": p.detach().clone() for g in ("enc", "pf", "lf")
            for n, p in getattr(st.bundle, g).named_parameters()}


def converted_run_samples_and_steps_as_jax(backbone, flat, tmp_path,
                                           monkeypatch):
    """Convert a 2-step JAX run; sample and step the port's run against
    JAX's."""
    # JAX's exact fp32 voxel route (its dense one rounds weights to bf16)
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)
    kw = dict(TINY, **(HYBRID if backbone == "hybrid" else {}))
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = JaxConfig(**kw, flat_optimizer=flat, out_dir=jax_dir)
    cfg = Config(**kw, flat_optimizer=flat, out_dir=port_dir)

    # the JAX run: 2 steps, one checkpoint, the JAX package's own code
    jb, jst, tx = jax_init_state(jcfg)
    jstep = jax.jit(lambda s, b, k: jax_train_step(
        jb, tx, s, b, k, jnp.float32(1.0), jnp.float32(DROP_P)))
    for i in range(2):
        jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in
                             _batch(i).items()}, jax.random.PRNGKey(10 + i))
    jax_ckpt.save(jax_dir, 2, jst, jcfg, async_save=False)
    with contextlib.redirect_stdout(io.StringIO()):
        path = jax_run_to_torch.main([jax_dir, "--out_dir", port_dir])
    assert path.endswith("hybrid_ep0002.pt")
    saved = torch.load(path, weights_only=True)
    assert saved["global_step"] == int(jst.step) == 2 and saved["epoch"] == 2
    assert saved["args"]["flat_optimizer"] is flat

    # the converted run generates JAX's clouds on JAX's priors
    pcfg, bundle, ep = load_run(port_dir, device="cpu")
    assert ep == 2 and pcfg.pf_backbone == backbone
    key, cond = jax.random.PRNGKey(3), _batch(5)["cond"]
    want = np.asarray(jax_sample_fn(jb)(jst, jnp.asarray(cond), key, BSZ, N))
    k_z, k_x = jax.random.split(key)
    z0 = _t(jax_latent_prior(k_z, BSZ, cfg.latent_dim))
    x0 = _t(jax_pf_prior(k_x, (BSZ, N, cfg.pf_point_dim),
                         cfg.point_prior_std, cfg.color_prior,
                         cfg.color_prior_std))
    got = make_sample_fn(bundle)(_t(cond), None, BSZ, N, z0=z0, x0=x0)
    np.testing.assert_allclose(got.numpy(), want, atol=SLICE_ATOL)

    # the next step from the converted run, against JAX's next step
    batch, key = _batch(7), jax.random.PRNGKey(12)
    new_j, _ = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want = {}
    for g, sd in jax_run_to_torch.to_state_dicts(
            jcfg, jax.device_get(new_j.params),
            jax.device_get(new_j.batch_stats)).items():
        want.update({f"{g}/{n}": v for n, v in sd.items()})
    draws = _jax_draws(cfg, key, BSZ, N, DROP_P)
    lr = cfg.lr_pf
    worst = {}
    for control in (False, True):
        st = state.init_state(cfg, "cpu", TOTAL,
                              torch.Generator().manual_seed(1))
        with contextlib.redirect_stdout(io.StringIO()) as log:
            checkpoint.auto_resume(port_dir, st)
        assert "RESET" not in log.getvalue() and st.step == 2
        assert {float(s["step"]) for s in st.opt.state.values()} == {2.0}
        if control:
            for s in st.opt.state.values():
                s["exp_avg"].zero_()
                s["exp_avg_sq"].zero_()
        step.train_step(st, {k: _t(v) for k, v in batch.items()}, None,
                        1.0, DROP_P, draws=draws)
        got = _port_params(st)
        worst[control] = max(float((got[k] - want[k]).abs().max())
                             for k in got)
    assert worst[False] <= 2e-3 * lr < worst[True], worst


@pytest.mark.parametrize("flat", [True, False])
def test_converted_mlp_run_samples_and_steps_as_jax(flat, tmp_path,
                                                    monkeypatch):
    converted_run_samples_and_steps_as_jax("mlp", flat, tmp_path,
                                           monkeypatch)


def test_moments_map_like_their_weights():
    """A moment tree goes through the weights' *_to_sd: the converted
    optimizer state holds, for each port parameter, the JAX moment of the
    same weight (transposed as the weight is), and nothing for the dead
    conv biases."""
    from pcfm_torch.nn.pvconv import dead_conv_biases

    kw = dict(TINY, **HYBRID)
    jcfg = JaxConfig(**kw)
    _, jst, _ = jax_init_state(jcfg)
    params = jax.device_get(jst.params)
    rng = np.random.RandomState(0)
    m = jax.tree_util.tree_map(
        lambda p: rng.randn(*np.shape(p)).astype(np.float32), params)
    stats = jax.device_get(jst.batch_stats)
    m_sd = jax_run_to_torch.to_state_dicts(jcfg, m, stats)
    bundle = state.ModelBundle(Config(**kw), "cpu",
                               torch.Generator().manual_seed(0))
    moments = {g: {n: (sd[n], sd[n] ** 2) for n in sd}
               for g, sd in m_sd.items()}
    opt = interop.adamw_state_dict(bundle, moments, 7)
    dead = {id(b) for b, _ in dead_conv_biases(bundle.pf)}
    names = [(g, n) for g in ("enc", "pf", "lf")
             for n, p in getattr(bundle, g).named_parameters()
             if id(p) not in dead]
    assert len(opt["state"]) == len(names) == sum(
        len(g["params"]) for g in opt["param_groups"])
    for i, (g, n) in enumerate(names):
        torch.testing.assert_close(opt["state"][i]["exp_avg"], m_sd[g][n],
                                   rtol=0, atol=0)
        assert float(opt["state"][i]["step"]) == 7.0
    kernel = m["pf"]["head"]["input"]["kernel"]
    torch.testing.assert_close(m_sd["pf"]["head.input.weight"],
                               torch.from_numpy(kernel.T.copy()))
