"""The port's sharded train step against the JAX package's, on the CPU:
one step at (dp, sp) = (2, 2) of the port (4 ranks over gloo,
tests/torch_parallel_workers.py) and of JAX's step on a (2, 2) mesh of the
8-device virtual CPU mesh that tests/conftest.py sets up, from the same
weights (pcfm_torch.interop), batch and draws (rebuilt from JAX's key
splits; the port takes each rank's block of them), for the ``mlp`` and the
``hybrid``.  Tolerances: tests/test_parallel.py's for JAX's sharded step
against its one-device step (tests/test_torch_port_parallel.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm.config import Config as JaxConfig  # noqa: E402
from pcfm.parallel import make_mesh, replicate_state  # noqa: E402
from pcfm.parallel import shard_batch as jax_shard_batch  # noqa: E402
from pcfm.train.state import init_state as jax_init_state  # noqa: E402
from pcfm.train.step import make_train_step  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from tests import torch_parallel_workers as tw  # noqa: E402
from tests.test_torch_port_parallel import (LOSS_RTOL, MODELS,  # noqa: E402
                                            PARAM_ATOL, PARAM_ATOL_HYBRID,
                                            PARAM_RTOL, _batch)


def _jax_draws(cfg, rng, bsz, n, drop_p):
    """The JAX step's draws of the global batch, rebuilt from its key
    splits (RGB path; pcfm/train/step.py:73-106)."""
    k_t, k_prior, k_tz, k_priorz, k_drop, _ = jax.random.split(rng, 6)
    kx, kc = jax.random.split(k_prior)
    beta = lambda k: jax.random.beta(k, cfg.t_beta_a, 1.0,  # noqa: E731
                                     (bsz,)).astype(jnp.float32)
    d = {"t": beta(k_t),
         "x0": jnp.concatenate(
             [jax.random.normal(kx, (bsz, n, 3)) * cfg.point_prior_std,
              jax.random.normal(kc, (bsz, n, 3)) * cfg.color_prior_std], -1),
         "drop": (jax.random.uniform(k_drop, (bsz,)) < drop_p).astype(
             jnp.float32),
         "t_z": beta(k_tz),
         "eps_z": jax.random.normal(k_priorz, (bsz, cfg.latent_dim))
         * cfg.latent_prior_std}
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in d.items()}


def _port_modules(jst, hybrid: bool) -> dict:
    """The JAX state's params (and the hybrid's statistics) as the port's
    module state dicts, the EMA shadows equal to the live modules."""
    p = jax.device_get(jst.params)
    if hybrid:
        pf = interop.hybrid_to_sd(p["pf"], jax.device_get(
            jst.batch_stats["pf"]))
    else:
        pf = interop.velocity_net_to_sd(p["pf"])
    lf = interop.latent_net_to_sd(p["lf"])
    return {"encoder": interop.shape_encoder_to_sd(p["enc"]), "pf": pf,
            "lf": lf, "ema_pf": pf, "ema_lf": lf}


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    """One step at (dp, sp) = (2, 2) of the port (4 ranks) and of JAX on
    its (2, 2) mesh, from the same weights, batch and draws."""
    tmp = str(tmp_path_factory.mktemp("jax"))
    batch = _batch()
    rng, drop_p = jax.random.PRNGKey(2), 0.5
    jmesh = make_mesh(2, 2)
    cases, jax_out = [], {}
    for model, kw in MODELS.items():
        jcfg = JaxConfig(**kw, dp=2, sp=2)
        bundle, jst, tx = jax_init_state(jcfg, jax.random.PRNGKey(0), 100)
        step = make_train_step(bundle, tx, donate=False)
        s_mesh, m_mesh = step(replicate_state(jst, jmesh),
                              jax_shard_batch(batch, jmesh), rng,
                              jnp.float32(1.0), jnp.float32(drop_p))
        jax_out[model] = (float(m_mesh["loss"]), _port_modules(
            s_mesh, model == "hybrid"))
        path = f"{tmp}/{model}_state.pt"
        torch.save(_port_modules(jst, model == "hybrid"), path)
        draws = _jax_draws(jcfg, rng, 8, 32, drop_p)
        cases.append((f"{model}_jax", kw, 2, 2, batch, 1, path, [draws]))
    tw.run_ranks(tw.step_cases, 4, tmp, cases)
    return {m: (jax_out[m], torch.load(f"{tmp}/{m}_jax.rank0.pt"))
            for m in MODELS}


@pytest.mark.parametrize("model", list(MODELS))
def test_sharded_step_matches_jax_sharded_step(against_jax, model):
    (loss_j, modules_j), port = against_jax[model]
    np.testing.assert_allclose(port["metrics"][0]["loss"], loss_j,
                               rtol=LOSS_RTOL)
    atol = PARAM_ATOL if model == "mlp" else PARAM_ATOL_HYBRID
    groups = {"enc": "encoder", "pf": "pf", "lf": "lf"}
    for key, got in port["params"].items():
        g, name = key.split("/", 1)
        np.testing.assert_allclose(got.numpy(),
                                   modules_j[groups[g]][name].numpy(),
                                   rtol=PARAM_RTOL, atol=atol, err_msg=key)
