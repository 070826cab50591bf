#!/usr/bin/env python3
"""Convert a JAX run of pcfm (orbax checkpoints) into a pcfm_torch run.

    python scripts/jax_run_to_torch.py runs/jax_run --out_dir runs/port_run
    python -m pcfm_torch.train.cli --out_dir runs/port_run ...  # resumes

Reads the newest complete checkpoint under ``<jax_run>/ckpts`` the way the
JAX package's sampling CLI does (pcfm/sample/cli.py:load_run: meta.json ->
Config, ``init_state``, ``checkpoint.restore``) and writes
``<out_dir>/ckpts/hybrid_ep{epoch:04d}.pt`` in the reference format that
every pcfm_torch CLI loads (``pcfm_torch.train.checkpoint``), with:

* the live modules (``encoder``, ``pf``, ``lf``, and ``adv`` where the run
  trains the adversary) and the EMA shadows (``ema_pf``, ``ema_lf``, from
  their {params, batch_stats}), mapped by ``pcfm_torch.interop``'s
  ``*_to_sd``; the hybrid's BatchNorm statistics as they are (the port's
  dead conv biases, which the JAX package does not have, are 0);
* the AdamW moments of every parameter, from either optimizer layout of
  the JAX package: the flat one (``FlatAdamWState.m`` / ``.v``, unraveled
  with ``ravel_pytree(state.params)``'s own unravel) or the optax
  ``multi_transform`` chain (each group's ``ScaleByAdamState.mu`` / ``.nu``).
  A moment is a tree shaped like the params and goes through the same
  ``*_to_sd`` as its weight (transposes and reshapes act on it alike);
  the port's optimizer (``make_optimizer``: groups enc / pf / lf / adv)
  holds no moment for the dead conv biases and none is made up;
* ``global_step`` and every parameter's AdamW ``step`` = the JAX
  ``state.step`` (optax's ``count``, not one more: both count bias
  correction from ``count + 1`` and evaluate the LR at ``count``), the
  epoch from meta.json, and the run's Config as ``args``.

The JAX PRNG key has no counterpart: after the resume, the port's draws
come from its own ``torch.Generator``, seeded as its own resume seeds it.

Runs where jax, flax, optax and orbax are installed (a TPU or CPU host);
the card machine needs only the written ``.pt``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_jax_run(jax_run: str):
    """(cfg, state on the host, epoch) of the newest complete checkpoint,
    as pcfm/sample/cli.py:load_run rebuilds it (``init_state``'s shapes
    are all ``restore`` reads, so they are traced, not run)."""
    import jax

    from pcfm.config import Config
    from pcfm.train import checkpoint as ckpt
    from pcfm.train.state import init_state

    path, ep = ckpt.find_latest(jax_run)
    if path is None:
        raise FileNotFoundError(f"no complete checkpoint under "
                                f"{jax_run}/ckpts")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = Config.from_json(json.dumps(meta["config"]))
    state = jax.eval_shape(lambda k: init_state(cfg, k, total_steps=1)[1],
                           jax.random.PRNGKey(0))
    state, meta = ckpt.restore(path, state)
    return cfg, jax.device_get(state), int(meta.get("epoch", ep))


def adam_moments(state) -> tuple:
    """(m, v, count): the first and second moments as trees shaped like
    ``state.params``, from the flat or the optax layout."""
    from jax.flatten_util import ravel_pytree

    from pcfm.train.flat_opt import FlatAdamWState

    opt = state.opt_state
    if isinstance(opt, FlatAdamWState):
        unravel = ravel_pytree(state.params)[1]
        return unravel(opt.m), unravel(opt.v), int(opt.count)
    m, v, counts = {}, {}, set()
    for group in state.params:
        adam = opt.inner_states[group].inner_state[0]   # ScaleByAdamState
        m[group], v[group] = adam.mu[group], adam.nu[group]
        counts.add(int(adam.count))
    if len(counts) != 1:
        raise ValueError(f"optimizer groups disagree on the step: {counts}")
    return m, v, counts.pop()


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def to_state_dicts(cfg, params, batch_stats) -> Dict[str, dict]:
    """{group: state_dict} of a params-shaped tree (weights or moments)."""
    from pcfm_torch import interop

    out = {"enc": interop.shape_encoder_to_sd(params["enc"]),
           "lf": interop.latent_net_to_sd(params["lf"])}
    if cfg.pf_backbone == "hybrid":
        out["pf"] = interop.hybrid_to_sd(params["pf"], batch_stats["pf"])
    else:
        out["pf"] = interop.velocity_net_to_sd(params["pf"])
    if "adv" in params:
        out["adv"] = interop.adversary_to_sd(params["adv"])
    return out


def convert(jax_run: str, out_dir: str) -> str:
    """Write the port run; returns the checkpoint's path."""
    import torch

    from pcfm_torch import interop
    from pcfm_torch.config import Config as PortConfig
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle

    cfg, state, epoch = load_jax_run(jax_run)
    m, v, count = adam_moments(state)
    step = int(state.step)
    if count != step:
        raise ValueError(f"optimizer count {count} != state.step {step}")
    stats = _np_tree(state.batch_stats)
    live = to_state_dicts(cfg, _np_tree(state.params), stats)
    ema_pf = _np_tree(state.ema_pf)
    ema = to_state_dicts(
        cfg, {"enc": _np_tree(state.params["enc"]), "pf": ema_pf["params"],
              "lf": _np_tree(state.ema_lf["params"])},
        {"pf": ema_pf["batch_stats"]})
    m_sd = to_state_dicts(cfg, _np_tree(m), stats)
    v_sd = to_state_dicts(cfg, _np_tree(v), stats)

    port_cfg = PortConfig.from_json(cfg.to_json()).replace(out_dir=out_dir)
    bundle = ModelBundle(port_cfg, "cpu", torch.Generator().manual_seed(0))
    modules = {"encoder": live["enc"], "pf": live["pf"], "lf": live["lf"],
               "ema_pf": ema["pf"], "ema_lf": ema["lf"]}
    if bundle.adv is not None:
        modules["adv"] = live["adv"]
    for key, module in bundle.modules().items():
        module.load_state_dict(modules[key])
    moments = {g: {name: (m_sd[g][name], v_sd[g][name]) for name in m_sd[g]}
               for g in m_sd}
    opt = interop.adamw_state_dict(bundle, moments, step)
    return checkpoint.save(out_dir, epoch, bundle, global_step=step,
                           opt=opt)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        description="Convert a JAX pcfm run into a pcfm_torch run")
    p.add_argument("jax_run", help="JAX run dir holding ckpts/")
    p.add_argument("--out_dir", required=True,
                   help="pcfm_torch run dir to write ckpts/ under")
    args = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")   # a host-side conversion
    path = convert(args.jax_run, args.out_dir)
    print(f"[jax_run_to_torch] wrote {path}")
    return path


if __name__ == "__main__":
    main()
