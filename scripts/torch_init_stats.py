#!/usr/bin/env python
"""The port's initial weights against the JAX package's, in distribution:
for one learning recipe's Config (``pcfm_torch.quality``), each
parameter's standard deviation and mean from the port's initialisation
(a ``torch.Generator``) and from the JAX package's (a PRNG key), the
JAX weights carried into the port's layout by ``pcfm_torch.interop``.
The draws differ, so the two agree within sampling error: a standard
deviation ratio off 1 by more than 10 % (plus 3 / sqrt(size)), or a mean
gap above 3 standard errors, is listed.  Both on the CPU.

    python scripts/torch_init_stats.py --recipe convergence_full \\
        --out_json docs/torch_quality/init_stats_convergence_full.json
"""
import argparse
import dataclasses
import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", choices=("convergence_full", "gen_quality"),
                   default="convergence_full")
    p.add_argument("--out_json", type=str, default=None)
    args = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    from pcfm.config import Config as JaxConfig
    from pcfm.train.state import init_state as jax_init_state
    from pcfm_torch.quality import convergence_full, gen_quality
    from pcfm_torch.train.state import init_state
    from scripts.torch_dyn_parity import carry_weights

    mod = {"convergence_full": convergence_full,
           "gen_quality": gen_quality}[args.recipe]
    cfg = mod.make_config(mod.build_parser().parse_args(
        ["--device", "cpu"])).replace(fused_trunk="off")
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})
    _, jst, _ = jax_init_state(jcfg, jax.random.PRNGKey(cfg.seed), 1)
    port = init_state(cfg, "cpu", 1, torch.Generator().manual_seed(cfg.seed))
    carried = init_state(cfg, "cpu", 1, torch.Generator().manual_seed(0))
    carry_weights(jst, carried, cfg.pf_backbone)

    def named(st):
        return {f"{g}.{n}": q.detach().double()
                for g in ("enc", "pf", "lf")
                for n, q in getattr(st.bundle, g).named_parameters()}

    rows, off = {}, []
    jx = named(carried)
    for k, a in named(port).items():
        b = jx[k]
        sa, sb = ((float(a.std()), float(b.std())) if a.numel() > 1
                  else (0.0, 0.0))
        ma, mb = float(a.mean()), float(b.mean())
        rows[k] = {"size": a.numel(), "port_std": sa, "jax_std": sb,
                   "port_mean": ma, "jax_mean": mb}
        if sa == 0 and sb == 0:
            bad = abs(ma - mb) > 1e-6
        else:
            se = max(sa, sb) / math.sqrt(a.numel())
            bad = (abs(sa / max(sb, 1e-12) - 1)
                   > 0.1 + 3 / math.sqrt(a.numel())
                   or abs(ma - mb) > 3 * se)
        if bad:
            off.append(k)
    out = {"recipe": args.recipe, "parameters": len(rows), "listed": off,
           "rows": rows}
    print(f"{len(rows)} parameters; listed {len(off)}:")
    for k in off:
        print(k, rows[k])
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
