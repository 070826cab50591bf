"""Training dynamics of the port against the JAX package over many steps
(scripts/torch_dyn_parity.py): both train on the CPU in fp32 from the
same weights, on the same batches, with the same draws at every step (the
port's rebuilt from the JAX step's key splits), then reconstruct with
Euler x 8 from their EMA weights, from one prior.  The sizes are those of
tests/test_dyn_parity.py: 32 clouds of 128 points, batch 8 (4 steps an
epoch), latent 32, widths 32 / 64 / 64, embedding 32.

Measured on the CPU (torch 2.13.0+cpu, jax 0.9.0):

  * mlp, 40 epochs (160 steps): first 20 steps' largest relative loss
    difference 3.1e-6 (loss_point) and 4.4e-7 (loss_latent); late-5-epoch
    rel diff 0.0 / 1e-6; recon CD 1.4218 both, ratio 1.000004;
  * hybrid, 30 epochs (120 steps): 6.1e-5 / 2.4e-6; late 4.7e-4 / 7e-6;
    recon CD 1.5737 (JAX) and 1.5735 (port), ratio 1.00009.

The tolerances: 1e-3 on the first 20 steps (rounding alone), and on
the late window and the recon CDs those of
tests/test_dyn_parity.py's mlp gate, which holds JAX against the
reference recipe's torch mirrors with independent draws.
"""
import pytest

pytest.importorskip("torch")

SIZES = dict(size=32, n_points=128, batch=8, latent=32, enc_width=32,
             pf_width=64, lf_width=64, emb=32, sample_steps=8)


@pytest.mark.parametrize("backbone,epochs", [("mlp", 40), ("hybrid", 30)])
def test_training_dynamics_match_jax(backbone, epochs, tmp_path):
    import json

    from scripts.torch_dyn_parity import FIRST_STEPS, run
    path = str(tmp_path / "dyn.json")
    out = run(epochs=epochs, backbone=backbone, out_json=path,
              verbose=False, **SIZES)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    steps = epochs * SIZES["size"] // SIZES["batch"]
    for side in ("pcfm", "pcfm_torch"):
        assert len(out[side]["step_loss_point"]) == steps
        assert len(out[side]["loss_point"]) == epochs
    # same weights, batches and draws: the first steps agree to rounding
    assert out["first_steps"] == FIRST_STEPS == 20
    for k, v in out["first_steps_max_rel_diff"].items():
        assert v < 1e-3, (k, v)
    assert out["rel_diff_lp_last5"] < 0.15, out["rel_diff_lp_last5"]
    assert out["rel_diff_ll_last5"] < 0.35, out["rel_diff_ll_last5"]
    cd_j, cd_t = out["pcfm"]["recon_cd"], out["pcfm_torch"]["recon_cd"]
    assert cd_j < 3.0 and cd_t < 3.0, (cd_j, cd_t)
    assert out["recon_cd_ratio"] < 2.5, (cd_j, cd_t)
    # both learned: the late losses lie below the first epoch's
    for side in ("pcfm", "pcfm_torch"):
        assert out[side]["lp_last5"] < out[side]["loss_point"][0]
