"""scripts/jax_run_to_torch.py on a JAX ``hybrid`` run, each optimizer
layout: tests/test_torch_port_jax_run.py's checks (the converted run's
clouds on JAX's priors, its next train step against JAX's next step
within 2e-3 x lr, the zeroed-moment control beyond it), in a file of
their own for the time of JAX's hybrid compiles."""
import pytest

pytest.importorskip("torch")

from tests.test_torch_port_jax_run import (  # noqa: E402
    converted_run_samples_and_steps_as_jax)


@pytest.mark.parametrize("flat", [True, False])
def test_converted_hybrid_run_samples_and_steps_as_jax(flat, tmp_path,
                                                       monkeypatch):
    converted_run_samples_and_steps_as_jax("hybrid", flat, tmp_path,
                                           monkeypatch)
