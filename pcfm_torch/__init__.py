"""pcfm_torch — the PyTorch / CUDA port of pcfm for NVIDIA Hopper (H100).

The JAX package ``pcfm`` is the reference; this package mirrors its module
paths and names and is held against it by the ``tests/test_torch_port_*``
parity tests.  It imports ``torch`` and never ``jax``; the framework-free
``pcfm.config``, ``pcfm.data`` and ``pcfm.utils`` are shared.

Layout (ported so far: the ``mlp`` sampling and training paths):
  pcfm_torch.nn       inits, FiLMBlock
  pcfm_torch.models   timestep embedding, VelocityNet,
                      ConditionalLatentVelocityNet, ShapeEncoder
  pcfm_torch.ops      the fused FiLM-block CUDA kernels (forward and
                      backward) and their builder; plain-torch chamfer
  pcfm_torch.train    ModelBundle, optimizer and train state, train step,
                      loop, sample/recon functions, checkpoints, train CLI
  pcfm_torch.sample   priors, fixed-grid ODE integrators, sampling CLI
  pcfm_torch.interop  JAX param trees -> port state_dicts
"""

__version__ = "0.1.0"
