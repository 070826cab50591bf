"""pcfm_torch — the PyTorch / CUDA port of pcfm for NVIDIA Hopper (H100).

The JAX package ``pcfm`` is the reference; this package mirrors its module
paths and names and is held against it by the ``tests/test_torch_port_*``
parity tests.  It imports ``torch`` and never ``jax``, and nothing of
``pcfm``: the framework-free ``Config``, data layer and runtime helpers are
copied here (``pcfm_torch.config``, ``pcfm_torch.data``,
``pcfm_torch.utils``).  Entry points run on the card unless the caller
asks for the CPU (``pcfm_torch.device``).

Layout (the ``mlp`` and ``hybrid`` sampling, training and distillation
paths, with every train-step option and data and point-axis parallel
training, evaluation, checkpoint import, the FLOP counter and the input
pipeline from dataset generation to the loaders):
  pcfm_torch.nn       inits, FiLMBlock, FiLM1d, GroupNorm / BatchNorm,
                      SharedMLP, SE3d, PVConv
  pcfm_torch.models   timestep embedding, VelocityNet(WithContext),
                      ConditionalLatentVelocityNet, ShapeEncoder,
                      ContextNet, HybridMLP, CondAdversary
  pcfm_torch.ops      the CUDA kernels (fused FiLM block forward and
                      backward, voxel gather and scatter) and their
                      builder; voxel coordinate math; plain-torch chamfer
  pcfm_torch.train    ModelBundle, optimizer and train state, train step,
                      loop, sample/recon functions, checkpoints, train CLI
  pcfm_torch.sample   priors, fixed-grid ODE integrators, sampling CLI
  pcfm_torch.distill  progressive few-NFE distillation, distill CLI
  pcfm_torch.eval     CD / EMD / F-score, the generative suite, eval CLI
  pcfm_torch.parallel process group, (data, points) grid, differentiable
                      collectives, the voxel ops over split clouds
  pcfm_torch.data     datasets, host loaders (threads; worker processes
                      for ``--loader_backend grain``), PLY IO, the PLY ->
                      H5 packer (``python -m pcfm_torch.data.pack_h5``)
  pcfm_torch.native   the C++ ASCII-PLY parser and subsample-gather (host
                      code, built with g++ at first use)
  pcfm_torch.datagen  URDF -> posed coloured PLY dataset generation
                      (``python -m pcfm_torch.datagen.cli``)
  pcfm_torch.utils    runtime helpers, the model-FLOP counter and MFU
  pcfm_torch.interop  JAX param trees -> port state_dicts; reference
                      checkpoints -> port runs (``python -m
                      pcfm_torch.interop``)
"""

__version__ = "0.1.0"
