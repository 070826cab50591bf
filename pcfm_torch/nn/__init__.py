"""Building blocks: inits and norm layers matching the JAX package,
FiLMBlock, FiLM1d, SharedMLP, SE3d, PVConv."""
