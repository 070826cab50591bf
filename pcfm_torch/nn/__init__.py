"""Building blocks: inits matching the JAX package, FiLMBlock."""
