"""Training of the port: model bundle and train state, train step, loop,
sample/recon functions, checkpoints, CLI."""
