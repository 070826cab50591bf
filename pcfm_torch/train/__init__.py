"""Model bundle, sample/recon functions and checkpoints of the port."""
