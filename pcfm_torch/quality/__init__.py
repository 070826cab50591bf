"""The port's learning runs: the counterparts of the JAX package's
quality harnesses, each a CLI that runs on the card (``--device cpu``
asks for the CPU) and takes its JAX script's knobs as flags of the same
names, lower-cased, with the same defaults.

  * ``gen_quality`` (scripts/gen_quality_tpu.py): the hybrid at 2048 RGB
    points trained toward the MMD / COV / 1-NNA suite's targets;
  * ``convergence_full`` (scripts/convergence_full.py): the hybrid at the
    bench workload, 8 x 20 000 points, with its recon-CD trajectory;
  * ``distill_demo`` (scripts/distill_demo.py): a small mlp teacher,
    distilled 32 -> 16 -> 8 -> 4 Euler steps;
  * ``common``: what the three share (a device-resident synthetic split,
    batches gathered by index, the conditioned suite, atomic JSON).

    python -m pcfm_torch.quality.gen_quality --out /tmp/genq
"""
