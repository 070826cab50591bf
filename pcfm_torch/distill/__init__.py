"""Progressive few-NFE distillation of the point flow (port of
pcfm/distill/) and its CLI."""
from pcfm_torch.distill.progressive import (DistillState, distill_pf,
                                            make_distill_step)

__all__ = ["DistillState", "distill_pf", "make_distill_step"]
