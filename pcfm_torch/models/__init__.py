"""Model zoo of the port (the ``mlp`` backbone so far)."""
from pcfm_torch.models.encoder import ShapeEncoder
from pcfm_torch.models.latent import ConditionalLatentVelocityNet
from pcfm_torch.models.velocity import VelocityNet

__all__ = ["ShapeEncoder", "ConditionalLatentVelocityNet", "VelocityNet"]
