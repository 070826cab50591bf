"""Model zoo of the port: the ``mlp`` and ``hybrid`` backbones."""
from pcfm_torch.models.context import ContextNet
from pcfm_torch.models.encoder import ShapeEncoder
from pcfm_torch.models.hybrid import HybridMLP
from pcfm_torch.models.latent import ConditionalLatentVelocityNet
from pcfm_torch.models.velocity import VelocityNet, VelocityNetWithContext

__all__ = ["ContextNet", "ShapeEncoder", "HybridMLP",
           "ConditionalLatentVelocityNet", "VelocityNet",
           "VelocityNetWithContext"]
