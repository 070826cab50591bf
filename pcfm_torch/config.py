"""The port's configuration: the framework-free ``Config`` dataclass of
pcfm/config.py, shared rather than copied, so that both packages take the
same flags and read the same checkpoints' ``args``.  The port's other
modules import it from here."""
from pcfm.config import Config

__all__ = ["Config"]
