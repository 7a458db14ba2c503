"""Training runtime of the port (counterpart of ``sihl_tpu/training``)."""

from sihl_tpu_torch.training.optim import make_optimizer
from sihl_tpu_torch.training.trainer import Trainer

__all__ = ["Trainer", "make_optimizer"]
