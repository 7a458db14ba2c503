"""Training runtime of the port (counterpart of ``sihl_tpu/training``)."""

from sihl_tpu_torch.training import metrics
from sihl_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from sihl_tpu_torch.training.optim import make_optimizer
from sihl_tpu_torch.training.trainer import Trainer

__all__ = ["Trainer", "make_optimizer", "metrics", "restore_checkpoint", "save_checkpoint"]
