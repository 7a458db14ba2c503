"""sihl_tpu_torch — the PyTorch port of ``sihl_tpu`` for one NVIDIA H100.

Same composition as the JAX package (``backbone -> (optional neck) ->
[head, ...]``) and the same public names, in PyTorch idiom: ``nn.Module``\\ s,
NCHW tensors in ``channels_last`` memory, an explicit ``torch.Generator``
for initialisation, and ``model.eval()`` for running-statistics BatchNorm.
The JAX package's Pallas kernels on the ported path are hand-written for
Hopper under ``sihl_tpu_torch/ops``; a CUDA tensor runs the kernel and a
CPU tensor its plain PyTorch version.
"""

from sihl_tpu_torch.backbones import _TIMM_ALIASES, Backbone, TimmBackbone, TorchvisionBackbone, backbone_names
from sihl_tpu_torch.model import SihlModel
from sihl_tpu_torch.policy import compute_dtype, set_compute_dtype

TORCHVISION_BACKBONE_NAMES = backbone_names()
TIMM_BACKBONE_NAMES = tuple(sorted(_TIMM_ALIASES))


def Trainer(*args, **kwargs):
    """Lazy alias for :class:`sihl_tpu_torch.training.Trainer`."""
    from sihl_tpu_torch.training import Trainer as _Trainer

    return _Trainer(*args, **kwargs)


__all__ = ["Backbone", "SihlModel", "TIMM_BACKBONE_NAMES", "TORCHVISION_BACKBONE_NAMES", "TimmBackbone",
           "TorchvisionBackbone", "Trainer", "backbone_names", "compute_dtype", "set_compute_dtype"]
