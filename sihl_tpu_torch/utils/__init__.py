"""Host-side utilities of the port (counterpart of ``sihl_tpu/utils``).

Ported so far: :mod:`~sihl_tpu_torch.utils.coco_map`, a copy of the JAX
package's numpy COCO mAP.
"""
