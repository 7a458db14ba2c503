"""The hand-written kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest
"""

import pytest
import torch

from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops import fused_mlp
from sihl_tpu_torch.ops.fusion import fused_upsample_add, fused_upsample_add_reference
from sihl_tpu_torch.policy import compute_dtype_scope


def _random_mlp(out: int, gen: torch.Generator) -> MLP:
    """An MLP whose every bias and LayerNorm affine parameter is random, so
    that the kernel's reads of each (per layer) are checked."""
    mlp = MLP(256, [256] * 4 + [out], generator=gen)
    with torch.no_grad():
        for lin in mlp.linears:
            lin.bias.uniform_(-0.1, 0.1, generator=gen)
        for norm in mlp.norms:
            norm.weight.uniform_(0.8, 1.2, generator=gen)
            norm.bias.uniform_(-0.1, 0.1, generator=gen)
    return mlp.cuda().eval()


@pytest.mark.cuda
def test_fused_mlp_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    for tdt, atol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        with compute_dtype_scope(tdt):
            mlps = [_random_mlp(n, gen) for n in (1, 80, 4)]
        for m in (1, 64, 65, 333, 1600):
            x = torch.randn(m, 256, generator=gen).to("cuda", tdt)
            with torch.no_grad():
                got = fused_mlp.fused_mlps(x, mlps)
                ref = fused_mlp.fused_mlps_reference(x, mlps)
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=atol)


@pytest.mark.cuda
def test_upsample_add_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for h in (40, 20, 10, 3):
            top = torch.randn(2, 256, h, h + 1, generator=gen)
            lat = torch.randn(2, 256, 2 * h, 2 * h + 2, generator=gen)
            top, lat = (
                t.to("cuda", dt).contiguous(memory_format=torch.channels_last) for t in (top, lat)
            )
            got = fused_upsample_add(top, lat)
            assert torch.equal(got, fused_upsample_add_reference(top, lat))
