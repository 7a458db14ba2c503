"""The fused-MLP wrapper's CPU-side pieces: the packed weight image the bf16
kernels copy into shared memory, the pack cache, the call checks, and the
autograd Function's routing of each gradient to its parameter (with the
kernels replaced by plain versions that read the same packs)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops import fused_mlp
from sihl_tpu_torch.policy import compute_dtype_scope

D = 256


def _mlp(out: int, seed: int, dtype=torch.float32, layers: int = 4) -> MLP:
    gen = torch.Generator().manual_seed(seed)
    with compute_dtype_scope(dtype):
        mlp = MLP(D, [D] * layers + [out], generator=gen, device="cpu")
    with torch.no_grad():
        for lin in mlp.linears:
            lin.bias.uniform_(-0.1, 0.1, generator=gen)
        for norm in mlp.norms:
            norm.weight.uniform_(0.8, 1.2, generator=gen)
            norm.bias.uniform_(-0.1, 0.1, generator=gen)
    return mlp


def _unpack_image(image: torch.Tensor, num_layers: int) -> np.ndarray:
    """(L, D, D) in the Linear layout from the flat image, by the layout's
    index formula: element (l, n, 64 kc + 8 u + e) is at
    (((l * 4 + kc) * 256 + n) * 8 + (u ^ (n % 8))) * 8 + e."""
    flat = image.float().numpy()
    l, n, col = np.meshgrid(np.arange(num_layers), np.arange(D), np.arange(D), indexing="ij")
    kc, u, e = col // 64, (col % 64) // 8, col % 8
    return flat[(((l * 4 + kc) * 256 + n) * 8 + (u ^ (n % 8))) * 8 + e]


@pytest.mark.parametrize("layers", [1, 4])
def test_packed_image_unpacks_to_the_linear_weights(layers):
    mlp = _mlp(5, seed=layers, dtype=torch.bfloat16, layers=layers)
    pack = fused_mlp.pack_mlp_params(mlp, torch.bfloat16)
    assert pack.w.dtype == torch.bfloat16 and pack.w.shape == (layers * D * D,) and pack.wt is None
    want = np.stack([lin.weight.detach().to(torch.bfloat16).float().numpy() for lin in list(mlp.linears)[:-1]])
    np.testing.assert_array_equal(_unpack_image(pack.w, layers), want)
    # each 32 KiB K-chunk is 256 rows of 128 bytes, every row a permutation of its own 64 columns
    chunk = pack.w.view(layers, 4, D, 64).float().numpy()
    for lyr in range(layers):
        for kc in range(4):
            np.testing.assert_array_equal(np.sort(chunk[lyr, kc], axis=1), np.sort(want[lyr][:, 64 * kc : 64 * kc + 64], axis=1))
    assert pack.wo.dtype == torch.bfloat16 and pack.wo.shape == (5, D)
    assert pack.bh.dtype == pack.sc.dtype == pack.bi.dtype == pack.bo.dtype == torch.float32


@pytest.mark.parametrize("n_out", [257, 600])
def test_wide_output_packs_after_the_hidden_layers(n_out):
    """An output layer wider than 256 follows the hidden layers in the bf16
    image: zero rows up to whole blocks of 256 outputs, each block laid out
    as a hidden layer."""
    mlp = _mlp(n_out, seed=n_out, dtype=torch.bfloat16, layers=2)
    pack = fused_mlp.pack_mlp_params(mlp, torch.bfloat16)
    blocks = -(-n_out // 256)
    assert pack.w.shape == ((2 + blocks) * D * D,) and pack.n_out == n_out
    hidden = np.stack([lin.weight.detach().to(torch.bfloat16).float().numpy() for lin in list(mlp.linears)[:-1]])
    unpacked = _unpack_image(pack.w, 2 + blocks)
    np.testing.assert_array_equal(unpacked[:2], hidden)
    wo = np.zeros((blocks * 256, D), np.float32)
    wo[:n_out] = mlp.linears[-1].weight.detach().to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(unpacked[2:].reshape(-1, D), wo)
    np.testing.assert_array_equal(fused_mlp.pack_output_image(mlp.linears[-1].weight.detach().to(torch.bfloat16))
                                  .float().numpy(), pack.w[2 * D * D :].float().numpy())


def test_f32_pack_holds_both_weight_layouts():
    mlp = _mlp(3, seed=1)
    pack = fused_mlp.pack_mlp_params(mlp, torch.float32)
    for lyr, lin in enumerate(list(mlp.linears)[:-1]):
        assert torch.equal(pack.wt[lyr], lin.weight) and torch.equal(pack.w[lyr], lin.weight.t())
    assert pack.w.is_contiguous() and pack.wt.is_contiguous()
    assert pack.num_layers == 4 and pack.n_out == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_cache_follows_parameter_updates(dtype):
    mlp = _mlp(4, seed=2, dtype=dtype)
    first = fused_mlp.pack_mlp_params(mlp, dtype)
    assert fused_mlp.pack_mlp_params(mlp, dtype) is first  # nothing changed: the same pack
    with torch.no_grad():
        mlp.norms[2].bias.add_(0.5)  # an in-place update, as an optimizer step makes
    second = fused_mlp.pack_mlp_params(mlp, dtype)
    assert second is not first
    assert torch.equal(second.bi[2], mlp.norms[2].bias.float()) and not torch.equal(second.bi[2], first.bi[2])
    with torch.no_grad():
        mlp.linears[0].weight.mul_(2.0)
    third = fused_mlp.pack_mlp_params(mlp, dtype)
    assert third is not second and not torch.equal(third.w, second.w)
    assert fused_mlp.pack_mlp_params(mlp, dtype) is third


def test_call_checks_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, D)
    with pytest.raises(ValueError, match="1 to 4 MLPs"):
        fused_mlp._check_supported(x, [_mlp(1, seed=s) for s in range(5)], width=D)
    with pytest.raises(ValueError, match="one depth"):
        fused_mlp._check_supported(x, [_mlp(1, seed=0), _mlp(1, seed=1, layers=3)], width=D)
    with pytest.raises(ValueError, match="at least 1 output"):
        fused_mlp._check_supported(x, [_mlp(0, seed=0)], width=D)
    wide = [_mlp(1, seed=0), _mlp(256, seed=1), _mlp(257, seed=2), _mlp(4420, seed=3)]
    assert fused_mlp._check_supported(x, wide, width=D) == torch.float32


def _chain_from_pack(x, pk):
    """The MLP from its f32 pack, as plain tensor code."""
    h = x
    for lyr in range(pk.num_layers):
        y = h @ pk.w[lyr] + pk.bh[lyr]
        h = F.silu(F.layer_norm(y, (D,), pk.sc[lyr], pk.bi[lyr], 1e-5))
    return h @ pk.wo.t() + pk.bo


def _plain_forward(x, packs, stash=None):
    return [_chain_from_pack(x, pk) for pk in packs]


def _plain_backward(x, packs, gs, stash=None):
    """What fused_mlps_backward returns, by autograd of the chain over the packs."""
    with torch.enable_grad():  # a Function's backward runs with gradients off
        x = x.detach().requires_grad_(True)
        leaves = [[t.detach().requires_grad_(True) for t in (pk.w, pk.bh, pk.sc, pk.bi, pk.wo, pk.bo)] for pk in packs]
        outs = [_chain_from_pack(x, fused_mlp.MLPPack(w, None, *rest)) for w, *rest in leaves]
        flat = [t for group in leaves for t in group]
        dx, *grads = torch.autograd.grad(outs, [x] + flat, gs)
    out = []
    for i in range(len(packs)):
        dw, dbh, dsc, dbi, dwo, dbo = grads[6 * i : 6 * i + 6]
        out += [dw.transpose(1, 2), dbh, dsc, dbi, dwo, dbo]  # dwh in the Linear layout, as the kernel writes it
    return dx, out


def test_function_routes_every_gradient_to_its_parameter(monkeypatch):
    """The Function's inputs are the MLPs' own parameters; with the kernels
    replaced by plain versions over the same f32 packs, every parameter's
    gradient and dx match autograd of the module chain."""
    monkeypatch.setattr(fused_mlp, "_forward_cuda", _plain_forward)
    monkeypatch.setattr(fused_mlp, "fused_mlps_backward", _plain_backward)
    mlps = [_mlp(n, seed=10 + n) for n in (80, 4)]
    rng = np.random.RandomState(0)
    x_np = rng.randn(70, D).astype(np.float32)
    weights = [torch.from_numpy(rng.randn(70, n).astype(np.float32)) for n in (80, 4)]

    def grads(run):
        x = torch.from_numpy(x_np).requires_grad_(True)
        for p in (p for m in mlps for p in m.parameters()):
            p.grad = None
        loss = sum((o * w).sum() for o, w in zip(run(x), weights))
        loss.backward()
        return [x.grad] + [p.grad for m in mlps for p in m.parameters()]

    params = [p for m in mlps for p in fused_mlp.mlp_parameters(m)]
    got = grads(lambda x: fused_mlp._FusedMLPs.apply(x, tuple(mlps), torch.float32, True, *params))
    want = grads(lambda x: fused_mlp.fused_mlps_reference(x, mlps))
    assert len(got) == len(want) == 1 + sum(len(list(m.parameters())) for m in mlps)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
