"""What holds P4, P5 and P2 (``ops/csrc/conv_probes.cu``) back on the card:
each kernel beside variants of itself, built from edited copies of its
source, and the card's own copy rate for the same bytes.

P4, ``matmul_stats`` at the probe's shape (409,600, 64) @ (64, 256):

  shipped       the source as it is
  no_stores     y never leaves shared memory (the TMA stores dropped): the
                loads, the products and the epilogue alone
  no_products   no wgmma (y is zeros): the loads, the epilogue and the stores
  ring8_bufs2   eight x stages and two y staging buffers, not four and four

P5, ``weight_grad_1x1`` at the probe's three shapes:

  shipped       clusters of four blocks, dW tiles of 128 ci rows where ci allows
  cluster2      clusters of two
  tiles64       dW tiles of 64 ci rows (the shipped build, launched so)

P2, ``conv3x3`` at the probe's shape (16, 160, 160, 64) by (3, 3, 64, 64):

  shipped       the source as it is
  no_stores     y never leaves shared memory: the halo loads, the products
                and the staging alone
  no_products   no wgmma (y is zeros): the loads, the staging and the stores
  ring2_bufs2   two halo stages and two staging buffers a warpgroup, not
                three and one

Beside them, PyTorch's copy of a tensor half the size of x and y together
(so as many bytes read and written as P4 moves) and its zeroing of a tensor
of y's size, and for P2 its copy of x (the bytes P2 must move): what the
card's own kernels reach on such bytes.  Every time is device time from a
CUDA graph of 20 calls.  The variants that still compute y or dW are
checked first: P4 and P2 bitwise against the shipped wrapper, P5 within
1e-5 of |x|^T |dy|.

Run on a CUDA card:  python -m sihl_tpu_torch.tools.probe_conv_variants
"""

from concurrent.futures import ThreadPoolExecutor

import torch

from sihl_tpu_torch.ops import conv_probes
from sihl_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR, cuda_library
from sihl_tpu_torch.tools.probe_timing import card_name, graph_ms, within_sum_order
from sihl_tpu_torch.tools.probe_wrt_filter import SHAPES

P4_STORE = "tma_store_rows(&y_map, buf, row0);"
P4_PRODUCT = ("wgmma<NC, 0, 1>(acc, sw128_desc(x_s + s * BOX + ks * 32, 16, 1024), "
              "sw128_desc(b_s + ks * 2048, BOX, 1024));")
P4_STAGES = "constexpr int STAGES = 4;                // x tiles in the ring"
P4_BUFS = "constexpr int Y_BUFS = 4;                // staging buffers"
P4_VARIANTS = {
    "shipped": [],
    "no_stores": [(P4_STORE, "(void)buf;")],
    "no_products": [(P4_PRODUCT, "(void)ks;")],
    "ring8_bufs2": [(P4_STAGES, P4_STAGES.replace("4;", "8;")), (P4_BUFS, P4_BUFS.replace("4;", "2;"))],
}
P5_CLUSTER = "constexpr int CL = 4;"
P5_VARIANTS = {"cluster2": [(P5_CLUSTER, "constexpr int CL = 2;")]}
P2_STORE = "tma_store_4d(&y_map, buf, 0, c0, r0, bi);"
P2_PRODUCT = ("wgmma_n64<0, 1>(acc[r], sw128_desc(halo + ((r + tap / 3) * HC + tap % 3) * 128 + ks * 32, 16, 1024),\n"
              "                          sw128_desc(w_s + tap * BOX + ks * 2048, BOX, 1024));")
P2_STAGES = "constexpr int STAGES = 3;                // halos in the ring"
P2_BUFS = "constexpr int Y_BUFS = 1;                // staging buffers of each warpgroup"
P2_VARIANTS = {
    "shipped": [],
    "no_stores": [(P2_STORE, "(void)c0;")],
    "no_products": [(P2_PRODUCT, "(void)halo;")],
    "ring2_bufs2": [(P2_STAGES, P2_STAGES.replace("3;", "2;")), (P2_BUFS, P2_BUFS.replace("1;", "2;"))],
}


def build(name: str, edits) -> object:
    """The library of conv_probes.cu with ``edits`` (text, replacement) made."""
    source = (CSRC_DIR / "conv_probes.cu").read_text()
    for old, new in edits:
        if old not in source:
            raise ValueError(f"variant {name}: {old!r} is not in conv_probes.cu")
        source = source.replace(old, new)
    path = BUILD_DIR / "variants" / name / "conv_probes.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return conv_probes.bind(cuda_library(f"conv_probes_{name}", path))


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream  # inside a graph, the capturing stream


def p4_times(name, lib, x, w, want) -> None:
    m = x.shape[0]
    blocks = {s: conv_probes.matmul_stats_blocks(m, lib.sihl_probe_matmul_resident(s)) for s in (0, 1)}
    y = torch.empty_like(want[0])
    scratch = torch.empty((max(blocks.values()) + 1) * 512, device="cuda")

    def call(stats):
        return lib.sihl_probe_matmul_stats(stats, x.data_ptr(), w.data_ptr(), m, y.data_ptr(), scratch.data_ptr(),
                                           scratch[blocks[stats] * 512:].data_ptr(), blocks[stats], stream())

    if call(1):
        raise RuntimeError(f"P4 {name}: launch failed")
    torch.cuda.synchronize()
    checked = ""
    if name not in ("no_stores", "no_products"):
        sums = scratch[blocks[1] * 512:][:512]
        if not (torch.equal(y, want[0]) and torch.equal(sums[:256], want[1]) and torch.equal(sums[256:], want[2])):
            raise AssertionError(f"P4 {name}: y or the sums differ from the shipped kernel's")
        checked = ", bitwise the shipped kernel's"
    print(f"  P4 {name:13s} alone {graph_ms(lambda: call(0)):.4f} ms, with the sums {graph_ms(lambda: call(1)):.4f} ms"
          f"{checked}", flush=True)


def p5_times(name, lib, x, dy, cluster, ti) -> None:
    m, ci = x.shape
    co = dy.shape[1]
    tiles = (ci // ti) * (co // conv_probes.P5_CO_STEP)
    groups = max(1, min(-(-m // (conv_probes.ROWS * cluster)), lib.sihl_probe_weight_grad_resident(ti) // tiles))
    splits = cluster * groups
    partials = torch.empty(groups * ci * co, device="cuda")
    dw = torch.empty(ci, co, device="cuda")

    def call(phases):
        return lib.sihl_probe_weight_grad(x.data_ptr(), dy.data_ptr(), m, ci, co, ti, splits, partials.data_ptr(),
                                          dw.data_ptr(), phases, stream())

    if call(3):
        raise RuntimeError(f"P5 {name}: launch failed")
    torch.cuda.synchronize()
    if not within_sum_order(dw, x.float().T @ dy.float(), x.float().abs().T @ dy.float().abs()):
        raise AssertionError(f"P5 {name}: dW is not within 1e-5 of |x|^T |dy|")
    print(f"  P5 {ci}x{co} {name:9s} alone {graph_ms(lambda: call(3)):.4f} ms (products "
          f"{graph_ms(lambda: call(1)):.4f}, partial sums {graph_ms(lambda: call(2)):.4f}; {splits} splits of "
          f"{tiles} tiles of {ti} ci rows)", flush=True)


def p2_times(name, lib, x, w, want) -> None:
    b, h, wd, _ = x.shape
    blocks = conv_probes.conv3x3_blocks(b, h, wd, lib.sihl_probe_conv3x3_resident())
    y = torch.empty_like(want)

    def call():
        return lib.sihl_probe_conv3x3(x.data_ptr(), w.data_ptr(), b, h, wd, y.data_ptr(), blocks, stream())

    if call():
        raise RuntimeError(f"P2 {name}: launch failed")
    torch.cuda.synchronize()
    checked = ""
    if name not in ("no_stores", "no_products"):
        if not torch.equal(y, want):
            raise AssertionError(f"P2 {name}: y differs from the shipped kernel's")
        checked = ", bitwise the shipped kernel's"
    print(f"  P2 {name:13s} alone {graph_ms(call):.4f} ms{checked}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_conv_variants: needs a CUDA card")
    print(f"probe_conv_variants: {card_name()}", flush=True)
    variants = {**{f"p4_{k}": v for k, v in P4_VARIANTS.items() if v}, **{f"p5_{k}": v for k, v in P5_VARIANTS.items()},
                **{f"p2_{k}": v for k, v in P2_VARIANTS.items() if v}}
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda kv: build(*kv), variants.items())))
    shipped = conv_probes._library()
    gen = torch.Generator("cuda").manual_seed(0)
    m = 16 * 160 * 160
    x = (torch.randn(m, 64, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
    w = (torch.randn(64, 256, device="cuda", generator=gen) * 0.05).to(torch.bfloat16)
    want = conv_probes.matmul_stats(x, w, stats=True)
    for name in P4_VARIANTS:
        p4_times(name, libs.get(f"p4_{name}", shipped), x, w, want)
    y = torch.empty_like(want[0])
    copy_src = torch.empty((x.numel() + y.numel()) // 2, dtype=torch.bfloat16, device="cuda")  # P4's bytes in all
    copy_dst = torch.empty_like(copy_src)
    t_copy, t_zero = graph_ms(lambda: copy_dst.copy_(copy_src)), graph_ms(lambda: y.zero_())
    print(f"  PyTorch's copy of {copy_src.numel() * 2 / 1e6:.1f} MB {t_copy:.4f} ms "
          f"({4 * copy_src.numel() / t_copy / 1e9:.3f} TB/s read and written); its zeroing of "
          f"{y.numel() * 2 / 1e6:.1f} MB {t_zero:.4f} ms ({2 * y.numel() / t_zero / 1e9:.3f} TB/s)", flush=True)
    for _, batch, side, ci, co in SHAPES:
        m = batch * side * side
        x = (torch.randn(m, ci, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
        dy = (torch.randn(m, co, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
        ti = 128 if ci % 128 == 0 else 64
        p5_times("shipped", shipped, x, dy, conv_probes.P5_CLUSTER, ti)
        p5_times("cluster2", libs["p5_cluster2"], x, dy, 2, ti)
        if ti == 128:
            p5_times("tiles64", shipped, x, dy, conv_probes.P5_CLUSTER, 64)

    x = (torch.randn(16, 160, 160, 64, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
    w = (torch.randn(3, 3, 64, 64, device="cuda", generator=gen) * 0.05).to(torch.bfloat16)
    want = conv_probes.conv3x3(x, w)
    for name in P2_VARIANTS:
        p2_times(name, libs.get(f"p2_{name}", shipped), x, w, want)
    copy_dst = torch.empty_like(x)
    t_copy = graph_ms(lambda: copy_dst.copy_(x))
    print(f"  PyTorch's copy of x ({x.numel() * 2 / 1e6:.1f} MB, the bytes P2 reads and writes) {t_copy:.4f} ms "
          f"({4 * x.numel() / t_copy / 1e9:.3f} TB/s read and written)", flush=True)


if __name__ == "__main__":
    main()
