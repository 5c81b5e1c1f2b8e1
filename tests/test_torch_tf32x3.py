"""Why the port's float32 tensor-core products are 3xTF32 (the split in
``src/repro_torch/kernels/csrc/mma_sm90.cuh``), shown on the CPU.

The card's ``cvt.rna.tf32.f32`` is done on the float32 bit pattern, as
the kernels do it with integer ops: the mantissa is rounded to 10 bits,
to nearest, ties away from zero. A tensor-core product of TF32 values is
exact and accumulated in float32, so the products are summed here in
float64. On seeded inputs at reduced
expert and attention shapes, one TF32 product misses the float32
tolerance that ``chip_smoke.py`` holds every kernel to, and the
three-product sum (small*big + big*small + big*big) stays well within
it: for the forwards' products, the expert dx and dW kernels', and the
flash backward's, whose dS tiles come from cancelling differences."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)
ATOL, RTOL = _smoke.TOL["float32"]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero: add half of the dropped 13 bits to the magnitude, then
    clear them (the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def three_products(a, b):
    """a b as the kernels take it: small*big + big*small + big*big."""
    (ab, as_), (bb, bs) = split(a), split(b)
    mm = lambda x, y: x.double() @ y.double()  # noqa: E731
    return mm(as_, bb) + mm(ab, bs) + mm(ab, bb)


def one_product(a, b):
    return tf32_rna(a).double() @ tf32_rna(b).double()


def limit_ratio(y, ref):
    """max |y - ref| / (ATOL + RTOL |ref|), y rounded to float32 first."""
    err = (y.float().double() - ref).abs()
    return float((err / (ATOL + RTOL * ref.abs())).max())


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0
    cases = {
        one + 2 ** -11: one + 2 ** -10,      # a tie rounds away from zero
        -(one + 2 ** -11): -(one + 2 ** -10),
        one + 2 ** -12: one,                 # below the tie: down
        one + 3 * 2 ** -12: one + 2 ** -10,  # above the tie: up
        2 - 2 ** -23: 2.0,                   # carries into the exponent
    }
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert not bool((tf32_rna(x).view(torch.int32) & 0x1FFF).any())


def test_split_keeps_float32_accuracy():
    x = torch.tensor(np.random.default_rng(0).normal(size=4096),
                     dtype=torch.float32)
    big, small = split(x)
    assert torch.equal(tf32_rna(big), big)
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
    assert float(((big.double() - x.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -12


def _backward_tiles(rng):
    """Reduced attention backward tiles, as the kernels hold them in
    float32: 512 query rows (256 positions x a GQA group of 2, granite's
    G; the kernels' dk/dv depth is 1,024 rows at S 512) against 256 keys,
    dh 64, p = softmax(q k^T / 8) and ds = p (dO v^T - delta) with delta
    = rowsum(p dO v^T) = rowsum(dO O): its cancellations are where the
    products lose digits."""
    q, k, v = (rng.normal(size=s) for s in ((512, 64), (256, 64), (256, 64)))
    do = rng.normal(size=(512, 64))
    s = q @ k.T / 8.0
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dp = do @ v.T
    ds = p * (dp - (p * dp).sum(-1, keepdims=True))
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return t(q), t(k), t(do), t(p), t(ds)


def _operands(case, rng):
    """Reduced shapes of the kernels' products: the expert FFN's x wi at
    depth d 768 (weights at fan-in scale); its dx kernel's dh = dy wo^T
    (depth d 768, wo at fan-in f 3,072) and da wi^T (depth f 3,072, da =
    gelu'(a) dh from a ~ N(0, 1) and dh ~ N(0, d / f), as x wi and dy
    wo^T give them); its dW kernel's x^T da and h^T dy over depth G *
    cap = 1,280 rows (the ViT's 5 groups of 256 slots; h = gelu(a)),
    scaled by 1 / sqrt(1,280) to entries of unit size as the other
    cases' are (the tolerance's atol is absolute); the flash forward's
    scaled
    scores Q K^T / 8 and its P V with P a softmax over 256 keys, dh 64;
    the flash backward's dQ = dS K / 8 (depth: the 256 keys), dK = dS^T
    Q / 8 and dV = P^T dO (depth: the 512 q rows of a kv head)."""
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    if case == "expert x wi":
        return (t(rng.normal(size=(64, 768))),
                t(rng.normal(size=(768, 256)) / 768 ** 0.5), 1.0)
    if case == "expert dy wo^T":
        return (t(rng.normal(size=(64, 768))),
                t(rng.normal(size=(256, 768)).T / 3072 ** 0.5), 1.0)
    if case == "expert da wi^T":
        a = t(rng.normal(size=(64, 3072)))
        dh = t(rng.normal(size=(64, 3072)) * 0.5)
        da = torch.ops.aten.gelu_backward(dh, a, approximate="tanh")
        return da, t(rng.normal(size=(256, 3072)).T / 768 ** 0.5), 1.0
    if case == "expert x^T da":
        x = t(rng.normal(size=(1280, 64)))
        a = t(rng.normal(size=(1280, 256)))
        dh = t(rng.normal(size=(1280, 256)) * 0.5)
        da = torch.ops.aten.gelu_backward(dh, a, approximate="tanh")
        return x.T.contiguous(), da, 1280 ** -0.5
    if case == "expert h^T dy":
        h = torch.nn.functional.gelu(t(rng.normal(size=(1280, 64))),
                                     approximate="tanh")
        return h.T.contiguous(), t(rng.normal(size=(1280, 256))), \
            1280 ** -0.5
    if case.startswith("attention d"):
        q, k, do, p, ds = _backward_tiles(rng)
        return {"attention dS K": (ds, k, 1 / 8),
                "attention dS^T Q": (ds.T.contiguous(), q, 1 / 8),
                "attention P^T dO": (p.T.contiguous(), do, 1.0)}[case]
    q, k = rng.normal(size=(128, 64)), rng.normal(size=(256, 64))
    if case == "attention scores":
        return t(q), t(k.T), 64 ** -0.5
    s = torch.tensor(q @ k.T / 8.0)
    return torch.softmax(s, -1).float(), t(rng.normal(size=(256, 64))), 1.0


@pytest.mark.parametrize("case", ["expert x wi", "expert dy wo^T",
                                  "expert da wi^T", "expert x^T da",
                                  "expert h^T dy", "attention scores",
                                  "attention P V", "attention dS K",
                                  "attention dS^T Q", "attention P^T dO"])
def test_three_tf32_products_hold_the_float32_tolerance(case):
    a, b, scale = _operands(case, np.random.default_rng(1))
    ref = (a.double() @ b.double()) * scale
    three = limit_ratio(three_products(a, b) * scale, ref)
    one = limit_ratio(one_product(a, b) * scale, ref)
    plain = limit_ratio((a @ b) * scale, ref)
    assert three < 0.05, three    # measured ~0.004
    assert one > 1.0, one         # one TF32 product misses the tolerance
    assert three <= 2 * plain + 0.01, (three, plain)  # as close as f32 FMAs


@pytest.mark.parametrize("case", ["expert x^T da", "expert h^T dy"])
def test_three_tf32_products_hold_dw_at_its_own_scale(case):
    """dW's two products unscaled, entries ~sqrt(1,280) as the kernel
    writes them at the ViT's depth: the three-product sum stays as close
    to the float64 product as plain f32 FMAs are."""
    a, b, _ = _operands(case, np.random.default_rng(1))
    ref = a.double() @ b.double()
    three = limit_ratio(three_products(a, b), ref)
    plain = limit_ratio(a @ b, ref)
    assert three <= 2 * plain + 0.01, (three, plain)


def slab_order(a, b, runs, slab=64, part=32):
    """a^T b as the grouped dW kernel sums it (csrc/grouped_mlp_bwd.cu):
    the depth rows of ``a`` (depth, M) and ``b`` (depth, N) come in runs
    (one a group), each padded to whole ``slab``-deep slabs with zero
    rows; every ``part``-deep part of a slab is three TF32 products
    summed from zero (exact products, rounded once to float32 here) and
    added to the float32 sums, part after part, run after run."""
    acc = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float32)
    r0 = 0
    for n in runs:
        pad = -(-n // slab) * slab
        za = torch.zeros(pad, a.shape[1])
        zb = torch.zeros(pad, b.shape[1])
        za[:n], zb[:n] = a[r0:r0 + n], b[r0:r0 + n]
        for k in range(0, pad, part):
            acc = acc + three_products(za[k:k + part].T.contiguous(),
                                       zb[k:k + part]).float()
        r0 += n
    return acc


@pytest.mark.parametrize("case", ["x^T da", "h^T dy"])
def test_three_tf32_slabs_hold_grouped_dw_over_two_groups(case):
    """The grouped dW's order over two groups' segments of one expert at
    granite's depth (250 + 254 valid rows, ~4 slabs each; d 1024 cut to
    128 columns, f 512 to 96), silu gated as granite runs it: the slab
    sums stay as close to the float64 product as one float32 product
    over the same rows, and within the float32 tolerance, which one TF32
    product misses."""
    rng = np.random.default_rng(4)
    runs, n = (250, 254), 504
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    a_pre, g = t(rng.normal(size=(n, 96))), t(rng.normal(size=(n, 96)))
    if case == "x^T da":
        dh = t(rng.normal(size=(n, 96)) * 0.5)
        da = torch.ops.aten.silu_backward(dh * g, a_pre)
        a, b = t(rng.normal(size=(n, 128))), da
    else:
        h = torch.nn.functional.silu(a_pre) * g
        a, b = h, t(rng.normal(size=(n, 128)))
    ref = a.double().T @ b.double()
    slabs = limit_ratio(slab_order(a, b, runs), ref)
    plain = limit_ratio(a.T @ b, ref)
    one = limit_ratio(one_product(a.T.contiguous(), b), ref)
    assert slabs <= 2 * plain + 0.01, (slabs, plain)  # measured ~0.02-0.04
    assert slabs < 0.05, slabs
    assert one > 1.0, one  # one TF32 product misses the tolerance
