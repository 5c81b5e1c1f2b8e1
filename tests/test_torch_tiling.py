"""The kernels' work models (``repro_torch.kernels.tiling``): the
reference's FLOP counts, the bound rule of the per-kernel line of
``chip_smoke.py`` (PERF.md's kernel table, row 1), each model's FLOPs
against FlopCounterMode's count of the kernel's plain version where the
plain version computes the same products, and the byte counts against
hand counts at tiny shapes. Exact unless stated."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels import tiling as jtiling
from repro_torch.kernels import ref
from repro_torch.kernels import tiling
from torch_threads import one_thread  # noqa: F401 (autouse)


def flops_of(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


def test_decode_attention_flops_match_the_reference():
    lengths = [0, 1, 17, 64, 130, 257, 400, 511]
    assert tiling.decode_attention_flops(lengths, 16, 64) == \
        jtiling.decode_attention_flops(lengths, 16, 64)
    # and the decode model's FLOPs on the same slots
    assert tiling.decode_work(8, 16, 8, 64, 16, lengths, itemsize=4)[1] == \
        jtiling.decode_attention_flops(lengths, 16, 64)


@pytest.mark.parametrize("start,chunk", [(0, 64), (192, 64), (256, 50),
                                         (7, 1)])
def test_paged_prefill_flops_match_the_reference(start, chunk):
    want = jtiling.paged_prefill_flops(start, chunk, 16, 64)
    assert tiling.paged_prefill_flops(start, chunk, 16, 64) == want
    nb = -(-(start + chunk) // 16)
    tables = np.arange(nb).reshape(1, nb)
    assert tiling.prefill_work(1, chunk, 16, 8, 64, 16, nb, tables, [start],
                               [chunk], itemsize=4)[1] == want


def test_bound_reproduces_the_kernel_table_row_1():
    """Granite's 16 x 512 causal float32 flash forward: 0.0522 ms by the
    tensor-core (3xTF32) bound, 0.1285 ms by the CUDA-core one."""
    nbytes, flops = tiling.flash_work("fwd", 16, 512, 512, 16, 8, 64,
                                      causal=True, itemsize=4)
    bound, by, cc = tiling.bound_ms("flash_attention", nbytes, flops)
    assert (round(bound, 4), by, round(cc, 4)) == (0.0522, "operations",
                                                   0.1285)
    # bfloat16 reads the dense bf16 peak, with no CUDA-core bound
    bound16, _, cc16 = tiling.bound_ms("flash_attention", nbytes // 2,
                                       flops, "bfloat16")
    assert cc16 is None and bound16 < bound
    # a kernel outside TF32X3_KERNELS: bytes or FLOPs over the f32 rate
    b, by, cc = tiling.bound_ms("rwkv6", 3.35e9, 0)
    assert (b, by, cc) == (1.0, "bytes", None)


def _qkv(B, Sq, Skv, H, Kh, dh):
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return rnd(B, Sq, H, dh), rnd(B, Skv, Kh, dh), rnd(B, Skv, Kh, dh), \
        rnd(B, Sq, H, dh)


def test_flash_flops_equal_the_plain_versions_non_causal():
    """Without a mask the plain versions compute exactly the kernels'
    products: QK^T and PV forward; QK^T, dO V^T and dS K for dq; and
    dS^T Q, P^T dO besides for dk/dv."""
    B, Sq, Skv, H, Kh, dh = 2, 8, 12, 4, 2, 16
    q, k, v, do = _qkv(B, Sq, Skv, H, Kh, dh)
    o, lse = ref.flash_attention_ref(q, k, v, causal=False)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    work = lambda kind: tiling.flash_work(  # noqa: E731
        kind, B, Sq, Skv, H, Kh, dh, causal=False, itemsize=4)[1]
    assert work("fwd") == flops_of(ref.flash_attention_ref, q, k, v,
                                   causal=False)
    assert work("dq") == flops_of(ref.flash_attention_dq_ref, q, k, v, do,
                                  lse, delta, causal=False)
    assert work("dkv") == flops_of(ref.flash_attention_dkv_ref, q, k, v, do,
                                   lse, delta, causal=False)


def test_flash_causal_pairs_and_offsets():
    """The causal model counts each row's live keys: S (S + 1) / 2 from
    position 0, capped by kv_len past an offset; tensors give the same
    as ints."""
    assert tiling.flash_pairs(512, 512, causal=True) == 512 * 513 // 2
    for Sq, Skv, qo, kl in [(4, 9, 3, None), (4, 9, 3, 6), (7, 7, 0, 3),
                            (5, 5, 9, 0)]:
        kv = Skv if kl is None else kl
        want = sum(max(0, min(qo + i + 1, kv)) for i in range(Sq))
        assert tiling.flash_pairs(Sq, Skv, causal=True, q_offset=qo,
                                  kv_len=kl) == want
        assert int(tiling.flash_pairs(
            Sq, Skv, causal=True, q_offset=torch.tensor([qo]),
            kv_len=torch.tensor([kv], dtype=torch.int32))) == want


def test_flash_work_from_int32_device_scalars_does_not_wrap():
    """The wrappers pass q_offset and kv_len as int32 tensors: the ViT's
    non-causal step (104 x 196, 12 heads of 64) passes 2^31 FLOPs."""
    i32 = dict(dtype=torch.int32)
    for causal in (False, True):
        want = tiling.flash_work("fwd", 104, 196, 196, 12, 12, 64,
                                 causal=causal, itemsize=4)
        got = tiling.flash_work("fwd", 104, 196, 196, 12, 12, 64,
                                causal=causal, itemsize=4,
                                q_offset=torch.tensor([0], **i32),
                                kv_len=torch.tensor([196], **i32))
        assert want[1] > 2 ** 31 and (got[0], int(got[1])) == want


@pytest.mark.parametrize("gated", [True, False])
def test_expert_flops_equal_the_plain_versions(gated):
    """The expert FFN forward, dx and dW over a full buffer (every slot
    computed, as the kernels do)."""
    G, E, cap, d, f = 2, 3, 5, 8, 12
    g = torch.Generator().manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    xe, dy = rnd(G, E, cap, d), rnd(G, E, cap, d)
    wi, wo = rnd(E, d, f), rnd(E, f, d)
    wg = rnd(E, d, f) if gated else None
    work = lambda kind: tiling.expert_work(  # noqa: E731
        kind, G, E, cap, d, f, gated=gated, itemsize=4)[1]
    assert work("fwd") == flops_of(ref.expert_ffn_ref, xe, wi, wg, wo)
    assert work("dx") == flops_of(ref.expert_ffn_dx_ref, xe, wi, wg, wo, dy)
    _, da, dg, h = ref.expert_ffn_dx_ref(xe, wi, wg, wo, dy)
    assert work("dw") == flops_of(ref.expert_ffn_dw_ref, xe, dy, da, dg, h)


def test_byte_counts_by_hand():
    # decode: B 2, H 2, Kh 1, dh 4, blocks of 4, lengths 3 and 5, f32:
    # q + o 2*2*2*4*4, keys and values 2*8*1*4*4, lengths 2 + blocks 3.
    assert tiling.decode_work(2, 2, 1, 4, 4, [3, 5], itemsize=4) == (
        128 + 256 + 4 * 5, 4 * 2 * 4 * 8)
    # bf16 pools beside an f32 query
    assert tiling.decode_work(2, 2, 1, 4, 4, [3, 5], itemsize=4,
                              kv_itemsize=2)[0] == 128 + 128 + 20
    # prefill: 2 lanes of C 3 sharing block 5; lane 0 starts at 2 (block
    # 5 up to 4 keys, block 6 one), lane 1 at 0 with 2 rows (block 5: 2
    # keys): blocks {5: 4, 6: 1}; H 2, Kh 1, dh 4, f32.
    tables = [[5, 6, 7], [5, 9, 9]]
    nbytes, flops = tiling.prefill_work(2, 3, 2, 1, 4, 4, 10, tables,
                                        [2, 0], [3, 2], itemsize=4)
    assert nbytes == 2 * 2 * 3 * 2 * 4 * 4 + 2 * 5 * 1 * 4 * 4 + 4 * (2 + 4)
    assert flops == 4 * 2 * 4 * ((3 + 4 + 5) + (1 + 2))
    # grouped forward: G 1, M 48, d 2, f 3, E 4; 5 valid rows of 2
    # experts; gated bf16: rows 5*2, weights 2*3*2*3, out 48*2, sizes 4*4.
    sizes = torch.tensor([[3, 0, 2, 0]], dtype=torch.int32)
    rows, live = tiling.grouped_rows(sizes)
    assert (int(rows), int(live)) == (5, 2)
    assert tiling.grouped_work("fwd", 1, 48, 2, 3, 4, 5, 2, gated=True,
                               itemsize=2) == (
        (10 + 36 + 96) * 2 + 16, 6 * 5 * 2 * 3)
    assert tiling.grouped_work("dx", 1, 48, 2, 3, 4, 5, 2, gated=True,
                               itemsize=2)[0] == (20 + 36 + 96) * 2 \
        + 3 * 5 * 3 * 4
    assert tiling.grouped_work("dw", 1, 48, 2, 3, 4, 5, 2, gated=False,
                               itemsize=4) == (
        2 * 5 * 2 * 4 + (2 * 5 * 3 + 2 * 4 * 2 * 3) * 4, 4 * 5 * 2 * 3)
    # tensors in, tensors out (the card's path): the same values
    t = tiling.grouped_work("fwd", 1, 48, 2, 3, 4, rows, live, gated=True,
                            itemsize=2)
    assert tuple(map(int, t)) == ((10 + 36 + 96) * 2 + 16, 6 * 5 * 2 * 3)
    # expert dx: G 1, E 2, cap 3, d 4, f 5, ungated f32: x, dy, dx 3*6*4,
    # weights 2*2*4*5, da and h 2*6*5 in f32.
    assert tiling.expert_work("dx", 1, 2, 3, 4, 5, gated=False,
                              itemsize=4)[0] == (72 + 80) * 4 + 60 * 4
    # flash forward: B 1, S 2, H 2, Kh 1, dh 4, f32: q, o 16 each; k, v
    # 8 each; lse 4 (all f32).
    assert tiling.flash_work("fwd", 1, 2, 2, 2, 1, 4, causal=True,
                             itemsize=4) == ((32 + 16) * 4 + 16,
                                             4 * 4 * 2 * 3)
    # WKV: B 1, T 2, H 1, K 2, V 3, bf16 r/k/v/o, f32 w; state in and
    # out 1*1*2*3*4 each; u 1*2*4.
    assert tiling.wkv_work(1, 2, 1, 2, 3, itemsize=2, state_in=True) == (
        2 * ((4 + 6) * 2 + 8) + 48 + 8, 4 * 2 * 2 * 3)


def test_the_ports_byte_models_keep_the_reference_names():
    """The reference's TPU byte models under their names, counting the
    port's once-each bytes: never more than the TPU block walks'."""
    lengths = [3, 17, 64]
    got = tiling.paged_decode_fwd_bytes(lengths, 16, 8, 64, n_heads=16)
    assert got == tiling.decode_work(3, 16, 8, 64, 16, lengths, itemsize=4,
                                     kv_itemsize=2)[0]
    assert got <= jtiling.paged_decode_fwd_bytes(
        lengths, 16, 8, 64, n_heads=16) + 4 * (3 + 7)
    pre = tiling.paged_prefill_fwd_bytes(192, 64, 16, 8, 64, n_heads=16)
    assert pre == tiling.prefill_work(1, 64, 16, 8, 64, 16, 16,
                                      np.arange(16).reshape(1, 16), [192],
                                      [64], itemsize=4, kv_itemsize=2)[0]
    assert pre < jtiling.paged_prefill_fwd_bytes(192, 64, 32, 16, 8, 64,
                                                 n_heads=16)
    assert tiling.grouped_walk_fwd_bytes(100, 3, 1, 160, 4, 8, 16) == \
        tiling.grouped_work("fwd", 1, 160, 8, 16, 4, 100, 3, gated=True,
                            itemsize=2)[0]
