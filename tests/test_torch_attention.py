"""Port parity: attention of ``repro_torch`` against the JAX package —
the row/decode cache writes, the plain decode and prefill attention
against JAX ``ops.*`` on "xla" and "pallas" (interpret mode), the plain
flash forward and backward against the Pallas kernels (interpret mode),
the differentiable ``ops.flash_attention`` against ``jax.grad``, the
O(S^2) oracle ``reference_attention``, and ``attention_apply`` in mixed,
decode-only and dense training mode. All
in float32 at atol 1e-5 (bf16 pools: both sides read the same bf16
values and accumulate in f32). The CUDA kernels are held against the plain
versions on the card in ``test_torch_kernels.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import param as jpm
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models.convert import from_jax_values
from torch_threads import one_thread  # noqa: F401 (autouse)

BS = 8
ATOL = 1e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _pools(rng, P, Kh, dh, bf16=False):
    kp = rng.normal(size=(P, BS, Kh, dh)).astype(np.float32)
    vp = rng.normal(size=(P, BS, Kh, dh)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, None)
    return ((jnp.asarray(kp, jd), jnp.asarray(vp, jd)),
            (_t(kp, td), _t(vp, td)))


def _decode_case(B, H, Kh, dh, nb, lengths, *, seed=0, bf16=False):
    rng = np.random.default_rng(seed)
    P = 1 + B * nb
    (jk, jv), (tk, tv) = _pools(rng, P, Kh, dh, bf16)
    q = rng.normal(size=(B, 1, H, dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P)).reshape(B, nb).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    jax_args = (jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(ln))
    return jax_args, (_t(q), tk, tv, _t(bt), _t(ln))


def _prefill_case(NC, C, H, Kh, dh, nb, starts, lens, *, seed=0,
                  bf16=False):
    rng = np.random.default_rng(seed)
    P = 1 + NC * nb
    (jk, jv), (tk, tv) = _pools(rng, P, Kh, dh, bf16)
    q = rng.normal(size=(NC, C, H, dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P)).reshape(NC, nb).astype(np.int32)
    st = np.asarray(starts, np.int32)
    ln = np.asarray(lens, np.int32)
    jax_args = (jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(st),
                jnp.asarray(ln))
    return jax_args, (_t(q), tk, tv, _t(bt), _t(st), _t(ln))


def _close(torch_out, jax_out):
    np.testing.assert_allclose(
        torch_out.float().numpy(), np.asarray(jax_out, np.float32),
        atol=ATOL, rtol=ATOL,
    )


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------


def test_row_write_matches_jax_incl_dead_rows_and_clamp():
    rng = np.random.default_rng(0)
    P, Kh, dh, nb, R = 7, 2, 4, 3, 9
    pool = rng.normal(size=(P, BS, Kh, dh)).astype(np.float32)
    kv = rng.normal(size=(R, 1, Kh, dh)).astype(np.float32)
    # live rows land in distinct blocks; row 8 runs past its table
    # (clamped) and rows 2, 5 and 8 are dead.
    tables = (np.arange(R * nb).reshape(R, nb) % (P - 1) + 1).astype(np.int32)
    positions = np.array([0, 7, 8, 15, 23, 3, 9, 16, 40], np.int32)
    live = np.array([1, 1, 0, 1, 1, 0, 1, 1, 0], bool)
    want = jattn.paged_row_write(jnp.asarray(pool), jnp.asarray(kv),
                                 jnp.asarray(tables), jnp.asarray(positions),
                                 jnp.asarray(live))
    got = _t(pool)
    out = tattn.paged_row_write(got, _t(kv), _t(tables), _t(positions),
                                _t(live))
    assert out is got  # in place
    want = np.asarray(want)
    # trash block 0 takes colliding dead-row writes in any order: it is
    # never read; every other block must match exactly.
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


def test_decode_write_matches_jax():
    rng = np.random.default_rng(1)
    P, Kh, dh, nb, B = 9, 2, 4, 4, 3
    pool = rng.normal(size=(P, BS, Kh, dh)).astype(np.float32)
    kv = rng.normal(size=(B, 1, Kh, dh)).astype(np.float32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    lengths = np.array([9, 31, 0], np.int32)
    want = jattn.paged_decode_write(jnp.asarray(pool), jnp.asarray(kv),
                                    jnp.asarray(tables),
                                    jnp.asarray(lengths))
    got = _t(pool)
    tattn.paged_decode_write(got, _t(kv), _t(tables), _t(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# decode attention (plain version) against JAX xla and pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("H,Kh", [(4, 4), (4, 2), (8, 2), (8, 1)])
def test_decode_matches_jax_gqa(H, Kh, impl):
    ja, ta = _decode_case(3, H, Kh, 16, 4, [5, 17, 32], seed=H * 10 + Kh)
    _close(ops.decode_attention(*ta), jops.decode_attention(
        *ja, implementation=impl))


@pytest.mark.parametrize("lengths", [[1, BS - 1, BS], [BS + 1, 2 * BS, 3 * BS - 1]])
def test_decode_block_boundaries(lengths):
    ja, ta = _decode_case(3, 4, 2, 16, 3, lengths, seed=sum(lengths))
    _close(ops.decode_attention(*ta),
           jops.decode_attention(*ja, implementation="pallas"))


def test_decode_free_slot_exact_zero_and_bf16_pools():
    ja, ta = _decode_case(3, 4, 2, 16, 4, [0, 12, 29], seed=5, bf16=True)
    y = ops.decode_attention(*ta)
    assert torch.equal(y[0], torch.zeros_like(y[0]))
    for impl in ("xla", "pallas"):
        _close(y, jops.decode_attention(*ja, implementation=impl))


# ---------------------------------------------------------------------------
# prefill attention (plain version) against JAX xla and pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("H,Kh", [(4, 4), (4, 2), (8, 1)])
def test_prefill_matches_jax_gqa(H, Kh, impl):
    ja, ta = _prefill_case(3, 8, H, Kh, 16, 4, [0, 5, 17], [8, 8, 8],
                           seed=H * 10 + Kh)
    _close(ops.prefill_attention(*ta),
           jops.prefill_attention(*ja, implementation=impl))


@pytest.mark.parametrize(
    "start,ln", [(0, 1), (BS - 1, 8), (BS, 8), (2 * BS - 3, 8), (3, 6)]
)
def test_prefill_chunk_crossing_block_boundaries(start, ln):
    ja, ta = _prefill_case(1, 8, 4, 2, 16, 4, [start], [ln],
                           seed=start * 10 + ln)
    _close(ops.prefill_attention(*ta),
           jops.prefill_attention(*ja, implementation="pallas"))


def test_prefill_dead_lane_and_padded_rows_exact_zero_bf16():
    ja, ta = _prefill_case(2, 8, 4, 2, 16, 3, [3, 0], [5, 0], seed=9,
                           bf16=True)
    y = ops.prefill_attention(*ta)
    assert torch.equal(y[0, 5:], torch.zeros_like(y[0, 5:]))
    assert torch.equal(y[1], torch.zeros_like(y[1]))
    for impl in ("xla", "pallas"):
        _close(y, jops.prefill_attention(*ja, implementation=impl))


def test_cuda_implementation_on_cpu_raises():
    _, ta = _decode_case(1, 4, 2, 16, 2, [3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.decode_attention(*ta, implementation="cuda")



@pytest.mark.parametrize("arch", ["qwen2.5-14b", "yi-9b"])
def test_decode_kernel_takes_reference_head_shapes(arch):
    """The decode kernel's wrapper takes the full-size heads of these
    reference configs (GQA groups 5 and 8 at head_dim 128, G * dh 640 and
    1,024): on CPU tensors its shape checks pass and the CUDA check is
    the one that raises. A group past 64 is refused by shape."""
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_cuda,
    )

    cfg = jax_config(arch)
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pool = torch.zeros(3, BS, Kh, dh)
    tables = torch.ones(2, 1, dtype=torch.int32)
    lengths = torch.tensor([0, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode_attention_cuda(torch.zeros(2, H, dh), pool, pool,
                                    tables, lengths)
    with pytest.raises(ValueError, match="GQA group"):
        paged_decode_attention_cuda(torch.zeros(2, 65 * Kh, dh), pool, pool,
                                    tables, lengths)

# ---------------------------------------------------------------------------
# attention_apply, mixed and decode-only
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    jcfg = jax_reduced("granite-moe-1b-a400m")
    p = jattn.attention_init(jax.random.PRNGKey(3), jcfg)
    vals, _ = jpm.split(p)
    tvals = from_jax_values(jax.tree.map(np.asarray, vals))
    return jcfg, get_reduced("granite-moe-1b-a400m"), vals, tvals


def test_attention_apply_mixed_matches_jax(layer):
    jcfg, cfg, vals, tvals = layer
    rng = np.random.default_rng(4)
    B, NC, C, nb = 3, 2, 8, 4
    P = 1 + (B + 1) * nb
    Kh, dh = cfg.n_kv_heads, cfg.head_dim
    kp = rng.normal(size=(P, BS, Kh, dh)).astype(np.float32)
    vp = rng.normal(size=(P, BS, Kh, dh)).astype(np.float32)
    tabs = np.arange(1, P).reshape(B + 1, nb).astype(np.int32)
    dec_len = np.array([5, 0, 17], np.int32)
    dec_tab = tabs[:B] * (dec_len > 0)[:, None]
    # two lanes of one request (the second attends the first's writes)
    ctab = np.repeat(tabs[B:], NC, axis=0)
    cstart = np.array([0, C], np.int32)
    clen = np.array([C, 5], np.int32)
    positions = np.concatenate(
        [dec_len, (cstart[:, None] + np.arange(C)).reshape(-1)]
    ).astype(np.int32)
    rows = np.concatenate([dec_tab, np.repeat(ctab, C, axis=0)])
    x = rng.normal(size=(B + NC * C, 1, cfg.d_model)).astype(np.float32)
    jy, jc = jattn.attention_apply(
        vals, jnp.asarray(x), jcfg, cache={"k": jnp.asarray(kp),
                                           "v": jnp.asarray(vp)},
        cache_index=jnp.asarray(positions), block_tables=jnp.asarray(rows),
        mixed=jattn.MixedMeta(num_decode=B, num_chunks=NC, chunk_tokens=C,
                              chunk_lens=jnp.asarray(clen)),
        implementation="xla",
    )
    tc = {"k": _t(kp), "v": _t(vp)}
    ty, tc = tattn.attention_apply(
        tvals, _t(x), cfg, cache=tc, cache_index=_t(positions),
        block_tables=_t(rows),
        mixed=tattn.MixedMeta(num_decode=B, num_chunks=NC, chunk_tokens=C,
                              chunk_lens=_t(clen)),
    )
    _close(ty, jy)
    for n in ("k", "v"):
        _close(tc[n][1:], jc[n][1:])


def test_attention_apply_decode_only_matches_jax(layer):
    jcfg, cfg, vals, tvals = layer
    rng = np.random.default_rng(6)
    B, nb = 3, 3
    P = 1 + B * nb
    Kh, dh = cfg.n_kv_heads, cfg.head_dim
    kp = rng.normal(size=(P, BS, Kh, dh)).astype(np.float32)
    vp = rng.normal(size=(P, BS, Kh, dh)).astype(np.float32)
    lengths = np.array([4, 0, 16], np.int32)
    tabs = np.arange(1, P).reshape(B, nb).astype(np.int32)
    tabs = tabs * (lengths > 0)[:, None]
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jy, jc = jattn.attention_apply(
        vals, jnp.asarray(x), jcfg,
        cache={"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        cache_index=jnp.asarray(lengths), block_tables=jnp.asarray(tabs),
        implementation="xla",
    )
    tc = {"k": _t(kp), "v": _t(vp)}
    ty, tc = tattn.attention_apply(tvals, _t(x), cfg, cache=tc,
                                   cache_index=_t(lengths),
                                   block_tables=_t(tabs))
    _close(ty, jy)
    for n in ("k", "v"):
        _close(tc[n][1:], jc[n][1:])


# ---------------------------------------------------------------------------
# dense flash attention (training): forward, backward, autograd
# ---------------------------------------------------------------------------
# (B, Sq, Skv, H, Kh, dh, causal, q_offset, kv_len)
FLASH_CASES = [
    (2, 12, 12, 4, 2, 16, True, 0, None),      # training: causal GQA
    (1, 9, 20, 8, 2, 8, True, 7, 15),          # offset queries, kv_len
    (2, 10, 14, 4, 4, 8, False, 0, 11),        # non-causal, kv_len mask
    (1, 8, 16, 4, 1, 8, True, -3, 16),         # rows 0-2: no valid key
]


def _flash_case(case, seed=0):
    B, Sq, Skv, H, Kh, dh = case[:6]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(B, Sq, H, dh), f(B, Skv, Kh, dh), f(B, Skv, Kh, dh), \
        f(B, Sq, H, dh)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_plain_matches_pallas(case):
    from repro_torch.kernels import ref

    *_, causal, qoff, kvlen = case
    q, k, v, _ = _flash_case(case)
    jo, jlse = jfa.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=qoff, kv_len=kvlen, interpret=True, return_residuals=True)
    to, tlse = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                       q_offset=qoff, kv_len=kvlen)
    _close(to, jo)
    jlse = np.asarray(jlse)[..., :q.shape[1]]
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=ATOL, rtol=ATOL)
    if qoff < 0:
        # A row with no valid key: exact zeros and lse = +inf.
        assert np.isinf(tlse.numpy()[..., :-qoff]).all()
        assert not to[:, :-qoff].any()


@pytest.mark.parametrize("case", FLASH_CASES[:3])
def test_reference_attention_matches_jax_and_the_plain_flash(case):
    """``attention.reference_attention``, the O(S^2) oracle, against the
    reference's and against the plain flash version, on the cases where
    every row has a valid key (the oracle's softmax over no key is NaN,
    as the reference's)."""
    from repro_torch.kernels import ref

    *_, causal, qoff, kvlen = case
    q, k, v, _ = _flash_case(case, seed=3)
    kw = dict(causal=causal, q_offset=qoff, kv_len=kvlen)
    got = tattn.reference_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), **kw))
    plain, _ = ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_plain_matches_pallas(case):
    from repro_torch.kernels import ref

    *_, causal, qoff, kvlen = case
    q, k, v, do = _flash_case(case, seed=1)
    kw = dict(causal=causal, q_offset=qoff, kv_len=kvlen)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa.flash_attention_pallas(jq, jk, jv, interpret=True,
                                          return_residuals=True, **kw)
    jgrads = jfa._flash_attention_pallas_bwd(
        jq, jk, jv, jo, jlse, jdo, qoff,
        k.shape[1] if kvlen is None else kvlen,
        causal=causal, bq=None, bk=None, interpret=True)
    to, tlse = ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw)
    tgrads = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), to, tlse,
                                         _t(do), **kw)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", FLASH_CASES[:2])
def test_flash_autograd_matches_jax_grad(case):
    *_, causal, qoff, kvlen = case
    q, k, v, w = _flash_case(case, seed=2)
    kw = dict(causal=causal, q_offset=qoff, kv_len=kvlen)

    def jloss(q, k, v):
        o = jops.flash_attention(q, k, v, implementation="pallas", **kw)
        return jnp.sum(o * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    o = ops.flash_attention(*xs, **kw)
    tg = torch.autograd.grad((o * _t(w)).sum(), xs)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=ATOL)


def test_attention_apply_dense_matches_jax(layer):
    jcfg, cfg, vals, tvals = layer
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    jy, _ = jattn.attention_apply(vals, jnp.asarray(x), jcfg,
                                  implementation="xla")
    ty, cache = tattn.attention_apply(tvals, _t(x), cfg)
    assert cache is None
    _close(ty, jy)
