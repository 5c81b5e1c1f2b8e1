"""The dry run's memory analysis (``launch/memory.py``, ``launch/dryrun.
rank_memory``): the live-bytes tracker against hand counts, the meta
device against the CPU, the fake-group rank step against real gloo
ranks, the output bytes against the reference's step, the kernels'
shape-only routes against their CUDA wrappers' allocations, and the
record ``run_cell`` writes. Bytes are exact throughout: a count is the
tracker's (each storage rounded up to 512 B), the arguments and outputs
exact bytes.
"""
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import checkpoint, noop_context_fn

import repro.configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import model_zoo as jzoo
from repro.optim import adafactor as jadafactor
from repro.optim import inverse_sqrt as jinverse_sqrt
from repro.sharding import spec_for as jspec_for
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import init_train_state as jinit_train_state
from repro.training.train_loop import make_train_step as jmake_train_step
from repro.training.train_loop import state_axes as jstate_axes
from repro_torch.configs import ShapeCfg, get_reduced
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import expert_mlp as em
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_mlp as gm
from repro_torch.kernels import paged_prefill as pp
from repro_torch.launch import dryrun
from repro_torch.launch.memory import measure
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.models import model_zoo as zoo
from repro_torch.models.stack import REMAT, _remat_context
from repro_torch.optim import adafactor, constant
import torch_mesh_steps as ms
from torch_threads import one_thread  # noqa: F401 (autouse)

KB = 1024
GRANITE = "granite-moe-1b-a400m"


# ---------------------------------------------------------------------------
# the tracker against hand counts
# ---------------------------------------------------------------------------

def _layer(x, w1, w2):
    return torch.relu(x @ w1) @ w2


def _mlp_step(remat):
    """Two layers of relu(x w1) w2, forward and backward to the weights'
    gradients, each layer under ``torch.utils.checkpoint`` with
    ``models/stack``'s policy unless ``remat`` is "none"."""
    def step(ws, x):
        with torch.enable_grad():
            for w in ws:
                w.requires_grad_(True)
            for w1, w2 in zip(ws[::2], ws[1::2]):
                if remat == "none":
                    x = _layer(x, w1, w2)
                else:
                    x = checkpoint(_layer, x, w1, w2, use_reentrant=False,
                                   context_fn=_remat_context(remat)
                                   or noop_context_fn)
            grads = torch.autograd.grad(x.sum(), ws)
        for w in ws:
            w.requires_grad_(False)
        return grads
    return step


# x (256, 32), w1 (32, 512), w2 (512, 32), float32: the arguments are 32
# KiB of x and 4 weights of 64 KiB; a hidden (256, 512) is 512 KiB, a
# layer's output (256, 32) 32 KiB, the loss and the backward's seed 512
# B each (one allocator block).
ARGS = 32 * KB + 4 * 64 * KB
HIDDEN, ROWS, SCALAR, W = 512 * KB, 32 * KB, 512, 64 * KB
MLP_PEAK = {
    # At layer 2's relu backward: layer 1's hidden (saved by its relu)
    # and output (saved by layer 2's first product); layer 2's hidden
    # (saved), output, the loss, the seed, layer 2's w2 gradient, the
    # hidden's gradient and the relu backward's output.
    "none": ARGS + 4 * HIDDEN + 2 * ROWS + 2 * SCALAR + W,
    # At layer 1's relu backward: layer 1 recomputed (its product freed,
    # its hidden held), layer 2's output, the loss, the seed, three
    # weight gradients, the hidden's gradient and the relu backward's
    # output; layer 1's output, the checkpoint's only save, is gone.
    "full": ARGS + 3 * HIDDEN + ROWS + 2 * SCALAR + 3 * W,
    # At layer 2's relu backward: layer 1's first product (saved by the
    # policy), layer 1's output, layer 2's output, the loss, the seed,
    # layer 2's relu recomputed from its saved product, its w2 gradient,
    # the hidden's gradient and the relu backward's output.
    "dots": ARGS + 4 * HIDDEN + 2 * ROWS + 2 * SCALAR + W,
}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_mlp_forward_and_backward_hand_count(remat):
    """The peak and output bytes of the two-layer MLP's step equal the
    hand count, with no remat, under the full policy and under the
    selective "dots" (the recompute's allocations seen by the tracker:
    the full policy's peak is a hidden and a layer's rows lower)."""
    ws = [torch.zeros(32, 512), torch.zeros(512, 32)] * 2
    ws = [w.clone() for w in ws]
    x = torch.zeros(256, 32)
    grads, rep = measure(_mlp_step(remat), ws, x)
    assert rep["argument_bytes"] == ARGS
    assert rep["output_bytes"] == 4 * W
    assert rep["peak_bytes"] == MLP_PEAK[remat]
    assert rep["total_bytes"] == rep["peak_bytes"] == (
        rep["argument_bytes"] + rep["temp_bytes"] + rep["output_bytes"])
    assert [tuple(g.shape) for g in grads] == [(32, 512), (512, 32)] * 2


def test_adafactor_update_hand_count():
    """Adafactor's update of an MLP's two weights (64, 128) and (128,
    32), both unfactored (a dim below 128): the peak sits at the first
    weight's update (32 KiB a buffer): the arguments (the gradients, the
    slots, the weights and the int32 step), the new step, beta2 and the
    learning rate (512 B each); that weight's g^2 + eps, its new slot,
    its clipped update and the scaled update (4 x 32 KiB); the update's
    RMS, the weight's RMS, the scale and its negation (4 x 512 B). The
    outputs: both updates and both slots, and the 4-byte step."""
    opt = adafactor(constant(1e-2))
    params = {"w1": torch.zeros(64, 128), "w2": torch.zeros(128, 32)}
    state = opt.init(params)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    _, rep = measure(lambda g, s, p: opt.update(g, s, p), grads, state,
                     params)
    leaves = 32 * KB + 16 * KB
    assert rep["argument_bytes"] == 3 * leaves + 4
    args = 3 * leaves + SCALAR  # the step rounded to its block
    assert rep["peak_bytes"] == args + 3 * SCALAR + 4 * 32 * KB \
        + 4 * SCALAR
    assert rep["output_bytes"] == 2 * leaves + 4


# ---------------------------------------------------------------------------
# the meta device allocates as a real device does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", REMAT)
def test_meta_step_allocates_as_the_cpu(remat):
    """The reduced granite's train step with the plain versions and the
    gather dispatch, under each remat policy of ``models/stack.py``: the
    tracker's arguments, outputs and peak on the meta device equal those
    on the CPU (the recompute and the optimizer seen alike)."""
    from repro_torch.optim import inverse_sqrt
    from repro_torch.training import init_train_state, make_train_step

    cfg = get_reduced(GRANITE)
    ac = zoo.ApplyCfg(**{**ms.MEMORY_AC, "remat": remat})
    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=10_000))
    step = make_train_step(cfg, opt, ac=ac)
    got = {}
    for device in ("cpu", "meta"):
        state = init_train_state(0 if device == "cpu" else None, cfg, opt,
                                 device=device)
        batch = {k: torch.zeros(4, 16, dtype=torch.int32, device=device)
                 for k in ("tokens", "targets")}
        _, rep = measure(step, state, batch)
        got[device] = {k: v for k, v in rep.items() if k != "at_peak"}
    assert got["meta"] == got["cpu"]
    assert got["cpu"]["temp_bytes"] > 0


# ---------------------------------------------------------------------------
# the fake-group rank step against real ranks
# ---------------------------------------------------------------------------

def test_fake_group_rank_step_matches_gloo_ranks(tmp_path):
    """The dry run of rank 0 under a fake process group of 4, told
    gloo's transport (a reduce-scatter built from an all-to-all), on the
    reduced granite at 8 x 32 under the ``optimized`` profile's rules on
    (2, 2), against the tracker on each of 4 spawned gloo ranks running
    the same step on the CPU: the same arguments, outputs and peak on
    every rank (the placement is symmetric: every rank holds blocks of
    the same shapes and runs the same ops)."""
    procs = ms.spawn_ranks(ms.memory_worker, str(tmp_path))
    want = dryrun.rank_memory(
        ms.MEMORY_ARCH, ShapeCfg("memory", ms.SEQ, ms.BATCH, "train"),
        {"data": 2, "model": 2}, profile=ms.MEMORY_PROFILE,
        extra_ac=ms.MEMORY_AC, cfg=get_reduced(ms.MEMORY_ARCH),
        param_dtype=torch.float32, transport="gloo")
    ranks = ms.join_ranks(procs, str(tmp_path))
    keys = ("argument_bytes", "output_bytes", "temp_bytes", "peak_bytes")
    for r, got in enumerate(ranks):
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}, r
    assert want["peak_bytes"] > want["argument_bytes"] > 0


# ---------------------------------------------------------------------------
# the dry run's record
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``run_cell``'s records of granite's ``train_4k`` and
    ``decode_32k`` cells on the pod mesh under ``optimized``."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    return {kind: dryrun.run_cell(GRANITE, shape, "pod", "optimized", out)
            for kind, shape in (("train", "train_4k"),
                                ("decode", "decode_32k"))}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_run_cell_writes_the_memory_record(records, kind):
    mem = records[kind]["memory"]
    for key in ("argument_bytes", "temp_bytes", "output_bytes",
                "total_bytes", "peak_bytes", "fits_hbm", "at_peak",
                "arguments_fit_hbm"):
        assert key in mem, key
    assert "absent" not in mem
    assert all(isinstance(mem[k], int) and mem[k] > 0 for k in
               ("temp_bytes", "output_bytes", "peak_bytes"))
    assert mem["total_bytes"] == mem["peak_bytes"] == (
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"])
    assert mem["fits_hbm"] is True
    top = mem["at_peak"]
    assert 0 < len(top) <= 10
    assert [g["bytes"] for g in top] == sorted(
        (g["bytes"] for g in top), reverse=True)
    assert sum(g["bytes"] for g in top) <= mem["peak_bytes"]


def test_fits_hbm_is_false_above_the_card():
    """Granite's whole logits at 64 x 4096 on one card (no ce_chunk):
    the float32 logits alone are 51.5 GB, their softmax as much."""
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        rec = dryrun.run_cell(
            GRANITE, ShapeCfg("big", 4096, 64, "train"), "one", "baseline",
            out, mesh={"data": 1, "model": 1},
            extra_ac=dict(ce_chunk=0, remat="none", dispatch="gather"))
    mem = rec["memory"]
    assert mem["peak_bytes"] > HBM_BYTES and mem["fits_hbm"] is False
    assert mem["arguments_fit_hbm"] is True


def _ref_output_bytes(arch, profile):
    """The reference's train-step output leaves on (16, 16) under the
    cell's placement (``spec_for``, param rules for the state),
    excluding its params, and its metrics (replicated scalars)."""
    from jax.sharding import AbstractMesh

    jmesh = AbstractMesh((16, 16), ("data", "model"))
    cfg = jconfigs.get_config(arch)
    ctx = jspecs.make_ctx(jmesh, cfg, jspecs.PROFILES[profile])
    opt = jadafactor(jinverse_sqrt(peak=0.01, warmup_steps=10_000))
    tc = JTrainConfig()
    state = jax.eval_shape(lambda: jinit_train_state(
        jax.random.PRNGKey(0), cfg, opt, tc=tc))
    batch = jspecs._batch_struct(cfg, jconfigs.SHAPES["train_4k"])
    step = jmake_train_step(cfg, opt, ac=jzoo.ApplyCfg(dispatch="gather"),
                            tc=tc)
    new, mets = jax.eval_shape(step, state, batch)
    sizes = dict(jmesh.shape)

    def leaf(axes, sds):
        spec = jspec_for(axes, sds.shape, jmesh, ctx.param_rules)
        shards = math.prod(sizes[a] for e in spec if e is not None
                           for a in ((e,) if isinstance(e, str) else e))
        return int(np.prod(sds.shape)) * sds.dtype.itemsize // shards

    axes = jstate_axes(cfg, tc=tc)
    kept = {k: v for k, v in new.items() if k != "params"}
    out = sum(jax.tree.leaves(jax.tree.map(
        leaf, {k: axes[k] for k in kept}, kept)))
    return out + sum(int(np.prod(m.shape)) * m.dtype.itemsize
                     for m in jax.tree.leaves(mets))


# The metrics the port's step returns under a ctx beyond the
# reference's: the expert-parallel capacity overflow summed over the MoE
# layers (``models/stack.py``), a float32 scalar.
PORT_ONLY_METRICS = ("ep_overflow_frac_sum",)


def test_output_bytes_match_the_reference(records):
    """A device's output bytes of granite's ``train_4k`` cell on the pod
    mesh equal the reference's step outputs under the same placement —
    the new optimizer state and step, the metrics — less its params: the
    port's step writes them in place, so their storages are the step's
    arguments; plus the port's one metric the reference lacks (4 B). The
    argument bytes stay the rules' (the existing parity)."""
    jconfigs.list_configs()
    rec = records["train"]
    assert rec["memory"]["output_bytes"] == _ref_output_bytes(
        GRANITE, "optimized") + 4 * len(PORT_ONLY_METRICS)


# ---------------------------------------------------------------------------
# the kernels' shape-only routes allocate what their CUDA wrappers do
# ---------------------------------------------------------------------------

class _Allocs(TorchDispatchMode):
    """Every new tensor an op returns: (shape, dtype), in order."""

    def __init__(self):
        super().__init__()
        self.got = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            seen = {t.untyped_storage()._cdata for t in
                    tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)}
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and \
                        t.untyped_storage()._cdata not in seen:
                    self.got.append((tuple(t.shape), t.dtype))
        return out


def _allocs(fn):
    with _Allocs() as a:
        fn()
    return a.got


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


F32 = torch.float32


def test_expert_ffn_meta_routes_allocate_the_cuda_buffers():
    """Forward: the output, then the float32 (G, E, cap, f) hidden; the
    backward: dx, the float32 da, dg and h, the float32 dwi, dwg, dwo
    (bfloat16 weights: then their casts)."""
    G, E, cap, d, f = 2, 4, 6, 32, 48
    for dt in (F32, torch.bfloat16):
        xe, dy = _m(G, E, cap, d, dtype=dt), _m(G, E, cap, d, dtype=dt)
        wi, wg = _m(E, d, f, dtype=dt), _m(E, d, f, dtype=dt)
        wo = _m(E, f, d, dtype=dt)
        route = _allocs(lambda: em.expert_ffn_meta(xe, wi, wg, wo))
        assert route == _allocs(lambda: em.fwd_buffers(xe, f))
        assert route == [((G, E, cap, d), dt), ((G, E, cap, f), F32)]
        route = _allocs(lambda: em.expert_ffn_bwd_meta(xe, wi, wg, wo, dy))
        shared = _allocs(lambda: (em.dx_buffers(xe, f, True),
                                  em.dw_buffers(xe, f, True)))
        casts = [((E, d, f), dt), ((E, d, f), dt), ((E, f, d), dt)]
        assert route == shared + (casts if dt != F32 else [])
        assert shared == [((G, E, cap, d), dt)] + [((G, E, cap, f), F32)] * 3 \
            + [((E, d, f), F32)] * 2 + [((E, f, d), F32)]


def test_grouped_mlp_meta_routes_allocate_the_cuda_buffers():
    """Forward: the output, then the float32 (G, M, f) hidden; backward:
    dx, da, dg, h, then dwi, dwg, dwo and the dW kernel's aligned
    segment starts (the offsets' own temporaries included)."""
    G, E, d, f = 2, 4, 32, 48
    M = E * gm.ROW_BLOCK * 2
    xs, dy = _m(G, M, d), _m(G, M, d)
    wi, wg, wo = _m(E, d, f), _m(E, d, f), _m(E, f, d)
    sizes = _m(G, E, dtype=torch.int32)
    route = _allocs(lambda: gm.grouped_mlp_meta(xs, wi, wg, wo, sizes))
    assert route == _allocs(lambda: gm.fwd_buffers(xs, f, sizes))
    assert route == [((G, M, d), F32), ((G, M, f), F32)]
    route = _allocs(lambda: gm.grouped_mlp_bwd_meta(xs, wi, wg, wo, dy,
                                                    sizes))
    shared = _allocs(lambda: (gm.dx_buffers(xs, f, True, sizes),
                              gm.dw_buffers(xs, f, True, sizes,
                                            gm.ROW_BLOCK)))
    assert route == shared
    assert shared[:7] == [((G, M, d), F32)] + [((G, M, f), F32)] * 3 \
        + [((E, d, f), F32)] * 2 + [((E, f, d), F32)]
    assert shared[-1] == ((G, E + 1), torch.int32)


def test_flash_backward_meta_route_allocates_delta():
    """The backward's float32 (B, H, Sq) delta (from the rows' dO . O)
    before dq, dk and dv; the forward's o and float32 lse."""
    B, S, H, Kh, dh = 2, 8, 4, 2, 16
    q, o, do = _m(B, S, H, dh), _m(B, S, H, dh), _m(B, S, H, dh)
    k, v = _m(B, S, Kh, dh), _m(B, S, Kh, dh)
    route = _allocs(lambda: fa.flash_attention_fwd_meta(q, k, v, 0, S,
                                                        causal=True))
    assert route == _allocs(lambda: fa.fwd_buffers(q)) == [
        ((B, S, H, dh), F32), ((B, H, S), F32)]
    route = _allocs(lambda: fa.flash_attention_bwd_meta(
        q, k, v, o, do, 0, S, causal=True))
    shared = _allocs(lambda: (fa.attention_delta(o, do),
                              torch.empty_like(q), torch.empty_like(k),
                              torch.empty_like(v)))
    assert route == shared
    assert ((B, H, S), F32) in shared[:-3]
    assert shared[-3:] == [((B, S, H, dh), F32), ((B, S, Kh, dh), F32),
                           ((B, S, Kh, dh), F32)]


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_split_walk_meta_routes_allocate_the_partials(kernel):
    """The paged kernels' float32 split partials at shapes whose walks
    the H100's 132 SMs split: decode, 2 slots over 64 table entries;
    prefill, one lane of 16 rows over 64 blocks of 16."""
    H, Kh, dh, bs, nb = 8, 2, 64, 16, 64
    pool = _m(2 * nb, bs, Kh, dh)
    if kernel == "decode":
        q, tables = _m(2, H, dh), _m(2, nb, dtype=torch.int32)
        lengths = _m(2, dtype=torch.int32)
        route = _allocs(lambda: da.paged_decode_attention_meta(
            q, pool, pool, tables, lengths))
        out, part, splits = da.buffers(q, pool, nb)
        shared = _allocs(lambda: da.buffers(q, pool, nb))
        n = splits * 2 * H * (dh + 2)
    else:
        q, tables = _m(1, 16, H, dh), _m(1, nb, dtype=torch.int32)
        lane = _m(1, dtype=torch.int32)
        route = _allocs(lambda: pp.paged_prefill_attention_meta(
            q, pool, pool, tables, lane, lane))
        out, part, _, splits = pp.buffers(q, pool, nb)
        shared = _allocs(lambda: pp.buffers(q, pool, nb))
        n = splits * 16 * H * (dh + 2)
    assert splits > 1 and part is not None
    assert route == shared
    assert shared == [(tuple(q.shape), F32), ((n,), F32)]

