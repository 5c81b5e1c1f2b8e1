"""The grouped kernels' ragged tile map (``ragged_tile`` and
``zero_dead_blocks`` in ``csrc/expert_gemm.cuh``, mirrored here by
``_ragged_tile_map``) on random group sizes, on the CPU, with the row
tile and grid size the wrappers launch with (``grouped_mlp.row_tile``,
``tile_slots``): every live 16-row block of the
layout (``block_tables``, held against the JAX package's in
``test_torch_moe.py``) is computed by exactly one tile, no tile crosses
its expert's segment, the live tiles fit the static grid
(``tile_slots``), and every dead block is zero-filled by exactly one
spare slot. The dW kernel's depth walk (``SegmentRuns`` in
``csrc/grouped_mlp_bwd.cu``, mirrored by ``_dw_depth_walk``): each
expert's block reads every valid row of its segments in every group
once, in group order, in slabs that never cross a group, and no dead
row."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_mlp as gm
from torch_threads import one_thread  # noqa: F401 (autouse)

ROW = gm.ROW_BLOCK


def _ragged_tile_map(sizes, M: int, bm: int, slots: int):
    """The kernels' tile map of one group, in their arithmetic: ``sizes``
    the E valid-row counts. Returns ``(tiles, dead)``: ``tiles[slot] =
    (expert, first row, rows)`` for each slot holding a live tile, and
    ``dead[spare] = [first rows]`` of the dead 16-row blocks (an empty
    expert's block, the blocks past the last segment) that each spare
    slot (past the live tiles) zero-fills in the output pass."""
    E = len(sizes)
    tiles, row_off, r0, t0 = {}, [], 0, 0
    for e, n in enumerate(int(x) for x in sizes):
        live = -(-n // ROW) * ROW
        for k in range(0, live, bm):
            slot = t0 + k // bm
            rows = max(0, min(bm, live - k, M - r0 - k))
            if slot < slots and rows:
                tiles[slot] = (e, r0 + k, rows)
        row_off.append(min(r0, M))
        t0 += -(-n // bm)
        r0 += max(live, ROW)
    end = min(r0, M)
    nspare = slots - t0
    items = E + -(-(M - end) // ROW)
    dead = {s: [] for s in range(max(nspare, 0))}
    for i in range(items if nspare > 0 else 0):
        if i < E and int(sizes[i]) > 0:
            continue
        first = row_off[i] if i < E else end + (i - E) * ROW
        if first < M:
            dead[i % nspare].append(first)
    return tiles, dead


# The dW kernel's slab depth (kDwSK in csrc/expert_ffn.cuh).
DW_SLAB = 64


def _dw_depth_walk(sizes, row_off, M: int, e: int):
    """The slabs one dW block of expert ``e`` stages, in the kernel's
    arithmetic: ``sizes`` (G, E) valid rows, ``row_off`` (G, E + 1)
    segment starts. Each group's run is padded to whole slabs; a cursor
    (run g from padded depth p0, n valid rows) moves on as the slabs are
    asked for in increasing depth. Returns [(first buffer row, rows)]
    (an empty list: the block writes its zero sums)."""
    G = len(sizes)
    pad = lambda n: -(-n // DW_SLAB) * DW_SLAB  # noqa: E731
    rows = lambda g: max(int(sizes[g][e]), 0)  # noqa: E731
    K = sum(pad(rows(g)) for g in range(G))
    slabs, g, p0, n = [], -1, 0, 0
    for k0 in range(0, K, DW_SLAB):
        while k0 >= p0 + pad(n):
            p0 += pad(n)
            g += 1
            n = rows(g)
        nk = min(DW_SLAB, K - k0, n - (k0 - p0))
        slabs.append((g * M + int(row_off[g][e]) + k0 - p0, nk))
    return slabs


def _check_dw_walk(sizes, M):
    """Every expert's slabs against its segments' valid rows."""
    sizes = np.asarray(sizes, np.int64)
    G, E = sizes.shape
    row_off, _ = gm.ragged_row_offsets(torch.tensor(sizes), ROW)
    row_off = row_off.numpy()
    _, bl = gm.block_tables(torch.tensor(sizes, dtype=torch.int32), ROW,
                            M // ROW)
    live = np.repeat(bl.numpy() == 1, ROW, axis=1).reshape(-1)  # (G M,)
    for e in range(E):
        slabs = _dw_depth_walk(sizes, row_off, M, e)
        read = [r for r0, nk in slabs for r in range(r0, r0 + nk)]
        want = [g * M + int(row_off[g, e]) + i for g in range(G)
                for i in range(int(sizes[g, e]))]
        assert read == want, e  # every valid row once, in group order
        for r0, nk in slabs:
            assert 0 < nk <= DW_SLAB
            assert r0 // M == (r0 + nk - 1) // M  # a slab in one group
        assert live[read].all() if read else not slabs  # no dead row
        assert len(slabs) == sum(-(-int(n) // DW_SLAB)
                                 for n in sizes[:, e])


def test_dw_walk_reads_each_valid_row_once():
    """Seeded random size vectors over 1 to 5 groups (empty experts,
    one-expert pile-ups, an expert empty in every group)."""
    rng = np.random.default_rng(3)
    for _ in range(120):
        G = int(rng.integers(1, 6))
        groups = [_random_sizes(rng) for _ in range(G)]
        E = len(groups[0][0])
        sizes = np.zeros((G, E), np.int64)
        for g, (sz, _) in enumerate(groups):
            sizes[g, :min(E, len(sz))] = sz[:E]
        M = max(gm.ragged_buffer_rows(int(sizes[g].sum()), E, ROW)
                for g in range(G))
        _check_dw_walk(sizes, M)


def test_dw_walk_at_the_training_shape():
    """Granite's training buffer: two groups of 4,096 tokens x top-8 over
    32 experts, counts clamped at the capacity 256 (~252 valid rows an
    expert a group, ~4 slabs), one expert empty in group 0 and one in
    every group, as chip_smoke.train_cases lays it out."""
    rng = np.random.default_rng(2)
    E, N = 32, 4096 * 8
    w = rng.random((2, E)) + 0.2
    sizes = np.minimum(np.floor(w / w.sum(-1, keepdims=True) * N),
                       256).astype(np.int64)
    sizes[0, 7] = 0
    sizes[:, 11] = 0
    _check_dw_walk(sizes, gm.ragged_buffer_rows(N, E, ROW))


def _random_sizes(rng):
    """(sizes (E,), N): N assignments split over E experts, with empty
    experts, one-expert pile-ups, counts that are multiples of 16 and
    dropped assignments (sizes summing below N)."""
    E = int(rng.integers(1, 70))
    N = int(rng.integers(0, 1200))
    kind = rng.integers(0, 4)
    if kind == 0:  # skewed, as top-k routing leaves it
        w = rng.random(E) ** 3
    elif kind == 1:  # one expert takes (nearly) all
        w = np.zeros(E)
        w[rng.integers(0, E)] = 1.0
    elif kind == 2:  # capacity-clamped: multiples of 16 where possible
        w = np.ones(E)
    else:
        w = rng.random(E)
    w[rng.random(E) < 0.2] = 0.0
    keep = N if rng.random() < 0.7 else int(rng.integers(0, N + 1))
    sizes = np.floor(w / max(w.sum(), 1e-12) * keep).astype(np.int64)
    if kind == 2 and E > 0:
        sizes = sizes // ROW * ROW
    return sizes, N


def _check_group(sizes, M, bm):
    E = len(sizes)
    slots = gm.tile_slots(M, E, bm)
    tiles, dead = _ragged_tile_map(sizes, M, bm, slots)
    # The live tiles fit the grid, and at least one slot is spare.
    n_tiles = sum(-(-int(n) // bm) for n in sizes)
    assert n_tiles <= slots and len(tiles) == n_tiles
    assert len(dead) >= 1
    # Every live block computed once, within its expert's segment.
    nb = M // ROW
    be, bl = gm.block_tables(torch.tensor(sizes[None], dtype=torch.int32),
                             ROW, nb)
    be, bl = be[0].numpy(), bl[0].numpy()
    row_off, _ = gm.ragged_row_offsets(
        torch.tensor(sizes[None], dtype=torch.int64), ROW)
    row_off = row_off[0].numpy()
    computed = np.zeros(nb, np.int64)
    for slot, (e, r0, rows) in tiles.items():
        assert 0 < rows <= bm and r0 % ROW == 0 and rows % ROW == 0
        live_end = row_off[e] + -(-int(sizes[e]) // ROW) * ROW
        assert row_off[e] <= r0 and r0 + rows <= live_end, (slot, e)
        computed[r0 // ROW:(r0 + rows) // ROW] += 1
    np.testing.assert_array_equal(computed, bl)
    # Every dead block zero-filled once, by the output pass's spare slots.
    zeroed = np.zeros(nb, np.int64)
    for firsts in dead.values():
        for r0 in firsts:
            zeroed[r0 // ROW] += 1
    np.testing.assert_array_equal(zeroed, 1 - bl)
    # A tile's expert is its blocks' owner.
    for e, r0, rows in tiles.values():
        assert (be[r0 // ROW:(r0 + rows) // ROW] == e).all()


@pytest.mark.parametrize("bm", gm.ROW_TILES)
def test_tile_map_covers_live_blocks_once(bm):
    rng = np.random.default_rng(bm)
    for _ in range(150):
        sizes, N = _random_sizes(rng)
        M = gm.ragged_buffer_rows(N, len(sizes), ROW)
        _check_group(sizes, M, bm)


@pytest.mark.parametrize("bm", gm.ROW_TILES)
def test_tile_map_at_the_main_path_shapes(bm):
    """The serve step's buffer (1,088 assignments over 32 experts, two
    empty), a decode step's (64), the training buffer (4,096 tokens x
    top-8, counts clamped at the capacity 256), an all-dead group and
    one expert holding every assignment."""
    rng = np.random.default_rng(7)
    E = 32
    w = rng.random(E) ** 3
    w[[5, 17]] = 0.0
    serve = np.floor(w / w.sum() * 1088).astype(np.int64)
    serve[0] += 1088 - serve.sum()
    train = np.minimum(np.floor((rng.random(E) + 0.2) / 21.0 * 32768),
                       256).astype(np.int64)
    for sizes, N in ((serve, 1088), (np.full(E, 2), 64), (train, 32768),
                     (np.zeros(E, np.int64), 64),
                     (np.eye(E, dtype=np.int64)[3] * 300, 300)):
        _check_group(sizes, gm.ragged_buffer_rows(N, E, ROW), bm)


@pytest.mark.parametrize("M,E,bm", [(576, 32, 16),      # a decode step
                                    (1600, 32, 64),     # the serve step
                                    (33280, 32, 128),   # training
                                    (160, 5, 16), (400, 5, 64),
                                    (1280, 5, 128)])
def test_row_tile_from_static_shapes(M, E, bm):
    assert gm.row_tile(M, E) == bm
    assert gm.row_tile(M, E, gm.DX_ROW_TILES) == min(bm, 64)
    assert gm.tile_slots(M, E, bm) == -(-M // bm) + E
