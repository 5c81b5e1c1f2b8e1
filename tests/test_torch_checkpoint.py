"""Port parity for checkpoints: ``repro_torch.checkpoint`` against
``repro.checkpoint``.

* Checkpoints cross both ways, bit for bit, at reduced granite (the MoE
  train state with its Adafactor slots, f32 and bf16 params) and reduced
  ViT, and the two packages write identical files for the same tree.
* The reference's store and manager cases (tests/test_checkpoint.py),
  run through both packages on the same inputs: each case is
  parametrised over the package, and both must give the same outcome.
* The port's own: the async save owns its snapshot while the train step
  updates tensors in place, ``key=`` subtree restores, leaf placement,
  and (on the card) CUDA tensors restored to the card bit for bit.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import store as jstore
from repro.configs import get_reduced as jax_reduced
from repro.optim import adafactor as jadafactor
from repro.optim import schedules as jsched
from repro.training import train_loop as jtl
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import store
from repro_torch.configs import get_reduced
from repro_torch.data import make_iterator
from repro_torch.models.convert import from_jax_values
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adafactor, schedules
from repro_torch.training import init_train_state, make_train_step
from torch_threads import one_thread  # noqa: F401 (autouse)


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as a numpy array (bf16 as its uint16 pattern)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _leaves(pkg, tree):
    """Leaves in the store's order (JAX's: dict keys sorted)."""
    if pkg == "jax":
        return jax.tree.leaves(tree)
    return [leaf for _, leaf in store._flatten(tree)]


def _assert_same_bits(a, b):
    assert _dtype_name(a) == _dtype_name(b)
    np.testing.assert_array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# the reference's store and manager cases, through both packages
# ---------------------------------------------------------------------------


def _jax_tree():
    return {
        "a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "b": {"c": jnp.ones((4,), jnp.bfloat16), "d": jnp.asarray(3)},
    }


def _torch_tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
              "d": torch.tensor(3, dtype=torch.int32)},
    }


PACKAGES = {
    "jax": types.SimpleNamespace(
        name="jax", store=jstore, Manager=JManager, tree=_jax_tree,
        zeros=lambda *s: jnp.zeros(s)),
    "torch": types.SimpleNamespace(
        name="torch", store=store, Manager=CheckpointManager,
        tree=_torch_tree, zeros=lambda *s: torch.zeros(s)),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _same_a(pkg, out, t):
    _assert_same_bits(out["a"], t["a"])


def test_roundtrip(pkg, tmp_path):
    t = pkg.tree()
    p = str(tmp_path / "ckpt")
    pkg.store.save_tree(p, t, metadata={"step": 7})
    out = pkg.store.load_tree(p, t)
    for x, y in zip(_leaves(pkg.name, t), _leaves(pkg.name, out)):
        _assert_same_bits(x, y)
    assert pkg.store.load_metadata(p)["step"] == 7


def test_missing_commit_is_invalid(pkg, tmp_path):
    t = pkg.tree()
    p = str(tmp_path / "ckpt")
    pkg.store.save_tree(p, t)
    os.remove(os.path.join(p, "COMMIT"))
    assert not pkg.store.is_valid(p)
    with pytest.raises(FileNotFoundError):
        pkg.store.load_tree(p, t)


def test_structure_mismatch_raises(pkg, tmp_path):
    t = pkg.tree()
    p = str(tmp_path / "ckpt")
    pkg.store.save_tree(p, t)
    with pytest.raises(ValueError, match="structure mismatch"):
        pkg.store.load_tree(p, {"a": t["a"]})
    bad = dict(t)
    bad["a"] = pkg.zeros(9, 9)
    with pytest.raises(ValueError, match="shape mismatch"):
        pkg.store.load_tree(p, bad)


def test_manager_rotation_and_latest(pkg, tmp_path):
    m = pkg.Manager(str(tmp_path), max_to_keep=2, keep_period=10)
    t = pkg.tree()
    for s in [1, 5, 10, 12, 14]:
        m.save(s, t, metadata={"data": {"step": s}})
    assert m.all_steps() == [10, 12, 14]  # 10 archived by keep_period
    out, step, meta = m.restore_latest(t)
    assert step == 14 and meta["data"]["step"] == 14
    _same_a(pkg, out, t)


def test_manager_skips_partial_checkpoints(pkg, tmp_path):
    m = pkg.Manager(str(tmp_path), max_to_keep=5)
    t = pkg.tree()
    m.save(3, t)
    broken = m.step_path(9)  # a crashed writer at step 9
    os.makedirs(broken)
    with open(os.path.join(broken, "manifest.json"), "w") as f:
        f.write("{}")
    assert m.latest_step() == 3
    _, step, _ = m.restore_latest(t)
    assert step == 3


def test_async_save(pkg, tmp_path):
    m = pkg.Manager(str(tmp_path), max_to_keep=3)
    m.save_async(2, pkg.tree())
    m.wait()
    assert m.latest_step() == 2


def test_crash_mid_write_keeps_previous(pkg, tmp_path):
    """A writer dies with a half-written tmp dir: the previous
    checkpoint still loads and the next save succeeds."""
    t = pkg.tree()
    p = str(tmp_path / "ckpt")
    pkg.store.save_tree(p, t, metadata={"step": 1})
    tmp = f"{p}.tmp-{os.getpid()}"
    os.makedirs(tmp)
    with open(os.path.join(tmp, "leaf_00000.npy"), "wb") as f:
        f.write(b"\x93NUMPY")  # torn npy header
    assert pkg.store.is_valid(p)
    _same_a(pkg, pkg.store.load_tree(p, t), t)
    pkg.store.save_tree(p, t, metadata={"step": 2})
    assert pkg.store.load_metadata(p)["step"] == 2


def test_torn_leaf_falls_back_to_last_known_good(pkg, tmp_path):
    m = pkg.Manager(str(tmp_path), max_to_keep=5)
    t = pkg.tree()
    m.save(3, t)
    m.save(7, t)
    with open(os.path.join(m.step_path(7), "leaf_00000.npy"), "wb") as f:
        f.write(b"\x93NU")  # truncated after COMMIT
    assert m.latest_step() == 7
    with pytest.raises(pkg.store.CorruptCheckpointError):
        pkg.store.load_tree(m.step_path(7), t)
    out, step, _ = m.restore_latest(t)
    assert step == 3
    _same_a(pkg, out, t)
    assert m.health()["fallbacks"] == 1


def test_manager_structure_mismatch_still_raises(pkg, tmp_path):
    m = pkg.Manager(str(tmp_path), max_to_keep=5)
    t = pkg.tree()
    m.save(3, t)
    with pytest.raises(ValueError):
        m.restore_latest({"a": t["a"]})


class _Flaky:
    """Injectable fault hook: fail the first ``n`` attempts of ``ops``."""

    def __init__(self, n, ops=("save", "restore", "restore_latest")):
        self.n = n
        self.ops = ops
        self.calls = []

    def __call__(self, op, attempt):
        self.calls.append((op, attempt))
        if op in self.ops and attempt < self.n:
            raise OSError(f"transient {op} failure #{attempt}")


def test_manager_retries_transient_save_and_restore(pkg, tmp_path):
    delays = []
    hook = _Flaky(2)
    m = pkg.Manager(str(tmp_path), io_retries=2, io_backoff=0.05,
                    io_backoff_cap=1.0, fault_hook=hook,
                    sleep=delays.append)
    t = pkg.tree()
    m.save(1, t)  # attempts 0, 1 fail, 2 succeeds
    assert [c for c in hook.calls if c[0] == "save"] == [
        ("save", 0), ("save", 1), ("save", 2)]
    assert delays == [0.05, 0.1]
    hook.n = 1
    _same_a(pkg, m.restore(1, t), t)
    _, step, _ = m.restore_latest(t)
    assert step == 1
    assert m.health()["io_retries"] == 4


def test_manager_retry_budget_exhausted_raises(pkg, tmp_path):
    delays = []
    m = pkg.Manager(str(tmp_path), io_retries=2, sleep=delays.append)
    t = pkg.tree()
    m.save(3, t)
    m.fault_hook = _Flaky(10 ** 9, ops=("save",))
    with pytest.raises(OSError):
        m.save(9, t)
    assert len(delays) == 2
    assert m.all_steps() == [3]


def test_manager_retry_backoff_is_capped(pkg, tmp_path):
    delays = []
    m = pkg.Manager(str(tmp_path), io_retries=5, io_backoff=0.1,
                    io_backoff_cap=0.3, fault_hook=_Flaky(5),
                    sleep=delays.append)
    m.save(1, pkg.tree())
    assert delays == [0.1, 0.2, 0.3, 0.3, 0.3]


def test_manager_never_retries_structure_mismatch(pkg, tmp_path):
    hook = _Flaky(0)
    m = pkg.Manager(str(tmp_path), io_retries=3, fault_hook=hook,
                    sleep=lambda _d: None)
    t = pkg.tree()
    m.save(1, t)
    with pytest.raises(ValueError):
        m.restore(1, {"a": t["a"]})
    assert [c for c in hook.calls if c[0] == "restore"] == [("restore", 0)]


def test_manager_health_tracks_failures_and_recovery(pkg, tmp_path):
    t = {"x": pkg.zeros(4)}
    pkg.Manager(str(tmp_path)).save(1, t)
    down = {"on": False}

    def hook(op, attempt):
        if down["on"]:
            raise OSError("store down")

    m = pkg.Manager(str(tmp_path), io_retries=1, fault_hook=hook,
                    sleep=lambda s: None)
    assert m.health() == {"io_retries": 0, "fallbacks": 0, "ops_ok": 0,
                          "consecutive_failures": 0, "healthy": True}
    _, step, _ = m.restore_latest(t)
    assert step == 1 and m.health()["ops_ok"] == 1
    down["on"] = True
    assert m.restore_latest(t) == (None, None, None)
    h1 = m.health()
    assert not h1["healthy"] and h1["consecutive_failures"] == 3
    assert h1["io_retries"] == 1 and h1["fallbacks"] == 1
    down["on"] = False
    _, step, _ = m.restore_latest(t)
    h2 = m.health()
    assert step == 1 and h2["healthy"] and h2["fallbacks"] == 1


def test_store_leaf_files(pkg, tmp_path):
    path = str(tmp_path / "ck")
    pkg.store.save_tree(path, {"b": np.ones((2, 2)), "a": np.arange(3.0)})
    files = pkg.store.leaf_files(path)
    assert [os.path.basename(f) for f in files] == ["leaf_00000.npy",
                                                    "leaf_00001.npy"]
    assert np.load(files[0]).shape == (3,)  # "a" first: keys sorted
    assert pkg.store.leaf_files(str(tmp_path / "nope")) == []


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

# (arch, params dtype): granite's MoE train state (Adafactor's factored
# and unfactored slots, int32 step counters) in f32 and bf16, and the
# ViT's.
CROSS_CASES = [("granite-moe-1b-a400m", "float32"),
               ("granite-moe-1b-a400m", "bfloat16"),
               ("vit-b16-upcycled", "float32")]


@pytest.fixture(scope="module", params=CROSS_CASES,
                ids=lambda c: f"{c[0]}-{c[1]}")
def train_states(request):
    """The JAX train state (numpy leaves) and the same state converted
    to the port's tensors."""
    arch, dtype = request.param
    cfg = jax_reduced(arch)
    opt = jadafactor(jsched.inverse_sqrt(peak=0.01, warmup_steps=2))
    js = jtl.init_train_state(jax.random.PRNGKey(0), cfg, opt,
                              dtype=getattr(jnp, dtype))
    js = jax.tree.map(np.asarray, js)
    return js, from_jax_values(js)


def test_port_restores_reference_checkpoints(train_states, tmp_path):
    js, ts = train_states
    p = str(tmp_path / "ref")
    jstore.save_tree(p, js, metadata={"step": 3})
    out = store.load_tree(p, ts)
    flat = store._flatten(out)
    assert len(flat) == len(jax.tree.leaves(js))
    for (path, got), want in zip(flat, jax.tree.leaves(js)):
        _assert_same_bits(got, want)
    assert store.load_metadata(p) == {"step": 3}


def test_reference_restores_port_checkpoints(train_states, tmp_path):
    js, ts = train_states
    p = str(tmp_path / "port")
    store.save_tree(p, ts, metadata={"step": 3})
    out = jstore.load_tree(p, js)
    for got, want in zip(jax.tree.leaves(out), jax.tree.leaves(js)):
        _assert_same_bits(got, want)


def test_packages_write_identical_files(train_states, tmp_path):
    js, ts = train_states
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    meta = {"data": {"step": 5}, "arch": "x"}
    jstore.save_tree(a, js, metadata=meta)
    store.save_tree(b, ts, metadata=meta)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    with open(os.path.join(a, "manifest.json")) as f:
        ma = f.read()
    with open(os.path.join(b, "manifest.json")) as f:
        assert f.read() == ma
    assert any(e["dtype"] == "int32" for e in json.loads(ma)["leaves"])
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_async_save_owns_its_snapshot(tmp_path):
    """The train step updates the parameter tensors in place and a CPU
    tensor's numpy array aliases it: ``save_async``, then a step, then
    ``wait`` — the checkpoint holds the state from before the step."""
    cfg = get_reduced("granite-moe-1b-a400m").dense_parent()
    opt = adafactor(schedules.constant(0.01))
    state = init_train_state(0, cfg, opt, device="cpu")
    before = [t.clone() for t in tree_leaves(state)]
    m = CheckpointManager(str(tmp_path))
    m.save_async(1, state)
    state, _ = make_train_step(cfg, opt)(
        state, next(make_iterator(cfg, global_batch=2, seq_len=16)))
    m.wait()
    moved = [not torch.equal(a, b)
             for a, b in zip(before, tree_leaves(state))]
    assert sum(moved) > len(moved) // 2
    out = m.restore(1, state)
    for a, b in zip(before, tree_leaves(out)):
        _assert_same_bits(b, a)


def test_load_tree_places_leaves_and_reads_subtrees(tmp_path):
    """Each leaf keeps its stored dtype and goes to ``device`` or its
    like-leaf's device; ``key=`` reads one top-level subtree, checked
    strictly against ``like``."""
    t = _torch_tree()
    state = {"params": t, "opt_state": {"step": torch.tensor(2)},
             "step": torch.tensor(2)}
    p = str(tmp_path / "ck")
    store.save_tree(p, state)
    like = {"a": torch.zeros(2, 3, dtype=torch.float64, device="meta"),
            "b": {"c": torch.zeros(4), "d": torch.zeros(())}}
    out = store.load_tree(p, like, device="cpu", key="params")
    for x, y in zip(tree_leaves(t), tree_leaves(out)):
        _assert_same_bits(y, x)
    assert out["a"].device.type == "cpu"
    meta = store.load_tree(p, like, key="params")
    assert meta["a"].device.type == "meta"
    assert meta["a"].dtype == torch.float32
    with pytest.raises(ValueError, match="structure mismatch"):
        store.load_tree(p, {"a": like["a"]}, key="params")
    with pytest.raises(ValueError, match="structure mismatch"):
        store.load_tree(p, like)  # the whole tree is not `like`


def test_reference_loader_reads_port_params_only_checkpoints(tmp_path):
    """A params-only checkpoint (the form the reference's loaders take)
    crosses too, and the port's ``key="params"`` reads it."""
    t = _torch_tree()
    p = str(tmp_path / "ck")
    store.save_tree(p, {"params": t})
    out = jstore.load_tree(p, {"params": _jax_tree()})
    _assert_same_bits(out["params"]["b"]["c"], _jax_tree()["b"]["c"])
    back = store.load_tree(p, t, key="params")
    _assert_same_bits(back["b"]["c"], t["b"]["c"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_roundtrip_is_bit_exact(dtype, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = {"w": torch.randn(64, 33, generator=gen, device="cuda").to(dtype),
         "s": [torch.randn(5, generator=gen, device="cuda").to(dtype)],
         "step": torch.tensor(4, dtype=torch.int32, device="cuda")}
    m = CheckpointManager(str(tmp_path))
    m.save(4, t)
    m.save_async(5, t)
    m.wait()
    for step in (4, 5):
        out = m.restore(step, t)
        for x, y in zip(tree_leaves(t), tree_leaves(out)):
            assert y.is_cuda
            _assert_same_bits(y, x)
