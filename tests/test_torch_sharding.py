"""The port's sharding rules engine and logical axes against the JAX
package's (no processes: a mesh is a ``{name: size}`` mapping, as the
reference's tests use ``AbstractMesh``).

The reference's ``tests/test_sharding.py`` ported case for case, then
parity at full size: for every arch (and the ``upcycled()`` target of
each config module that has one) the port's ``state_axes`` equals the
reference's leaf by leaf, and ``spec_for`` gives the same spec for every
leaf on the production meshes under every rules variant. Exact."""
import importlib

import jax.tree_util as jtu
import pytest
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.sharding import make_rules as jmake_rules
from repro.sharding import spec_for as jspec_for
from repro.training.train_loop import state_axes as jstate_axes
from repro_torch import configs as tconfigs
from repro_torch.sharding import (
    expert_parallel_layout,
    make_rules,
    placements_for,
    spec_for,
    tree_placements,
    tree_specs,
)
from repro_torch.training.train_loop import state_axes
from torch_threads import one_thread  # noqa: F401 (autouse)


def mesh2():
    return {"data": 16, "model": 16}


def mesh3():
    return {"pod": 2, "data": 16, "model": 16}


def pr(mesh, **kw):
    return make_rules(mesh, params=True, **kw)


def ar(mesh, **kw):
    return make_rules(mesh, params=False, **kw)


def spec(*entries):
    """The canonical tuple of ``PartitionSpec(*entries)``."""
    return tuple(entries)


# ---------------------------------------------------------------------------
# tests/test_sharding.py, ported
# ---------------------------------------------------------------------------


def test_expert_weights_ep_plus_fsdp():
    m = mesh2()
    assert spec_for("expert embed mlp", (32, 1024, 512), m, pr(m)) == \
        spec("model", "data")


def test_grok_fallback_expert_tp():
    m = mesh2()
    assert spec_for("expert embed mlp", (8, 6144, 32768), m, pr(m)) == \
        spec(None, "data", "model")


def test_granite_vocab_fallback():
    m = mesh2()
    assert spec_for("vocab embed", (49155, 1024), m, pr(m)) == \
        spec(None, "data")
    assert spec_for("vocab embed", (131072, 5120), m, pr(m)) == \
        spec("model", "data")


def test_qwen25_heads_indivisible():
    m = mesh2()
    assert spec_for("embed heads head_dim", (5120, 40, 128), m, pr(m)) == \
        spec("data")


def test_dp_only_baseline_has_no_fsdp():
    m = mesh2()
    assert spec_for("embed mlp", (4096, 14336), m, pr(m, dp_only=True)) \
        == spec(None, "model")


def test_activation_batch_sharding():
    m2, m3 = mesh2(), mesh3()
    assert spec_for("batch seq embed", (256, 4096, 1024), m2, ar(m2)) == \
        spec("data")
    assert spec_for("batch seq embed", (256, 4096, 1024), m3, ar(m3)) == \
        spec(("pod", "data"))
    assert spec_for("batch seq embed", (1, 4096, 1024), m2, ar(m2)) == ()


def test_kv_cache_sequence_sharding():
    m = mesh2()
    assert spec_for(
        "batch cache_seq kv_heads head_dim", (128, 32768, 8, 128),
        m, ar(m),
    ) == spec("data", "model")


def test_fsdp_over_pod_optin():
    m = mesh3()
    assert spec_for("embed mlp", (4096, 14336), m,
                    pr(m, fsdp_over_pod=True)) == \
        spec(("pod", "data"), "model")
    assert spec_for("embed mlp", (4096, 14336), m, pr(m)) == \
        spec("data", "model")


def test_no_axis_reuse_within_tensor():
    m = mesh2()
    assert spec_for("heads kv_heads", (16, 16), m, pr(m)) == spec("model")


def test_rank_mismatch_raises():
    m = mesh2()
    with pytest.raises(ValueError):
        spec_for("embed mlp", (4, 4, 4), m, pr(m))


def test_expert_parallel_layout():
    m2, m3 = mesh2(), mesh3()
    assert expert_parallel_layout(m2, 32) == \
        ("model", 16, ("data", "model"))
    assert expert_parallel_layout(m3, 64) == \
        ("model", 16, ("pod", "data", "model"))
    assert expert_parallel_layout(m2, 8) is None
    assert expert_parallel_layout(None, 32) is None
    assert expert_parallel_layout({"data": 16}, 32) is None
    assert expert_parallel_layout({"data": 16, "model": 1}, 32) is None


def test_placements_follow_the_spec():
    """A spec's DTensor placements: Shard(dim) on the mesh dim each
    tensor dim shards over, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    m = mesh3()
    assert placements_for(spec(("pod", "data"), "model"), m) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements_for(spec(None, "data"), m) == \
        (Replicate(), Shard(1), Replicate())
    assert placements_for((), m) == (Replicate(),) * 3
    tree = tree_placements({"w": "expert embed mlp", "b": ["_"]},
                           {"w": (32, 1024, 512), "b": [(7,)]}, m, pr(m))
    assert tree == {"w": (Replicate(), Shard(1), Shard(0)),
                    "b": [(Replicate(),) * 3]}


# ---------------------------------------------------------------------------
# parity with the reference at full size
# ---------------------------------------------------------------------------

UPCYCLED = ("pixtral_12b", "qwen2_5_14b", "tinyllama_1_1b", "qwen1_5_0_5b",
            "yi_9b", "rwkv6_7b", "whisper_base")


def _cases():
    # The reference's registry is filled through list_configs() before
    # any of its config modules is imported by name.
    names = jconfigs.list_configs()
    return [(n, None) for n in names] + [(m, m) for m in UPCYCLED]


def _configs(name, mod):
    if mod is None:
        return tconfigs.get_config(name), jconfigs.get_config(name)
    return (importlib.import_module(f"repro_torch.configs.{mod}").upcycled(),
            importlib.import_module(f"repro.configs.{mod}").upcycled())


def _flat_jax(tree):
    return {jtu.keystr(p): v for p, v in jtu.tree_leaves_with_path(tree)}


def _flat(tree, pre=""):
    """{key path: leaf} in the reference's ``keystr`` form; lists are
    nodes, tuples (specs, shapes) leaves."""
    if isinstance(tree, dict):
        return {k: v for kk, vv in tree.items()
                for k, v in _flat(vv, pre + f"[{kk!r}]").items()}
    if isinstance(tree, list):
        return {k: v for i, vv in enumerate(tree)
                for k, v in _flat(vv, pre + f"[{i}]").items()}
    return {pre: tree}


def _state_shapes(cfg):
    """Leaf shapes of the port's train state (built on the meta
    device)."""
    from repro_torch.optim import adafactor, constant
    from repro_torch.training import init_train_state

    state = init_train_state(None, cfg, adafactor(constant(1e-2)),
                             device="meta")
    return {k: tuple(v.shape) for k, v in _flat(state).items()}


def _rules_variants(mesh, cfg):
    over = dict(cfg.sharding_overrides or {})
    yield "default", dict(overrides=over)
    yield "dp_only", dict(dp_only=True, overrides=over)
    yield "fsdp_over_pod", dict(fsdp_over_pod=True, overrides=over)


@pytest.mark.parametrize("name,mod", _cases())
def test_state_axes_and_specs_match_reference(name, mod):
    """state_axes leaf by leaf, then spec_for of every leaf of the train
    state on (16, 16) and (2, 16, 16), both rule tables, each rules
    variant with the arch's overrides — all equal the reference's."""
    tcfg, jcfg = _configs(name, mod)
    t_axes = _flat(state_axes(tcfg))
    j_axes = _flat_jax(jstate_axes(jcfg))
    assert t_axes == j_axes
    shapes = _state_shapes(tcfg)
    assert set(shapes) == set(t_axes)
    pairs = sorted({(a, shapes[k]) for k, a in t_axes.items()})
    for mesh, axes in (((16, 16), ("data", "model")),
                       ((2, 16, 16), ("pod", "data", "model"))):
        tm = dict(zip(axes, mesh))
        jm = AbstractMesh(mesh, axes)
        for params in (True, False):
            for label, kw in _rules_variants(tm, tcfg):
                tr = make_rules(tm, params=params, **kw)
                jr = jmake_rules(jm, params=params, **kw)
                for a, shape in pairs:
                    want = tuple(jspec_for(a, shape, jm, jr))
                    got = spec_for(a, shape, tm, tr)
                    assert got == want, (name, mod, axes, params, label, a)
    # The tree form agrees with the leaf form.
    tree = tree_specs(state_axes(tcfg)["params"], _param_shapes(tcfg),
                      mesh2(), pr(mesh2()))
    assert _flat(tree, "['params']") == {
        k: spec_for(a, shapes[k], mesh2(), pr(mesh2()))
        for k, a in t_axes.items() if k.startswith("['params']")}


def _param_shapes(cfg):
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import tree_map

    return tree_map(lambda t: tuple(t.shape),
                    zoo.init_params(None, cfg, device="meta"))


def test_state_axes_with_compression_match_reference():
    """Under gradient compression the state gains the ``residual``
    subtree, the params' axes: equal to the reference's."""
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro_torch.training import TrainConfig

    name = "granite-moe-1b-a400m"
    got = _flat(state_axes(tconfigs.get_config(name),
                           tc=TrainConfig(compression="int8")))
    want = _flat_jax(jstate_axes(jconfigs.get_config(name),
                                 tc=JTrainConfig(compression="int8")))
    assert got == want
    assert any(k.startswith("['residual']") for k in got)
