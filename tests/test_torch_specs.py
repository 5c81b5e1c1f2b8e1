"""The port's dry-run cells (``repro_torch.launch.specs``) against the
JAX package's ``repro.launch.specs``: parameter counts of every arch,
the profiles, the batch inputs of every applicable (arch x shape) cell,
the rules of the cell's ``ShardCtx`` and the exact argument bytes a
device on the production mesh. Exact throughout. Nothing here runs a
step: the cells are built on the meta device."""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.launch import specs as jspecs
from repro.optim import adafactor as jadafactor
from repro.optim import inverse_sqrt as jinverse_sqrt
from repro.sharding import spec_for as jspec_for
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import init_train_state as jinit_train_state
from repro.training.train_loop import state_axes as jstate_axes
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun, specs
from torch_threads import one_thread  # noqa: F401 (autouse)

MESH = {"data": 16, "model": 16}


def archs():
    return jconfigs.list_configs()


@pytest.fixture(scope="module")
def ref_counts():
    """The reference's (total, active) of every arch, once a module."""
    return {a: jspecs.count_params(jconfigs.get_config(a)) for a in archs()}


@pytest.mark.parametrize("arch", tconfigs.list_configs())
def test_count_params_matches_the_reference(arch, ref_counts):
    assert specs.count_params(tconfigs.get_config(arch)) == ref_counts[arch]


def test_granite_counts():
    """The counts the chip run's mfu reads (PERF.md's expectation)."""
    total, active = specs.count_params(
        tconfigs.get_config("granite-moe-1b-a400m"))
    assert (total, active) == (1_334_628_352, 428_068_864)


@pytest.mark.parametrize("name", sorted(jspecs.PROFILES))
def test_profiles_match_the_reference(name):
    assert dataclasses.asdict(specs.PROFILES[name]) == \
        dataclasses.asdict(jspecs.PROFILES[name])
    assert sorted(specs.PROFILES) == sorted(jspecs.PROFILES)


def test_constants_match_the_reference():
    assert specs.BIG_PARAM_THRESHOLD == jspecs.BIG_PARAM_THRESHOLD
    assert specs.WHISPER_ENC_FRAMES == jspecs.WHISPER_ENC_FRAMES
    assert specs.PIXTRAL_PATCHES == jspecs.PIXTRAL_PATCHES
    assert specs.BATCH_AXES == jspecs.BATCH_AXES


def test_batch_struct_matches_the_reference():
    checked = 0
    for arch in archs():
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for name, shape in jconfigs.SHAPES.items():
            ok, _ = jconfigs.shape_applicable(jcfg, shape)
            assert (ok, name) == (tconfigs.shape_applicable(
                tcfg, tconfigs.SHAPES[name])[0], name)
            if not ok:
                continue
            ref = jspecs._batch_struct(jcfg, shape)
            got = specs._batch_struct(tcfg, tconfigs.SHAPES[name])
            assert sorted(got) == sorted(ref), (arch, name)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == ref[k].shape, (arch, name, k)
                assert str(v.dtype).split(".")[1] == str(ref[k].dtype), \
                    (arch, name, k)
            assert specs.batch_axes(got) == jspecs.batch_axes(ref)
            checked += 1
    assert checked >= 30


@pytest.mark.parametrize("profile", sorted(jspecs.PROFILES))
def test_make_ctx_rules_match_the_reference(profile):
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    for arch in ("granite-moe-1b-a400m", "qwen2.5-14b", "grok-1-314b"):
        ref = jspecs.make_ctx(jmesh, jconfigs.get_config(arch),
                              jspecs.PROFILES[profile])
        got = specs.make_ctx(MESH, tconfigs.get_config(arch),
                             specs.PROFILES[profile])
        assert dict(got.param_rules) == dict(ref.param_rules), arch
        assert dict(got.act_rules) == dict(ref.act_rules), arch
        assert not got.groups


@functools.lru_cache(maxsize=None)
def _ref_state(arch, total):
    """The reference's train-state shapes and axes of ``arch``'s cell."""
    cfg = jconfigs.get_config(arch)
    dtype = (jax.numpy.bfloat16 if total > jspecs.BIG_PARAM_THRESHOLD
             else jax.numpy.float32)
    opt = jadafactor(jinverse_sqrt(peak=0.01, warmup_steps=10_000))
    tc = JTrainConfig()
    return (jax.eval_shape(lambda: jinit_train_state(
        jax.random.PRNGKey(0), cfg, opt, dtype=dtype, tc=tc)),
        jstate_axes(cfg, dtype=dtype, tc=tc))


def _ref_argument_bytes(arch, profile, total):
    """Sum over the reference's train state and batch of each leaf's
    shard bytes under ``spec_for`` on (16, 16)."""
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    cfg = jconfigs.get_config(arch)
    ctx = jspecs.make_ctx(jmesh, cfg, jspecs.PROFILES[profile])
    state, axes = _ref_state(arch, total)
    sizes = dict(jmesh.shape)

    def one(rules):
        def leaf(axes, sds):
            spec = jspec_for(axes, sds.shape, jmesh, rules)
            shards = math.prod(sizes[a] for e in spec if e is not None
                               for a in ((e,) if isinstance(e, str) else e))
            return int(np.prod(sds.shape)) * sds.dtype.itemsize // shards
        return leaf

    st = jax.tree.leaves(jax.tree.map(one(ctx.param_rules), axes, state))
    batch = jspecs._batch_struct(cfg, jconfigs.SHAPES["train_4k"])
    bt = jax.tree.leaves(jax.tree.map(one(ctx.act_rules),
                                      jspecs.batch_axes(batch), batch))
    return sum(st) + sum(bt)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2.5-14b"])
@pytest.mark.parametrize("profile", ["baseline", "optimized"])
def test_argument_bytes_match_the_reference(arch, profile, ref_counts):
    _, args, info = specs.build_cell(arch, "train_4k", MESH,
                                     profile=profile)
    got = dryrun.argument_bytes(args, info["axes"], info["ctx"], "train")
    assert got["total"] == _ref_argument_bytes(arch, profile,
                                               ref_counts[arch][0])
    assert got["total"] == got["state"] + got["batch"]
