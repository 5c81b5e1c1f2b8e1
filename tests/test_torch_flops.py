"""A step's counted cost (``repro_torch.launch.flops``), the kernels'
work counters (``kernels.build.count_work``) and their shape-only route
on the meta device (``kernels/ops.py``), and the dry run's record
(``repro_torch.launch.dryrun``). No card: the meta route stands in for
the kernels, whose work models it records. Exact."""
import json

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import ops, tiling
from repro_torch.kernels.build import count_work
from repro_torch.kernels.grouped_mlp import KERNEL as GROUPED
from repro_torch.launch import dryrun, flops
from repro_torch.launch.mesh import PEAK_FLOPS_BF16
from repro_torch.models import model_zoo as zoo
from repro_torch.models import stack as stk
from repro_torch.optim import adafactor, inverse_sqrt
from repro_torch.training import init_train_state, make_train_step
from torch_threads import one_thread  # noqa: F401 (autouse)

B, S = 2, 16


def _meta_cell(dispatch="sorted"):
    """A reduced granite train cell on the meta device: (step, state,
    batch, cfg)."""
    cfg = get_reduced("granite-moe-1b-a400m")
    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=10))
    state = init_train_state(None, cfg, opt, device="meta")
    batch = {k: torch.empty(B, S, dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    step = make_train_step(cfg, opt, ac=zoo.ApplyCfg(dispatch=dispatch))
    return step, state, batch, cfg


@pytest.mark.parametrize("dispatch", ["sorted", "gather"])
def test_meta_train_step_counts_aten_plus_kernels(dispatch):
    step, state, batch, cfg = _meta_cell(dispatch)
    (new, mets), cost = flops.step_cost(step, state, batch)
    assert mets["loss"].device.type == "meta"
    assert cost["total_flops"] == cost["aten_flops"] + sum(
        cost["kernel_flops"].values())
    assert cost["aten_flops"] > 0 and cost["aten_bytes"] > 0
    descs = stk.layer_descs(cfg)
    n_attn = sum(d.mixer == "attn" for d in descs)
    n_moe = sum(d.ffn == "moe" for d in descs)
    moe = ("grouped_mlp", "grouped_mlp_dx", "grouped_mlp_dw") \
        if dispatch == "sorted" else ("expert_mlp", "expert_mlp_dx",
                                      "expert_mlp_dw")
    want = {k: n_attn for k in ("flash_attention", "flash_attention_dq",
                                "flash_attention_dkv")}
    want.update({k: n_moe for k in moe})
    assert cost["kernel_calls"] == want
    # each flash call at the step's shapes, causal from position 0
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for name, kind in (("flash_attention", "fwd"),
                       ("flash_attention_dq", "dq"),
                       ("flash_attention_dkv", "dkv")):
        nbytes, fl = tiling.flash_work(kind, B, S, S, H, Kh, dh,
                                       causal=True, itemsize=4)
        assert cost["kernel_flops"][name] == n_attn * fl
        assert cost["kernel_bytes"][name] == n_attn * nbytes


def test_meta_grouped_work_is_the_capacity_full_bound():
    """On the meta device a grouped call counts min(E cap, g k) valid
    rows a group and every expert live."""
    from repro_torch.core.routing import capacity
    from repro_torch.kernels.grouped_mlp import ROW_BLOCK, ragged_buffer_rows

    step, state, batch, cfg = _meta_cell("sorted")
    _, cost = flops.step_cost(step, state, batch)
    moe = cfg.moe
    g = min(moe.group_size, B * S)
    G = -(-B * S // g)
    n = g * moe.top_k
    rows = min(moe.num_experts * capacity(g, moe), n)
    M = ragged_buffer_rows(n, moe.num_experts, ROW_BLOCK)
    n_moe = sum(d.ffn == "moe" for d in stk.layer_descs(cfg))
    for name, kind in (("grouped_mlp", "fwd"), ("grouped_mlp_dx", "dx"),
                       ("grouped_mlp_dw", "dw")):
        nbytes, fl = tiling.grouped_work(
            kind, G, M, cfg.d_model, cfg.d_ff, moe.num_experts, G * rows,
            moe.num_experts, gated=cfg.gated_mlp, itemsize=4)
        assert cost["kernel_flops"][name] == n_moe * fl, name
        assert cost["kernel_bytes"][name] == n_moe * nbytes, name


def test_counters_stay_zero_outside_count_work():
    ops.reset_launch_counts()
    step, state, batch, _ = _meta_cell()
    step(state, batch)  # the meta route, no count open
    with count_work() as w:
        pass
    assert (w.calls, w.flops, w.bytes) == ({}, {}, {})
    # the meta route is no launch
    assert all(v == 0 for v in ops.launch_counts().values())
    # the plain versions on the CPU record no kernel work either
    cfg = get_reduced("granite-moe-1b-a400m")
    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=10))
    st = init_train_state(0, cfg, opt, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32)
    _, cost = flops.step_cost(make_train_step(cfg, opt), st,
                              {"tokens": toks, "targets": toks})
    assert cost["kernel_calls"] == {} and cost["aten_flops"] > 0


def test_work_count_reads_device_scalars_once_at_close():
    with count_work() as w:
        GROUPED.record(lambda: (torch.tensor(5), torch.tensor(7)))
        GROUPED.record(lambda: (3, torch.tensor(11)))
        assert isinstance(w.flops["grouped_mlp"][0], torch.Tensor)
    assert (w.calls, w.bytes, w.flops) == ({"grouped_mlp": 2},
                                           {"grouped_mlp": 8},
                                           {"grouped_mlp": 18})
    with count_work():
        with pytest.raises(RuntimeError, match="nest"):
            with count_work():
                pass


def test_meta_route_resolution():
    meta, cpu = torch.empty(1, device="meta"), torch.empty(1)
    assert ops.resolve("auto", meta) == "meta"
    assert ops.resolve("cuda", meta) == "meta"
    assert ops.resolve("eager", meta) == "eager"
    assert ops.resolve("auto", cpu) == "eager"
    with pytest.raises(ValueError):
        ops.resolve("cuda", cpu)
    assert zoo.ApplyCfg().resolve("meta").moe_impl == "cuda"
    assert zoo.ApplyCfg().resolve("cpu").attn_impl == "eager"


def test_model_flops_and_utilization():
    cfg = get_reduced("granite-moe-1b-a400m")
    assert flops.model_flops(cfg, "train", 10, 7) == 420
    assert flops.model_flops(cfg, "decode", 10, 7) == 140
    u = flops.utilization(2e12, 4e12, 0.5)
    assert u == {"mfu": 2e12 / (0.5 * PEAK_FLOPS_BF16),
                 "hardware_flops_util": 4e12 / (0.5 * PEAK_FLOPS_BF16),
                 "useful_flops_ratio": 0.5}


def test_ep_a2a_bytes_by_hand():
    """Granite over 2 expert-parallel ranks, 2,048 tokens a rank in one
    group, top-8: 16,384 assignments, a budget of factor x the balanced
    share a peer (block-aligned), rows of d f32 out and back and int32
    ids."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, ep="a2a", ep_budget_factor=2.0, group_size=2048))
    got = dryrun.ep_a2a_bytes(cfg, tokens_per_rank=2048, ep=2, itemsize=4)
    budget = 16384  # min(2.0 x 16384 / 2, 16384), a multiple of 16
    assert got == {"forward": 2 * budget * (2 * 1024 * 4 + 4),
                   "backward": 2 * budget * 2 * 1024 * 4}
    coll = dryrun.collective_bytes(
        cfg, kind="train", params=zoo.init_params(None, cfg, device="meta"),
        dispatch="sorted", remat="none", mesh={"data": 1, "model": 2},
        tokens=4096, itemsize=4)
    assert coll["a2a_forward"] == cfg.n_layers * got["forward"]
    assert coll["a2a_backward"] == cfg.n_layers * got["backward"]
    assert coll["counts"] == {"all-reduce": 1, "all-to-all": 5 * 24}


def test_dryrun_main_writes_the_record(tmp_path):
    dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape", "train_4k",
                 "--mesh", "pod", "--profile", "optimized", "--out",
                 str(tmp_path)])
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    for key in ("params_total", "params_active", "param_dtype", "n_chips",
                "flops_per_device", "model_flops_per_device",
                "useful_flops_ratio", "collective_bytes_per_device"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["params_active"] == 428_068_864
    assert rec["memory"]["argument_bytes"] > 0
    mem = rec["memory"]
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    assert mem["total_bytes"] == mem["peak_bytes"] == (
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"])
    assert "absent" not in mem
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "step_time_lower_bound_s"}
    assert rec["roofline"]["step_time_lower_bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    assert 0 < rec["useful_flops_ratio"] < 1.5
    assert rec["attention"]["flash_flops"] > 0
