"""The other families' train step under the rules' placement on
``gloo`` ranks on the CPU, (data=2, model=2), against the reference's
sharded step (``tests/torch_mesh_steps.py``).

Reduced jamba (7 mamba layers and one attention layer, a MoE of 4
experts top-2 every other layer; the mamba mixers' leaves joined over
``model`` at the top of the step, ``sharding/comm.params_for_compute``,
as GSPMD's placement computes them), pixtral (the patch frontend
replacing the first positions' embeddings) and rwkv6 (the time mix
joined in training, the WKV through its plain chunked version) each take
one ``make_train_step`` step under ``train_layout`` on a global batch of
8 x 32 (jamba's data ranks hold whole routing groups of 64), against the
reference's jitted ``make_train_step(ctx=)`` on a forced 4-device (2, 2)
mesh (loss rtol 2e-4, every parameter atol 2e-4 and rtol 2e-3) and
against the port's one process (every leaf of the state at the same
tolerances; the reduced gradients within 1e-3 of each leaf's largest).
The bytes every rank counts through each kind of collective equal
``launch/dryrun.rules_collective_payloads``. One spawn of 4 ranks and two
reference subprocesses; the ranks import torch and the port only.
"""
import os
import subprocess
import sys

import pytest
import torch

import torch_mesh_steps as ms
from torch_threads import one_thread  # noqa: F401 (autouse)

WORLD = 4
CASES = ("jamba", "pixtral", "rwkv")


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx

    ctx = ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model")))
    out = {case: ms.mesh_step(case, ctx) for case in CASES}
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the one process's, the reference's). The
    reference runs in two subprocesses (jamba; pixtral and rwkv) and the
    one process here while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("mesh_families"))
    ms.save_inputs(tmp, CASES)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   ["src", os.environ.get("PYTHONPATH", "")]))
    refs = [subprocess.Popen([sys.executable, "-c", ms.REFERENCE, tmp,
                              *part], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
            for part in (("jamba",), ("pixtral", "rwkv"))]
    procs = torch.multiprocessing.start_processes(
        _worker, args=(WORLD, tmp), nprocs=WORLD, join=False,
        start_method="spawn")
    try:
        one = {case: ms.one_step(case) for case in CASES}
        while not procs.join():
            pass
    finally:
        errs = [ref.communicate(timeout=600)[1] for ref in refs]
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err.decode()[-3000:]
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, one, {case: ms.load_reference(tmp, case)
                        for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_mesh_step_matches_reference_and_one_process(runs, case):
    ranks, one, ref = runs
    for got in ranks:
        ms.hold(got[case], one[case], ref[case])


@pytest.mark.parametrize("case", CASES)
def test_collective_payloads_match_the_dry_run(runs, case):
    """FSDP's gathers and scatters, the joined mixer leaves
    (``model_all_gather``: mamba's and the rwkv time mix's), the
    attention's, FFNs' and MoE's all-reduces, the router's gathers, the
    vocab-parallel lookup, head and cross-entropy."""
    ranks, _, _ = runs
    want = ms.payloads(case)
    for got in ranks:
        assert got[case]["counts"] == want
    assert want["model_all_gather"] > 0 or case == "pixtral"
