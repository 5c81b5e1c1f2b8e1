"""Expert-parallel sorted dispatch: ragged all-to-all over the mesh's
``model`` ranks (port of ``repro/core/ep.py``).

The ``moe.ep="a2a"`` regime: **tokens move, weights stay**. Each rank
holds ``E / ep`` experts of every expert leaf (their natural
PARAM_RULES placement on ``model``) and runs the grouped-GEMM kernels
over only those; token rows cross the ``model`` group through two
all-to-alls (dispatch + return). Each rank:

1. flattens its routing groups into one assignment stream and
   partitions it by DESTINATION PEER (``expert // E_loc``), in stream
   order;
2. packs rows into a send buffer with a *static* per (src, dst) row
   budget — assignments past the budget are dropped exactly like
   capacity overflow (``ep_overflow_frac``);
3. exchanges token rows and local-expert ids through the group's
   all-to-all, in equal splits of ``budget`` rows (the reference's
   tiled ``lax.all_to_all``);
4. sorts the received rows by local expert into the block-aligned
   ragged layout of the single-device sorted path
   (``kernels/grouped_mlp.ragged_destinations``) and runs
   ``ops.grouped_mlp`` (the grouped forward, dx and dW kernels on the
   card);
5. returns the results through the mirror all-to-all and combines on
   the SOURCE rank (weight multiply + ``routing.sum_rows``, the
   fixed-order combine), so combine weights never travel.

The rows' all-to-all is differentiable (its backward is the same
exchange of the gradient), so autograd carries the gradients of the
rank's tokens and of its experts from every source. The reference's
psum transpose of the replicated-in expert weights — the sum of their
gradients over the non-``model`` axes — is the train step's reduction
(``training/train_loop.py``). The module calls the group's collectives
and nothing else: the transport is the process group's (NCCL across
cards, gloo on the CPU or between ranks sharing a card).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig, MoECfg
from repro_torch.core import routing as R
from repro_torch.kernels.grouped_mlp import ROW_BLOCK, ragged_destinations
from repro_torch.sharding import comm


def ep_row_budget(n_local: int, ep: int, factor: float, block: int) -> int:
    """Static per-(src, dst) peer row budget: ``factor`` times the
    balanced share of the local assignments, block-aligned, capped at
    ``n_local`` (a source can never send more than everything to one
    peer — ``factor >= ep`` therefore guarantees zero EP drops)."""
    b = -(-int(n_local * factor) // ep)
    b = max(block, -(-b // block) * block)
    return min(b, -(-n_local // block) * block)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    comm._count("ep_all_to_all", x)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The equal-split exchange; its backward is the same exchange of
    the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group):
    """Equal-split all-to-all of ``x``'s rows over ``group`` (one block
    of ``budget`` rows a peer; differentiable for floating ``x``); each
    exchange's input counted as ``ep_all_to_all``
    (``sharding/comm.py``)."""
    if x.is_floating_point():
        return _AllToAll.apply(x, group)
    return _exchange(x, group)


def sorted_dispatch_ep(params, xg, r: R.Routing, cfg: ArchConfig,
                       moe: MoECfg, *, ctx, implementation: str,
                       block: int = ROW_BLOCK):
    """Expert-parallel sorted dispatch of this rank's groups. xg:
    (G_loc, g, d) -> (y (G_loc, g, d), ep_overflow_frac scalar, summed
    over every rank). ``params["experts"]`` holds this rank's ``E /
    ep`` experts; the caller (``core.moe.moe_apply``) checked that
    ``expert_parallel_layout(ctx.mesh, E)`` is not None and that this
    rank's tokens form whole groups."""
    from repro_torch.kernels import ops
    from repro_torch.sharding import all_reduce, expert_parallel_layout

    E = moe.num_experts
    ep_axis, ep, token_axes = expert_parallel_layout(ctx.mesh, E)
    group = ctx.group((ep_axis,))
    E_loc = E // ep
    Gl, g, d = xg.shape
    dev = xg.device
    tok, eid, w = R.assignment_stream(r, E, g)  # (Gl, N) each
    N = tok.shape[1]
    Nl = Gl * N
    budget = ep_row_budget(Nl, ep, moe.ep_budget_factor, block)

    # ---- pack by destination peer -----------------------------------
    eidf = eid.reshape(Nl).long()
    valid = (eidf < E) & (tok.reshape(Nl) < g)
    peer = torch.where(valid, eidf // E_loc, torch.full_like(eidf, ep))
    onehot = (peer[:, None] == torch.arange(ep, device=dev)[None, :]
              ).to(torch.int32)
    rank = ((torch.cumsum(onehot, 0, dtype=torch.int32) - onehot)
            * onehot).sum(1)
    keep = valid & (rank < budget)  # overflow dropped like capacity
    slot = torch.where(keep, peer * budget + rank,
                       torch.full_like(peer, ep * budget))

    experts = None if r.token_expert is not None else E
    # The send buffer's rows as a row map of the stream's units: each
    # unit's rows in stream order; rows past the budget (or dropped)
    # land in the cut-off row ep * budget.
    units, A = R.stream_units(xg, tok, experts)
    m = R.row_map(slot.reshape(-1, A), ep * budget)
    send_x = R.take_rows(units, m)
    send_e = torch.full((ep * budget + 1,), E_loc, dtype=torch.int32,
                        device=dev).index_copy(
        0, slot, torch.where(keep, eidf % E_loc,
                             torch.full_like(eidf, E_loc)).to(torch.int32)
    )[:ep * budget]

    # ---- dispatch all-to-all (tokens + local-expert ids) ------------
    recv_x = _all_to_all(send_x, group)
    recv_e = _all_to_all(send_e, group)

    # ---- local ragged sort by expert + grouped GEMM -----------------
    # The single-device path's layout (recv_e == E_loc marks an empty
    # row; counts (1, E_loc) feed the kernels directly).
    Rr = ep * budget
    perm, _, counts, dest, M = ragged_destinations(recv_e[None], E_loc,
                                                   block)
    perm, dest = perm[0].long(), dest[0].long()
    xs = recv_x.new_zeros((M + 1, d)).index_copy(
        0, dest, recv_x[perm])[:M]
    ex = params["experts"]
    # A local expert takes at most ``cap`` rows of each of the model
    # group's Gl * ep routing groups (the meta route's bound).
    ys = ops.grouped_mlp(
        xs[None], ex["wi"], ex.get("wg"), ex["wo"], counts,
        act=cfg.act, block=block, implementation=implementation,
        max_rows=min(Rr, E_loc * R.capacity(g, moe) * Gl * ep),
    )[0]

    # ---- return all-to-all + combine on the source ------------------
    ys_pad = torch.cat([ys, ys.new_zeros((1, d))], 0)
    y_recv = ys_pad.new_zeros((Rr, d)).index_copy(0, perm, ys_pad[dest])
    y_ret = _all_to_all(y_recv, group)
    w_eff = torch.where(keep, w.reshape(Nl), torch.zeros_like(
        w.reshape(Nl)))
    w_row = w_eff.new_zeros(ep * budget + 1).index_copy(
        0, slot, w_eff)[:ep * budget]
    yw = (y_ret * w_row[:, None]).to(xg.dtype)
    y = R.units_to_tokens(R.sum_rows(yw, m), tok, g, experts)

    # ---- overflow metric (EP drops on top of capacity drops) --------
    counts_over = torch.stack([(valid & ~keep).sum(), valid.sum()]).float()
    counts_over = all_reduce(counts_over, ctx.group(token_axes))
    over_frac = counts_over[0] / torch.clamp(counts_over[1], min=1.0)
    return y, over_frac
