"""Collectives over a mesh axis and the explicit lookup over row shards
(counterpart of ``sml_tpu/parallel/collective.py``).

The transport. :func:`all_reduce`, :func:`all_gather` and :func:`broadcast`
run over one process group (a mesh axis, ``Mesh.group(axis)``) and are a
pass-through on a group of one rank. The group's backend is fixed when the
world starts (:func:`sml_tpu_torch.parallel.multihost.init_distributed`),
from the cards the ranks hold (:func:`backend_for`): NCCL when every rank
is on a card and no two ranks hold the same card, gloo when ranks share a
card (on one host or on two) or run on the CPU. Gloo takes CUDA tensors
for every collective used here (all-reduce, all-gather, broadcast: checked with two ranks on one H100
under torch 2.11, see ``GLOO_CUDA_COLLECTIVES``), so the port hands them
over as they are and copies nothing to the host itself; ProcessGroupGloo
stages CUDA tensors through pinned host buffers and reduces them on the
CPU inside itself, so a gloo collective of CUDA tensors still crosses host
memory. A collective that fails or outlives the group's timeout raises.

Inside a CUDA graph (``train/graphs.py``) a group of one rank makes no
collective, so a graph on a mesh of one rank is captured like any other.
A gloo collective cannot be captured, and one on a capturing stream
raises. An NCCL collective across ranks is captured where it sits in the
graph's own stream order, between the IF nodes of a step slot split at
its collectives (``train/steps.py`` ``run_slots``); inside the body of an
IF node (``graphs.step_if``) it ends the capture with
``cudaErrorInvalidValue`` (two ranks on two H100s, torch 2.11, CUDA 12.8,
NCCL 2.28: ``python -m sml_tpu_torch.scripts.nccl_capture_probe``). So a
step slot's segments run under :func:`segment`, and a collective called
inside one raises, naming it, on every device and every group size.
:func:`capture_refusal` refuses gloo across ranks (ranks sharing a card),
and nothing else: the fused programs' ``"auto"`` fuses on NCCL meshes
across cards, and only ranks that share a card stay unfused. On the CPU
nothing is captured: a program runs eagerly, with its collectives, on any
mesh.

The lookup. Every rank holds a contiguous row block of a table (block
``r`` of the group's ``M`` ranks: rows ``[r·n/M, (r+1)·n/M)``). A batch of
global ids, the same on every rank of the group, is resolved by each rank
gathering the ids it owns, zeroing the rest (:func:`owned_rows`) and
summing the ``(B, d)`` rows over the group: one all-reduce of the
activation rows instead of moving table rows. The gradient is the exact
transpose (:func:`lookup_rows`), a local scatter-add of the incoming
gradient into the owned rows **with no collective**: the incoming gradient
is already the whole loss's on every rank of the group (they all compute
the same loss), so a second reduction would count it once per shard. A
split step takes the two halves apart: the owned rows before its cut, the
summed rows after it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# The collectives the port calls, each checked on CUDA tensors over gloo
# on the card (two ranks on cuda:0, torch 2.11; dryrun.check_transport).
GLOO_CUDA_COLLECTIVES = frozenset({"all_reduce", "all_gather", "broadcast"})

# this process's place in its world, as init_distributed finds it: the
# ranks on its host, its index among them, the mesh groups' backend, and
# by rank the world's hosts and the cards the ranks hold
WORLD = {"local_rank": 0, "local_world": 1, "backend": "gloo"}


# bytes of tensors this process has handed to collectives, by the ranks of
# the group they went over (the world's ranks, sorted): counted at each
# call, so a captured collective counts once, at its capture, however
# often the graph replays it
TRAFFIC: dict = {}


def traffic(group) -> int:
    """Bytes this process has handed to collectives over ``group``
    (:data:`TRAFFIC`)."""
    return TRAFFIC.get(tuple(dist.get_process_group_ranks(group)), 0)


def backend_for(device_type: str, cards: Sequence[Optional[str]]) -> str:
    """The rule, from the card each rank of the world holds (``cards``, by
    rank: the card's UUID, None for a rank on the CPU): NCCL when the
    ranks run on cards (``device_type`` "cuda") and no two of them hold
    the same card; gloo otherwise (ranks sharing a card, whether on one
    host or on two, or on the CPU). No count of cards decides it: a rank
    that sees only its own card and a rank that sees all of them are
    told apart by the card they hold."""
    if (device_type == "cuda" and None not in cards
            and len(set(cards)) == len(cards)):
        return "nccl"
    return "gloo"


def capture_refusal(groups, device) -> Optional[str]:
    """Why a CUDA graph on ``device`` cannot hold collectives over
    ``groups``, or None where it can: on the CPU nothing is captured, a
    group of one rank makes no collective, and an NCCL collective across
    ranks is captured between IF nodes; a gloo one is not captured."""
    if torch.device(device).type != "cuda":
        return None
    for g in groups:
        if group_size(g) > 1 and dist.get_backend(g) != "nccl":
            return (f"a {dist.get_backend(g)} collective cannot be captured "
                    "in a CUDA graph (the ranks share a card, so the mesh "
                    "runs over gloo)")
    return None


def check_same(value, what: str) -> None:
    """Raise on every rank unless every rank of the world passed an equal
    ``value`` (a host object; one ``all_gather_object`` over the world's
    group). A no-op outside a world of several ranks."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    if any(v != got[0] for v in got):
        raise ValueError(f"the ranks disagree on {what}: {got} (by rank)")


# the step-slot segment this thread is running (see :func:`segment`)
_SEGMENT = threading.local()


@contextlib.contextmanager
def segment(name: str):
    """Mark the body of a split step slot's segment (``train/steps.py``
    ``run_slots``; captured, an IF node's body): a collective called
    inside it raises, naming it."""
    outer = getattr(_SEGMENT, "name", None)
    _SEGMENT.name = name
    try:
        yield
    finally:
        _SEGMENT.name = outer


def _runs(op: str, t: torch.Tensor, group) -> bool:
    """Whether collective ``op`` of ``t`` over ``group`` has work to do
    (False for a group of one rank); raises inside a step slot's segment,
    and on a capturing stream where :func:`capture_refusal` refuses."""
    inside = getattr(_SEGMENT, "name", None)
    if inside is not None:
        raise RuntimeError(
            f"{op} called inside {inside}: a step slot's collectives run at "
            "its cuts, between its IF nodes (train/steps.py run_slots)")
    if group_size(group) == 1:
        return False
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        why = capture_refusal([group], t.device)
        if why is not None:
            raise RuntimeError(why)
    key = tuple(dist.get_process_group_ranks(group))
    TRAFFIC[key] = TRAFFIC.get(key, 0) + t.numel() * t.element_size()
    return True


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def transport(group) -> str:
    """What moves a CUDA tensor over ``group``: ``"nccl"``, ``"gloo"``
    (CUDA tensors handed to gloo as they are, which stages them through
    host memory) or ``"local"`` (one rank)."""
    if group_size(group) == 1:
        return "local"
    return dist.get_backend(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (in place; returns ``t``)."""
    if not _runs("all_reduce", t, group):
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group ranks' ``t`` concatenated along dim 0, in rank order (every
    rank's ``t`` has the same shape)."""
    if not _runs("all_gather", t, group):
        return t
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.cat(out)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` of the group's rank ``src`` on every rank (in place)."""
    if not _runs("broadcast", t, group):
        return t
    dist.broadcast(t, group=group, group_src=src)
    return t


def owned_rows(table_shard, idx, group, dtype):
    """``(rows, safe, in_range)``: the rows of ``idx`` this rank holds in
    ``dtype``, 0 for the others (the lookup's contribution to its sum over
    ``group``), and where they sit in ``table_shard``. No gradient."""
    with torch.no_grad():
        rows_per = table_shard.shape[0]
        local = idx.long() - group_rank(group) * rows_per
        in_range = (local >= 0) & (local < rows_per)
        safe = torch.clamp(local, 0, rows_per - 1)
        rows = torch.where(in_range[:, None], table_shard[safe].to(dtype),
                           torch.zeros((), dtype=dtype,
                                       device=table_shard.device))
    return rows, safe, in_range


class _LookupRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_shard, summed, safe, in_range):
        ctx.save_for_backward(safe, in_range)
        ctx.shape = table_shard.shape
        ctx.table_dtype = table_shard.dtype
        return summed

    @staticmethod
    def backward(ctx, grad_rows):
        safe, in_range = ctx.saved_tensors
        # mask -> local scatter-add: the transpose of the lookup, with no
        # reduction over the group (each rank keeps its own rows' gradient).
        # index_put_(accumulate=True) adds a repeated id's rows in a fixed
        # order on the card (sorted, each id's rows serially), as the
        # single-rank path's indexing backward does: index_add_'s atomics
        # would add them in whatever order they land, and an eager and a
        # replayed step would differ in the last bits
        grad = torch.zeros(ctx.shape, dtype=grad_rows.dtype,
                           device=grad_rows.device)
        grad.index_put_((safe,), torch.where(in_range[:, None], grad_rows,
                                             torch.zeros_like(grad_rows)),
                        accumulate=True)
        return grad.to(ctx.table_dtype), None, None, None


def lookup_rows(table_shard: torch.Tensor, summed: torch.Tensor,
                safe: torch.Tensor, in_range: torch.Tensor) -> torch.Tensor:
    """The lookup's rows, ``summed`` (its :func:`owned_rows` summed over
    the group), differentiable in ``table_shard``: the gradient is the
    local scatter-add into the owned rows, with no collective."""
    return _LookupRows.apply(table_shard, summed, safe, in_range)


def collective_gather(table_shard: torch.Tensor, idx: torch.Tensor, group,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rows ``idx`` (global ids, the same on every rank of ``group``) of a
    table whose rank ``r`` of ``group`` holds the contiguous block ``r``
    (``table_shard``, ``(n/M, d)``). Returns ``(B, d)`` rows in ``dtype``
    (default the table's; the rows are cast before the sum, so a bf16
    snapshot comes back exactly as its f32 upcast), the same on every rank.
    Differentiable in ``table_shard``: the gradient is the local scatter-add
    of the owned rows, with no collective."""
    dtype = table_shard.dtype if dtype is None else dtype
    rows, safe, in_range = owned_rows(table_shard, idx, group, dtype)
    return lookup_rows(table_shard, all_reduce(rows, group), safe, in_range)


def make_sharded_mf_train_step(mesh, lr: float = 0.01, l2: float = 1e-5):
    """A BCE MF SGD step with explicit collective lookups: ``step(user_shard,
    item_shard, u, i, j) -> (user_shard, item_shard, loss)`` with both
    tables row-sharded over ``mesh``'s ``model`` axis and the id batches
    the same on every rank. The tables and their updates stay on their
    ranks; only the ``(B, d)`` activation rows cross between ranks. The
    shards are updated in place."""
    group = mesh.group("model")

    def step(user_shard, item_shard, u, i, j):
        ut = user_shard.detach().requires_grad_()
        it = item_shard.detach().requires_grad_()
        with torch.enable_grad():
            xu = collective_gather(ut, u, group)
            xi = collective_gather(it, i, group)
            xj = collective_gather(it, j, group)
            pos = torch.sum(xu * xi, -1)
            neg = torch.sum(xu * xj, -1)
            bce = (-torch.mean(torch.log(torch.sigmoid(pos) + 1e-15))
                   - torch.mean(torch.log(torch.sigmoid(-neg) + 1e-15)))
            reg = l2 * 0.5 * (torch.sum(xu * xu) + torch.sum(xi * xi)
                              + torch.sum(xj * xj))
            loss = bce + reg
            gu, gi = torch.autograd.grad(loss, [ut, it])
        with torch.no_grad():
            user_shard.sub_(lr * gu)
            item_shard.sub_(lr * gi)
        return user_shard, item_shard, loss.detach()

    return step
