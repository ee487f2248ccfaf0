"""Meshes and row-sharded state (counterpart of
``sml_tpu/parallel/sharding.py``).

A mesh is the R ranks of a ``torch.distributed`` world, one process per
rank, laid out ``(n_data, n_model)`` as a ``DeviceMesh`` with
``mesh_dim_names=("data", "model")``; each axis's process group comes from
it. The placement rule is the JAX package's:

* every state leaf whose first dimension is the user or the item count
  (tables, bias tables, the ``last``/``hat`` snapshots, both Adam moments
  of the tables) is **row-sharded over 'model'**: model rank ``m`` of ``M``
  keeps the contiguous block ``[m·n/M, (m+1)·n/M)``, and the plan records
  the leaf's global row count and the block's offset (:class:`RowBlock`);
* a row-aligned leaf whose row count does not divide by ``M`` stays
  replicated, as does everything else (Θ, its optimizer state, counts, the
  generator);
* batches are sharded over 'data': data rank ``d`` of ``D`` keeps rows
  ``[d·n/D, (d+1)·n/D)``.

Without GSPMD the epochs cannot follow the data by themselves: what XLA
inserts, :class:`TableLayout` writes out (lookups through the collective
lookup of ``parallel/collective.py``, gradients and losses reduced over
'data' only, see ``train/steps.py``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.parallel import collective

AXES = ("data", "model")


class Mesh:
    """A ``(data, model)`` grid over every rank of the world, row-major
    (rank ``r`` sits at ``(r // n_model, r % n_model)``). ``group(axis)``
    is that axis's process group through this rank."""

    def __init__(self, n_data: int, n_model: int):
        from torch.distributed.device_mesh import init_device_mesh
        world = dist.get_world_size()
        if n_data * n_model != world:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                             f"{n_data * n_model} ranks, the world has "
                             f"{world}")
        self.shape = {"data": n_data, "model": n_model}
        # the axes' groups take the world's rule (collective.backend_for);
        # the mesh's device type moves no tensor: a collective runs on the
        # device its tensors are on
        self.transport = collective.WORLD["backend"]
        if self.transport == "nccl":
            # the rank's card was set when the world started
            # (init_distributed); DeviceMesh picks one itself (rank %
            # device_count) only where CUDA is not initialized yet, which
            # the world's exchange of card identities has done
            dev = collective.WORLD["device"]
            self.device_mesh = init_device_mesh(
                "cuda", (n_data, n_model), mesh_dim_names=AXES,
                backend_override={a: "nccl" for a in AXES})
            if torch.cuda.current_device() != dev.index:
                raise RuntimeError(
                    f"the mesh moved this rank to cuda:"
                    f"{torch.cuda.current_device()}, not its card {dev}")
            # every axis's communicator made now, by an eager collective on
            # it, in the same order on every rank: NCCL makes one at its
            # group's first collective, which must not fall inside a
            # capture
            for a in AXES:
                collective.all_reduce(torch.zeros(1, device=dev),
                                      self.group(a))
        else:
            self.device_mesh = init_device_mesh(
                "cpu", (n_data, n_model), mesh_dim_names=AXES)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def make_mesh(n_data: int = 1, n_model: Optional[int] = None) -> Mesh:
    """A ``(n_data, n_model)`` mesh over the world's ranks; ``n_model``
    defaults to ``R // n_data``. Every rank calls it (it creates the axes'
    process groups)."""
    if n_model is None:
        n_model = dist.get_world_size() // n_data
    return Mesh(n_data, n_model)


class RowBlock(NamedTuple):
    """This rank's rows of a row-sharded leaf."""
    rows: int     # the leaf's global row count
    offset: int   # the global row of the block's first row
    local: int    # rows in the block


def row_block(n_rows: int, mesh: Mesh, n_users: int,
              n_items: int) -> Optional[RowBlock]:
    """The placement rule for a leaf of ``n_rows`` rows: its block over
    'model', or None where it stays replicated."""
    m = mesh.shape["model"]
    if n_rows not in (n_users, n_items) or n_rows % m:
        return None
    per = n_rows // m
    return RowBlock(n_rows, mesh.index("model") * per, per)


SNAPSHOTS = ("last_user", "last_item", "hat_user", "hat_item")
# the row-aligned leaves of an SMLState, by path
TABLE_PATHS = (tuple(f"mf/{f}" for f in MFParams._fields) + SNAPSHOTS
               + tuple(f"mf_opt/{part}/{f}" for part in ("mu", "nu")
                       for f in MFParams._fields))


def leaf_side(path: str) -> str:
    """``"user"`` or ``"item"``: the table a row-aligned leaf follows."""
    return "user" if "user" in path.rsplit("/", 1)[-1] else "item"


def table_leaves(state) -> Dict[str, torch.Tensor]:
    """The leaves of an ``SMLState`` that the placement rule considers, by
    path: the MF tables, the snapshots and the MF Adam moments. Θ and its
    optimizer state are replicated by construction."""
    out = {f"mf/{f}": getattr(state.mf, f) for f in MFParams._fields}
    for f in SNAPSHOTS:
        out[f] = getattr(state, f)
    for part in ("mu", "nu"):
        for name, t in getattr(state.mf_opt, part).items():
            out[f"mf_opt/{part}/{name}"] = t
    return out


def replace_table_leaves(state, leaves: Dict[str, torch.Tensor]):
    """``state`` with the table leaves at the paths of ``leaves`` replaced."""
    mf = state.mf._replace(**{p.split("/", 1)[1]: t
                              for p, t in leaves.items()
                              if p.startswith("mf/")})
    opt = state.mf_opt
    moments = {part: {**getattr(opt, part),
                      **{p.rsplit("/", 1)[1]: t for p, t in leaves.items()
                         if p.startswith(f"mf_opt/{part}/")}}
               for part in ("mu", "nu")}
    snaps = {p: t for p, t in leaves.items() if "/" not in p}
    return state._replace(mf=mf, mf_opt=opt._replace(**moments), **snaps)


def state_shardings(tree, mesh: Mesh, n_users: int, n_items: int
                    ) -> Dict[str, Optional[RowBlock]]:
    """The per-leaf plan: ``{path: RowBlock or None}`` for the table leaves
    of ``tree``, a global ``SMLState``; with ``tree=None`` for those of any
    ``SMLState`` of these counts (each leaf follows its side's table), so a
    state can be built sharded without a global one."""
    if tree is None:
        rows = {p: n_users if leaf_side(p) == "user" else n_items
                for p in TABLE_PATHS}
    else:
        rows = {p: t.shape[0] for p, t in table_leaves(tree).items()}
    return {p: row_block(n, mesh, n_users, n_items)
            for p, n in rows.items()}


def shard_rows(t: torch.Tensor, block: Optional[RowBlock]) -> torch.Tensor:
    """This rank's block of ``t`` as a tensor of its own (``t`` itself where
    the leaf is replicated)."""
    if block is None:
        return t
    return t[block.offset:block.offset + block.local].clone()


def shard_state(state, mesh: Mesh, n_users: int, n_items: int):
    """Each rank keeps its row blocks of the row-aligned leaves of a global
    ``SMLState``; every other leaf stays as it is."""
    plan = state_shardings(state, mesh, n_users, n_items)
    leaves = table_leaves(state)
    return replace_table_leaves(state, {p: shard_rows(leaves[p], b)
                                        for p, b in plan.items()})


def data_slice(n: int, mesh: Mesh) -> slice:
    """This rank's block of ``n`` rows over 'data'."""
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(f"{n} rows do not divide over {d} data ranks")
    per = n // d
    lo = mesh.index("data") * per
    return slice(lo, lo + per)


def shard_batch(padded, mesh: Mesh):
    """This rank's block over 'data' of padded rows (and their mask and
    packed candidate mask). ``n_real`` stays the global count: sums over
    the blocks are reduced over 'data' before anything divides by it."""
    sl = data_slice(padded.rows.shape[0], mesh)
    cm = padded.cand_mask
    return padded._replace(rows=padded.rows[sl], mask=padded.mask[sl],
                           cand_mask=None if cm is None else cm[sl])


def replicate(tree, mesh: Mesh):
    """Every tensor of a tensor, tuple, list or dict as rank 0 holds it, on
    every rank (broadcast over 'model', then over 'data'), in place."""
    if isinstance(tree, torch.Tensor):
        collective.broadcast(tree, mesh.group("model"))
        return collective.broadcast(tree, mesh.group("data"))
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [replicate(v, mesh) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree


class TableLayout:
    """What the epochs, the refresh and the evaluation need to run on row
    shards under a mesh: which side's tables are sharded and where this
    rank's block starts, this rank's block of a batch, and the reductions
    over 'data'. Built by ``SMLEngine.set_mesh``."""

    def __init__(self, mesh: Mesh, n_users: int, n_items: int):
        self.mesh = mesh
        self.blocks = {"user": row_block(n_users, mesh, n_users, n_items),
                       "item": row_block(n_items, mesh, n_users, n_items)}
        self.model_group = mesh.group("model")
        self.data_group = mesh.group("data")

    def sharded(self, side: str) -> bool:
        return self.blocks[side] is not None

    def data_slice(self, n: int) -> slice:
        return data_slice(n, self.mesh)

    def owned_into(self, out: torch.Tensor, lookups) -> list:
        """The half of a lookup before its sum over 'model': this rank's
        rows of each sharded ``(table, idx, side)`` lookup (0 where another
        rank owns the id) written into ``out``, one block after another.
        Returns, per lookup, its rows' ``(safe, in_range)``, or None where
        its side is replicated. No gradient."""
        owned, k = [], 0
        for table, idx, side in lookups:
            if not self.sharded(side):
                owned.append(None)
                continue
            rows, safe, in_range = collective.owned_rows(
                table, idx, self.model_group, out.dtype)
            out[k:k + rows.shape[0]].copy_(rows)
            k += rows.shape[0]
            owned.append((safe, in_range))
        if k != out.shape[0]:
            raise ValueError(f"{k} owned rows for a buffer of "
                             f"{out.shape[0]}")
        return owned

    def rows_from(self, lookups, summed: torch.Tensor, owned) -> list:
        """The half after the sum: the rows of every lookup, the sharded
        ones from ``summed`` (:meth:`owned_into`'s buffer summed over
        'model'; ``owned`` its result), the replicated ones by indexing,
        in ``summed``'s dtype. A lookup whose table requires a gradient is
        differentiable in it (for a sharded side the local scatter-add,
        with no collective)."""
        out, k = [], 0
        for (table, idx, _), mine in zip(lookups, owned):
            if mine is None:
                out.append(table[idx.long()].to(summed.dtype))
                continue
            rows = summed[k:k + idx.shape[0]]
            k += idx.shape[0]
            out.append(collective.lookup_rows(table, rows, *mine)
                       if table.requires_grad else rows)
        return out

    def rows_many(self, lookups, dtype: torch.dtype = torch.float32):
        """Rows of several ``(table, idx, side)`` lookups in ``dtype`` (no
        gradient), the sharded ones through one all-reduce over 'model'."""
        n = sum(idx.shape[0] for _, idx, side in lookups
                if self.sharded(side))
        buf = torch.zeros((n, lookups[0][0].shape[1]), dtype=dtype,
                          device=lookups[0][0].device)
        owned = self.owned_into(buf, lookups)
        if n:
            collective.all_reduce(buf, self.model_group)
        return self.rows_from(lookups, buf, owned)

    def whole(self, table: torch.Tensor, side: str) -> torch.Tensor:
        """The whole ``side`` table on every rank (all-gathered over
        'model' where it is sharded)."""
        if not self.sharded(side):
            return table
        return collective.all_gather(table, self.model_group)

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        return collective.all_reduce(t, self.data_group)

    def gather_data(self, flat: torch.Tensor, parts: int) -> list:
        """``flat``, this rank's blocks of ``parts`` equal parts of a batch
        one after another, as the whole batch's parts: one all-gather over
        'data', each part the data ranks' blocks in order."""
        per_rank = collective.all_gather(flat, self.data_group).chunk(
            self.mesh.shape["data"])
        return [torch.cat([r.chunk(parts)[k] for r in per_rank])
                for k in range(parts)]

    def sum_rows(self, t: torch.Tensor, side: str) -> torch.Tensor:
        """A sum over a ``side`` leaf's local rows, summed over 'model'
        where the leaf is sharded."""
        if not self.sharded(side):
            return t
        return collective.all_reduce(t, self.model_group)
