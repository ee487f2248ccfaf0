"""Adam with the JAX package's (torch-compatible) semantics (counterpart of
``sml_tpu/train/optim.py``).

The reference trains the MF tables with ``torch.optim.Adam(weight_decay=0)``
and Θ with ``weight_decay=TR_l2``; the JAX package reproduces that with the
optax chain ``add_decayed_weights(wd) -> scale_by_adam -> scale(-lr)``: L2
is added to the gradient before the moments, and the step is
``m_hat / (sqrt(v_hat) + eps)``. :func:`adam_update` is that chain as plain
tensor ops in the same order, so both packages round alike.
``torch.optim.Adam`` is not used: it computes
``lr/bc1 * m / (sqrt(v)/sqrt(bc2) + eps)``, which rounds differently, and
Adam's normalisation magnifies that over a sweep.

State is an :class:`AdamState`: the step count as a host ``int`` (so no
step waits on the device) and the moments as ``{name: tensor}`` maps whose
names are the leaf paths of the JAX optimizer state (``user_emb``,
``user/fc1_w``); :func:`opt_state_from_numpy` carries a JAX state across.
Parameters and moments are updated in place.

The bias corrections ``1 - b**t`` are computed on the host in f32 from the
count (:func:`bias_corrections`) and divide as 0-d tensors on the device.
A step that a CUDA graph replays (``train/graphs.py``) cannot take them by
value: the replay would repeat the captured step's numbers. There the
state's ``bias`` is a :class:`BiasTable`, a device buffer of one
``(bc1, bc2)`` pair per step slot of the captured region, filled on the
host with the same f32 values before every replay for the steps that run;
the steps read their pair through fixed views, so they round exactly as
the by-value steps do.

:func:`sparse_dense_adam_update` is the same step for row-sparse table
gradients with exact dense semantics: a full-table g=0 pass (kernel K3 on
the card, :mod:`sml_tpu_torch.ops.adam_kernel`) and an exact fix-up of the
touched rows.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.ops.adam_kernel import fused_decay_adam_multi

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class AdamState(NamedTuple):
    count: int                      # steps taken
    mu: Dict[str, torch.Tensor]     # first moments, by leaf name
    nu: Dict[str, torch.Tensor]     # second moments, by leaf name
    # where steps read their bias corrections: None, from ``count`` on the
    # host; a BiasTable inside a captured region
    bias: Optional["BiasTable"] = None


class TableGrad(NamedTuple):
    """Row-sparse gradient of a table: ``rows[k]`` is the gradient of row
    ``idx[k]``; ``idx`` may repeat."""
    idx: torch.Tensor    # (K,) int64
    rows: torch.Tensor   # (K, d)


def adam_init(params: Mapping) -> AdamState:
    """Zero moments shaped like ``params`` (``{name: tensor}``)."""
    return AdamState(
        0, {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for n, p in params.items()},
        {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
         for n, p in params.items()})


def bias_corrections(count: int, b1: float = ADAM_B1,
                     b2: float = ADAM_B2):
    """``(1 - b1**count, 1 - b2**count)`` computed in float32 from the
    integer step count, as the JAX package computes them; returned as
    Python floats that hold the f32 values exactly."""
    t = np.float32(count)
    return (float(np.float32(1.0) - np.power(np.float32(b1), t)),
            float(np.float32(1.0) - np.power(np.float32(b2), t)))


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-d f32 tensor on the device: dividing by it is a true division
    # on the card, where a host scalar becomes a reciprocal multiply
    return torch.full((), value, dtype=torch.float32, device=like.device)


class BiasTable:
    """The bias corrections of the Adam steps of a captured region in one
    ``(epochs * slots, 2)`` f32 buffer on ``device``: row ``e * slots + b``
    belongs to step slot ``b`` of epoch ``e``. :meth:`fill` writes them for
    a new ``base`` count and the run's ``taken`` slots per epoch (one
    host-to-device copy, ordered on the current stream): slot ``(e, b)``,
    ``b < taken``, holds ``(bc1, bc2)`` of count ``base + 1 + e * taken +
    b``. A step reads its slot's row through :meth:`at`, whose views keep
    their addresses, so a CUDA graph that captured every slot reads each
    replay's values whatever ``taken`` is. Inside the region the steps'
    count runs over slots: epoch ``e`` starts at :meth:`epoch_count`."""

    def __init__(self, slots: int, device, epochs: int = 1,
                 b1: float = ADAM_B1, b2: float = ADAM_B2):
        self.slots, self.epochs, self.b1, self.b2 = slots, epochs, b1, b2
        self.buf = torch.zeros((epochs * slots, 2), dtype=torch.float32,
                               device=device)
        self.base = 0

    def fill(self, base: int, taken: Optional[int] = None) -> None:
        """Rows for a region from count ``base`` whose epochs take their
        first ``taken`` slots (default all), each pair the f32 values
        :func:`bias_corrections` gives; untaken slots hold 1.0."""
        taken = self.slots if taken is None else taken
        vals = np.ones((self.epochs, self.slots, 2), dtype=np.float32)
        for e in range(self.epochs):
            for b in range(min(taken, self.slots)):
                vals[e, b] = bias_corrections(base + 1 + e * taken + b,
                                              self.b1, self.b2)
        vals = torch.from_numpy(vals.reshape(-1, 2))
        if self.buf.is_cuda:
            # pinned, so the copy is ordered on the stream (the previous
            # replay may still read the buffer) and the host goes on
            self.buf.copy_(vals.pin_memory(), non_blocking=True)
        else:
            self.buf.copy_(vals)
        self.base = base

    def epoch_count(self, e: int) -> int:
        """The slot count epoch ``e``'s steps start from."""
        return self.base + e * self.slots

    def at(self, count: int, b1: float, b2: float):
        """``(bc1, bc2)`` of the step whose slot count is ``count`` (slot
        row ``count - base - 1``) as 0-d views of the buffer."""
        k = count - self.base - 1
        if not 0 <= k < self.buf.shape[0] or (b1, b2) != (self.b1, self.b2):
            raise ValueError(f"step {count} with b1={b1}, b2={b2} is not in "
                             f"this table (slots {self.base + 1} ... "
                             f"{self.base + self.buf.shape[0]}, "
                             f"b1={self.b1}, b2={self.b2})")
        row = self.buf[k]
        return row[0], row[1]


def _bias_of(state: AdamState, count: int, b1: float, b2: float,
             like: torch.Tensor):
    """Step ``count``'s bias corrections as 0-d f32 tensors on ``like``'s
    device: from the host, or the state's :class:`BiasTable`."""
    if state.bias is not None:
        return state.bias.at(count, b1, b2)
    bc1, bc2 = bias_corrections(count, b1, b2)
    return _full(bc1, like), _full(bc2, like)


def adam_update(params: Mapping, grads: Mapping, state: AdamState, *,
                lr: float, weight_decay: float = 0.0, b1: float = ADAM_B1,
                b2: float = ADAM_B2, eps: float = ADAM_EPS) -> AdamState:
    """One step of the optax chain, in place on ``params`` and the moments.
    ``grads[name]`` may be None (a leaf the loss does not reach: zero
    gradient, so its moments decay and it moves on its momentum)."""
    count = state.count + 1
    bc1, bc2 = _bias_of(state, count, b1, b2, next(iter(params.values())))
    with torch.no_grad():
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            if weight_decay:
                g = g + weight_decay * p
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_((g * g) * (1 - b2))
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            p.add_(step * (-lr))
    return state._replace(count=count)


def _collapse_duplicates(idx: torch.Tensor, rows: torch.Tensor
                         ) -> torch.Tensor:
    """Give every occurrence of a repeated index the SUMMED row gradient
    (dense semantics square the summed gradient, not its pieces).

    Sort-based and deterministic on the card: ``searchsorted`` into the
    sorted indices gives each occurrence the segment id of its first
    equal, and ``index_put_(accumulate=True)`` adds each segment's rows in
    a fixed order (PyTorch sorts the indices on CUDA and accumulates each
    one's rows serially). The JAX package sums with an equality-matrix
    product; the two differ only in the rounding of three or more
    duplicates."""
    sorted_idx, _ = torch.sort(idx)
    seg = torch.searchsorted(sorted_idx, idx)
    sums = torch.zeros_like(rows).index_put_((seg,), rows, accumulate=True)
    return sums[seg]


def sparse_dense_adam_update(params, state: AdamState,
                             sparse: Dict[str, TableGrad], *, lr: float,
                             b1: float = ADAM_B1, b2: float = ADAM_B2,
                             eps: float = ADAM_EPS,
                             blocks: Optional[Dict] = None) -> AdamState:
    """One weight-decay-0 :func:`adam_update` step with exact dense
    semantics for row-sparse gradients, in place.

    Torch's dense ``nn.Embedding`` gradient makes Adam move every row every
    step. This computes the same numbers without a dense gradient:

    1. every leaf's touched rows' pre-update ``p``, ``mu``, ``nu`` are
       gathered, with their summed gradient;
    2. the full-table g=0 pass runs in place on every leaf at once
       (:func:`fused_decay_adam_multi`: kernel K3 on the card, one launch
       for the MF tables and biases);
    3. the touched rows are recomputed from their pre-update values with
       the summed gradient and scattered back (duplicates write identical
       values).

    ``params`` is a NamedTuple of tables (row axis first); ``sparse`` maps
    field names to row gradients; other fields (the never-scored bias
    tables) get the pure decay.

    ``blocks`` (row-sharded tables, ``parallel/sharding.py``) maps a field
    to the ``RowBlock`` its local table holds: ``sparse`` then carries the
    whole batch's global ids (every data rank's), duplicates are summed
    over all of them, and only the owned ids are fixed up, at their local
    rows. The owned ids are not cut out (a count the host would have to
    read, which a CUDA graph cannot capture): every id keeps its place and
    an id of another rank writes, at the first owned id's row, that row's
    own fix-up (or, where the batch owns none, row 0's decayed value back
    into row 0), so the tables come out as if only the owned ids were
    written."""
    count = state.count + 1
    leaves = {name: (getattr(params, name), state.mu[name], state.nu[name])
              for name in params._fields}
    # 0-d tensors on the tables' device: K3 reads them through pointers
    bc1, bc2 = _bias_of(state, count, b1, b2, params[0])
    with torch.no_grad():
        fixes = []
        for name, (idx, g_rows) in sparse.items():
            p, mu, nu = leaves[name]
            g_sum = _collapse_duplicates(idx, g_rows)
            block = None if blocks is None else blocks.get(name)
            own = None
            if block is not None:
                local = idx - block.offset
                own = (local >= 0) & (local < block.local)
                idx = torch.clamp(local, 0, block.local - 1)
            fixes.append((leaves[name], idx, own, g_sum, p[idx], mu[idx],
                          nu[idx]))
        fused_decay_adam_multi(leaves.values(), bc1, bc2, lr=lr, b1=b1,
                               b2=b2, eps=eps)
        for (p, mu, nu), idx, own, g_sum, p_rows, mu_rows, nu_rows in fixes:
            mu_f = g_sum * (1 - b1) + mu_rows * b1
            nu_f = (g_sum * g_sum) * (1 - b2) + nu_rows * b2
            p_f = p_rows + (mu_f / bc1) / (
                torch.sqrt(nu_f / bc2) + eps) * (-lr)
            if own is not None:
                idx, (mu_f, nu_f, p_f) = _owned_writes(
                    own, idx, (mu_f, nu_f, p_f), (mu, nu, p))
            mu[idx] = mu_f
            nu[idx] = nu_f
            p[idx] = p_f
    return state._replace(count=count)


def _owned_writes(own: torch.Tensor, idx: torch.Tensor, fixed, tables):
    """The fix-up writes of a row block with every id kept in place:
    ``(idx, values)`` where an id the block does not own (``own`` False)
    is sent to the first owned id's row with that row's values, or, when
    the block owns none of the ids, to row 0 with row 0's current (decayed)
    values; duplicate writes then carry identical values."""
    # (1,)-shaped picks: indexing by a 0-d device tensor would read it on
    # the host, which a CUDA graph cannot capture
    first = torch.argmax(own.to(torch.int32)).reshape(1)
    any_own = own.any()
    pick = idx.index_select(0, first)
    out_idx = torch.where(own, idx,
                          torch.where(any_own, pick, torch.zeros_like(pick)))
    vals = []
    for f, table in zip(fixed, tables):
        other = torch.where(any_own, f.index_select(0, first), table[:1])
        vals.append(torch.where(own[:, None], f, other))
    return out_idx, vals


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    """``{"a/b": leaf}`` from nested NamedTuples / mappings."""
    if hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, Mapping):
        items = tree.items()
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def opt_state_from_numpy(opt_state, device="cuda") -> AdamState:
    """Carry an optimizer state across from the JAX package onto
    ``device`` (the companion of ``models.transfer.theta_from_numpy``).

    ``opt_state`` is the optax ``torch_adam`` chain state with numpy
    leaves, ``(EmptyState(), ScaleByAdamState(count, mu, nu),
    EmptyState())`` (e.g. ``jax.tree.map(np.asarray, state.mf_opt)``), its
    ``ScaleByAdamState`` alone, or a mapping with ``count``/``mu``/``nu``.
    ``mu``/``nu`` may be MFParams or TransferParams trees; their leaves are
    named by path (``user_emb``, ``user/conv1_w``)."""
    device = resolve_device(device)
    adam = opt_state
    # (a tuple has a .count method, so the chain is told apart by .mu)
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "mu"):
        found = [s for s in opt_state if hasattr(s, "mu")]
        if len(found) != 1:
            raise ValueError("expected one ScaleByAdamState in the chain")
        adam = found[0]

    def get(name):
        return adam[name] if isinstance(adam, Mapping) else getattr(adam,
                                                                    name)

    def tensors(tree):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                for k, v in _flatten(tree).items()}
    return AdamState(int(np.asarray(get("count"))), tensors(get("mu")),
                     tensors(get("nu")))


def copy_opt_state(state: AdamState) -> AdamState:
    """A deep copy (new buffers for every moment)."""
    return AdamState(state.count,
                     {k: v.clone() for k, v in state.mu.items()},
                     {k: v.clone() for k, v in state.nu.items()})
