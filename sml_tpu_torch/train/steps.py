"""Training epochs (counterpart of ``sml_tpu/train/steps.py``).

Each epoch narrows the rows to ``(u, i, j)`` triples, shuffles the real rows
ahead of the padding and runs exactly ``ceil(n_real/B)`` optimizer steps:
no phantom step ever decays the Adam moments. The returned loss vector is
``nb_max`` long (the padded batch count) with zeros in the skipped tail,
the same vector the JAX scan returns. Eagerly the loop runs the real
batches; inside a program (``slots=``) every one of the ``nb_max`` step
slots is a ``graphs.step_if`` on a device predicate, as the JAX scan's
``lax.cond``, so one CUDA graph serves any ``n_real``. A single-rank SML
step is a span (``inner_step``, ``outer_step``; ``utils/profiling.py``):
eagerly one a step, in a program one a step slot at its capture.

Gradient flow, as in the JAX package:

* inner epoch (MF): the loss runs through the frozen Θ; the ``last``
  snapshot rows are constants and only the MF tables learn. With
  ``cfg.fast_table_adam`` the step differentiates with respect to the
  gathered rows and applies :func:`sparse_dense_adam_update` (kernel K3 on
  the card); otherwise the tables take a dense gradient and
  :func:`adam_update`.
* outer epoch (Θ): the rows come from the detached ``last``/``hat``
  snapshots, upcast to f32 (snapshots may be stored bf16), and only Θ
  learns.
* plain MF epoch (the pretrainer and the full-retrain / fine-tune
  baselines): mean BCE plus per-side L2 on the tables alone, with sampled
  negatives; dense :func:`adam_update`, or the row-sparse path (K3) with
  ``fast_lr``.

Parameters and moments are updated in place. Random draws (negative
columns, shuffles, sampled negatives) come from one ``torch.Generator`` on
the device, in a fixed order; replay mode draws nothing. A replay advances
a CUDA generator past every step slot, the skipped ones too (as the JAX
package splits ``nb_max`` keys), so an eager epoch on a CUDA generator
skips the Philox offset of each step it does not run: the eager and the
replayed epochs draw alike. No step reads a value back to the host, so a
CUDA graph can capture whole epochs; the epochs then write their losses
into a buffer they are given (``losses=``) rather than a new one, and
:class:`PlainEpochProgram` runs the plain MF epoch as such a program.

Under a mesh (``layout``, a :class:`~sml_tpu_torch.parallel.sharding.
TableLayout`) the inner and outer epochs write out what GSPMD inserts in
the JAX package:

* data axis: every rank makes the whole global batch's draws from its copy
  of the shared generator (shuffle, 'all'-mode column, sampled negatives)
  and keeps its block ``[d·B/D, (d+1)·B/D)``, so R ranks draw what one
  rank draws. The masked mean losses divide by the whole batch's mask
  count; Θ's and the dense tables' gradients and the loss are summed over
  'data' only (the model ranks compute the same loss, so a sum over
  'model' would count it M times);
* model axis: table and snapshot rows come through the collective lookup
  (one all-reduce for all six lookups of a step), whose gradient is a
  local scatter-add;
* row-sparse table Adam: the per-row gradients are all-gathered over
  'data' in the single-rank order before the duplicate sums, then each
  rank decays its own rows (K3) and fixes up the ids it owns.

A sharded step is split at its collectives (:class:`Cut`): it is a
generator that writes a cut's contribution buffers, yields the cut and
gets the cut's result back, and :func:`run_slots` runs each segment
between two cuts where the slot is taken (inside a program: an IF node of
its own on the slot's predicate) and each cut's collectives in every slot,
outside the segments (captured: in the graph's own stream order, between
the IF nodes), a skipped slot's over its zeroed buffers. So every rank
makes the same collectives in the same order, eagerly and replayed, and a
CUDA graph holds NCCL collectives across ranks (none may sit inside an IF
node's body). The cuts of a step: the rows of its six lookups, summed over
'model'; then Θ's or the dense tables' gradients and the loss, summed over
'data', or the row-sparse gradients, all-gathered over 'data', and the
loss, summed over 'data'.

Without ``layout`` the code path is the single-rank one.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Optional, Sequence, Tuple

import torch

from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models.mf import (MFParams, score_pairs,
                                     score_pairs_biased)
from sml_tpu_torch.models.transfer import (TransferParams, apply_rows,
                                           theta_alias, theta_leaves)
from sml_tpu_torch.ops import sampling
from sml_tpu_torch.ops.batching import (PaddedRows, num_batches,
                                        shuffle_real_first)
from sml_tpu_torch.ops.losses import (bce_pair_loss, bpr_loss,
                                      l2_embedding_penalty)
from sml_tpu_torch.ops.sampling import PeriodIndex, sample_negatives
from sml_tpu_torch.parallel import collective
from sml_tpu_torch.train import graphs
from sml_tpu_torch.train.optim import (AdamState, BiasTable, TableGrad,
                                       adam_update, sparse_dense_adam_update)
from sml_tpu_torch.utils.profiling import annotate


def scan_epoch(carry, rows: torch.Tensor, mask: torch.Tensor, n_real: int,
               generator: torch.Generator, batch_size: int, step_fn,
               shuffle: bool = True, losses: torch.Tensor = None,
               slots: Optional[graphs.SlotTable] = None,
               step_draws: Optional[Tuple[int, int]] = None,
               cuts: Sequence["Cut"] = ()):
    """Shuffle, then ``ceil(n_real/B)`` calls of ``step_fn(carry, rows_b,
    mask_b, generator) -> (carry, loss)``. Returns ``(carry, losses)`` with
    ``losses`` (nb_max,) f32 on the rows' device, 0 for skipped batches;
    ``losses`` given, the epoch zeroes and fills that buffer.
    ``shuffle=False`` (replay mode) keeps the given order.

    ``slots`` (inside a program, ``train/graphs.py``): every one of the
    ``nb_max`` slots is a step under :func:`graphs.step_if`, which the
    slot table's taken slots run (``n_real`` is then not read); captured,
    each is an IF node, the counterpart of the JAX package's ``lax.cond``.
    ``cuts``: where ``step_fn`` is split (a generator yielding each of
    them in turn, :func:`run_slots`). ``step_draws``: the ``(rows,
    tries)`` of the sampler draw each step makes, or None. A replay
    advances a CUDA generator past every slot, so an eager epoch on a CUDA
    generator skips the Philox offset of each step it does not run (as
    the JAX package splits ``nb_max`` keys whether or not the batches
    run); on the CPU nothing is skipped."""
    if shuffle:
        rows, mask = shuffle_real_first(generator, rows, mask)
    nb_max = rows.shape[0] // batch_size
    losses = loss_buffer(losses, nb_max, rows.device)
    per_step = None
    if step_draws is not None:
        def per_step(device):
            return sampling.draw_offset(*step_draws, device)

    def one(b):
        nonlocal carry
        sl = slice(b * batch_size, (b + 1) * batch_size)
        out = step_fn(carry, rows[sl], mask[sl], generator)
        if cuts:
            out = yield from out
        carry, loss = out
        losses[b] = loss.detach()
    run_slots(nb_max, num_batches(n_real, batch_size), generator, slots,
              one, per_step, cuts)
    return carry, losses


def loss_buffer(losses: Optional[torch.Tensor], nb_max: int, device):
    """A zeroed ``(nb_max,)`` f32 loss vector: ``losses`` itself when
    given (it must have that shape), else a new one."""
    if losses is None:
        return torch.zeros(nb_max, dtype=torch.float32, device=device)
    if losses.shape != (nb_max,):
        raise ValueError(f"losses must be ({nb_max},), got "
                         f"{tuple(losses.shape)}")
    return losses.zero_()


class Cut:
    """A collective site of a split step: the contribution buffers the
    segment before it writes, allocated outside the step slots (so they
    exist, zeroed, in a slot that does not run, and nothing freed inside
    an IF node is read across it), and ``reduce(*bufs)``, its collectives,
    whose result the segment after it reads."""

    def __init__(self, name: str, bufs: Sequence[torch.Tensor],
                 reduce: Callable):
        self.name, self.bufs, self.reduce = name, tuple(bufs), reduce

    def zero(self) -> None:
        for buf in self.bufs:
            buf.zero_()

    def run(self):
        return self.reduce(*self.bufs)


def _advance(segments, value):
    """Run a split step's next segment (``value``: the last cut's result);
    the cut it stops at, or None at its end (``segments`` not a generator:
    an unsplit step, which ran whole when it was called)."""
    if not inspect.isgenerator(segments):
        return None
    try:
        return segments.send(value)
    except StopIteration:
        return None


def run_slots(nb_max: int, nb_real: int, generator: torch.Generator,
              slots: Optional[graphs.SlotTable], step, per_step=None,
              cuts: Sequence[Cut] = ()) -> None:
    """An epoch's step slots: ``step(b)`` runs slot ``b``; with ``cuts``
    it returns a generator that stops at each cut in turn (yielding it,
    and taking its result back) and then ends, which splits the slot into
    ``len(cuts) + 1`` segments. Under
    ``slots`` (inside a program) all ``nb_max`` slots run and each segment
    is a :func:`graphs.step_if` on the slot (captured: an IF node of its
    own), which the taken slots run; without, the first ``nb_real`` slots
    run. Each cut's buffers are zeroed before the slot's first segment and
    its collectives run after the segment before it, outside the
    segments, in every slot that runs, taken or not: the ranks make the
    same collectives in the same order, eagerly and replayed. A collective
    inside a segment raises (``collective.segment``).

    ``per_step(device)``: the Philox offset each step reserves on a CUDA
    generator (None: steps draw nothing). Run eagerly on a CUDA generator,
    every step is checked to reserve exactly that and the skipped slots'
    offsets are skipped, as a replay advances past every slot (the JAX
    package splits ``nb_max`` keys whether or not the batches run); on
    the CPU nothing is skipped."""
    eager_cuda = (generator.device.type == "cuda"
                  and not torch.cuda.is_current_stream_capturing())
    offset = (per_step(generator.device)
              if eager_cuda and per_step is not None else 0)
    ran = 0
    for b in range(nb_max if slots is not None else min(nb_real, nb_max)):
        for cut in cuts:
            cut.zero()
        started, segments, value, start = False, None, None, 0
        for k in range(len(cuts) + 1):
            until = cuts[k] if k < len(cuts) else None
            where = f"step slot {b}" + (
                f", before its cut '{until.name}'" if until is not None
                else ", after its last cut" if cuts else "")
            gate = (graphs.step_if(slots, b, k) if slots is not None
                    else contextlib.nullcontext(True))
            with gate as run:
                if run:
                    if k and not started:
                        raise RuntimeError(f"{where} runs, its first "
                                           "segment did not")
                    with collective.segment(where):
                        if not started:
                            started = True
                            start = generator.get_offset() if eager_cuda else 0
                            segments = step(b)
                        reached = _advance(segments, value)
                    if reached is not until:
                        raise RuntimeError(
                            f"step slot {b} stopped at "
                            f"{getattr(reached, 'name', 'its end')}, not "
                            f"at {getattr(until, 'name', 'its end')}")
            if until is not None:
                value = until.run()
        if not started:
            continue
        ran += 1
        if eager_cuda and generator.get_offset() - start != offset:
            raise RuntimeError(
                f"a step reserved {generator.get_offset() - start} "
                f"Philox offsets, the skip-ahead assumes {offset}")
    if eager_cuda and offset and ran < nb_max:
        generator.set_offset(generator.get_offset()
                             + (nb_max - ran) * offset)


def transferred_pair_loss(theta: TransferParams, tcfg: TransferConfig,
                          lu, li, lj, xu, xi, xj, mask: torch.Tensor,
                          use_bce: bool, denom=None) -> torch.Tensor:
    """Score a (u, i, j) batch through Θ and reduce to the SML loss; the
    positive and negative item rows go through the item tower as one
    (2B, ·) batch. ``denom``: the BCE mean's divisor, where it is not this
    batch's own mask count."""
    b = xu.shape[0]
    nu = apply_rows(theta, tcfg, "user", lu, xu)
    nij = apply_rows(theta, tcfg, "item", torch.cat([li, lj], dim=0),
                     torch.cat([xi, xj], dim=0))
    pos = torch.sum(nu * nij[:b], dim=-1)
    neg = torch.sum(nu * nij[b:], dim=-1)
    if use_bce:
        return bce_pair_loss(pos, neg, mask, denom)
    return bpr_loss(pos, neg, mask)


def _epoch_triples(rows: torch.Tensor, generator: torch.Generator,
                   mode: str) -> torch.Tensor:
    """Narrow the rows to (n, 3) before shuffling. In 'all' mode the rows
    are eval-format ``[u, pos, negs...]`` and ONE negative column, drawn
    once per epoch, serves every row."""
    if mode != "all":
        return rows
    col = torch.randint(0, rows.shape[1] - 2, (1,), generator=generator,
                        device=rows.device)
    j = rows.index_select(1, col + 2)[:, 0]
    return torch.stack([rows[:, 0], rows[:, 1], j], dim=1)


def _g32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows, upcast to f32."""
    return table[idx].to(torch.float32)


def _triple(r: torch.Tensor, mode: str, index: Optional[PeriodIndex],
            generator: torch.Generator, tries: int):
    u, i = r[:, 0].long(), r[:, 1].long()
    if mode in ("all", "replay"):
        j = r[:, 2].long()
    else:
        j = sample_negatives(index, u, generator, tries)
    return u, i, j


def _block(layout, u, i, j, m):
    """This data rank's block of a batch's ids and mask, and the whole
    batch's valid-row count."""
    denom = torch.clamp(m.sum(), min=1.0)
    sl = layout.data_slice(m.shape[0])
    return u[sl], i[sl], j[sl], m[sl], denom


# the sides of a sharded step's six lookups: (u, i, j) of two tables
LOOKUP_SIDES = ("user", "item", "item") * 2


def _rows_cut(layout, n: int, width: int, device) -> Cut:
    """A sharded step's first cut: the owned rows of its sharded lookups,
    ``n`` ids each, summed over 'model' in one all-reduce (exact: each row
    has one owner, the other ranks add 0)."""
    k = sum(layout.sharded(side) for side in LOOKUP_SIDES)
    buf = torch.zeros((k * n, width), dtype=torch.float32, device=device)

    def reduce(buf):
        return collective.all_reduce(buf, layout.model_group) if k else buf
    return Cut("rows over 'model'", (buf,), reduce)


def _sum_cut(layout, numel: int, device) -> Cut:
    """A dense step's second cut: its gradients and loss as one flat f32
    buffer (:func:`_flat_into`), summed over 'data' in one all-reduce."""
    buf = torch.zeros(numel + 1, dtype=torch.float32, device=device)
    return Cut("gradients and loss over 'data'", (buf,), layout.sum_data)


def _gather_cut(layout, n: int, width: int, device) -> Cut:
    """The row-sparse step's second cut: its three ``(n, width)`` blocks
    of row gradients, all-gathered over 'data' into the single-rank order,
    and its loss, summed over 'data'."""
    rows = torch.zeros((3 * n, width), dtype=torch.float32, device=device)
    loss = torch.zeros(1, dtype=torch.float32, device=device)
    return Cut("gradient rows and loss over 'data'", (rows, loss),
               lambda rows, loss: (layout.gather_data(rows, 3),
                                   layout.sum_data(loss)))


def _flat_into(buf: torch.Tensor, grads, loss: torch.Tensor) -> None:
    torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)],
              out=buf)


def _unflat(flat: torch.Tensor, grads):
    """The gradients (shaped like ``grads``) and the loss of a flat buffer
    that :func:`_flat_into` filled."""
    parts = flat.split([g.numel() for g in grads] + [1])
    return ([p.view_as(g) for p, g in zip(parts, grads)],
            parts[-1].reshape(()))


def make_inner_epoch(cfg: SMLConfig, layout=None):
    """Inner (MF) epoch through the frozen Θ: ``epoch(mf, opt, theta,
    last_u, last_i, rows, mask, n_real, generator, index=None,
    losses=None) -> (mf, opt, losses)``, with ``mf`` updated in place (and
    the losses in ``losses`` when given). With ``layout`` the tables are
    this rank's row blocks and the losses are the whole batch's."""
    tcfg = cfg.transfer
    batch = cfg.mf_batch_size
    mode = "replay" if cfg.replay_mode else cfg.mf_sample

    def row_loss(xu, xi, xj, theta, lu, li, lj, m, denom=None):
        loss = transferred_pair_loss(theta, tcfg, lu, li, lj, xu, xi, xj, m,
                                     cfg.use_bce, denom)
        return loss + cfg.mf_l2 * l2_embedding_penalty(m, xu, xi, xj)

    def sharded_step(mf, opt, theta, last_u, last_i, u, i, j, m, cuts):
        bu, bi, bj, bm, denom = _block(layout, u, i, j, m)
        lookups = list(zip(
            (last_u, last_i, last_i, mf.user_emb, mf.item_emb, mf.item_emb),
            (bu, bi, bj) * 2, LOOKUP_SIDES))
        rows_cut, last_cut = cuts
        owned = layout.owned_into(rows_cut.bufs[0], lookups)
        summed = yield rows_cut
        if cfg.fast_table_adam:
            lu, li, lj, *xs = layout.rows_from(lookups, summed, owned)
            xs = [x.requires_grad_() for x in xs]
            with torch.enable_grad():
                loss = row_loss(*xs, theta, lu, li, lj, bm, denom)
                grads = torch.autograd.grad(loss, xs)
            grad_rows, loss_buf = last_cut.bufs
            torch.cat(grads, out=grad_rows)
            loss_buf.copy_(loss.detach().reshape(1))
            # the whole batch's row gradients, in the single-rank order
            (gu, gi, gj), loss = yield last_cut
            sparse = {"user_emb": TableGrad(u.long(), gu),
                      "item_emb": TableGrad(torch.cat([i, j]).long(),
                                            torch.cat([gi, gj], dim=0))}
            opt = sparse_dense_adam_update(
                mf, opt, sparse, lr=cfg.mf_lr,
                blocks={"user_emb": layout.blocks["user"],
                        "item_emb": layout.blocks["item"]})
            return opt, loss.reshape(())
        tabs = {f: getattr(mf, f).detach().requires_grad_()
                for f in ("user_emb", "item_emb")}
        lookups[3:] = [(tabs[f], idx, side) for f, (_, idx, side) in zip(
            ("user_emb", "item_emb", "item_emb"), lookups[3:])]
        with torch.enable_grad():
            lu, li, lj, xu, xi, xj = layout.rows_from(lookups, summed, owned)
            loss = row_loss(xu, xi, xj, theta, lu, li, lj, bm, denom)
            grads = torch.autograd.grad(loss, list(tabs.values()))
        _flat_into(last_cut.bufs[0], grads, loss)
        grads, loss = _unflat((yield last_cut), grads)
        opt = adam_update(mf._asdict(), dict(zip(tabs, grads)), opt,
                          lr=cfg.mf_lr)
        return opt, loss

    draws = None if mode in ("all", "replay") else (batch, cfg.neg_tries)

    def epoch(mf: MFParams, opt: AdamState, theta: TransferParams,
              last_u, last_i, rows, mask, n_real: int,
              generator: torch.Generator,
              index: Optional[PeriodIndex] = None, losses=None, slots=None):
        rows = _epoch_triples(rows, generator, mode)
        cuts = ()
        if layout is not None:
            n, d = batch // layout.mesh.shape["data"], mf.user_emb.shape[1]
            cuts = (_rows_cut(layout, n, d, rows.device),
                    _gather_cut(layout, n, d, rows.device)
                    if cfg.fast_table_adam else
                    _sum_cut(layout, mf.user_emb.numel()
                             + mf.item_emb.numel(), rows.device))

        def step(opt, r, m, gen):
            if layout is not None:
                return sharded_step(mf, opt, theta, last_u, last_i,
                                    *_triple(r, mode, index, gen,
                                             cfg.neg_tries), m, cuts)
            with annotate("inner_step"):
                u, i, j = _triple(r, mode, index, gen, cfg.neg_tries)
                lu, li, lj = _g32(last_u, u), _g32(last_i, i), _g32(last_i, j)
                if cfg.fast_table_adam:
                    xs = [mf.user_emb[u].requires_grad_(),
                          mf.item_emb[i].requires_grad_(),
                          mf.item_emb[j].requires_grad_()]
                    with torch.enable_grad():
                        loss = row_loss(*xs, theta, lu, li, lj, m)
                        gu, gi, gj = torch.autograd.grad(loss, xs)
                    sparse = {"user_emb": TableGrad(u, gu),
                              "item_emb": TableGrad(
                                  torch.cat([i, j]),
                                  torch.cat([gi, gj], dim=0))}
                    opt = sparse_dense_adam_update(mf, opt, sparse,
                                                   lr=cfg.mf_lr)
                    return opt, loss
                tabs = {f: getattr(mf, f).detach().requires_grad_()
                        for f in ("user_emb", "item_emb")}
                with torch.enable_grad():
                    loss = row_loss(tabs["user_emb"][u], tabs["item_emb"][i],
                                    tabs["item_emb"][j], theta, lu, li, lj, m)
                    grads = dict(zip(tabs, torch.autograd.grad(
                        loss, list(tabs.values()))))
                opt = adam_update(mf._asdict(), grads, opt, lr=cfg.mf_lr)
                return opt, loss

        opt, losses = scan_epoch(opt, rows, mask, n_real, generator, batch,
                                 step, shuffle=mode != "replay",
                                 losses=losses, slots=slots,
                                 step_draws=draws, cuts=cuts)
        return mf, opt, losses

    return epoch


def make_outer_epoch(cfg: SMLConfig, layout=None):
    """Outer (Θ) epoch on the detached snapshots: ``epoch(theta, opt,
    last_u, last_i, hat_u, hat_i, rows, mask, n_real, generator,
    index=None, losses=None) -> (theta, opt, losses)``, with Θ updated in
    place (and the losses in ``losses`` when given). With ``layout`` the
    snapshots are this rank's row blocks and the losses are the whole
    batch's."""
    tcfg = cfg.transfer
    batch = cfg.tr_batch_size
    mode = "replay" if cfg.replay_mode else cfg.tr_sample_type

    draws = None if mode in ("all", "replay") else (batch, cfg.neg_tries)

    def epoch(theta: TransferParams, opt: AdamState, last_u, last_i, hat_u,
              hat_i, rows, mask, n_real: int, generator: torch.Generator,
              index: Optional[PeriodIndex] = None, losses=None, slots=None):
        rows = _epoch_triples(rows, generator, mode)
        # Θ is differentiated through new parameters on its storage, as
        # the tables through detached copies: a graph into Θ that a caller
        # holds would tie a captured step's gradients to the stream it was
        # made on, and the capture's end would die of a segmentation fault
        own = theta_alias(theta)
        leaves = theta_leaves(own)
        cuts = ()
        if layout is not None:
            n = batch // layout.mesh.shape["data"]
            cuts = (_rows_cut(layout, n, last_u.shape[1], rows.device),
                    _sum_cut(layout, sum(p.numel() for p in leaves.values()),
                             rows.device))

        def sharded_step(opt, u, i, j, m):
            bu, bi, bj, bm, denom = _block(layout, u, i, j, m)
            lookups = list(zip((last_u, last_i, last_i, hat_u, hat_i, hat_i),
                               (bu, bi, bj) * 2, LOOKUP_SIDES))
            owned = layout.owned_into(cuts[0].bufs[0], lookups)
            rows = layout.rows_from(lookups, (yield cuts[0]), owned)
            with torch.enable_grad():
                loss = transferred_pair_loss(own, tcfg, *rows, bm,
                                             cfg.use_bce, denom)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            _flat_into(cuts[1].bufs[0], grads, loss)
            grads, loss = _unflat((yield cuts[1]), grads)
            opt = adam_update(leaves, dict(zip(leaves, grads)), opt,
                              lr=cfg.tr_lr, weight_decay=cfg.tr_l2)
            return opt, loss

        def step(opt, r, m, gen):
            if layout is not None:
                return sharded_step(opt, *_triple(r, mode, index, gen,
                                                  cfg.neg_tries), m)
            with annotate("outer_step"):
                u, i, j = _triple(r, mode, index, gen, cfg.neg_tries)
                with torch.enable_grad():
                    loss = transferred_pair_loss(
                        own, tcfg, _g32(last_u, u), _g32(last_i, i),
                        _g32(last_i, j), _g32(hat_u, u), _g32(hat_i, i),
                        _g32(hat_i, j), m, cfg.use_bce)
                    grads = dict(zip(leaves, torch.autograd.grad(
                        loss, list(leaves.values()))))
                opt = adam_update(leaves, grads, opt, lr=cfg.tr_lr,
                                  weight_decay=cfg.tr_l2)
                return opt, loss

        opt, losses = scan_epoch(opt, rows, mask, n_real, generator, batch,
                                 step, shuffle=mode != "replay",
                                 losses=losses, slots=slots,
                                 step_draws=draws, cuts=cuts)
        return theta, opt, losses

    return epoch


def make_plain_mf_epoch(batch_size: int, l2_user: float, l2_item: float,
                        lr: float, neg_tries: int = 16, biased: bool = False,
                        fast_lr: Optional[float] = None):
    """Plain BCE-MF epoch for the pretrainer and the full-retrain /
    fine-tune baselines: mean BCE plus per-side summed L2, uniform
    rejection-sampled negatives. ``epoch(mf, opt, rows, mask, n_real,
    generator, index) -> (mf, opt, losses)``, with ``mf`` updated in place.

    The dense step is :func:`adam_update` at ``lr`` with weight decay 0 (the
    JAX package's ``torch_adam(lr, 0.0)``). ``fast_lr``: when set (and
    ``biased`` is False) the step takes :func:`sparse_dense_adam_update` at
    that rate instead (K3 on the card), the same numbers with less memory
    traffic. The biased variant scores through the bias tables, whose
    row-sparse gradients are not plumbed, so it keeps the dense path."""
    score = score_pairs_biased if biased else score_pairs
    use_fast = fast_lr is not None and not biased
    leaves = (("user_emb", "item_emb", "user_bias", "item_bias") if biased
              else ("user_emb", "item_emb"))

    def row_loss(xu, xi, xj, m):
        pos = torch.sum(xu * xi, dim=-1)
        neg = torch.sum(xu * xj, dim=-1)
        return (bce_pair_loss(pos, neg, m)
                + l2_user * l2_embedding_penalty(m, xu)
                + l2_item * l2_embedding_penalty(m, xi, xj))

    def loss_fn(mfp: MFParams, u, i, j, m):
        xu, xi, xj = mfp.user_emb[u], mfp.item_emb[i], mfp.item_emb[j]
        return (bce_pair_loss(score(mfp, u, i), score(mfp, u, j), m)
                + l2_user * l2_embedding_penalty(m, xu)
                + l2_item * l2_embedding_penalty(m, xi, xj))

    def epoch(mf: MFParams, opt: AdamState, rows, mask, n_real: int,
              generator: torch.Generator, index: PeriodIndex, losses=None,
              slots=None):
        def step(opt, r, m, gen):
            u, i = r[:, 0].long(), r[:, 1].long()
            j = sample_negatives(index, u, gen, neg_tries)
            if use_fast:
                xs = [mf.user_emb[u].requires_grad_(),
                      mf.item_emb[i].requires_grad_(),
                      mf.item_emb[j].requires_grad_()]
                with torch.enable_grad():
                    loss = row_loss(*xs, m)
                    gu, gi, gj = torch.autograd.grad(loss, xs)
                sparse = {"user_emb": TableGrad(u, gu),
                          "item_emb": TableGrad(torch.cat([i, j]),
                                                torch.cat([gi, gj], dim=0))}
                opt = sparse_dense_adam_update(mf, opt, sparse, lr=fast_lr)
                return opt, loss
            tabs = {f: getattr(mf, f).detach().requires_grad_()
                    for f in leaves}
            with torch.enable_grad():
                loss = loss_fn(mf._replace(**tabs), u, i, j, m)
                grads = dict(zip(tabs, torch.autograd.grad(
                    loss, list(tabs.values()))))
            opt = adam_update(mf._asdict(), grads, opt, lr=lr)
            return opt, loss

        opt, losses = scan_epoch(opt, rows, mask, n_real, generator,
                                 batch_size, step, losses=losses, slots=slots,
                                 step_draws=(batch_size, neg_tries))
        return mf, opt, losses

    return epoch


class EpochProgram(graphs.Program):
    """An MF epoch ``epoch(mf, opt, *inputs, n, generator, index, losses,
    slots)`` as a program on fixed buffers, the counterpart of the JAX
    package's jitted epoch. It holds its own tables and moments (shaped
    like the first run's), input buffers at the padded shapes, and a
    :class:`~sml_tpu_torch.train.graphs.SlotTable` and
    :class:`~sml_tpu_torch.train.optim.BiasTable` of ``slots`` step slots;
    :meth:`run_taken` copies the run's state and inputs in, marks the
    first ``taken`` slots and fills their bias corrections, runs the epoch
    (eagerly on the CPU; on the card the site's warm-up, then one capture,
    then replays) and returns ``(mf, opt, losses)``, ``mf`` and the
    moments the program's own buffers (the next run overwrites them),
    ``losses`` a copy. Inside the program the epoch reads its step count
    from the slots (``n`` is 0)."""

    def __init__(self, epoch, site: graphs.GraphSite, mf: MFParams,
                 opt: AdamState, inputs, index: PeriodIndex, slots: int):
        super().__init__(site)
        self.epoch = epoch
        self.mf = MFParams(*(t.detach().clone() for t in mf))
        self.mu = {k: v.clone() for k, v in opt.mu.items()}
        self.nu = {k: v.clone() for k, v in opt.nu.items()}
        self.inputs = tuple(t.clone() for t in inputs)
        self.index = PeriodIndex(*(t.clone() for t in index))
        self.slots = graphs.SlotTable(slots, site.device)
        self.bias = BiasTable(slots, site.device)
        self.losses = torch.zeros(slots, dtype=torch.float32,
                                  device=site.device)

    def body(self, gen: torch.Generator) -> None:
        opt = AdamState(self.bias.epoch_count(0), self.mu, self.nu,
                        self.bias)
        self.epoch(self.mf, opt, *self.inputs, 0, gen, self.index,
                   self.losses, self.slots)

    def run_taken(self, mf: MFParams, opt: AdamState, inputs,
                  index: PeriodIndex, taken: int, gen: torch.Generator):
        graphs.load_into(
            [*self.mf, *self.mu.values(), *self.nu.values(), *self.inputs,
             *self.index],
            [*mf, *(opt.mu[k] for k in self.mu),
             *(opt.nu[k] for k in self.nu), *inputs, *index])
        taken = min(taken, self.slots.host.shape[0])
        self.slots.fill(taken)
        self.bias.fill(opt.count, taken)
        self.launch(gen)
        return (self.mf, AdamState(opt.count + taken, self.mu, self.nu),
                self.losses.clone())


class PlainEpochProgram(EpochProgram):
    """One plain MF epoch (:func:`make_plain_mf_epoch`'s ``epoch``) as an
    :class:`EpochProgram`: the pretrainer's and the full-retrain /
    fine-tune baselines'. Its inputs are the padded rows and mask, its
    slots the padded batch count; :meth:`run` takes the run's
    ``ceil(n_real/B)`` batches."""

    def __init__(self, epoch, site: graphs.GraphSite, mf: MFParams,
                 opt: AdamState, padded: PaddedRows, index: PeriodIndex,
                 batch_size: int):
        super().__init__(epoch, site, mf, opt, (padded.rows, padded.mask),
                         index, padded.rows.shape[0] // batch_size)
        self.batch_size = batch_size

    def run(self, mf: MFParams, opt: AdamState, padded: PaddedRows,
            gen: torch.Generator, index: PeriodIndex):
        return self.run_taken(mf, opt, (padded.rows, padded.mask), index,
                              num_batches(padded.n_real, self.batch_size),
                              gen)
