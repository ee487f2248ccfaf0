"""Training epochs (counterpart of ``sml_tpu/train/steps.py``).

Each epoch narrows the rows to ``(u, i, j)`` triples, shuffles the real rows
ahead of the padding and runs exactly ``ceil(n_real/B)`` optimizer steps as
a Python loop: no phantom step ever decays the Adam moments. The returned
loss vector is ``nb_max`` long (the padded batch count) with zeros in the
skipped tail, the same vector the JAX scan returns.

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
the device, in a fixed order; replay mode draws nothing. No step reads a
value back to the host (the step count is ``ceil(n_real/B)`` from the host
int ``n_real``), so a CUDA graph can capture whole epochs; the inner and
outer epochs then write their losses into a buffer they are given
(``losses=``) rather than a new one.

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
* model axis: table and snapshot rows come through the collective lookup,
  whose gradient is a local scatter-add;
* row-sparse table Adam: the per-row gradients are all-gathered over
  'data' in the single-rank order before the duplicate sums, then each
  rank decays its own rows (K3) and fixes up the ids it owns.

Without ``layout`` the code path is the single-rank one.
"""

from __future__ import annotations

from typing import Optional

import torch

from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models.mf import (MFParams, score_pairs,
                                     score_pairs_biased)
from sml_tpu_torch.models.transfer import (TransferParams, apply_rows,
                                           theta_leaves)
from sml_tpu_torch.ops.batching import num_batches, shuffle_real_first
from sml_tpu_torch.ops.losses import (bce_pair_loss, bpr_loss,
                                      l2_embedding_penalty)
from sml_tpu_torch.ops.sampling import PeriodIndex, sample_negatives
from sml_tpu_torch.train.optim import (AdamState, TableGrad, adam_update,
                                       sparse_dense_adam_update)


def scan_epoch(carry, rows: torch.Tensor, mask: torch.Tensor, n_real: int,
               generator: torch.Generator, batch_size: int, step_fn,
               shuffle: bool = True, losses: torch.Tensor = None):
    """Shuffle, then ``ceil(n_real/B)`` calls of ``step_fn(carry, rows_b,
    mask_b, generator) -> (carry, loss)``. Returns ``(carry, losses)`` with
    ``losses`` (nb_max,) f32 on the rows' device, 0 for skipped batches;
    ``losses`` given, the epoch zeroes and fills that buffer.
    ``shuffle=False`` (replay mode) keeps the given order."""
    if shuffle:
        rows, mask = shuffle_real_first(generator, rows, mask)
    nb_max = rows.shape[0] // batch_size
    if losses is None:
        losses = torch.zeros(nb_max, dtype=torch.float32, device=rows.device)
    elif losses.shape != (nb_max,):
        raise ValueError(f"losses must be ({nb_max},), got "
                         f"{tuple(losses.shape)}")
    else:
        losses.zero_()
    for b in range(min(num_batches(n_real, batch_size), nb_max)):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        carry, loss = step_fn(carry, rows[sl], mask[sl], generator)
        losses[b] = loss.detach()
    return carry, losses


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

    def sharded_step(mf, opt, theta, last_u, last_i, u, i, j, m):
        bu, bi, bj, bm, denom = _block(layout, u, i, j, m)
        if cfg.fast_table_adam:
            lu, li, lj, *xs = layout.rows_many(
                [(last_u, bu, "user"), (last_i, bi, "item"),
                 (last_i, bj, "item"), (mf.user_emb, bu, "user"),
                 (mf.item_emb, bi, "item"), (mf.item_emb, bj, "item")])
            xs = [x.requires_grad_() for x in xs]
            with torch.enable_grad():
                loss = row_loss(*xs, theta, lu, li, lj, bm, denom)
                grads = torch.autograd.grad(loss, xs)
            # the whole batch's row gradients, in the single-rank order
            gu, gi, gj = layout.gather_data(list(grads))
            sparse = {"user_emb": TableGrad(u.long(), gu),
                      "item_emb": TableGrad(torch.cat([i, j]).long(),
                                            torch.cat([gi, gj], dim=0))}
            opt = sparse_dense_adam_update(
                mf, opt, sparse, lr=cfg.mf_lr,
                blocks={"user_emb": layout.blocks["user"],
                        "item_emb": layout.blocks["item"]})
            return opt, layout.sum_data(loss.detach())
        lu, li, lj = layout.rows_many([(last_u, bu, "user"),
                                       (last_i, bi, "item"),
                                       (last_i, bj, "item")])
        tabs = {f: getattr(mf, f).detach().requires_grad_()
                for f in ("user_emb", "item_emb")}
        with torch.enable_grad():
            loss = row_loss(layout.rows(tabs["user_emb"], bu, "user"),
                            layout.rows(tabs["item_emb"], bi, "item"),
                            layout.rows(tabs["item_emb"], bj, "item"),
                            theta, lu, li, lj, bm, denom)
            grads = torch.autograd.grad(loss, list(tabs.values()))
        grads, loss = _sum_data(layout, list(grads), loss.detach())
        opt = adam_update(mf._asdict(), dict(zip(tabs, grads)), opt,
                          lr=cfg.mf_lr)
        return opt, loss

    def epoch(mf: MFParams, opt: AdamState, theta: TransferParams,
              last_u, last_i, rows, mask, n_real: int,
              generator: torch.Generator,
              index: Optional[PeriodIndex] = None, losses=None):
        rows = _epoch_triples(rows, generator, mode)

        def step(opt, r, m, gen):
            u, i, j = _triple(r, mode, index, gen, cfg.neg_tries)
            if layout is not None:
                return sharded_step(mf, opt, theta, last_u, last_i, u, i, j,
                                    m)
            lu, li, lj = _g32(last_u, u), _g32(last_i, i), _g32(last_i, j)
            if cfg.fast_table_adam:
                xs = [mf.user_emb[u].requires_grad_(),
                      mf.item_emb[i].requires_grad_(),
                      mf.item_emb[j].requires_grad_()]
                with torch.enable_grad():
                    loss = row_loss(*xs, theta, lu, li, lj, m)
                    gu, gi, gj = torch.autograd.grad(loss, xs)
                sparse = {"user_emb": TableGrad(u, gu),
                          "item_emb": TableGrad(torch.cat([i, j]),
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
                                 losses=losses)
        return mf, opt, losses

    return epoch


def _sum_data(layout, grads, loss):
    """Gradients and the loss summed over 'data', in one all-reduce."""
    flat = layout.sum_data(torch.cat([g.reshape(-1) for g in grads]
                                     + [loss.reshape(1)]))
    parts = flat.split([g.numel() for g in grads] + [1])
    return ([p.view_as(g) for p, g in zip(parts, grads)],
            parts[-1].reshape(()))


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

    def epoch(theta: TransferParams, opt: AdamState, last_u, last_i, hat_u,
              hat_i, rows, mask, n_real: int, generator: torch.Generator,
              index: Optional[PeriodIndex] = None, losses=None):
        rows = _epoch_triples(rows, generator, mode)
        leaves = theta_leaves(theta)

        def sharded_step(opt, u, i, j, m):
            bu, bi, bj, bm, denom = _block(layout, u, i, j, m)
            rows = layout.rows_many(
                [(last_u, bu, "user"), (last_i, bi, "item"),
                 (last_i, bj, "item"), (hat_u, bu, "user"),
                 (hat_i, bi, "item"), (hat_i, bj, "item")])
            with torch.enable_grad():
                loss = transferred_pair_loss(theta, tcfg, *rows, bm,
                                             cfg.use_bce, denom)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            grads, loss = _sum_data(layout, list(grads), loss.detach())
            opt = adam_update(leaves, dict(zip(leaves, grads)), opt,
                              lr=cfg.tr_lr, weight_decay=cfg.tr_l2)
            return opt, loss

        def step(opt, r, m, gen):
            u, i, j = _triple(r, mode, index, gen, cfg.neg_tries)
            if layout is not None:
                return sharded_step(opt, u, i, j, m)
            with torch.enable_grad():
                loss = transferred_pair_loss(
                    theta, tcfg, _g32(last_u, u), _g32(last_i, i),
                    _g32(last_i, j), _g32(hat_u, u), _g32(hat_i, i),
                    _g32(hat_i, j), m, cfg.use_bce)
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
            opt = adam_update(leaves, grads, opt, lr=cfg.tr_lr,
                              weight_decay=cfg.tr_l2)
            return opt, loss

        opt, losses = scan_epoch(opt, rows, mask, n_real, generator, batch,
                                 step, shuffle=mode != "replay",
                                 losses=losses)
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
              generator: torch.Generator, index: PeriodIndex):
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
                                 batch_size, step)
        return mf, opt, losses

    return epoch
