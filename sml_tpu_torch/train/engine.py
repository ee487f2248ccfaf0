"""SML engine: state and operations (counterpart of
``sml_tpu/train/engine.py``).

Holds the state record and everything the driver runs on it: the
``last``/``hat`` snapshots, the full-table refresh ``W_t = Θ(W_{t-1},
Ŵ_t)`` (kernel K1 on the card for ``conv_com``), the inner (MF) and outer (Θ) training
epochs (kernel K3 on the card with ``fast_table_adam``), the Θ identity
warm-start and the saddle guard's re-roll, the host-side data preparation
(padding, period sampling indices) and the leave-one-out evaluation with
packed candidate masks (kernel K2 on the card), plain or with hit
attribution by entity freshness.

The JAX package's fused phase and period programs exist to cut JAX
dispatches and compiles; the port runs eagerly and has only the
epoch-at-a-time path. Tables, Θ and moments are updated in place.

Under a mesh (:meth:`SMLEngine.set_mesh`, the ``placement`` property or
:meth:`SMLEngine.init_state_sharded`) each rank holds its row blocks of the
row-aligned leaves (``parallel/sharding.py``): the epochs keep each
batch's block over 'data' and read rows through the collective lookup, the
refresh runs on the blocks (two K1 launches per rank), and an evaluation
all-gathers the item table once, reads its rows' user rows once, ranks
this rank's block of the test rows (K2) and sums over 'data'.
"""

from __future__ import annotations

import copy
import hashlib
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from sml_tpu_torch.config import SMLConfig, resolve_fast_table_adam
from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.eval.evaluator import (make_attributed_eval_fn,
                                          make_eval_fn)
from sml_tpu_torch.models.mf import MFParams, init_mf, with_tables
from sml_tpu_torch.models.transfer import (TransferParams, apply_rows,
                                           apply_tables,
                                           init_transfer, theta_leaves)
from sml_tpu_torch.ops import eval_kernel
from sml_tpu_torch.ops.batching import PaddedRows, bucket_rows, pad_rows
from sml_tpu_torch.parallel.sharding import (TableLayout, shard_rows,
                                             state_shardings)
from sml_tpu_torch.ops.sampling import (PeriodIndex, build_period_index,
                                        sampler_stats)
from sml_tpu_torch.train.optim import (AdamState, adam_init, adam_update,
                                       copy_opt_state)
from sml_tpu_torch.train.steps import make_inner_epoch, make_outer_epoch
from sml_tpu_torch.utils.profiling import annotate

_SNAPSHOT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

DIAG_NAMES = ("user_norm", "item_norm", "hat_user_norm", "hat_item_norm",
              "last_user_norm", "last_item_norm", "theta_norm")


class SMLState(NamedTuple):
    """What evolves across periods: ``last_*`` = W_{t-1}, ``hat_*`` =
    Ŵ_t (stored in ``cfg.snapshot_dtype``), the two Adam states and the
    run's random generator (on the state's device)."""
    mf: MFParams
    theta: TransferParams
    last_user: torch.Tensor
    last_item: torch.Tensor
    hat_user: torch.Tensor
    hat_item: torch.Tensor
    mf_opt: AdamState
    tr_opt: AdamState
    gen: torch.Generator


def derive_seed(*parts) -> int:
    """A 63-bit seed from a tuple of ints and strings (stable across runs
    and hosts)."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def clone_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def copy_state(state: SMLState) -> SMLState:
    """A deep copy: new buffers for every tensor, Θ and moment, and a
    generator at the same position (the saddle guard's restart point)."""
    return SMLState(
        mf=MFParams(*(t.clone() for t in state.mf)),
        theta=copy.deepcopy(state.theta),
        last_user=state.last_user.clone(), last_item=state.last_item.clone(),
        hat_user=state.hat_user.clone(), hat_item=state.hat_item.clone(),
        mf_opt=copy_opt_state(state.mf_opt),
        tr_opt=copy_opt_state(state.tr_opt),
        gen=clone_generator(state.gen))


def _content_key(arr: np.ndarray) -> tuple:
    """Identity of an eval matrix for the upload cache: shape, dtype and a
    digest of every byte."""
    digest = hashlib.blake2b(np.ascontiguousarray(arr).tobytes(),
                             digest_size=16).hexdigest()
    return arr.shape, arr.dtype.str, digest


class SMLEngine:
    def __init__(self, cfg: SMLConfig, n_users: int, n_items: int,
                 device="cuda"):
        self.device = resolve_device(device)
        cfg = cfg.replace(fast_table_adam=resolve_fast_table_adam(
            cfg.fast_table_adam, n_users + n_items, cfg.mf_batch_size))
        self.cfg = cfg
        self.n_users = n_users
        self.n_items = n_items
        self._inner = make_inner_epoch(cfg)
        self._outer = make_outer_epoch(cfg)
        self._eval = make_eval_fn(cfg.topk, cfg.eval_batch_size,
                                  scoring=cfg.eval_scoring)
        self._eval_attr = make_attributed_eval_fn(
            cfg.topk, cfg.eval_batch_size, scoring=cfg.eval_scoring)
        # packed candidate masks for the masked scoring modes, or for eval
        # sets the protocol re-evaluates (in-training evals)
        self._want_masks = (
            cfg.eval_scoring in ("masked", "masked_bf16")
            or (cfg.eval_scoring == "auto"
                and (cfg.eval_during_inner or cfg.eval_during_outer)
                and n_items <= cfg.eval_mask_max_items))
        # content-keyed cache of uploaded eval sets (the same test/<p>.npy
        # serves as period t's val, period t+1's test and, in
        # mf_sample='all' mode, a training pool); the prefetch worker and
        # the main thread both insert, and an insert with its evictions
        # holds the lock
        self._upload_cache: Dict[tuple, PaddedRows] = {}
        self._upload_cache_cap = 3
        self._upload_lock = threading.Lock()
        # sweep-wide row-count floors per stream ("set_t"/"set_tt"/"eval"),
        # set by the driver from the feeder's npy-header scan
        self.shape_targets: Dict[str, int] = {}
        # the latest sampler-quality probe and warm-start loss (log_norms)
        self.sampler_stats: Dict[str, float] = {}
        # row-sharded state (set_mesh): the mesh, the epochs' layout and
        # the per-leaf plan; the multi-process placement, when one is set
        self.mesh = None
        self.layout: Optional[TableLayout] = None
        self.plan = None
        self._placement = None

    # ------------------------------------------------------------------ state
    def _snap_dtype(self) -> torch.dtype:
        return _SNAPSHOT_DTYPES[self.cfg.snapshot_dtype]

    def _theta_seed(self) -> int:
        return (self.cfg.theta_seed if self.cfg.theta_seed is not None
                else self.cfg.seed + 1)

    def _generator(self, *parts) -> torch.Generator:
        """A generator on the engine's device seeded from ``parts``."""
        return torch.Generator(device=self.device).manual_seed(
            derive_seed(*parts))

    def init_state(self, pretrained_mf: Optional[MFParams] = None,
                   skip_theta_warmstart: bool = False) -> SMLState:
        """Fresh state: ``last`` at zeros, ``hat`` at the (pretrained)
        tables, zero Adam moments. Tables draw from a CPU generator seeded
        ``cfg.seed``, Θ from one seeded ``cfg.theta_seed`` (default
        ``cfg.seed + 1``), so one seed gives the same weights on every
        device; the run's generator lives on the device. With
        ``theta_warmstart_steps`` Θ is identity-warm-started, unless
        ``skip_theta_warmstart`` (a checkpoint is about to replace it)."""
        if pretrained_mf is not None:
            mf = MFParams(*(torch.as_tensor(t).to(self.device, copy=True)
                            for t in pretrained_mf))
        else:
            gen = torch.Generator().manual_seed(self.cfg.seed)
            mf = init_mf(gen, self.n_users, self.n_items,
                         self.cfg.latent_dim, device=self.device,
                         emb_scale=self.cfg.emb_init_scale)
        return self._fresh_state(mf, skip_theta_warmstart)

    def _fresh_state(self, mf: MFParams,
                     skip_theta_warmstart: bool) -> SMLState:
        """The state around fresh tables ``mf``: Θ from its seed (warm-
        started unless skipped), zero ``last``, ``hat`` at the tables, zero
        moments and the run's generator."""
        theta = init_transfer(
            torch.Generator().manual_seed(self._theta_seed()),
            self.cfg.transfer, device=self.device)
        if self.cfg.theta_warmstart_steps > 0 and not skip_theta_warmstart:
            theta = self._theta_warmstart(
                theta, mf, self._generator(self.cfg.seed, "warmstart"))
        sdt = self._snap_dtype()
        return SMLState(
            mf=mf, theta=theta,
            last_user=torch.zeros(mf.user_emb.shape, dtype=sdt,
                                  device=self.device),
            last_item=torch.zeros(mf.item_emb.shape, dtype=sdt,
                                  device=self.device),
            hat_user=self._snap(mf.user_emb),
            hat_item=self._snap(mf.item_emb),
            mf_opt=adam_init(mf._asdict()),
            tr_opt=adam_init(theta_leaves(theta)),
            gen=self._generator(self.cfg.seed, "run"))

    @property
    def placement(self):
        return self._placement

    @placement.setter
    def placement(self, p) -> None:
        """A ``parallel.multihost.MultihostPlacement``: its mesh becomes the
        engine's (:meth:`set_mesh`)."""
        self._placement = p
        self.set_mesh(None if p is None else p.mesh)

    def set_mesh(self, mesh) -> None:
        """Tell the engine its state is row-sharded over ``mesh``: the
        epochs, the evaluation and the diagnostics take the mesh's layout
        (the refresh needs nothing: it runs on the row blocks the state
        holds)."""
        self.mesh = mesh
        self.layout = (None if mesh is None
                       else TableLayout(mesh, self.n_users, self.n_items))
        self.plan = (None if mesh is None
                     else state_shardings(None, mesh, self.n_users,
                                          self.n_items))
        self._inner = make_inner_epoch(self.cfg, self.layout)
        self._outer = make_outer_epoch(self.cfg, self.layout)

    def init_state_sharded(self, mesh, pretrained_mf: Optional[MFParams]
                           = None, skip_theta_warmstart: bool = False
                           ) -> SMLState:
        """:meth:`init_state` with every row-aligned leaf born as this
        rank's row block of ``mesh`` (and the engine set to the mesh): the
        tables are drawn block by block (``models.mf.init_mf``), pretrained
        tables are cut on the host before they move, so no rank ever holds
        a whole table. Leaf for leaf equal to ``init_state`` followed by
        ``sharding.shard_state``."""
        self.set_mesh(mesh)
        blocks = self.layout.blocks
        if pretrained_mf is not None:
            mf = MFParams(*(
                shard_rows(torch.as_tensor(t), self.plan[f"mf/{f}"])
                .to(self.device, copy=True)
                for f, t in zip(MFParams._fields, pretrained_mf)))
        else:
            gen = torch.Generator().manual_seed(self.cfg.seed)
            mf = init_mf(gen, self.n_users, self.n_items,
                         self.cfg.latent_dim, device=self.device,
                         emb_scale=self.cfg.emb_init_scale, blocks=blocks)
        return self._fresh_state(mf, skip_theta_warmstart)

    def _table_rows(self, table: torch.Tensor, idx: torch.Tensor,
                    side: str) -> torch.Tensor:
        """Rows ``idx`` (global ids) of a ``side`` table, whole or a row
        block under the mesh."""
        if self.layout is None:
            return table[idx]
        return self.layout.rows_many([(table, idx, side)],
                                     dtype=table.dtype)[0]

    def _rows_of(self, table: torch.Tensor, side: str) -> int:
        """The global row count of a ``side`` table (whole or a block)."""
        block = None if self.layout is None else self.layout.blocks[side]
        return table.shape[0] if block is None else block.rows

    def _theta_warmstart(self, theta: TransferParams, mf: MFParams,
                         gen: torch.Generator,
                         steps: Optional[int] = None) -> TransferParams:
        """Fit Θ_side(x, x) ≈ x on table rows drawn from ``gen``, in place:
        at every period start ``last`` equals the tables, so the identity
        is the value-preserving point of the refresh. Adam at
        ``cfg.theta_warmstart_lr`` from zero moments."""
        cfg = self.cfg
        n_rows = cfg.theta_warmstart_rows
        n_steps = cfg.theta_warmstart_steps if steps is None else steps
        leaves = theta_leaves(theta)
        opt = adam_init(leaves)
        loss = None
        n_u = self._rows_of(mf.user_emb, "user")
        n_i = self._rows_of(mf.item_emb, "item")
        for _ in range(n_steps):
            iu = torch.randint(0, n_u, (n_rows,), generator=gen,
                               device=self.device)
            ii = torch.randint(0, n_i, (n_rows,), generator=gen,
                               device=self.device)
            xu = self._table_rows(mf.user_emb, iu, "user")
            xi = self._table_rows(mf.item_emb, ii, "item")
            with torch.enable_grad():
                pu = apply_rows(theta, cfg.transfer, "user", xu, xu)
                pi = apply_rows(theta, cfg.transfer, "item", xi, xi)
                loss = (torch.mean(torch.sum((pu - xu) ** 2, -1))
                        + torch.mean(torch.sum((pi - xi) ** 2, -1)))
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
            opt = adam_update(leaves, grads, opt,
                              lr=cfg.theta_warmstart_lr)
        if loss is not None:
            self.sampler_stats["theta_warmstart_final_loss"] = float(
                loss.detach())
        return theta

    def reinit_theta(self, state: SMLState, salt: int,
                     warmstart: bool = False) -> SMLState:
        """The saddle guard's re-roll: a fresh Θ (and zero Θ moments) from
        a seed derived from the Θ seed and ``salt``; with ``warmstart``
        (the last retry's escalation) or ``theta_warmstart_steps`` it is
        identity-warm-started first."""
        seed = derive_seed(self._theta_seed(), 104729 + salt)
        theta = init_transfer(torch.Generator().manual_seed(seed),
                              self.cfg.transfer, device=self.device)
        steps = self.cfg.theta_warmstart_steps
        if warmstart:
            steps = max(steps, self.cfg.saddle_warmstart_steps)
        if steps > 0:
            theta = self._theta_warmstart(theta, state.mf,
                                          self._generator(seed, 1),
                                          steps=steps)
        return state._replace(theta=theta,
                              tr_opt=adam_init(theta_leaves(theta)))

    def fold_generator(self, gen: torch.Generator,
                       salt: int) -> torch.Generator:
        """A new stream derived from ``gen``'s seed and ``salt`` (a saddle
        retry's fresh data stream)."""
        return self._generator(gen.initial_seed(), 7919 + salt)

    # ------------------------------------------------------------- data prep
    def prep_inner(self, set_t: np.ndarray):
        """Pad and upload the inner pool (and build its sampling index in
        'alone' mode). In 'all' mode with unified pad bounds the pool is
        the same eval-format matrix the eval path uploads, so it is served
        from the upload cache. Under a mesh every rank holds the whole
        epoch (it makes the whole batch's draws); each step keeps its
        rank's block (``train/steps.py``)."""
        bound = self.shape_targets.get("set_t", 0)
        # under a mesh the eval sets hold one data block while every rank
        # trains on the whole epoch, so the upload is not shared there
        if (self.cfg.mf_sample == "all" and bound and self.layout is None
                and self.cfg.upload_dedup
                and bound == self.shape_targets.get("eval")
                and self.cfg.mf_batch_size == self.cfg.eval_batch_size):
            key = _content_key(set_t)
            padded = self._upload_cache.get(key)
            if padded is None:
                padded = pad_rows(set_t, self.cfg.mf_batch_size,
                                  pad_to=bound, device=self.device)
                self._cache_upload(key, padded)
            return padded, None
        padded = pad_rows(set_t, self.cfg.mf_batch_size, pad_to=bound,
                          device=self.device)
        index = (build_period_index(set_t, self.n_items, min_rows=bound,
                                    device=self.device)
                 if self.cfg.mf_sample == "alone"
                 and not self.cfg.replay_mode else None)
        self._probe_sampler("inner", index, set_t)
        return padded, index

    def prep_outer(self, set_tt: np.ndarray):
        bound = self.shape_targets.get("set_tt", 0)
        padded = pad_rows(set_tt, self.cfg.tr_batch_size, pad_to=bound,
                          device=self.device)
        index = (build_period_index(set_tt, self.n_items, min_rows=bound,
                                    device=self.device)
                 if self.cfg.tr_sample_type == "alone"
                 and not self.cfg.replay_mode else None)
        self._probe_sampler("outer", index, set_tt)
        return padded, index

    def _probe_sampler(self, tag: str, index: Optional[PeriodIndex],
                       rows: np.ndarray, cap: int = 8192) -> None:
        """The rejection sampler's fallback and leak rates on this period's
        users (``log_norms`` diagnostics only); draws from its own
        generator, so the run's stream is untouched."""
        if index is None or not self.cfg.log_norms:
            return
        users = torch.from_numpy(np.ascontiguousarray(
            rows[:cap, 0], dtype=np.int64)).to(self.device)
        fb, leak = sampler_stats(index, users, self._generator(0, tag),
                                 self.cfg.neg_tries)
        self.sampler_stats[f"{tag}_fallback_rate"] = float(fb)
        self.sampler_stats[f"{tag}_leak_rate"] = float(leak)

    # ------------------------------------------------------------ operations
    def _snap(self, x: torch.Tensor) -> torch.Tensor:
        """A new buffer in ``cfg.snapshot_dtype``."""
        return x.detach().to(self._snap_dtype(), copy=True)

    def snapshot_last(self, state: SMLState) -> SMLState:
        """``save_MF_weight('last')``."""
        return state._replace(last_user=self._snap(state.mf.user_emb),
                              last_item=self._snap(state.mf.item_emb))

    def snapshot_hat(self, state: SMLState) -> SMLState:
        """``save_MF_weight('hat')``."""
        return state._replace(hat_user=self._snap(state.mf.user_emb),
                              hat_item=self._snap(state.mf.item_emb))

    def load_hat_into_mf(self, state: SMLState) -> SMLState:
        """``load_MFbase_weight(hat)`` (the ``Load_W_hat`` option)."""
        dt = state.mf.user_emb.dtype
        return state._replace(mf=with_tables(
            state.mf, state.hat_user.to(dt, copy=True),
            state.hat_item.to(dt, copy=True)))

    def refresh(self, state: SMLState) -> SMLState:
        """``updata``: MF tables <- Θ(last, hat); for ``conv_com`` on the
        card one K1 launch per side. Under a mesh the snapshots are the
        rank's row blocks, so this is the sharded refresh
        (``apply_tables_sharded``), with no collective."""
        new_u, new_i = apply_tables(
            state.theta, self.cfg.transfer,
            state.last_user, state.hat_user,
            state.last_item, state.hat_item)
        return state._replace(mf=with_tables(state.mf, new_u, new_i))

    def inner_epoch(self, state: SMLState, padded: PaddedRows,
                    index: Optional[PeriodIndex]):
        """One inner (MF) epoch through the frozen Θ: ``ceil(n_real /
        mf_batch_size)`` Adam steps on the tables. Returns ``(state,
        losses)``, ``losses`` the per-batch losses (0 past the real
        batches)."""
        mf, opt, losses = self._inner(
            state.mf, state.mf_opt, state.theta, state.last_user,
            state.last_item, padded.rows, padded.mask, padded.n_real,
            state.gen, index)
        return state._replace(mf=mf, mf_opt=opt), losses

    def outer_epoch(self, state: SMLState, padded: PaddedRows,
                    index: Optional[PeriodIndex]):
        """One outer (Θ) epoch on the detached snapshots."""
        theta, opt, losses = self._outer(
            state.theta, state.tr_opt, state.last_user, state.last_item,
            state.hat_user, state.hat_item, padded.rows, padded.mask,
            padded.n_real, state.gen, index)
        return state._replace(theta=theta, tr_opt=opt), losses

    def diagnostics(self, state: SMLState) -> Dict[str, float]:
        """Mean per-row squared norm of the tables and snapshots (over the
        whole tables under a mesh), and the global L2 norm of Θ."""
        with torch.no_grad():
            def rownorm(t, side):
                t = t.float()
                if self.layout is None:
                    return torch.mean(torch.sum(t * t, dim=-1))
                return (self.layout.sum_rows(torch.sum(t * t), side)
                        / self._rows_of(t, side))
            theta_sq = sum(torch.sum(p * p)
                           for p in theta_leaves(state.theta).values())
            vals = (rownorm(state.mf.user_emb, "user"),
                    rownorm(state.mf.item_emb, "item"),
                    rownorm(state.hat_user, "user"),
                    rownorm(state.hat_item, "item"),
                    rownorm(state.last_user, "user"),
                    rownorm(state.last_item, "item"),
                    torch.sqrt(theta_sq))
            return {n: float(v) for n, v in zip(DIAG_NAMES, vals)}

    def whole_state(self, state: SMLState) -> SMLState:
        """The global state with CPU table leaves: under a mesh the row
        blocks are all-gathered over 'model' (every rank calls this)."""
        if self.layout is None:
            return state
        from sml_tpu_torch.parallel.multihost import whole_state
        return whole_state(state, self.mesh, self.n_users, self.n_items)

    def fetch_host(self, tree):
        """Tensors of a nested tuple / list / dict -> numpy on the host; an
        ``SMLState`` under a mesh is made whole first (a collective)."""
        if isinstance(tree, SMLState):
            tree = self.whole_state(tree)
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        if isinstance(tree, dict):
            return {k: self.fetch_host(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            out = [self.fetch_host(v) for v in tree]
            return type(tree)(*out) if hasattr(tree, "_fields") \
                else type(tree)(out)
        return tree

    # ------------------------------------------------------------- evaluation
    def make_eval_set(self, test_rows: np.ndarray,
                      build_mask: bool = False) -> PaddedRows:
        """Pad and upload an eval set once; reuse it across ``evaluate``
        calls. ``build_mask`` also attaches the packed negative mask
        (honoured only when the engine's policy wants masks); a cached
        entry without one is upgraded in place. Inside a trace, the
        content hash, the padding and upload and the mask are spans of
        their own (``eval_set_hash``, ``eval_set_pad_upload``,
        ``eval_set_mask``)."""
        build_mask = build_mask and self._want_masks
        if self.layout is not None:
            return self._make_eval_block(test_rows, build_mask)
        key = None
        if self.cfg.upload_dedup:
            with annotate("eval_set_hash"):
                key = _content_key(test_rows)
            hit = self._upload_cache.get(key)
            if hit is not None:
                if build_mask and hit.cand_mask is None:
                    hit = hit._replace(cand_mask=self._build_cand_mask(hit))
                    self._cache_upload(key, hit)
                return hit
        with annotate("eval_set_pad_upload"):
            padded = pad_rows(test_rows, self.cfg.eval_batch_size,
                              pad_to=self.shape_targets.get("eval", 0),
                              device=self.device)
        if build_mask:
            padded = padded._replace(cand_mask=self._build_cand_mask(padded))
        if key is not None:
            self._cache_upload(key, padded)
        return padded

    def _make_eval_block(self, test_rows: np.ndarray,
                         build_mask: bool) -> PaddedRows:
        """:meth:`make_eval_set` under a mesh: this rank's block over
        'data' of the padded set, padded so that every block is a whole
        number of eval batches; ``n_real`` stays the global count. The
        cache is keyed on the block's rows (and the set's shape)."""
        n, b = test_rows.shape[0], self.cfg.eval_batch_size
        n_pad = max(bucket_rows(n, b),
                    bucket_rows(self.shape_targets.get("eval", 0), b))
        per = b * self.mesh.shape["data"]
        sl = self.layout.data_slice(-(-n_pad // per) * per)
        part = np.ascontiguousarray(test_rows[sl.start:min(sl.stop, n)])
        key = None
        if self.cfg.upload_dedup:
            with annotate("eval_set_hash"):
                key = ("block", test_rows.shape, sl.start, sl.stop,
                       _content_key(part))
            hit = self._upload_cache.get(key)
            if hit is not None:
                if build_mask and hit.cand_mask is None:
                    hit = hit._replace(cand_mask=self._build_cand_mask(hit))
                    self._cache_upload(key, hit)
                return hit
        with annotate("eval_set_pad_upload"):
            rows = np.zeros((sl.stop - sl.start, test_rows.shape[1]),
                            np.int32)
            rows[:part.shape[0]] = part
            mask = np.zeros(rows.shape[0], np.float32)
            mask[:part.shape[0]] = 1.0
            padded = PaddedRows(torch.from_numpy(rows).to(self.device),
                                torch.from_numpy(mask).to(self.device), n)
        if build_mask:
            padded = padded._replace(cand_mask=self._build_cand_mask(padded))
        if key is not None:
            self._cache_upload(key, padded)
        return padded

    def _eval_inputs(self, mf: MFParams, padded: PaddedRows):
        """``(mf, user_rows)`` for the evaluators: single-rank, the tables
        as they are; under a mesh the item table all-gathered over 'model'
        and the rows' user rows read once through the collective lookup."""
        if self.layout is None:
            return mf, None
        users = self._table_rows(mf.user_emb, padded.rows[:, 0], "user")
        return (mf._replace(item_emb=self.layout.whole(mf.item_emb, "item")),
                users)

    def _sum_data(self, tree):
        """A nested dict / tuple of f32 sums, summed over 'data' in one
        all-reduce (single-rank: as it is)."""
        if self.layout is None:
            return tree
        flat = []

        def collect(t):
            if isinstance(t, dict):
                return {k: collect(v) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(collect(v) for v in t)
            flat.append(t)
            return len(flat) - 1
        shape = collect(tree)
        summed = self.layout.sum_data(torch.cat([t.reshape(-1)
                                                 for t in flat]))
        parts = summed.split([t.numel() for t in flat])

        def rebuild(t):
            if isinstance(t, dict):
                return {k: rebuild(v) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(rebuild(v) for v in t)
            return parts[t].view_as(flat[t])
        return rebuild(shape)

    def _build_cand_mask(self, padded: PaddedRows) -> torch.Tensor:
        """Packed mask over the negatives ``rows[:, 2:]`` (col 0 is the
        user, col 1 the target)."""
        with annotate("eval_set_mask"):
            return eval_kernel.build_packed_mask(padded.rows[:, 2:],
                                                 self.n_items)

    def _cache_upload(self, key, padded: PaddedRows) -> None:
        with self._upload_lock:
            self._upload_cache.pop(key, None)
            self._upload_cache[key] = padded
            while len(self._upload_cache) > self._upload_cache_cap:
                self._upload_cache.pop(next(iter(self._upload_cache)))

    def evaluate_deferred(self, mf: MFParams, test_rows):
        """Run an eval without reading the result back: ``(sums, n)`` with
        ``sums`` = {K: (hit, ndcg)} 0-d tensors on the device (under a mesh
        already summed over 'data')."""
        padded = (test_rows if isinstance(test_rows, PaddedRows)
                  else self.make_eval_set(test_rows))
        mf, users = self._eval_inputs(mf, padded)
        sums = self._eval(mf, padded.rows, padded.mask, padded.cand_mask,
                          user_rows=users)
        return self._sum_data(sums), max(padded.n_real, 1)

    def resolve_evals(self, deferred):
        """``evaluate_deferred`` results -> list of {K: {recall, ndcg}}."""
        return [{k: {"recall": float(h) / n, "ndcg": float(nd) / n}
                 for k, (h, nd) in sums.items()}
                for sums, n in deferred]

    def evaluate(self, mf: MFParams, test_rows) -> Dict[int, Dict[str, float]]:
        """recall@K / NDCG@K over eval-format rows (numpy or a
        ``make_eval_set`` result); all Ks in one pass."""
        return self.resolve_evals([self.evaluate_deferred(mf, test_rows)])[0]

    def evaluate_attributed_deferred(self, mf: MFParams, test_rows,
                                     is_new_user: torch.Tensor,
                                     is_new_item: torch.Tensor):
        """The hit-attribution evaluation (the reference's
        ``test_model_pre``) without reading the result back: ``(out, n)``
        with ``out`` the device dict of
        :func:`eval.evaluator.make_attributed_eval_fn` (its ``base`` holds
        the plain hit/NDCG sums). ``is_new_user`` (U,) and ``is_new_item``
        (I,) are 0/1 f32 tensors on the engine's device."""
        padded = (test_rows if isinstance(test_rows, PaddedRows)
                  else self.make_eval_set(test_rows))
        mf, users = self._eval_inputs(mf, padded)
        out = self._eval_attr(mf, padded.rows, padded.mask, is_new_user,
                              is_new_item, padded.cand_mask,
                              user_rows=users)
        return self._sum_data(out), max(padded.n_real, 1)

    def resolve_attributed(self, deferred):
        """``evaluate_attributed_deferred`` results -> one record each: the
        hit shares of new users and new items per K, and the four
        old/new-user x old/new-item buckets at the largest K as shares of
        all hits and of the test count."""
        results = []
        for out, n in deferred:
            buckets = [float(x) for x in out["buckets_at_max_k"]]
            all_hits = max(sum(buckets), 1.0)
            rec = {}
            for k in self.cfg.topk:
                rec[f"hit_share_new_user@{k}"] = \
                    float(out["hit_new_user"][k]) / n
                rec[f"hit_share_new_item@{k}"] = \
                    float(out["hit_new_item"][k]) / n
            for name, v in zip(("old_user_old_item", "old_user_new_item",
                                "new_user_old_item", "new_user_new_item"),
                               buckets):
                rec[f"{name}_of_hits"] = v / all_hits
                rec[f"{name}_of_test"] = v / n
            results.append(rec)
        return results

    def evaluate_attributed(self, mf: MFParams, test_rows,
                            is_new_user: torch.Tensor,
                            is_new_item: torch.Tensor) -> Dict[str, float]:
        """One attributed evaluation, read back: the record of
        :meth:`resolve_attributed`."""
        return self.resolve_attributed([self.evaluate_attributed_deferred(
            mf, test_rows, is_new_user, is_new_item)])[0]

    def serve_topk(self, mf: MFParams, users: torch.Tensor, k: int,
                   compute_dtype=None, topk_method: str = "exact"):
        """Full-catalog top-K for ``users`` from the state's tables:
        ``eval.full_ranking``'s dense path, or under a mesh whose item
        table is row-sharded its sharded merge (user rows through the
        collective lookup). Returns (scores, ids), the same on every
        rank."""
        from sml_tpu_torch.eval.full_ranking import (dense_full_topk,
                                                     make_sharded_full_topk)
        rows = self._table_rows(mf.user_emb, users.long(), "user")
        if self.layout is not None and self.layout.sharded("item"):
            return make_sharded_full_topk(self.mesh, k, compute_dtype,
                                          topk_method)(rows, mf.item_emb)
        return dense_full_topk(rows, mf.item_emb, k, compute_dtype,
                               topk_method)

    def new_entity_masks(self, new_users: np.ndarray,
                         new_items: np.ndarray):
        """0/1 f32 masks over the user and item ids (on the engine's
        device) from the dataset's new-entity id files; every rank holds
        them whole under a mesh (they are small, as in the JAX package)."""
        def mask(n, ids):
            m = torch.zeros(n, dtype=torch.float32, device=self.device)
            m[torch.from_numpy(np.asarray(ids, np.int64)).to(
                self.device)] = 1.0
            return m
        return mask(self.n_users, new_users), mask(self.n_items, new_items)
