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

Tables, Θ and moments are updated in place. Besides the epoch-at-a-time
operations the driver's unfused path calls, the engine has the JAX
package's fused programs: :meth:`SMLEngine.phase_step` runs one SML phase
(inner epochs -> hat snapshot -> refresh -> outer epochs, each with its
refresh, the val evals inside when given) and :meth:`SMLEngine.period_step`
a period's phases, stacking their losses, eval sums and weight norms. The
phase is the same calls in the same order as the unfused driver's, on
fixed buffers the program owns (a state slot and input buffers, copied
into before each run; the refresh and the snapshot write into the slot's
tables, the Adam steps read their bias corrections and the epochs which
step slots run from device tables). As the JAX package compiles its period
program once, one phase program serves a sweep: on the card it is captured
once as a CUDA graph and replayed in every period, whatever the period's
row counts (``train/graphs.py``); on the CPU it runs eagerly, which is its
plain version. No mesh: gloo's collectives cannot be captured.

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
from sml_tpu_torch.ops.batching import (PaddedRows, bucket_rows,
                                        num_batches, pad_rows)
from sml_tpu_torch.parallel.sharding import (TableLayout, shard_rows,
                                             state_shardings)
from sml_tpu_torch.ops.sampling import (PeriodIndex, build_period_index,
                                        sampler_stats)
from sml_tpu_torch.train import graphs
from sml_tpu_torch.train.optim import (AdamState, BiasTable, adam_init,
                                       adam_update, copy_opt_state)
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
        # the fused phase programs, by their inputs' shapes (one per sweep
        # under uniform shapes), and the site their graphs run on; its
        # counts: programs made, eager warm-up phases on the capture
        # stream, captures, replays, and the host seconds spent in warm-ups
        # and captures
        self._programs: Dict[tuple, _PhaseProgram] = {}
        self._site = graphs.GraphSite(self.device)
        self.graph_stats = self._site.stats

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

    # ---------------------------------------------------- fused programs
    def fused_program_warm(self) -> bool:
        """The route ``fuse_period="auto"`` takes: True (fused: each phase
        a CUDA-graph replay) on a CUDA engine, False (the eager per-phase
        path) on the CPU and under a mesh. The JAX package's marker file
        avoided a first XLA compile of minutes; a capture costs about one
        eager phase, so the port needs none."""
        return self.device.type == "cuda" and self.mesh is None

    def _program(self, state: SMLState, prep_t, prep_tt, ev,
                 want_diag: bool) -> "_PhaseProgram":
        """The phase program for inputs of these shapes, made on first use
        and kept until :meth:`release_programs`: the JAX package compiles
        its period program once per ``(length, want_diag)``, and
        ``uniform_shapes`` gives every period one shape, so a sweep makes
        one (replay mode, whose shapes differ by period, one per
        shape)."""
        if self.mesh is not None:
            raise ValueError(
                "the fused phase and period programs do not run under a "
                "mesh: gloo's collectives cannot be captured (ROADMAP §2, "
                "fused periods over NCCL); use fuse_period=False")
        key = (want_diag, ev is not None,
               graphs.shape_key(*_prep_tensors(prep_t),
                                *_prep_tensors(prep_tt), *(ev or ())))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _PhaseProgram(
                self, state, prep_t, prep_tt, ev, want_diag)
        prog.load_inputs(prep_t, prep_tt, ev)
        return prog

    def release_programs(self) -> None:
        """Drop the phase programs (their graphs and buffers)."""
        self._programs.clear()

    def phase_step(self, state: SMLState, prep_t, prep_tt):
        """One fused SML phase; returns ``(state, last_inner_losses,
        last_outer_losses)``. The same calls in the same order as the
        driver's unfused phase (so the same numbers and draws); on the
        card a CUDA-graph replay once the program is captured. The state
        returned holds the program's buffers."""
        prog = self._program(state, prep_t, prep_tt, None, False)
        state = prog.run(state)
        return state, prog.il.clone(), prog.ol.clone()

    def period_step(self, state: SMLState, prep_t, prep_tt, n_phases: int,
                    val: Optional[PaddedRows] = None,
                    want_diag: bool = False):
        """``n_phases`` fused SML phases; returns ``(state, evals, (ils,
        ols), diags)``. ``ils``/``ols``: the last inner/outer epoch's
        per-batch losses of each phase, ``(n_phases, n_batches)``;
        ``evals``: {} or, when ``val`` (a ``make_eval_set`` result) is
        given and in-training evals are on, ``{"inner"/"outer": {K: (hit,
        ndcg)}}`` sums of shape ``(n_phases, epochs)``, observed on the
        same intermediate states as the unfused path's evals (expand them
        with :meth:`resolve_stacked_evals`); ``diags``: with ``want_diag``
        the 7 :data:`DIAG_NAMES` norms of each phase-end state, each
        ``(n_phases,)``, else ``()``. Nothing is read back to the host; the
        state returned holds the program's buffers."""
        cfg = self.cfg
        ev = None
        if val is not None and (cfg.eval_during_inner
                                or cfg.eval_during_outer):
            ev = (val.rows, val.mask, val.cand_mask)
        prog = self._program(state, prep_t, prep_tt, ev, want_diag)

        def stack(buf):
            return (None if buf is None else
                    torch.zeros((n_phases, *buf.shape), dtype=buf.dtype,
                                device=self.device))
        outs = [(prog.il, stack(prog.il)), (prog.ol, stack(prog.ol)),
                (prog.ev_in, stack(prog.ev_in)),
                (prog.ev_out, stack(prog.ev_out)),
                (prog.diag, stack(prog.diag))]
        for p in range(n_phases):
            state = prog.run(state)
            for buf, st in outs:
                if buf is not None:
                    st[p].copy_(buf)
        ils, ols, ev_in, ev_out, diag = (st for _, st in outs)
        evals = {}
        for name, st in (("inner", ev_in), ("outer", ev_out)):
            if st is not None:
                evals[name] = {k: (st[:, :, i, 0], st[:, :, i, 1])
                               for i, k in enumerate(cfg.topk)}
        diags = (() if diag is None
                 else tuple(diag[:, i] for i in range(len(DIAG_NAMES))))
        return state, evals, (ils, ols), diags

    def resolve_stacked_evals(self, bundles):
        """Expand ``period_step`` eval bundles into the per-epoch records
        the unfused path logs, in its order (per phase: the inner epochs,
        then the outer epochs). ``bundles``: a list of ``(evals, n)`` or
        ``(evals, n, keep)``, ``keep`` limiting the expansion to the first
        ``keep`` phases (a guard-aborted attempt keeps the phases the
        unfused guard would have run). Returns one list of ``(kind, epoch,
        {K: {recall, ndcg}})`` per bundle, after one host fetch for all."""
        if not bundles:
            return []
        flat = [t for b in bundles for sec in b[0].values()
                for pair in sec.values() for t in pair]
        host = (torch.cat([t.reshape(-1) for t in flat]).cpu().numpy()
                if flat else np.zeros(0, np.float32))
        pos = 0

        def take(t):
            nonlocal pos
            out = host[pos:pos + t.numel()].reshape(tuple(t.shape))
            pos += t.numel()
            return out
        out_all = []
        for bundle in bundles:
            evals, n = bundle[0], bundle[1]
            keep = bundle[2] if len(bundle) > 2 else None
            sections = [(kind, {k: (take(h), take(nd))
                                for k, (h, nd) in evals[key].items()})
                        for kind, key in (("inner_eval", "inner"),
                                          ("outer_eval", "outer"))
                        if key in evals]
            out = []
            if sections:
                n_phases = next(iter(sections[0][1].values()))[0].shape[0]
                if keep is not None:
                    n_phases = min(n_phases, keep)
                for p in range(n_phases):
                    for kind, sec in sections:
                        epochs = next(iter(sec.values()))[0].shape[1]
                        for e in range(epochs):
                            out.append((kind, e,
                                        {k: {"recall": float(h[p, e]) / n,
                                             "ndcg": float(nd[p, e]) / n}
                                         for k, (h, nd) in sec.items()}))
            out_all.append(out)
        return out_all

    def _diag_values(self, state: SMLState):
        """The :data:`DIAG_NAMES` values as 0-d tensors on the device."""
        with torch.no_grad():
            def rownorm(t, side):
                t = t.float()
                if self.layout is None:
                    return torch.mean(torch.sum(t * t, dim=-1))
                return (self.layout.sum_rows(torch.sum(t * t), side)
                        / self._rows_of(t, side))
            theta_sq = sum(torch.sum(p * p)
                           for p in theta_leaves(state.theta).values())
            return (rownorm(state.mf.user_emb, "user"),
                    rownorm(state.mf.item_emb, "item"),
                    rownorm(state.hat_user, "user"),
                    rownorm(state.hat_item, "item"),
                    rownorm(state.last_user, "user"),
                    rownorm(state.last_item, "item"),
                    torch.sqrt(theta_sq))

    def diagnostics(self, state: SMLState) -> Dict[str, float]:
        """Mean per-row squared norm of the tables and snapshots (over the
        whole tables under a mesh), and the global L2 norm of Θ."""
        return {n: float(v)
                for n, v in zip(DIAG_NAMES, self._diag_values(state))}

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
        return dense_full_topk(rows, mf.item_emb, k,
                               compute_dtype=compute_dtype,
                               topk_method=topk_method)

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


def _state_tensors(state: SMLState) -> list:
    """The buffers a phase reads and writes: the tables, snapshots, Θ and
    both optimizers' moments (by name)."""
    tensors = [*state.mf, state.last_user, state.last_item, state.hat_user,
               state.hat_item, *theta_leaves(state.theta).values()]
    for opt in (state.mf_opt, state.tr_opt):
        tensors += [opt.mu[k] for k in sorted(opt.mu)]
        tensors += [opt.nu[k] for k in sorted(opt.nu)]
    return tensors


def _prep_tensors(prep) -> tuple:
    """The tensors of a ``prep_inner`` / ``prep_outer`` result that an
    epoch reads: rows, mask and the sampling index (None where absent)."""
    padded, index = prep
    return (padded.rows, padded.mask,
            *(index if index is not None else (None,) * 5))


def _clone_prep(prep):
    padded, index = prep
    return (PaddedRows(padded.rows.clone(), padded.mask.clone(),
                       padded.n_real),
            None if index is None else PeriodIndex(*(t.clone()
                                                     for t in index)))


class _PhaseProgram(graphs.Program):
    """One SML phase on fixed buffers (``train/graphs.py``): the driver's
    unfused phase (``_inner_block``, ``snapshot_hat``, ``refresh``,
    ``_outer_block``) as the same calls in the same order, on buffers the
    program owns, which change no number:

    * a state slot (tables, snapshots, Θ, both optimizers' moments) and
      input buffers at the inputs' padded shapes (set_t and set_tt rows,
      masks and sampling indexes, and the val set when the evals run
      inside); :meth:`load_inputs` copies a period's inputs in, and
      :meth:`run` copies in every state buffer that is not the slot's
      (the snapshots are new tensors each period) and returns a state
      that holds the slot;
    * the hat snapshot is copied into the slot's ``hat_*`` buffers, each
      refresh writes into the MF tables themselves (``apply_tables(...,
      out=)``), and ``load_w_hat`` copies the snapshot into the tables;
    * the epochs write their losses into :attr:`il` / :attr:`ol`, the val
      evals their sums into :attr:`ev_in` / :attr:`ev_out` (``(epochs, K,
      2)``: hit, NDCG) and, with ``want_diag``, the phase-end norms go
      into :attr:`diag`;
    * every step slot of an epoch runs under ``graphs.step_if`` on a
      :class:`~sml_tpu_torch.train.graphs.SlotTable` marked with the
      period's ``ceil(n_real/B)``, and the Adam steps read their bias
      corrections from two
      :class:`~sml_tpu_torch.train.optim.BiasTable`, filled from the
      state's counts before every run.

    So one capture serves every period of a sweep: on the card the run
    after the engine's warm-up captures the phase, and every run from then
    on is a replay; on the CPU it runs eagerly."""

    def __init__(self, eng: SMLEngine, state: SMLState, prep_t, prep_tt,
                 ev, want_diag: bool):
        super().__init__(eng._site)
        cfg = eng.cfg
        self.eng, self.cfg = eng, cfg
        self.slot = copy_state(state)._replace(gen=None)
        _check_disjoint(self.slot)
        self.t, self.tt = _clone_prep(prep_t), _clone_prep(prep_tt)
        self.ev = (None if ev is None else
                   tuple(None if x is None else x.clone() for x in ev))
        dev = eng.device
        nb_in = self.t[0].rows.shape[0] // cfg.mf_batch_size
        nb_out = self.tt[0].rows.shape[0] // cfg.tr_batch_size
        self.t_slots = graphs.SlotTable(nb_in, dev)
        self.tt_slots = graphs.SlotTable(nb_out, dev)
        self.mf_bias = BiasTable(nb_in, dev, epochs=cfg.mf_epochs)
        self.tr_bias = BiasTable(nb_out, dev, epochs=cfg.tr_epochs)
        self.taken = (0, 0)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        self.il, self.ol = zeros(nb_in), zeros(nb_out)
        n_k = len(cfg.topk)
        self.ev_in = (zeros(cfg.mf_epochs, n_k, 2)
                      if ev is not None and cfg.eval_during_inner else None)
        self.ev_out = (zeros(cfg.tr_epochs, n_k, 2)
                       if ev is not None and cfg.eval_during_outer
                       and cfg.refresh_after_outer_epoch else None)
        self.diag = zeros(len(DIAG_NAMES)) if want_diag else None

    def load_inputs(self, prep_t, prep_tt, ev) -> None:
        """Copy a period's prepared inputs into the program's buffers and
        mark each epoch's real batches (``ceil(n_real/B)``) taken."""
        dst = [x for x in (*_prep_tensors(self.t), *_prep_tensors(self.tt),
                           *(self.ev or ())) if x is not None]
        src = [x for x in (*_prep_tensors(prep_t), *_prep_tensors(prep_tt),
                           *(ev or ())) if x is not None]
        graphs.load_into(dst, src)
        cfg = self.cfg
        self.taken = (
            min(num_batches(prep_t[0].n_real, cfg.mf_batch_size),
                self.t_slots.host.shape[0]),
            min(num_batches(prep_tt[0].n_real, cfg.tr_batch_size),
                self.tt_slots.host.shape[0]))
        self.t_slots.fill(self.taken[0])
        self.tt_slots.fill(self.taken[1])

    def _eval_into(self, buf: torch.Tensor, mf: MFParams) -> None:
        rows, mask, cand_mask = self.ev
        sums = self.eng._eval(mf, rows, mask, cand_mask)
        buf.copy_(torch.stack([torch.stack(sums[k]) for k in self.cfg.topk]))

    def _refresh(self, state: SMLState) -> None:
        apply_tables(state.theta, self.cfg.transfer,
                     state.last_user, state.hat_user,
                     state.last_item, state.hat_item,
                     out=(state.mf.user_emb, state.mf.item_emb))

    def body(self, gen: torch.Generator) -> None:
        cfg, eng, st = self.cfg, self.eng, self.slot
        (pt, it), (ptt, itt) = self.t, self.tt
        mf_opt = st.mf_opt._replace(bias=self.mf_bias)
        tr_opt = st.tr_opt._replace(bias=self.tr_bias)
        for e in range(cfg.mf_epochs):
            eng._inner(st.mf, mf_opt._replace(
                count=self.mf_bias.epoch_count(e)), st.theta, st.last_user,
                st.last_item, pt.rows, pt.mask, pt.n_real, gen, it,
                losses=self.il, slots=self.t_slots)
            if self.ev_in is not None:
                self._eval_into(self.ev_in[e], st.mf)
        with torch.no_grad():
            st.hat_user.copy_(st.mf.user_emb)
            st.hat_item.copy_(st.mf.item_emb)
        self._refresh(st)
        for e in range(cfg.tr_epochs):
            eng._outer(st.theta, tr_opt._replace(
                count=self.tr_bias.epoch_count(e)), st.last_user,
                st.last_item, st.hat_user, st.hat_item, ptt.rows, ptt.mask,
                ptt.n_real, gen, itt, losses=self.ol, slots=self.tt_slots)
            if cfg.refresh_after_outer_epoch:
                self._refresh(st)
                if self.ev_out is not None:
                    self._eval_into(self.ev_out[e], st.mf)
        if cfg.load_w_hat:
            with torch.no_grad():
                st.mf.user_emb.copy_(st.hat_user)
                st.mf.item_emb.copy_(st.hat_item)
        if self.diag is not None:
            self.diag.copy_(torch.stack(eng._diag_values(st)))

    def run(self, state: SMLState) -> SMLState:
        """One phase from ``state`` on the loaded inputs; returns the state
        after it (the slot's buffers, ``state``'s generator advanced), its
        step counts advanced by the real steps."""
        slot = self.slot
        graphs.load_into(_state_tensors(slot), _state_tensors(state))
        c_mf, c_tr = state.mf_opt.count, state.tr_opt.count
        self.mf_bias.fill(c_mf, self.taken[0])
        self.tr_bias.fill(c_tr, self.taken[1])
        self.launch(state.gen)
        return slot._replace(
            gen=state.gen,
            mf_opt=AdamState(c_mf + self.cfg.mf_epochs * self.taken[0],
                             slot.mf_opt.mu, slot.mf_opt.nu),
            tr_opt=AdamState(c_tr + self.cfg.tr_epochs * self.taken[1],
                             slot.tr_opt.mu, slot.tr_opt.nu))


def _check_disjoint(state: SMLState) -> None:
    """The fused phase writes the MF tables and the hat snapshots in place:
    none of them may share memory with another or with ``last``."""
    ts = [state.mf.user_emb, state.mf.item_emb, state.hat_user,
          state.hat_item, state.last_user, state.last_item]
    spans = [(t.untyped_storage().data_ptr(),
              t.untyped_storage().data_ptr() + t.untyped_storage().nbytes())
             for t in ts]
    for a in range(len(spans)):
        for b in range(a + 1, len(spans)):
            if spans[a][0] < spans[b][1] and spans[b][0] < spans[a][1]:
                raise ValueError("the state's tables and snapshots share "
                                 "memory; the fused phase writes them in "
                                 "place")
