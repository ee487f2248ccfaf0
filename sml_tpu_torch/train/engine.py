"""SML engine, serving half (counterpart of ``sml_tpu/train/engine.py``).

Holds what publishes and serves period *t*'s model: the state record, the
``last``/``hat`` snapshots, the full-table refresh ``W_t = Θ(W_{t-1},
Ŵ_t)`` (kernel K1 on the card) and the leave-one-out evaluation with
packed candidate masks (kernel K2 on the card). The inner and outer
training epochs come with the training slice.
"""

from __future__ import annotations

import hashlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from sml_tpu_torch.config import SMLConfig
from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.eval.evaluator import make_eval_fn
from sml_tpu_torch.models.mf import MFParams, init_mf, with_tables
from sml_tpu_torch.models.transfer import (TransferParams, apply_tables,
                                           init_transfer)
from sml_tpu_torch.ops import eval_kernel
from sml_tpu_torch.ops.batching import PaddedRows, pad_rows

_SNAPSHOT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TRAINING = ("training is not ported yet: inner/outer epochs, optimizers "
             "and Θ warm-start come with slice 2 (ROADMAP.md §1)")


class SMLState(NamedTuple):
    """What evolves across periods: ``last_*`` = W_{t-1}, ``hat_*`` =
    Ŵ_t, stored in ``cfg.snapshot_dtype``."""
    mf: MFParams
    theta: TransferParams
    last_user: torch.Tensor
    last_item: torch.Tensor
    hat_user: torch.Tensor
    hat_item: torch.Tensor


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
        self.cfg = cfg
        self.n_users = n_users
        self.n_items = n_items
        self._eval = make_eval_fn(cfg.topk, cfg.eval_batch_size,
                                  scoring=cfg.eval_scoring)
        # packed candidate masks for the masked scoring modes, or for eval
        # sets the protocol re-evaluates (in-training evals)
        self._want_masks = (
            cfg.eval_scoring in ("masked", "masked_bf16")
            or (cfg.eval_scoring == "auto"
                and (cfg.eval_during_inner or cfg.eval_during_outer)
                and n_items <= cfg.eval_mask_max_items))
        # content-keyed cache of uploaded eval sets (the same test/<p>.npy
        # serves as period t's val and period t+1's test)
        self._upload_cache: Dict[tuple, PaddedRows] = {}
        self._upload_cache_cap = 3

    # ------------------------------------------------------------------ state
    def _snap_dtype(self) -> torch.dtype:
        return _SNAPSHOT_DTYPES[self.cfg.snapshot_dtype]

    def init_state(self, pretrained_mf: Optional[MFParams] = None
                   ) -> SMLState:
        """Fresh state: ``last`` at zeros, ``hat`` at the (pretrained)
        tables. Tables draw from a CPU generator seeded ``cfg.seed``, Θ
        from one seeded ``cfg.theta_seed`` (default ``cfg.seed + 1``), so
        one seed gives the same state on every device."""
        if self.cfg.theta_warmstart_steps > 0:
            raise NotImplementedError(_TRAINING)
        if pretrained_mf is not None:
            mf = MFParams(*(torch.as_tensor(t).to(self.device, copy=True)
                            for t in pretrained_mf))
        else:
            gen = torch.Generator().manual_seed(self.cfg.seed)
            mf = init_mf(gen, self.n_users, self.n_items,
                         self.cfg.latent_dim, device=self.device,
                         emb_scale=self.cfg.emb_init_scale)
        theta_seed = (self.cfg.theta_seed if self.cfg.theta_seed is not None
                      else self.cfg.seed + 1)
        theta = init_transfer(torch.Generator().manual_seed(theta_seed),
                              self.cfg.transfer, device=self.device)
        sdt = self._snap_dtype()
        return SMLState(
            mf=mf, theta=theta,
            last_user=torch.zeros(mf.user_emb.shape, dtype=sdt,
                                  device=self.device),
            last_item=torch.zeros(mf.item_emb.shape, dtype=sdt,
                                  device=self.device),
            hat_user=self._snap(mf.user_emb),
            hat_item=self._snap(mf.item_emb))

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
        """``updata``: MF tables <- Θ(last, hat); on the card one K1 launch
        per side."""
        new_u, new_i = apply_tables(
            state.theta, self.cfg.transfer,
            state.last_user, state.hat_user,
            state.last_item, state.hat_item)
        return state._replace(mf=with_tables(state.mf, new_u, new_i))

    def inner_epoch(self, state, padded, index):
        raise NotImplementedError(_TRAINING)

    def outer_epoch(self, state, padded, index):
        raise NotImplementedError(_TRAINING)

    # ------------------------------------------------------------- evaluation
    def make_eval_set(self, test_rows: np.ndarray,
                      build_mask: bool = False) -> PaddedRows:
        """Pad and upload an eval set once; reuse it across ``evaluate``
        calls. ``build_mask`` also attaches the packed negative mask
        (honoured only when the engine's policy wants masks); a cached
        entry without one is upgraded in place."""
        build_mask = build_mask and self._want_masks
        key = _content_key(test_rows) if self.cfg.upload_dedup else None
        if key is not None:
            hit = self._upload_cache.get(key)
            if hit is not None:
                if build_mask and hit.cand_mask is None:
                    hit = hit._replace(cand_mask=self._build_cand_mask(hit))
                    self._cache_upload(key, hit)
                return hit
        padded = pad_rows(test_rows, self.cfg.eval_batch_size,
                          device=self.device)
        if build_mask:
            padded = padded._replace(cand_mask=self._build_cand_mask(padded))
        if key is not None:
            self._cache_upload(key, padded)
        return padded

    def _build_cand_mask(self, padded: PaddedRows) -> torch.Tensor:
        """Packed mask over the negatives ``rows[:, 2:]`` (col 0 is the
        user, col 1 the target)."""
        return eval_kernel.build_packed_mask(padded.rows[:, 2:],
                                             self.n_items)

    def _cache_upload(self, key, padded: PaddedRows) -> None:
        self._upload_cache.pop(key, None)
        self._upload_cache[key] = padded
        while len(self._upload_cache) > self._upload_cache_cap:
            self._upload_cache.pop(next(iter(self._upload_cache)))

    def evaluate_deferred(self, mf: MFParams, test_rows):
        """Run an eval without reading the result back: ``(sums, n)`` with
        ``sums`` = {K: (hit, ndcg)} 0-d tensors on the device."""
        padded = (test_rows if isinstance(test_rows, PaddedRows)
                  else self.make_eval_set(test_rows))
        return (self._eval(mf, padded.rows, padded.mask, padded.cand_mask),
                max(padded.n_real, 1))

    def resolve_evals(self, deferred):
        """``evaluate_deferred`` results -> list of {K: {recall, ndcg}}."""
        return [{k: {"recall": float(h) / n, "ndcg": float(nd) / n}
                 for k, (h, nd) in sums.items()}
                for sums, n in deferred]

    def evaluate(self, mf: MFParams, test_rows) -> Dict[int, Dict[str, float]]:
        """recall@K / NDCG@K over eval-format rows (numpy or a
        ``make_eval_set`` result); all Ks in one pass."""
        return self.resolve_evals([self.evaluate_deferred(mf, test_rows)])[0]
