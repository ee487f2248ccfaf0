"""Synthetic sequential-recommendation datasets (numpy copy of
``sml_tpu/data/synthetic.py``).

Writes a dataset in the reference's on-disk layout with its statistical
shape: a latent ground-truth factor model scores (user, item) pairs, user
tastes drift over periods, new users and items appear over time, item
popularity follows a power law, and eval rows carry ``neg_num`` negatives
from the seen catalog minus the user's history. Deterministic given the
seed. Interactions are drawn exactly as the JAX package draws them and the
negatives come from the same native sampler, so both packages write the
same files for the same spec.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sml_tpu_torch.data.formats import (DatasetInfo, attach_negatives,
                                        write_dataset)


@dataclass(frozen=True)
class SyntheticSpec:
    n_users: int = 2000
    n_items: int = 1000
    n_periods: int = 12
    interactions_per_period: int = 4000
    latent_dim: int = 4
    drift: float = 0.03               # per-period taste drift magnitude
    # 'random': a white-noise walk; 'rotate': a fixed small rotation of the
    # latent space each period (systematic drift a transfer can learn)
    drift_mode: str = "random"
    new_entity_rate: float = 0.06     # fraction of catalog unlocked per period
    first_test_period: int = 4        # periods >= this get test/<p>.npy files
    neg_num: int = 999
    seed: int = 0


def generate_synthetic_dataset(path: str, spec: SyntheticSpec) -> DatasetInfo:
    """Generate and write a dataset under ``path``; returns its info."""
    rng = np.random.default_rng(spec.seed)
    U, I, D = spec.n_users, spec.n_items, spec.latent_dim

    user_f = rng.normal(0, 1.0, size=(U, D))
    item_f = rng.normal(0, 1.0, size=(I, D))
    pop = -np.log(np.arange(1, I + 1) / I)
    pop = pop / pop.max()

    def active_counts(p: int) -> tuple:
        frac = min(1.0, (1.0 - spec.new_entity_rate * spec.n_periods)
                   + spec.new_entity_rate * (p + 1))
        frac = max(frac, 0.3)
        return max(32, int(U * frac)), max(32, int(I * frac))

    train_periods = []
    test_periods = {}
    users_seen_before_test: set = set()
    items_seen_before_test: set = set()

    rot_angles = (rng.uniform(0.5, 1.5, size=D // 2) * spec.drift
                  if spec.drift_mode == "rotate" else None)

    def rotate(f):
        f = f.copy()
        for pidx in range(D // 2):
            a, b = 2 * pidx, 2 * pidx + 1
            c, s = np.cos(rot_angles[pidx]), np.sin(rot_angles[pidx])
            fa = c * f[:, a] - s * f[:, b]
            fb = s * f[:, a] + c * f[:, b]
            f[:, a], f[:, b] = fa, fb
        return f

    for p in range(spec.n_periods):
        au, ai = active_counts(p)
        if spec.drift_mode == "rotate":
            user_f = rotate(user_f)
        else:
            user_f = user_f + rng.normal(0, spec.drift, size=user_f.shape)
        users = rng.integers(0, au, size=spec.interactions_per_period)
        # argmax over a scored slate: preference-correlated interactions
        slate = rng.integers(0, ai, size=(spec.interactions_per_period, 8))
        logits = np.einsum("nd,nkd->nk", user_f[users], item_f[slate]) \
            + 1.5 * pop[slate] + rng.gumbel(0, 1.0, size=slate.shape)
        items = slate[np.arange(slate.shape[0]), logits.argmax(axis=1)]
        inter = np.stack([users, items], axis=1).astype(np.int64)
        train_periods.append(inter)
        if p < spec.first_test_period:
            users_seen_before_test.update(int(u) for u in users)
            items_seen_before_test.update(int(i) for i in items)
        else:
            # negatives from the history and catalog known through period
            # p, never future interactions
            history = np.concatenate(train_periods, axis=0)
            catalog = np.unique(history[:, 1])
            test_periods[p] = attach_negatives(
                inter, history, catalog, spec.neg_num,
                seed=spec.seed * 1000 + p)

    all_users = np.unique(np.concatenate([t[:, 0] for t in train_periods]))
    all_items = np.unique(np.concatenate([t[:, 1] for t in train_periods]))
    new_users = np.array(sorted(set(map(int, all_users))
                                - users_seen_before_test), dtype=np.int64)
    new_items = np.array(sorted(set(map(int, all_items))
                                - items_seen_before_test), dtype=np.int64)

    info = DatasetInfo(
        n_interactions=int(sum(t.shape[0] for t in train_periods)),
        n_users=U, n_items=I)
    write_dataset(path, train_periods, test_periods, info,
                  new_user_ids=new_users, new_item_ids=new_items)
    return info
