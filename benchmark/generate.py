"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and makes the inputs of a run from its seed.

* ``sweep`` mixes: a dataset of periods in the port's on-disk format
  (``information.npy``, ``train/<p>.npy`` ``[user, item]``,
  ``test/<p>.npy`` ``[user, pos, neg_1..neg_k]``, int32), written under a
  directory the caller gives (the run's ``TMPDIR``). Each period holds
  ``interactions`` rows whose users and items are drawn Zipf(s) over the
  whole id ranges (ranks scattered over the ids by a permutation from the
  seed); each test row holds ``neg_num`` distinct negatives drawn uniformly
  outside the user's history (every pair of the dataset), as the
  reference's ``select_neg_forinteraction`` does. ``distinct_periods`` are
  drawn; the later periods of the ``periods`` the driver may read are hard
  links to them in turn, so a run writes the distinct ones only.
* ``serve`` mixes: page requests of n users, P(n) ~ n^-a over
  ``[min_users, max_users]``, users drawn Zipf(s) over the user ids. Every
  seed serves the same multiset of request sizes (each block of
  ``block_requests`` holds the distribution's quantiles), in its own order,
  with its own users.

Draws run on the device the caller names, from ``torch.Generator``s seeded
from the run's seed, in a few large calls.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def stream_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one of a run's streams (any int seed works)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + tag * 0xBF58476D1CE4E5B9) & _MASK63
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) & _MASK63


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, tag))


def zipf_ids(n_ids: int, exponent: float, count: int, gen: torch.Generator,
             perm: torch.Tensor) -> torch.Tensor:
    """``count`` ids whose ranks are Zipf(``exponent``) over ``n_ids``,
    rank r at id ``perm[r]``; int64 on the generator's device."""
    dev = perm.device
    w = torch.arange(1, n_ids + 1, dtype=torch.float64,
                     device=dev).pow_(-exponent)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(count, generator=gen, dtype=torch.float64, device=dev)
    rank = torch.clamp(torch.searchsorted(cdf, u), max=n_ids - 1)
    return perm[rank]


# ------------------------------------------------------------------- sweep
def _distinct_negatives(users: torch.Tensor, hist_keys: torch.Tensor,
                        n_items: int, k: int,
                        gen: torch.Generator) -> torch.Tensor:
    """``(n, k)`` item ids per user: distinct within a row and outside the
    user's history (``hist_keys``: sorted ``user * n_items + item``)."""
    n = users.shape[0]
    dev = users.device
    negs = torch.randint(0, n_items, (n, k), generator=gen, device=dev)
    for _ in range(64):
        keys = users[:, None] * n_items + negs
        loc = torch.clamp(torch.searchsorted(hist_keys, keys), max=
                          hist_keys.shape[0] - 1)
        bad = hist_keys[loc] == keys
        srt, order = torch.sort(negs, dim=1)
        dup_sorted = torch.zeros_like(bad)
        dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
        dup = torch.zeros_like(bad).scatter_(1, order, dup_sorted)
        bad |= dup
        nbad = int(bad.sum())
        if nbad == 0:
            return negs
        negs[bad] = torch.randint(0, n_items, (nbad,), generator=gen,
                                  device=dev)
    raise RuntimeError("could not draw distinct negatives outside the "
                       "users' histories")


def sweep_dataset(traffic: dict, n_users: int, n_items: int, seed: int,
                  root: str, device) -> dict:
    """Write the dataset ``<root>/bench`` and return the ``DataSpec``
    fields the driver needs, with the distinct periods' row counts."""
    dev = torch.device(device)
    gen = generator(seed, 1, dev)
    n_int = int(traffic["interactions"])
    n_dist = int(traffic["distinct_periods"])
    n_per = int(traffic["periods"])
    neg = int(traffic["neg_num"])
    perm_u = torch.randperm(n_users, generator=gen, device=dev)
    perm_i = torch.randperm(n_items, generator=gen, device=dev)
    users = zipf_ids(n_users, traffic["user_zipf"], n_dist * n_int, gen,
                     perm_u).view(n_dist, n_int)
    items = zipf_ids(n_items, traffic["item_zipf"], n_dist * n_int, gen,
                     perm_i).view(n_dist, n_int)
    del perm_u, perm_i
    hist = torch.unique(users.reshape(-1) * n_items + items.reshape(-1))
    path = os.path.join(root, "bench")
    os.makedirs(os.path.join(path, "train"), exist_ok=True)
    os.makedirs(os.path.join(path, "test"), exist_ok=True)
    np.save(os.path.join(path, "information.npy"),
            np.array([n_int * n_per, n_users, n_items], dtype=np.int64))
    for p in range(n_dist):
        negs = _distinct_negatives(users[p], hist, n_items, neg, gen)
        train = torch.stack([users[p], items[p]], dim=1)
        test = torch.cat([train, negs], dim=1)
        np.save(os.path.join(path, "train", f"{p}.npy"),
                train.to(torch.int32).cpu().numpy())
        np.save(os.path.join(path, "test", f"{p}.npy"),
                test.to(torch.int32).cpu().numpy())
    for p in range(n_dist, n_per):
        for kind in ("train", "test"):
            os.link(os.path.join(path, kind, f"{p % n_dist}.npy"),
                    os.path.join(path, kind, f"{p}.npy"))
    return {"root": root, "name": "bench", "num_periods": n_per,
            "online_train_start": 0,
            "online_test_start": int(traffic["online_test_start"]),
            "eval_neg_num": neg}


# ------------------------------------------------------------------- serve
def request_sizes(traffic: dict) -> np.ndarray:
    """One block's request sizes: the quantiles of P(n) ~ n^-a at
    ``(j + 0.5) / block_requests``, so every block, whatever the seed,
    holds the same multiset."""
    lo, hi = int(traffic["min_users"]), int(traffic["max_users"])
    n = np.arange(lo, hi + 1, dtype=np.float64)
    cdf = np.cumsum(n ** -float(traffic["size_exponent"]))
    cdf /= cdf[-1]
    m = int(traffic["block_requests"])
    q = (np.arange(m) + 0.5) / m
    return (lo + np.searchsorted(cdf, q)).astype(np.int64)


def serve_requests(traffic: dict, n_users: int, seed: int, device):
    """``(sizes, users)``: ``blocks`` blocks of request sizes, each block's
    multiset in the seed's order, and one int64 user id array holding the
    requests' users back to back (host arrays)."""
    dev = torch.device(device)
    gen = generator(seed, 2, dev)
    block = torch.from_numpy(request_sizes(traffic))
    order_gen = torch.Generator().manual_seed(stream_seed(seed, 3))
    sizes = torch.cat([block[torch.randperm(block.shape[0],
                                            generator=order_gen)]
                       for _ in range(int(traffic["blocks"]))])
    perm = torch.randperm(n_users, generator=gen, device=dev)
    users = zipf_ids(n_users, traffic["user_zipf"], int(sizes.sum()), gen,
                     perm)
    return sizes.numpy(), users.cpu().numpy()
