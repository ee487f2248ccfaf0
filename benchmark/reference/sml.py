"""Plain PyTorch reference of the SML sequential-retraining sweep.

Written from the SML paper's method and the reference repository's
``SML`` loop (``zyang1580/SML``), not from the program under test, whose
modules it never imports. Per period t:

1. ``last <- W`` (stored in the snapshot dtype);
2. branch A (no test yet) runs ``multi_num`` phases; branch C (a test
   period) runs phase 0 with the test scored on the tables refreshed after
   its inner epoch and before its outer epochs, then the other phases;
3. a phase: inner (MF) epochs through the frozen transfer Θ, ``hat <- W``,
   the refresh ``W <- Θ(last, hat)``, then outer (Θ) epochs, each followed
   by a refresh; the period ends with one more refresh.

The transfer is ``conv_com``: per row the stack ``[x_t, x_hat, x_com]``,
``x_com = x_t * x_hat / ||x_t||`` (no gradient through it), two channel
mixes 3 -> C1 -> C2 with ``gelu(x) = x * sigmoid(1.702 x)``, then FC(C2*d
-> H), gelu, FC(H -> d); separate user and item towers. The loss is the
masked mean BCE of (positive, negative) scores, ``-log(sigmoid(s+) +
1e-15) - log(sigmoid(-s-) + 1e-15)``, plus ``mf_l2 * 0.5 * sum(row^2)`` on
the MF rows in the inner epochs. Both optimizers are Adam in the optax
order (L2 added to the gradient, ``m_hat / (sqrt(v_hat) + eps)``, bias
corrections in f32); the tables take the dense gradient of their gathered
rows (every row's moments decay every step).

Its random draws follow the sweep's documented stream: in each inner epoch
(``mf_sample='all'``) one negative column of the eval-format rows, then a
shuffle of the real rows (uniform keys, padding last); in each outer epoch
(``tr_sample_type='alone'``) the shuffle, then per step ``neg_tries``
32-bit draws per row reduced modulo the period's unique-item pool, the
first candidate a 2-probe bloom filter over the period's (user, item)
pair hashes does not flag (the last where it flags all). On a CUDA
generator an epoch reserves the draws of its padded step slots too. Given
the same files, initial tables, Θ and run seed it takes the same draws as
the program, so the two can be compared step by step.

Run under ``reference.precision.precision("tf32")`` it is the control;
``fault`` plants one of the faults a check must catch: ``"unchanged"``
(every inner step leaves the tables as they were), ``"half"`` (each step's
loss over the first half of its batch, the mean taken over that half) or
``"altered"`` (the period's last refresh writes one wrong value).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
DRAW_HIGH = (1 << 32) - 1
_U32 = 0xFFFFFFFF
_M1, _M2, _M3, _BLOOM_MUL = 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x9E3779B1
SNAPSHOT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOWER_FIELDS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b",
                "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def tower(w: Dict[str, torch.Tensor], x_t: torch.Tensor,
          x_hat: torch.Tensor) -> torch.Tensor:
    """One ``conv_com`` tower on rows ``(N, d)`` -> ``(N, d)``."""
    with torch.no_grad():
        norm = torch.sqrt((x_t * x_t).sum(-1, keepdim=True))
        x_com = torch.where(norm > 0, x_t * x_hat / torch.where(
            norm > 0, norm, torch.ones_like(norm)), torch.zeros_like(x_t))
    n, d = x_t.shape
    stack = torch.stack([x_t, x_hat, x_com], dim=2)              # (N, d, 3)
    h1 = gelu(stack @ w["conv1_w"].T + w["conv1_b"])            # (N, d, C1)
    h2 = gelu(h1 @ w["conv2_w"].T + w["conv2_b"])               # (N, d, C2)
    flat = h2.transpose(1, 2).reshape(n, -1)                    # channel-major
    h3 = gelu(flat @ w["fc1_w"] + w["fc1_b"])
    return h3 @ w["fc2_w"] + w["fc2_b"]


def refresh_table(w: Dict[str, torch.Tensor], last: torch.Tensor,
                  hat: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """``Θ_side(last, hat)`` over every row, in blocks, as f32."""
    out = torch.empty(last.shape, dtype=torch.float32, device=last.device)
    with torch.no_grad():
        for s in range(0, last.shape[0], block):
            out[s:s + block] = tower(w, last[s:s + block].float(),
                                     hat[s:s + block].float())
    return out


def init_theta(gen: torch.Generator, d: int, c1: int, c2: int, h: int,
               device) -> Dict[str, torch.Tensor]:
    """Θ by leaf path (``user/conv1_w`` ...): U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) per leaf, torch's default, from ``gen``."""
    spec = [((c1, 3), 3), ((c1,), 3), ((c2, c1), c1), ((c2,), c1),
            ((c2 * d, h), c2 * d), ((h,), c2 * d), ((h, d), h), ((d,), h)]
    out = {}
    for side in ("user", "item"):
        for f, (shape, fan) in zip(TOWER_FIELDS, spec):
            u = torch.rand(shape, generator=gen, device=gen.device)
            out[f"{side}/{f}"] = ((u * 2 - 1) / fan ** 0.5).to(device)
    return out


def side(theta: Dict[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    return {f: theta[f"{name}/{f}"] for f in TOWER_FIELDS}


# ----------------------------------------------------------- bookkeeping
def bucket_rows(n: int, multiple: int, granularity: int = 8) -> int:
    """Padded row count: a batch multiple with at most 1/granularity of
    slack (the program's uniform shapes)."""
    nb = -(-max(n, 1) // multiple)
    if nb <= granularity:
        return nb * multiple
    step = 1 << max(0, (nb - 1).bit_length() - granularity.bit_length())
    return -(-nb // step) * step * multiple


def bias_corrections(count: int):
    t = np.float32(count)
    return (float(np.float32(1.0) - np.power(np.float32(B1), t)),
            float(np.float32(1.0) - np.power(np.float32(B2), t)))


def adam(ps, gs, mus, nus, count: int, lr: float, wd: float = 0.0) -> None:
    """One Adam step in place on lists of leaves (optax order, f32 bias
    corrections)."""
    bc1, bc2 = bias_corrections(count)
    with torch.no_grad():
        if wd:
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
        torch._foreach_mul_(mus, B1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - B1))
        torch._foreach_mul_(nus, B2)
        torch._foreach_add_(nus, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - B2))
        den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(den, EPS)
        step = torch._foreach_div(torch._foreach_div(mus, bc1), den)
        torch._foreach_add_(ps, torch._foreach_mul(step, -lr))


# ----------------------------------------------------------- the sampler
def _hash_np(u: np.ndarray, i: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = u.astype(np.uint32) * np.uint32(_M1)
        h ^= h >> np.uint32(13)
        h ^= i.astype(np.uint32) * np.uint32(_M2)
        h *= np.uint32(_M3)
        h ^= h >> np.uint32(15)
    return h


def _second_np(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return (h * np.uint32(_BLOOM_MUL)) ^ (h >> np.uint32(16))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` in int64 from 16-bit halves of ``c``."""
    return ((a * (c & 0xFFFF)) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _hash_t(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    h = _mul32(u.long() & _U32, _M1)
    h = h ^ (h >> 13)
    h = h ^ _mul32(i.long() & _U32, _M2)
    h = _mul32(h, _M3)
    return h ^ (h >> 15)


class PeriodPool:
    """One period's negative pool: its unique items (padded) and a bloom
    filter over its (user, item) pair hashes, sized from ``min_rows``."""

    def __init__(self, rows: np.ndarray, min_rows: int, n_items: int,
                 device, pad: int = 1024):
        users, items = rows[:, 0], rows[:, 1]
        pool = np.unique(items)
        size = pool.shape[0]
        ppad = -(-max(size, min(min_rows, n_items)) // pad) * pad
        pool = np.concatenate([pool, np.full(ppad - size, pool[0])])
        hashes = np.unique(_hash_np(users, items))
        bits = 1024
        while bits < 16 * max(hashes.shape[0], min_rows):
            bits <<= 1
        mask = np.uint32(bits - 1)
        words = np.zeros(bits // 32, dtype=np.uint32)
        with np.errstate(over="ignore"):
            for pos in (hashes & mask, _second_np(hashes) & mask):
                np.bitwise_or.at(words, pos >> 5,
                                 np.uint32(1) << (pos & np.uint32(31)))
        self.pool = torch.from_numpy(pool.astype(np.int64)).to(device)
        self.size = torch.tensor(size, dtype=torch.int64, device=device)
        self.words = torch.from_numpy(words.astype(np.int64)).to(device)
        self.mask = int(mask)

    def flagged(self, users: torch.Tensor, items: torch.Tensor):
        h = _hash_t(users, items)
        hit = None
        for probe in (h, _mul32(h, _BLOOM_MUL) ^ (h >> 16)):
            b = probe & self.mask
            bit = (self.words[b >> 5] >> (b & 31)) & 1
            hit = bit if hit is None else hit & bit
        return hit == 1

    def negatives(self, users: torch.Tensor, gen: torch.Generator,
                  tries: int) -> torch.Tensor:
        draws = torch.randint(0, DRAW_HIGH, (users.shape[0], tries),
                              generator=gen, device=users.device) % self.size
        cands = self.pool[draws]
        flagged = self.flagged(users[:, None], cands)
        first = torch.argmax((~flagged).to(torch.int32), dim=1)
        pick = torch.where(flagged.all(dim=1),
                           torch.full_like(first, tries - 1), first)
        return cands.gather(1, pick[:, None])[:, 0]


def draw_offset(rows: int, tries: int, device) -> int:
    """The Philox offset one sampler draw reserves on a CUDA generator."""
    gen = torch.Generator(device=device).manual_seed(0)
    start = gen.get_offset()
    torch.randint(0, DRAW_HIGH, (rows, tries), generator=gen, device=device)
    return gen.get_offset() - start


# ----------------------------------------------------------- the sweep
def dense_grad(table: torch.Tensor, idx: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """The table's dense gradient from its gathered rows' gradients, a
    repeated id's rows summed. ``index_put_(accumulate=True)`` sorts the
    ids on a card and adds each one's rows in a fixed order, so the
    reference gives the same bits on every run (``index_add_``'s atomics
    do not)."""
    return torch.zeros_like(table).index_put_((idx,), rows, accumulate=True)


def pair_loss(theta, lu, li, lj, xu, xi, xj, m, fault: Optional[str]):
    """Masked mean BCE of the (positive, negative) pairs through Θ."""
    if fault == "half":
        m = m.clone()
        m[m.shape[0] // 2:] = 0
    b = xu.shape[0]
    nu = tower(side(theta, "user"), lu, xu)
    nij = tower(side(theta, "item"), torch.cat([li, lj]), torch.cat([xi, xj]))
    pos = (nu * nij[:b]).sum(-1)
    neg = (nu * nij[b:]).sum(-1)
    denom = torch.clamp(m.sum(), min=1.0)
    return (-(m * torch.log(torch.sigmoid(pos) + 1e-15)).sum() / denom
            - (m * torch.log(torch.sigmoid(-neg) + 1e-15)).sum() / denom), m


class Sweep:
    """The reference sweep's state and periods. ``tables``: the initial
    ``(user, item)`` f32 tables; ``theta``: Θ by leaf path; ``gen``: the
    run's generator (on the tables' device)."""

    def __init__(self, hp: dict, tables, theta: Dict[str, torch.Tensor],
                 gen: torch.Generator, bounds: Dict[str, int],
                 fault: Optional[str] = None):
        self.hp, self.fault, self.gen, self.bounds = hp, fault, gen, bounds
        self.dev = tables[0].device
        self.snap = SNAPSHOT[hp["snapshot_dtype"]]
        self.U, self.I = (t.clone() for t in tables)
        self.theta = {k: v.clone() for k, v in theta.items()}
        z = torch.zeros_like
        self.mf_mu = {"user_emb": z(self.U), "item_emb": z(self.I)}
        self.mf_nu = {"user_emb": z(self.U), "item_emb": z(self.I)}
        self.tr_mu = {k: z(v) for k, v in self.theta.items()}
        self.tr_nu = {k: z(v) for k, v in self.theta.items()}
        self.mf_count = self.tr_count = 0
        self.last_u = self.last_i = self.hat_u = self.hat_i = None
        self.offset = (draw_offset(hp["tr_batch_size"], hp["neg_tries"],
                                   self.dev)
                       if self.dev.type == "cuda" else 0)

    @classmethod
    def resume(cls, hp: dict, snap: dict, bounds: Dict[str, int], device,
               fault: Optional[str] = None) -> "Sweep":
        """A sweep at a period's start from a state ``snap`` (host
        tensors, as :meth:`snapshot` gives them): tables, both Adam
        states and step counts, Θ, and the run generator's state."""
        gen = torch.Generator(device=device)
        gen.set_state(snap["gen"])
        sw = cls(hp, (snap["U"].to(device), snap["I"].to(device)),
                 {k: v.to(device) for k, v in snap["theta"].items()}, gen,
                 bounds, fault)
        for name in ("mf_mu", "mf_nu", "tr_mu", "tr_nu"):
            mine = getattr(sw, name)
            for k in mine:
                mine[k].copy_(snap[name][k])
        sw.mf_count, sw.tr_count = snap["mf_count"], snap["tr_count"]
        return sw

    def snapshot(self) -> dict:
        """The state a period starts from, on the host
        (:meth:`resume`)."""
        def cpu(t):
            return t.detach().to("cpu", copy=True)
        leaves = {n: {k: cpu(v) for k, v in getattr(self, n).items()}
                  for n in ("theta", "mf_mu", "mf_nu", "tr_mu", "tr_nu")}
        return {"U": cpu(self.U), "I": cpu(self.I), **leaves,
                "mf_count": self.mf_count, "tr_count": self.tr_count,
                "gen": self.gen.get_state()}

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Every leaf's Adam first moment by name: the tables'
        (``user_emb``, ``item_emb``), then Θ's."""
        return {**self.mf_mu, **self.tr_mu}

    # ------------------------------------------------------------- parts
    def _pad(self, rows: np.ndarray, batch: int, bound: int):
        n = rows.shape[0]
        n_pad = max(bucket_rows(n, batch), bucket_rows(bound, batch))
        out = np.zeros((n_pad, rows.shape[1]), dtype=np.int64)
        out[:n] = rows
        mask = np.zeros(n_pad, dtype=np.float32)
        mask[:n] = 1
        return (torch.from_numpy(out).to(self.dev),
                torch.from_numpy(mask).to(self.dev), n)

    def _shuffle(self, rows, mask):
        r = torch.rand(rows.shape[0], generator=self.gen, device=self.dev)
        r = torch.where(mask > 0, r, torch.full_like(r, float("inf")))
        order = torch.argsort(r)
        return rows[order], mask[order]

    def refresh(self) -> None:
        self.U = refresh_table(side(self.theta, "user"), self.last_u,
                               self.hat_u)
        self.I = refresh_table(side(self.theta, "item"), self.last_i,
                               self.hat_i)

    def inner_epoch(self, padded) -> torch.Tensor:
        hp = self.hp
        rows, mask, n = padded
        col = torch.randint(0, rows.shape[1] - 2, (1,), generator=self.gen,
                            device=self.dev)
        trip = torch.stack([rows[:, 0], rows[:, 1],
                            rows.index_select(1, col + 2)[:, 0]], dim=1)
        trip, mask = self._shuffle(trip, mask)
        b_sz = hp["mf_batch_size"]
        losses = []
        for b in range(-(-n // b_sz)):
            sl = slice(b * b_sz, (b + 1) * b_sz)
            u, i, j = trip[sl, 0], trip[sl, 1], trip[sl, 2]
            m = mask[sl]
            lu, li, lj = (self.last_u[u].float(), self.last_i[i].float(),
                          self.last_i[j].float())
            xs = [self.U[u].requires_grad_(), self.I[i].requires_grad_(),
                  self.I[j].requires_grad_()]
            with torch.enable_grad():
                loss, mm = pair_loss(self.theta, lu, li, lj, *xs, m,
                                     self.fault)
                loss = loss + hp["mf_l2"] * 0.5 * sum(
                    (mm[:, None] * x * x).sum() for x in xs)
                gu, gi, gj = torch.autograd.grad(loss, xs)
            losses.append(loss.detach())
            self.mf_count += 1
            if self.fault == "unchanged":
                continue
            g_u = dense_grad(self.U, u, gu)
            g_i = dense_grad(self.I, torch.cat([i, j]), torch.cat([gi, gj]))
            adam([self.U, self.I], [g_u, g_i],
                 [self.mf_mu["user_emb"], self.mf_mu["item_emb"]],
                 [self.mf_nu["user_emb"], self.mf_nu["item_emb"]],
                 self.mf_count, hp["mf_lr"])
            del g_u, g_i
        return torch.stack(losses)

    def outer_epoch(self, padded, pool: PeriodPool) -> torch.Tensor:
        hp = self.hp
        rows, mask, n = padded
        rows, mask = self._shuffle(rows, mask)
        b_sz = hp["tr_batch_size"]
        names = list(self.theta)
        params = [self.theta[k].requires_grad_() for k in names]
        losses = []
        nb_real, nb_max = -(-n // b_sz), rows.shape[0] // b_sz
        for b in range(nb_real):
            sl = slice(b * b_sz, (b + 1) * b_sz)
            u, i, m = rows[sl, 0], rows[sl, 1], mask[sl]
            j = pool.negatives(u, self.gen, hp["neg_tries"])
            snaps = (self.last_u[u], self.last_i[i], self.last_i[j],
                     self.hat_u[u], self.hat_i[i], self.hat_i[j])
            with torch.enable_grad():
                loss, _ = pair_loss(self.theta, *(s.float() for s in snaps),
                                    m, self.fault)
                grads = torch.autograd.grad(loss, params)
            losses.append(loss.detach())
            self.tr_count += 1
            adam(params, list(grads), [self.tr_mu[k] for k in names],
                 [self.tr_nu[k] for k in names], self.tr_count, hp["tr_lr"],
                 hp["tr_l2"])
        for p in params:
            p.requires_grad_(False)
        if self.offset and nb_max > nb_real:
            self.gen.set_offset(self.gen.get_offset()
                                + (nb_max - nb_real) * self.offset)
        return torch.stack(losses)

    def test(self, rows: np.ndarray, topk, block: int = 1024) -> Dict:
        """Hits per K of a leave-one-out test: the target's rank is the
        count of its candidates scored strictly above it."""
        hits = {k: 0 for k in topk}
        with torch.no_grad():
            for s in range(0, rows.shape[0], block):
                r = torch.from_numpy(rows[s:s + block].astype(np.int64)).to(
                    self.dev)
                sc = (self.U[r[:, 0]][:, None, :] * self.I[r[:, 1:]]).sum(-1)
                rank = (sc[:, 1:] > sc[:, :1]).sum(1)
                for k in topk:
                    hits[k] += int((rank < k).sum())
        return hits

    # ------------------------------------------------------------ period
    def period(self, set_t: np.ndarray, set_tt: np.ndarray,
               now_test: Optional[np.ndarray]) -> dict:
        """One period; returns its per-phase losses and test hits."""
        hp = self.hp
        self.last_u, self.last_i = self.U.to(self.snap), self.I.to(self.snap)
        pt = self._pad(set_t, hp["mf_batch_size"], self.bounds["set_t"])
        ptt = self._pad(set_tt, hp["tr_batch_size"], self.bounds["set_tt"])
        pool = PeriodPool(set_tt, self.bounds["set_tt"], self.I.shape[0],
                          self.dev)
        rec = {"inner": [], "outer": [], "hits": None}
        for phase in range(hp["multi_num"]):
            for _ in range(hp["mf_epochs"]):
                rec_in = self.inner_epoch(pt)
            rec["inner"].append(rec_in)
            self.hat_u, self.hat_i = (self.U.to(self.snap),
                                      self.I.to(self.snap))
            self.refresh()
            if phase == 0 and now_test is not None:
                rec["hits"] = self.test(now_test, hp["topk"])
            for _ in range(hp["tr_epochs"]):
                rec_out = self.outer_epoch(ptt, pool)
                self.refresh()
            rec["outer"].append(rec_out)
        self.refresh()
        if self.fault == "altered":
            self.U[0, 0] += 1.0
        return rec
