"""Full-catalog top-K serving's window: ``sml_tpu_torch.eval.full_ranking.
recommend``, what ``python -m sml_tpu_torch rank`` calls, over tables held
on the card.

Set-up draws both f32 tables on the card from the seed, makes the page
requests, and serves one request of every size the traffic holds (the
warm-up). The window is one client's closed loop: each request's users go
in, its ids and scores come back to the host, and the next one starts;
every request started before ``--seconds`` is served and timed. After it,
a sample of the served requests drawn from the seed (with the largest one
served) is held to a float64 plain reference of every item's score.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

import checks
import costs
import generate
import harness
from reference import topk as ref
from reference.precision import precision

VARIANTS = ("tf32/sound", "f32/altered", "f32/half")


def tables(cfg: dict, seed: int, device):
    g = generate.generator(seed, 20, device)
    d = cfg["latent_dim"]
    return (torch.randn((cfg["n_users"], d), generator=g, device=device),
            torch.randn((cfg["n_items"], d), generator=g, device=device))


def sample(seed: int, served: int, sizes: np.ndarray, count: int,
           users_max: int) -> list:
    """Served request indices to check: drawn from the seed, with the
    largest served request, up to ``users_max`` users in all."""
    rng = np.random.default_rng(generate.stream_seed(seed, 21))
    largest = int(np.argmax(sizes[:served]))
    pick, total = [largest], int(sizes[largest])
    for r in rng.permutation(served)[:count]:
        if r != largest and total + sizes[r] <= users_max:
            pick.append(int(r))
            total += int(sizes[r])
    return pick


def reference_numbers(U, I, requests, block: int = 64) -> Dict[str, float]:
    """``rank`` and ``score`` over ``requests`` (``(users, scores, ids)``
    host arrays each) against float64 scores of every item."""
    worst = {"rank": 0.0, "score": 0.0}
    for users, s, ids in requests:
        for a in range(0, len(users), block):
            u = torch.from_numpy(np.asarray(users[a:a + block])).to(U.device)
            full = ref.all_scores(U[u], I)
            got = checks.serve_numbers(
                torch.as_tensor(s[a:a + block]).to(U.device),
                torch.as_tensor(ids[a:a + block]).to(U.device), full)
            for k in worst:
                worst[k] = max(worst[k], got[k])
            del full
    return worst


def _served(recommend, mf, users: np.ndarray, k: int, method: str,
            spans: bool = False):
    if not spans:
        s, i = recommend(mf, torch.from_numpy(users), k, topk_method=method)
        return s.cpu().numpy(), i.cpu().numpy()
    with torch.profiler.record_function("bench.recommend"):
        s, i = recommend(mf, torch.from_numpy(users), k, topk_method=method)
    with torch.profiler.record_function("bench.to_host"):
        return s.cpu().numpy(), i.cpu().numpy()


def run(ctx: dict) -> dict:
    from sml_tpu_torch.eval.full_ranking import recommend
    from sml_tpu_torch.models.mf import MFParams

    cfg, tr, dev = ctx["config"], ctx["traffic"], ctx["device"]
    seed, seconds, traced = ctx["seed"], ctx["seconds"], ctx["trace"]
    k, method = int(tr["k"]), tr["topk_method"]
    U, I = tables(cfg, seed, dev)
    none = torch.empty((0, 1), device=dev)
    mf = MFParams(U, I, none, none)
    sizes, users = generate.serve_requests(tr, cfg["n_users"], seed, dev)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    # warm-up: one request of each size the traffic holds
    for n in np.unique(sizes):
        _served(recommend, mf, users[:n], k, method)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = harness.process_age_s()

    lat, out = [], []
    trace = harness.Trace(torch, dev) if traced else None
    if trace:
        seconds = min(seconds, float(tr["traced_seconds"]))
    with trace or contextlib.nullcontext():
        t0 = time.perf_counter()
        r = 0
        while time.perf_counter() - t0 < seconds:
            q = r % len(sizes)   # past the last block the requests repeat
            a = time.perf_counter()
            out.append(_served(recommend, mf, users[offs[q]:offs[q + 1]], k,
                               method, traced))
            lat.append(time.perf_counter() - a)
            r += 1
        window = time.perf_counter() - t0
    served = len(lat)
    sizes = np.resize(sizes, served)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    users = np.resize(users, int(offs[-1]))
    peak_window = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    n_users = int(sizes[:served].sum())

    pick = sample(seed, served, sizes, int(tr["checked_requests"]),
                  int(tr["checked_users_max"]))
    reqs = [(users[offs[r]:offs[r + 1]], *out[r]) for r in pick]
    with torch.no_grad():
        numbers = reference_numbers(U, I, reqs)
    lat_ms = np.asarray(lat) * 1e3
    res = {
        "numbers": numbers, "attempted": served, "failed": 0,
        "setup_s": setup_s, "window_s": window,
        "memory_peak_bytes": max(peak_setup, peak_window)
        if dev.type == "cuda" else 0,
        "e2e": {"serve_users_per_s": (n_users / window, "users/s"),
                "serve_p95_ms": (float(np.percentile(lat_ms, 95)), "ms")},
        "info": {"requests": served, "users": n_users,
                 "p50_ms": float(np.percentile(lat_ms, 50)),
                 "checked_requests": len(pick),
                 "checked_users": int(sum(len(q[0]) for q in reqs))},
    }
    if traced:
        dig = harness.digest(trace, spans=("bench.recommend",
                                           "bench.to_host"))
        d = cfg["latent_dim"]
        res["trace"] = dig
        res["layer_ctx"] = {
            "trace": dig, "requests": served,
            "score_least_s": sum(costs.least_s(
                costs.score_flops(int(n), cfg["n_items"], d),
                costs.score_bytes(int(n), cfg["n_items"], d))
                for n in sizes[:served]),
            "request_least_s": sum(costs.request_least_s(
                int(n), cfg["n_items"], d, k) for n in sizes[:served]),
            "peak_window_bytes": peak_window}
    return res


# ----------------------------------------------------------- controls
def control_numbers(ctx: dict, variants) -> Dict[str, Dict[str, float]]:
    """The check's numbers with the plain reference served in the
    program's place (its float32 product in ``precision``), and with each
    planted fault: ``"altered"`` (one served id changed), ``"half"`` (the
    second half of each request's users given the first half's answers),
    over the requests the cell's check samples from its seed."""
    cfg, tr, dev, seed = (ctx["config"], ctx["traffic"], ctx["device"],
                          ctx["seed"])
    k = int(tr["k"])
    U, I = tables(cfg, seed, dev)
    sizes, users = generate.serve_requests(tr, cfg["n_users"], seed, dev)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    served = min(len(sizes), int(tr["block_requests"]))
    pick = sample(seed, served, sizes, int(tr["checked_requests"]),
                  int(tr["checked_users_max"]))
    out = {}
    for prec, fault in variants:
        reqs = []
        with precision(prec), torch.no_grad():
            for r in pick:
                uu = users[offs[r]:offs[r + 1]]
                u = torch.from_numpy(uu).to(dev)
                s, i = ref.served(U[u], I, k)
                s, i = s.cpu().numpy(), i.cpu().numpy()
                if fault == "altered":
                    i[0, 0] = (i[0, 0] + 1) % cfg["n_items"]
                if fault == "half" and len(uu) > 1:
                    h = len(uu) // 2
                    s[h:2 * h], i[h:2 * h] = s[:h], i[:h]
                reqs.append((uu, s, i))
            out[f"{prec}/{fault or 'sound'}"] = reference_numbers(U, I, reqs)
    return out
