"""The numbers that decide ``correct``: the program's readings against the
plain reference's (``reference/``), each a worst relative gap.

Training (the sweep): the reference follows the program's first period
from the seed's inputs and draws, and one window period from the state
the program started it with (tables, Adam states, Θ, generator); a last
number holds the window's last refresh to the reference's refresh of the
program's own final state. Per compared period each side gives its
phases' last inner and outer epochs' step losses, the test's hits, each
leaf's Adam first moment at the period's end (norm) and each leaf's
change over the period (norm):

* ``loss``: the first inner epoch's step losses and the first outer
  step's in the period from the seed, ``|L - L_ref| / |L_ref|`` at worst;
* ``window_loss``: the same in the window period;
* ``epoch_loss``: each epoch's mean loss, worst over both periods;
* ``moment``, ``change``: by leaf, ``|n - n_ref| / max(n_ref, median
  leaf's n_ref)`` at worst; a leaf whose reference moment is under a
  thousandth of the median leaf's (a gradient that is nought to
  rounding) is left out;
* ``hits``: each test's hits at each K, ``|h - h_ref| / n_test``;
* ``refresh``: ``max |W - Θ(last, hat)| / max |Θ(last, hat)|``.

Serving: ``rank`` is the widest gap by which a served item's reference
score lies below the reference's score at that rank, and ``score`` the
widest gap between a served score and the reference score of its item,
both over the reference's largest score in the request.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SWEEP = ("loss", "window_loss", "epoch_loss", "moment", "change", "hits")


def _rel(p, r):
    return np.abs(p - r) / np.maximum(np.abs(r), 1e-30)


def _first(rec: dict) -> np.ndarray:
    """A period's first inner epoch and first outer step."""
    inner, outer = rec["phases"][0]
    return np.concatenate([inner, outer[:1]])


def _leaves(p: dict, r: dict):
    """Worst leaf's norm gap and its name; leaves whose reference moment
    is nought to rounding are left out by the caller."""
    med = float(np.median(list(r.values())))
    return max((abs(p[k] - r[k]) / max(r[k], med, 1e-30), k) for k in r)


def sweep_numbers(prog: dict, ref: dict, where: dict = None
                  ) -> Dict[str, float]:
    """``prog``, ``ref``: ``{period: record}`` as ``drivers/sweep.py``
    reads them; a record holds ``from`` ("seed" or "state"), ``phases``
    (each phase's last inner and outer epoch's step losses), ``hits``
    (``{K: hits}`` or None), ``n_test``, ``moments`` and ``change`` (leaf
    norms). A number with nothing to compare is left out (and fails).
    ``where``, when given, gets the period (and leaf) of each worst and,
    under ``left_out``, the leaves left out."""
    out: Dict[str, float] = {}
    where = {} if where is None else where

    def worst(name, v, at):
        if float(v) >= out.get(name, 0.0):
            out[name], where[name] = float(v), at
    for d, r in ref.items():
        p = prog.get(d)
        if p is None or [tuple(map(len, ph)) for ph in p["phases"]] != \
                [tuple(map(len, ph)) for ph in r["phases"]]:
            return dict.fromkeys(SWEEP, float("inf"))
        worst("loss" if r["from"] == "seed" else "window_loss",
              _rel(_first(p), _first(r)).max(), [d])
        for ph, (a, b) in enumerate(zip(p["phases"], r["phases"])):
            for kind, x, y in zip(("inner", "outer"), a, b):
                worst("epoch_loss", abs(x.mean() - y.mean()) / abs(y.mean()),
                      [d, ph, kind])
        med = float(np.median(list(r["moments"].values())))
        keep = [k for k, v in r["moments"].items() if v >= 1e-3 * med]
        where.setdefault("left_out", []).extend(
            [d, k] for k in r["moments"] if k not in keep)
        v, leaf = _leaves({k: p["moments"][k] for k in keep},
                          {k: r["moments"][k] for k in keep})
        worst("moment", v, [d, leaf])
        moved = [k for k in r["change"] if k in keep]
        v, leaf = _leaves({k: p["change"][k] for k in moved},
                          {k: r["change"][k] for k in moved})
        worst("change", v, [d, leaf])
        if r["hits"] is not None:
            worst("hits", max(abs(p["hits"][k] - r["hits"][k]) / r["n_test"]
                              for k in r["hits"]), [d])
    return out


def refresh_gap(got, want) -> float:
    """``max |got - want| / max |want|`` over a list of table pairs."""
    num = max(float((g - w).abs().max()) for g, w in zip(got, want))
    den = max(float(w.abs().max()) for w in want)
    return num / den


def serve_numbers(served_scores, served_ids, ref_scores_all) -> Dict:
    """Per request: ``served_*`` (n, k) from the program, ``ref_scores_all``
    (n, I) float64 reference scores of every item. Returns the request's
    ``rank`` and ``score`` gaps."""
    import torch
    k = served_ids.shape[1]
    top = torch.topk(ref_scores_all, k, dim=1).values           # (n, k)
    of_served = torch.gather(ref_scores_all, 1, served_ids.long())
    scale = top[:, :1].abs().clamp_min(1e-30)
    rank = ((top - of_served) / scale).max()
    score = ((served_scores.double() - of_served).abs() / scale).max()
    return {"rank": float(rank), "score": float(score)}
