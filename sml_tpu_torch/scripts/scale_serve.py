"""Full-catalog top-K serving at scale through the ``rank`` CLI, timed and
checked:

    python -m sml_tpu_torch.scripts.scale_serve --model m.npz --users 4096
    python -m sml_tpu_torch.scripts.scale_serve --model m.npz --users 4096 \\
        --ranks 4 --shard

``--model`` is a ``.npz`` of tables (``scale_engine_run --save-model``
writes one at any shape; ``--make-model USERS,ITEMS`` writes N(0,1) tables
there first, as in ``--make-model 1000000,5000000`` for top-100 over 5M
items on one card). Draws ``--users`` distinct user ids from a seed,
runs ``python -m sml_tpu_torch rank`` over them (``--ranks`` processes of
one world, ``--shard`` row-sharding the item table over them), and holds
process 0's printed rows to a top-K computed here on the CPU from the same
file for the first ``--check`` users: the id sets must be equal except
where the CPU's scores tie (an id in either set but not both scores within
``--tie`` of the CPU's k-th score); with ``--bf16`` both sides round the
scoring inputs to bfloat16. Prints one JSON line: the CLI's own load and
serve seconds and its peak device memory (its stderr line), the
processes' wall, the rows checked and those that differ other than at
ties; exits 1 when a row differs, a process fails or a row is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

TIMEOUT_S = 1800.0


def untied_rows(user_rows: np.ndarray, item_table, got_ids: np.ndarray,
                k: int, tie: float, bf16: bool = False) -> dict:
    """``got_ids`` (B, k) served for ``user_rows`` (B, d) against an exact
    top-K of ``user_rows @ item_table.T`` in f32 on the CPU (the item table
    is read in blocks of rows, so a memory map stays on disk): the rows
    whose id sets differ, and those that differ other than at ties.
    ``bf16``: both inputs rounded to bfloat16 first, as ``rank --bf16``
    rounds them."""
    import torch

    def rows_of(a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(torch.bfloat16).float() if bf16 else t
    users = rows_of(user_rows)
    best_s = best_i = None
    block = 1 << 20
    for s in range(0, item_table.shape[0], block):
        part = rows_of(item_table[s:s + block])
        sc, ix = torch.topk(users @ part.T, min(k, part.shape[0]), dim=1)
        ix = ix + s
        if best_s is not None:
            sc, sel = torch.topk(torch.cat([best_s, sc], 1), k, dim=1)
            ix = torch.gather(torch.cat([best_i, ix], 1), 1, sel)
        best_s, best_i = sc, ix
    differ = untied = 0
    for b in range(got_ids.shape[0]):
        want, got = set(best_i[b].tolist()), set(got_ids[b].tolist())
        if want == got:
            continue
        differ += 1
        ids = np.asarray(sorted(want ^ got))
        rows = rows_of(item_table[ids])
        scores = users[b] @ rows.T
        if (scores - best_s[b, -1]).abs().max().item() > tie:
            untied += 1
    return {"rows_checked": int(got_ids.shape[0]), "rows_differ": differ,
            "rows_differ_untied": untied}


def write_random_model(path: str, n_users: int, n_items: int,
                       seed: int = 0, dim: int = 64) -> None:
    """``rank``'s ``.npz`` of N(0,1) f32 tables (zero biases): rows well
    apart, so a served top-K has few ties to excuse."""
    rng = np.random.default_rng(seed)
    np.savez(path,
             user_emb=rng.standard_normal((n_users, dim), np.float32),
             item_emb=rng.standard_normal((n_items, dim), np.float32),
             user_bias=np.zeros((n_users, 1), np.float32),
             item_bias=np.zeros((n_items, 1), np.float32))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("scale_serve")
    p.add_argument("--model", required=True)
    p.add_argument("--users", type=int, default=4096,
                   help="distinct users to serve")
    p.add_argument("-k", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--ranks", type=int, default=1)
    p.add_argument("--shard", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="rank --bf16: bf16 scoring inputs (the CPU top-K "
                        "rounds its inputs the same way)")
    p.add_argument("--check", type=int, default=8,
                   help="users held to a CPU top-K")
    p.add_argument("--tie", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--make-model", default=None, metavar="USERS,ITEMS",
                   help="first write N(0,1) tables of this many users and "
                        "items (d=64, from --seed) to --model")
    args = p.parse_args(argv)

    from sml_tpu_torch.cli import npz_arrays
    if args.make_model:
        write_random_model(args.model, *map(int, args.make_model.split(",")),
                           seed=args.seed)
    from sml_tpu_torch.parallel.dryrun import run_cli_world
    arrays = npz_arrays(args.model)
    n_users, n_items = (arrays["user_emb"].shape[0],
                        arrays["item_emb"].shape[0])
    users = np.random.default_rng(args.seed).choice(
        n_users, size=args.users, replace=False)
    tmp = tempfile.mkdtemp(prefix="sml_serve_")
    try:
        users_file = os.path.join(tmp, "users.txt")
        np.savetxt(users_file, users, fmt="%d")
        argv_rank = ["rank", "--model", os.path.abspath(args.model),
                     "--users-file", users_file, "-k", str(args.k),
                     "--batch-size", str(args.batch_size)]
        argv_rank += [flag for flag, on in (("--shard", args.shard),
                                            ("--bf16", args.bf16)) if on]
        t0 = time.perf_counter()
        procs = run_cli_world(argv_rank, args.ranks, args.device, TIMEOUT_S)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report = {"users": args.users, "items": n_items, "table_users": n_users,
              "k": args.k, "batch_size": args.batch_size,
              "ranks": args.ranks, "shard": args.shard, "bf16": args.bf16,
              "returncodes": [rc for rc, _, _ in procs],
              "processes_wall_s": wall}
    rc0, out0, err0 = procs[0]
    stats = [json.loads(ln) for ln in err0.splitlines()
             if ln.startswith('{"rank_load_s"')]
    rows = [json.loads(ln) for ln in out0.splitlines() if ln.strip()]
    ok = all(rc == 0 for rc, _, _ in procs) and len(stats) == 1
    if stats:
        report.update(stats[0])
    ok = ok and [r["user"] for r in rows] == users.tolist() and all(
        len(r["items"]) == args.k for r in rows)
    report["rows_printed"] = len(rows)
    if ok:
        n = min(args.check, len(rows))
        got = np.asarray([r["items"] for r in rows[:n]])
        report.update(untied_rows(arrays["user_emb"][users[:n]],
                                  arrays["item_emb"], got, args.k,
                                  args.tie, args.bf16))
        ok = report["rows_differ_untied"] == 0
    else:
        report["stderr_tail"] = [e[-2000:] for _, _, e in procs]
    report["ok"] = ok
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
