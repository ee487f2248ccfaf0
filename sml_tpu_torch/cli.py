"""Command-line entry point (counterpart of ``sml_tpu/cli.py``).

    python -m sml_tpu_torch rank --model final.npz --users 17,42 -k 20
    python -m sml_tpu_torch --device cpu rank --model final.npz --users 0,1

``rank`` takes the same flags and prints the same JSON lines as
``python -m sml_tpu rank``; ``--device {cuda,cpu}`` (before the subcommand)
takes the place of ``--platform`` and defaults to ``cuda``.
The training subcommands come with the training slice.
"""

from __future__ import annotations

import argparse
import json
import sys

DEVICE_HELP = ("device to run on (default cuda; a host without a GPU "
               "raises unless --device cpu is given)")


def cmd_rank(args) -> int:
    """Full-catalog top-K serving from trained tables."""
    import numpy as np
    import torch

    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.eval.full_ranking import recommend
    from sml_tpu_torch.models.mf import MFParams

    device = resolve_device(args.device)
    with np.load(args.model) as blob:
        mf = MFParams(*(torch.from_numpy(np.asarray(blob[f])).to(device)
                        for f in MFParams._fields))

    if args.users:
        users = np.asarray([int(u) for u in args.users.split(",")], np.int64)
    else:
        with open(args.users_file) as fh:
            users = np.asarray([int(line) for line in fh if line.strip()],
                               np.int64)
    n_users = mf.user_emb.shape[0]
    bad = users[(users < 0) | (users >= n_users)]
    if bad.size:
        print(f"error: user ids out of range [0, {n_users}): "
              f"{bad[:10].tolist()}", file=sys.stderr)
        return 2

    # --shard spreads the item table over devices; on one device it is a
    # no-op, as in the JAX package (the sharded merge is not ported yet)
    dtype = torch.bfloat16 if args.bf16 else None
    for start in range(0, users.shape[0], args.batch_size):
        chunk = users[start:start + args.batch_size]
        scores, items = recommend(mf, torch.from_numpy(chunk), args.k,
                                  compute_dtype=dtype,
                                  topk_method=args.topk_method)
        scores = scores.cpu().numpy()
        items = items.cpu().numpy()
        for r in range(chunk.shape[0]):
            print(json.dumps({"user": int(chunk[r]),
                              "items": items[r].tolist(),
                              "scores": [round(float(s), 4)
                                         for s in scores[r]]}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser("sml_tpu_torch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help=DEVICE_HELP)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("rank", help="exact full-catalog top-K "
                                     "recommendations from trained tables")
    pr.add_argument("--model", required=True,
                    help=".npz with user_emb/item_emb/user_bias/item_bias "
                         "(pretrain output or exported SML tables)")
    g = pr.add_mutually_exclusive_group(required=True)
    g.add_argument("--users", default=None, help="comma list of user ids")
    g.add_argument("--users-file", default=None, help="file of user ids")
    pr.add_argument("-k", type=int, default=20)
    pr.add_argument("--batch-size", type=int, default=1024)
    pr.add_argument("--shard", action="store_true",
                    help="row-shard the item table over all devices (a "
                         "no-op on one device)")
    pr.add_argument("--bf16", action="store_true",
                    help="round the scoring inputs to bfloat16 (scores "
                         "still accumulate in f32; near-tie ranks may swap)")
    pr.add_argument("--topk-method", default="exact",
                    choices=["exact", "exact_sort", "exact_bucket",
                             "approx", "approx99"],
                    help="every method is served by an exact torch.topk: "
                         "'exact'/'exact_sort'/'exact_bucket' are exact in "
                         "the JAX package too, and 'approx'/'approx99' name "
                         "the TPU's hardware PartialReduce, which has no GPU "
                         "counterpart; an exact answer meets their "
                         "0.95/0.99 recall targets")
    pr.set_defaults(fn=cmd_rank)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
