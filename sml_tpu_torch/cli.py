"""Command-line entry point (counterpart of ``sml_tpu/cli.py``).

    python -m sml_tpu_torch synth --out D/synth --users 400 --items 200 ...
    python -m sml_tpu_torch ingest --csv log.csv --out D/mydata --periods 12 --first-test 4
    python -m sml_tpu_torch pretrain --data-root D --data-name synth --out pre.npz ...
    python -m sml_tpu_torch sml --data-root D --data-name synth --pre-model pre.npz ...
    python -m sml_tpu_torch baseline --data-root D --method spmf --pool-size 300 ...
    python -m sml_tpu_torch rank --model final.npz --users 17,42 -k 20
    python -m sml_tpu_torch --device cpu sml --data-root D ...

``sml``, ``pretrain``, ``baseline``, ``synth``, ``ingest`` and ``rank``
take the same flags and print the same JSON as ``python -m sml_tpu``, and
the ``.npz`` tables of either package load in the other; ``--device
{cuda,cpu}`` (before the subcommand) takes the place of ``--platform`` and
defaults to ``cuda``.

Multi-process: start one process per rank with the same command and
``--coordinator host:port --num-processes R --process-id r`` (before the
subcommand). Each rank runs on ``cuda:{local_rank % device_count}`` (or the
CPU with ``--device cpu``); ranks that share a card, or the CPU, talk over
gloo, ranks with a card each over NCCL. ``sml`` then row-shards the state
over the ranks of a host (``parallel/multihost.py``), logs and writes
checkpoints and ``--save-model`` from process 0 only (whole tables, as one
process writes them), and refuses to start when the processes disagree on
the checkpoint to resume from. ``rank --shard`` row-shards the item table
over all ranks and prints from process 0; with one process it is a no-op.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from sml_tpu_torch import config as C

DEVICE_HELP = ("device to run on (default cuda; a host without a GPU "
               "raises unless --device cpu is given)")


def _dataspec(args) -> C.DataSpec:
    if args.data_name == "yelp":
        return C.yelp_data(args.data_root)
    if args.data_name in ("news", "adressa"):
        return C.adressa_data(args.data_root)
    return C.DataSpec(root=args.data_root, name=args.data_name,
                      num_periods=args.num_periods,
                      online_train_start=args.online_train_start,
                      online_test_start=args.online_test_start)


def _add_data_args(p):
    p.add_argument("--data-root", required=True)
    p.add_argument("--data-name", default="yelp")
    p.add_argument("--num-periods", type=int, default=40)
    p.add_argument("--online-train-start", type=int, default=10)
    p.add_argument("--online-test-start", type=int, default=30)
    p.add_argument("--metrics-jsonl", default=None,
                   help="write structured metrics to this jsonl file")
    p.add_argument("--checkpoint-dir", default=None)


def npz_arrays(path: str) -> dict:
    """The arrays of an ``.npz`` by name, read lazily: a stored
    (uncompressed, as ``np.savez`` writes) member is a read-only memory map
    of the file, so a caller reads from disk only the rows it takes; a
    compressed member is read whole."""
    import struct
    import zipfile

    import numpy as np
    fmt = np.lib.format
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for info in zf.infolist():
            name = info.filename.removesuffix(".npy")
            if info.compress_type == zipfile.ZIP_STORED:
                # the member's bytes follow its local header, whose name
                # and extra fields may differ in length from the central
                # directory's
                fh.seek(info.header_offset + 26)
                n_name, n_extra = struct.unpack("<HH", fh.read(4))
                fh.seek(info.header_offset + 30 + n_name + n_extra)
                version = fmt.read_magic(fh)
                read_header = {(1, 0): fmt.read_array_header_1_0,
                               (2, 0): fmt.read_array_header_2_0}.get(version)
                if read_header is not None:
                    shape, fortran, dtype = read_header(fh)
                    if not dtype.hasobject and 0 not in shape:
                        out[name] = np.memmap(
                            path, dtype=dtype, mode="r", offset=fh.tell(),
                            shape=shape, order="F" if fortran else "C")
                        continue
            with zf.open(info) as member:
                out[name] = fmt.read_array(member)
    return out


def _load_mf(path: str, device, item_rows: slice = slice(None)):
    """The ``.npz`` tables on ``device``; ``item_rows`` keeps a row block
    of the item table (only those rows are read from the file)."""
    import numpy as np
    import torch

    from sml_tpu_torch.models.mf import MFParams
    arrays = npz_arrays(path)
    return MFParams(*(
        torch.from_numpy(np.array(
            arrays[f][item_rows] if f == "item_emb" else arrays[f],
            order="C")).to(device) for f in MFParams._fields))


def sml_config(args) -> C.SMLConfig:
    """The ``SMLConfig`` that ``sml`` runs for its parsed flags."""
    news = _dataspec(args).name == "news"
    preset = C.adressa_sml() if news else C.yelp_sml()

    def pick(value, default):
        return value if value is not None else default
    return preset.replace(
        multi_num=pick(args.multi_num, preset.multi_num),
        mf_epochs=pick(args.mf_epochs, preset.mf_epochs),
        tr_epochs=pick(args.tr_epochs, preset.tr_epochs),
        mf_lr=args.mf_lr, mf_l2=args.mf_l2, tr_lr=args.tr_lr,
        tr_l2=args.tr_l2, latent_dim=args.latent,
        # the com2/com3 tower of the reference is 1024 wide, conv_com 512
        transfer=C.TransferConfig(
            latent_dim=args.latent, kind=args.transfer_type,
            fc_hidden=1024 if args.transfer_type == "conv_com_root" else 512),
        mf_sample=args.mf_sample, tr_sample_type=args.tr_sample_type,
        tr_stop=args.tr_stop, load_w_hat=args.load_w_hat,
        pass_num=args.pass_num, seed=args.seed,
        attributed_eval=args.attributed_eval,
        uniform_shapes=not args.per_period_shapes,
        emb_init_scale=args.emb_init_scale,
        eval_during_inner=args.eval_during_inner,
        eval_during_outer=args.eval_during_outer,
        eval_scoring=args.eval_scoring,
        theta_warmstart_steps=args.theta_warmstart,
        saddle_retries=args.saddle_retries,
        snapshot_dtype=args.snapshot_dtype,
        profile_dir=args.profile_dir)


def cmd_sml(args) -> int:
    """The SML sweep, with period-boundary checkpoints and resume."""
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.parallel.multihost import process_count, process_index
    from sml_tpu_torch.train.driver import RunReport, SMLDriver
    from sml_tpu_torch.utils.checkpoint import (latest_step, read_manifest,
                                                save_checkpoint,
                                                state_from_checkpoint)
    from sml_tpu_torch.utils.logging import MetricsLogger

    device = resolve_device(args.device)
    spec = _dataspec(args)
    cfg = sml_config(args)

    n_proc, main_proc = process_count(), process_index() == 0
    logger = MetricsLogger(args.metrics_jsonl if main_proc else None,
                           echo=main_proc)
    driver = SMLDriver(cfg, spec, logger=logger, device=device)
    try:
        engine = driver.engine
        placement = None
        if n_proc > 1:
            from sml_tpu_torch.parallel.multihost import (MultihostPlacement,
                                                          make_global_mesh)
            mesh = make_global_mesh()
            placement = MultihostPlacement(mesh, engine.n_users,
                                           engine.n_items)
            engine.placement = placement
            if main_proc:
                print(f"multi-process: {n_proc} processes, mesh "
                      f"{mesh.shape} over {mesh.transport}", file=sys.stderr)
        resume_step = (latest_step(args.checkpoint_dir)
                       if args.checkpoint_dir else None)
        if args.checkpoint_dir and n_proc > 1:
            # every process must resume from the same step, or their
            # collectives stop matching: check instead of hanging
            import torch.distributed as dist
            steps = [None] * n_proc
            dist.all_gather_object(steps, resume_step)
            if len(set(steps)) != 1:
                raise RuntimeError(
                    "checkpoint resume disagrees across processes (latest "
                    f"steps per process: {steps}); --checkpoint-dir must be "
                    "shared storage visible to every host")
        start_pass, start_period = 0, 0
        if resume_step is not None:
            state = state_from_checkpoint(args.checkpoint_dir, device=device)
            extra = read_manifest(args.checkpoint_dir).get("extra", {})
            start_pass = int(extra.get("pass_id", 0))
            start_period = int(extra.get("period", resume_step)) + 1
            if "report" in extra:
                driver.report = RunReport.from_dict(extra["report"])
            if main_proc:
                print(f"resumed at pass {start_pass} period {start_period}",
                      file=sys.stderr)
        else:
            pretrained = (_load_mf(args.pre_model, device)
                          if args.pre_model else None)
            state = engine.init_state(pretrained_mf=pretrained)
        if placement is not None:
            state = placement.state(state)

        def on_period_end(st, pass_id, d_time, drv):
            if not args.checkpoint_dir:
                return
            # whole tables on every process (a collective), written by
            # process 0; the deferred tests are drained first, so the
            # checkpointed report covers every completed test period
            hs = engine.whole_state(st)
            drv.finalize()
            if main_proc:
                save_checkpoint(args.checkpoint_dir,
                                pass_id * spec.num_periods + d_time, hs,
                                extra={"pass_id": pass_id, "period": d_time,
                                       "report": drv.report.to_dict()})

        driver.run(state, start_pass=start_pass, start_period=start_period,
                   on_period_end=on_period_end)
        if args.save_model:
            hs = engine.whole_state(driver.final_state)
            if main_proc:
                _save_mf(args.save_model, hs.mf)
                print(f"saved final tables to {args.save_model}",
                      file=sys.stderr)
    finally:
        driver.close()
        logger.close()
    if main_proc:
        print(json.dumps(driver.report.summary(), indent=2))
    return 0


def _save_mf(path: str, mf) -> None:
    import numpy as np
    np.savez(path, **{f: getattr(mf, f).detach().cpu().numpy()
                      for f in ("user_emb", "item_emb", "user_bias",
                                "item_bias")})


def cmd_pretrain(args) -> int:
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.train.pretrain import pretrain_mf
    from sml_tpu_torch.utils.logging import MetricsLogger

    device = resolve_device(args.device)
    spec = _dataspec(args)
    pcfg = C.PretrainConfig(lr=args.lr, l2_user=args.l2, l2_item=args.l2,
                            batch_size=args.batch_size,
                            max_epochs=args.epochs, latent_dim=args.latent,
                            seed=args.seed)
    period = args.period if args.period is not None \
        else spec.online_test_start - 1
    logger = MetricsLogger(args.metrics_jsonl, echo=True)
    try:
        params, metrics = pretrain_mf(pcfg, spec, period, logger=logger,
                                      device=device)
    finally:
        logger.close()
    _save_mf(args.out, params)
    print(json.dumps(metrics, indent=2))
    return 0


def cmd_baseline(args) -> int:
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.train.baselines import BaselineDriver
    from sml_tpu_torch.utils.logging import MetricsLogger

    device = resolve_device(args.device)
    spec = _dataspec(args)
    start = args.start_period if args.start_period is not None \
        else spec.online_test_start
    bcfg = C.BaselineConfig(
        method=args.method, lr=args.lr, l2_user=args.l2, l2_item=args.l2,
        epochs=args.epochs, batch_size=args.batch_size,
        pool_size=args.pool_size, start_period=start,
        pool_init_type=1 if spec.name == "news" else 0,
        latent_dim=args.latent, seed=args.seed)
    pretrained = _load_mf(args.pre_model, device) if args.pre_model else None
    logger = MetricsLogger(args.metrics_jsonl, echo=True)
    try:
        driver = BaselineDriver(bcfg, spec, pretrained=pretrained,
                                logger=logger, device=device)
        summary = driver.run()
    finally:
        logger.close()
    print(json.dumps(summary, indent=2))
    return 0


def cmd_synth(args) -> int:
    from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                              generate_synthetic_dataset)

    spec = SyntheticSpec(n_users=args.users, n_items=args.items,
                         n_periods=args.periods,
                         interactions_per_period=args.interactions,
                         first_test_period=args.first_test,
                         neg_num=args.neg_num, seed=args.seed)
    info = generate_synthetic_dataset(args.out, spec)
    print(json.dumps(dataclasses.asdict(info)))
    return 0


def cmd_ingest(args) -> int:
    from sml_tpu_torch.data.ingest import IngestSpec, ingest_csv

    spec = IngestSpec(n_periods=args.periods,
                      first_test_period=args.first_test,
                      neg_num=args.neg_num, split=args.split, seed=args.seed)
    info = ingest_csv(args.csv, args.out, spec,
                      user_col=args.user_col, item_col=args.item_col,
                      time_col=args.time_col, delimiter=args.delimiter,
                      skip_header=args.skip_header)
    print(json.dumps(dataclasses.asdict(info)))
    return 0


def cmd_rank(args) -> int:
    """Full-catalog top-K serving from trained tables. Only the served
    users' rows and this rank's item rows are read from the ``.npz``
    (:func:`npz_arrays`), so no rank holds the whole user table, in host
    memory or on its card. Process 0 also prints, to stderr, one JSON line
    with the seconds taken to load and to serve."""
    import time

    import numpy as np
    import torch

    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.eval.full_ranking import recommend
    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.parallel.multihost import process_count, process_index

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    n_proc = process_count()
    arrays = npz_arrays(args.model)
    n_users, n_items = (arrays["user_emb"].shape[0],
                        arrays["item_emb"].shape[0])
    mesh, item_rows = None, slice(None)
    if args.shard and n_proc > 1:
        # the item table's row block of this rank, over every rank
        from sml_tpu_torch.parallel.sharding import make_mesh
        mesh = make_mesh(1, n_proc)
        if n_items % n_proc:
            raise ValueError(f"--shard: {n_items} items do not divide over "
                             f"{n_proc} ranks")
        per = n_items // n_proc
        item_rows = slice(mesh.index("model") * per,
                          (mesh.index("model") + 1) * per)

    if args.users:
        users = np.asarray([int(u) for u in args.users.split(",")], np.int64)
    else:
        with open(args.users_file) as fh:
            users = np.asarray([int(line) for line in fh if line.strip()],
                               np.int64)
    bad = users[(users < 0) | (users >= n_users)]
    if bad.size:
        print(f"error: user ids out of range [0, {n_users}): "
              f"{bad[:10].tolist()}", file=sys.stderr)
        return 2

    def rows(name, sl):
        return torch.from_numpy(np.array(arrays[name][sl], order="C")).to(
            device)
    item_emb, item_bias = rows("item_emb", item_rows), rows("item_bias",
                                                            item_rows)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dtype = torch.bfloat16 if args.bf16 else None
    for start in range(0, users.shape[0], args.batch_size):
        chunk = users[start:start + args.batch_size]
        # the batch's user rows stand in for the user table
        mf = MFParams(rows("user_emb", chunk), item_emb,
                      rows("user_bias", chunk), item_bias)
        scores, items = recommend(mf, torch.arange(chunk.shape[0]), args.k,
                                  mesh=mesh, compute_dtype=dtype,
                                  topk_method=args.topk_method)
        scores = scores.cpu().numpy()
        items = items.cpu().numpy()
        if process_index() != 0:
            continue
        for r in range(chunk.shape[0]):
            print(json.dumps({"user": int(chunk[r]),
                              "items": items[r].tolist(),
                              "scores": [round(float(s), 4)
                                         for s in scores[r]]}))
    if process_index() == 0:
        print(json.dumps({"rank_load_s": load_s,
                          "rank_serve_s": time.perf_counter() - t0,
                          "users": int(users.shape[0]),
                          "batches": -(-users.shape[0] // args.batch_size),
                          "items": n_items, "processes": n_proc,
                          # the card's peak while loading and serving
                          "rank_peak_gib": (
                              torch.cuda.max_memory_allocated(device)
                              / 2 ** 30 if device.type == "cuda"
                              else None)}),
              file=sys.stderr, flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sml_tpu_torch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help=DEVICE_HELP)
    p.add_argument("--coordinator", default=None,
                   help="multi-process: host:port of rank 0's store")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process: this process's rank")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sml", help="run the SML sequential-retraining sweep")
    _add_data_args(ps)
    ps.add_argument("--pre-model", default=None,
                    help=".npz from `pretrain` (reference --pre_model)")
    ps.add_argument("--save-model", default=None,
                    help="write the final transferred tables as .npz "
                         "(consumable by `rank`)")
    ps.add_argument("--multi-num", type=int, default=None)
    ps.add_argument("--mf-epochs", type=int, default=None)
    ps.add_argument("--tr-epochs", type=int, default=None)
    ps.add_argument("--mf-lr", type=float, default=0.01)
    ps.add_argument("--mf-l2", type=float, default=1e-6)
    ps.add_argument("--tr-lr", type=float, default=0.001)
    ps.add_argument("--tr-l2", type=float, default=1e-4)
    ps.add_argument("--latent", type=int, default=64)
    ps.add_argument("--mf-sample", default="all", choices=["all", "alone"])
    ps.add_argument("--tr-sample-type", default="alone",
                    choices=["all", "alone"])
    ps.add_argument("--tr-stop", action="store_true")
    ps.add_argument("--transfer-type", default="conv_com",
                    choices=["conv_com", "conv2ch", "conv_com_root",
                             "mlp_delta", "linear", "gru", "gated"],
                    help="the kind of transfer tower Θ "
                         "(models/transfer.py)")
    ps.add_argument("--seed", type=int, default=2000)
    ps.add_argument("--load-w-hat", action="store_true",
                    help="restore MF <- W_hat after each outer step "
                         "(reference --Load_W_hat)")
    ps.add_argument("--pass-num", type=int, default=1)
    ps.add_argument("--attributed-eval", action="store_true",
                    help="per-test-period hit attribution by entity "
                         "freshness (reads test_new_user.npy / "
                         "test_new_item.npy of the dataset)")
    ps.add_argument("--emb-init-scale", type=float, default=1.0)
    ps.add_argument("--per-period-shapes", action="store_true",
                    help="pad each period to its own bucket instead of one "
                         "sweep-wide bucket per stream")
    ps.add_argument("--eval-during-inner", action="store_true")
    ps.add_argument("--eval-during-outer", action="store_true")
    ps.add_argument("--eval-scoring", default="auto",
                    choices=["auto", "gather", "matmul", "gather_bf16",
                             "matmul_bf16", "masked", "masked_bf16"],
                    help="candidate scoring mode (eval/evaluator.py); "
                         "'masked*' rank through kernel K2 on the card")
    ps.add_argument("--saddle-retries", type=int, default=2,
                    help="retry the first online-train period (at most N "
                         "times, re-rolled Θ/stream pair) when the outer "
                         "loss stalls near the zero-score BCE saddle; 0 "
                         "for strict reference behaviour")
    ps.add_argument("--theta-warmstart", type=int, default=0,
                    help="identity warm-start steps for Θ before the sweep "
                         "(0 = strict reference init)")
    ps.add_argument("--snapshot-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="dtype of the last/hat table snapshots")
    ps.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (Chrome JSON) of "
                         "period 0 here")
    ps.set_defaults(fn=cmd_sml)

    pp = sub.add_parser("pretrain", help="pretrain the base MF model")
    _add_data_args(pp)
    pp.add_argument("--out", required=True, help="output .npz path")
    pp.add_argument("--period", type=int, default=None,
                    help="pretrain period (default online_test_start-1)")
    pp.add_argument("--lr", type=float, default=0.01)
    pp.add_argument("--l2", type=float, default=1e-5)
    pp.add_argument("--epochs", type=int, default=200)
    pp.add_argument("--batch-size", type=int, default=256)
    pp.add_argument("--latent", type=int, default=64)
    pp.add_argument("--seed", type=int, default=2000)
    pp.set_defaults(fn=cmd_pretrain)

    pb = sub.add_parser("baseline", help="full-retrain / fine-tune / SPMF")
    _add_data_args(pb)
    pb.add_argument("--method", default="full",
                    choices=["full", "fine", "spmf"])
    pb.add_argument("--pre-model", default=None)
    pb.add_argument("--start-period", type=int, default=None)
    pb.add_argument("--lr", type=float, default=0.01)
    pb.add_argument("--l2", type=float, default=1e-5)
    pb.add_argument("--epochs", type=int, default=20)
    pb.add_argument("--batch-size", type=int, default=256)
    pb.add_argument("--pool-size", type=int, default=0)
    pb.add_argument("--latent", type=int, default=64)
    pb.add_argument("--seed", type=int, default=2000)
    pb.set_defaults(fn=cmd_baseline)

    pg = sub.add_parser("synth", help="generate a synthetic dataset")
    pg.add_argument("--out", required=True)
    pg.add_argument("--users", type=int, default=2000)
    pg.add_argument("--items", type=int, default=1000)
    pg.add_argument("--periods", type=int, default=12)
    pg.add_argument("--interactions", type=int, default=4000)
    pg.add_argument("--first-test", type=int, default=4)
    pg.add_argument("--neg-num", type=int, default=999)
    pg.add_argument("--seed", type=int, default=0)
    pg.set_defaults(fn=cmd_synth)

    pi = sub.add_parser("ingest", help="raw (user,item,timestamp) CSV log "
                                       "-> period-file dataset")
    pi.add_argument("--csv", required=True)
    pi.add_argument("--out", required=True)
    pi.add_argument("--periods", type=int, required=True)
    pi.add_argument("--first-test", type=int, required=True)
    pi.add_argument("--neg-num", type=int, default=999)
    pi.add_argument("--split", default="count", choices=["count", "time"])
    pi.add_argument("--user-col", type=int, default=0)
    pi.add_argument("--item-col", type=int, default=1)
    pi.add_argument("--time-col", type=int, default=2)
    pi.add_argument("--delimiter", default=",")
    pi.add_argument("--skip-header", type=int, default=1)
    pi.add_argument("--seed", type=int, default=0)
    pi.set_defaults(fn=cmd_ingest)

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
                    help="row-shard the item table over all ranks of a "
                         "multi-process world (a no-op with one process)")
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.coordinator:
        return args.fn(args)
    import torch.distributed as dist

    from sml_tpu_torch.parallel.multihost import init_distributed
    from sml_tpu_torch.train import graphs
    args.device = str(init_distributed(args.coordinator, args.num_processes,
                                       args.process_id, device=args.device))
    try:
        try:
            rc = args.fn(args)
        finally:
            # the barrier and the teardown hang while a CUDA graph that
            # holds NCCL collectives is alive
            graphs.release_all()
        # no process leaves while a peer may still be connecting to it
        dist.barrier()
        return rc
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
