"""Multi-rank dry run (the port's analogue of
``__graft_entry__.dryrun_multichip``) and the launcher it runs on.

:func:`run_world` spawns R processes, joins them into one world over a
file store and calls a function of this package on every rank, with a
timeout for the whole world: a rank that fails, or a world that outlives
its time, kills every rank and raises; with ``hosts=H`` its ranks run as
H simulated hosts, each seeing its own share of the cards
(:func:`simulated_hosts`). :func:`full_step` is what one rank
runs: one full SML step (inner epoch -> snapshot -> refresh -> outer epoch
-> refresh), a leave-one-out test and full-catalog top-K serving, on a
mesh or on one rank alone, with the kernels' launches counted per rank.

:func:`run_cli_world` starts ``python -m sml_tpu_torch`` as R processes of
one world over a local TCP port, with one timeout for them all.

:func:`dryrun_multichip` holds one full step on an R-rank mesh to the same
step on one rank, in three sample modes (the JAX dry run's 'alone' mode,
replay and 'all'), the JAX dry run's fused parts (c) (``phase_step`` with
``mf_sample="all"``) and (d) (``period_step`` of two phases with the
in-training evals inside) on the mesh against one rank
(:func:`fused_parts`), and sharded serving to dense serving on the same
tables.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Optional

import numpy as np

DEFAULT_WORLD_TIMEOUT_S = 600.0
SERVE_BATCH = 1024      # users per top-K call
_PENDING = object()     # a rank still running


def simulated_hosts(n: int, hosts: int, device: str) -> list:
    """Where each rank of an ``n``-rank world of ``hosts`` simulated hosts
    runs: ``(host, env)`` by rank. Rank ``r`` is on host ``r // (n //
    hosts)`` (a host's ranks contiguous, as ``make_global_mesh`` needs).
    On cards each host sees its own share of the machine's cards
    (``CUDA_VISIBLE_DEVICES``; with fewer cards than hosts every host sees
    the first, and the ranks then share it over gloo), and NCCL is told
    the hosts apart (``NCCL_HOSTID``), so it carries what crosses hosts
    over its network transport and not over P2P or shared memory. One
    host: ``(None, {})`` for every rank (the machine's own name, its
    environment as it is)."""
    if hosts == 1:
        return [(None, {})] * n
    if hosts < 1 or n % hosts:
        raise ValueError(f"{n} ranks do not divide into {hosts} hosts")
    import socket
    name = socket.gethostname()
    share = []
    if device == "cuda":
        import torch
        seen = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = ([c for c in seen.split(",") if c] if seen is not None
                 else [str(i) for i in range(torch.cuda.device_count())])
        per = len(cards) // hosts
        share = [cards[h * per:(h + 1) * per] if per else cards[:1]
                 for h in range(hosts)]
    out = []
    for r in range(n):
        h = r // (n // hosts)
        env = ({"CUDA_VISIBLE_DEVICES": ",".join(share[h]),
                "NCCL_HOSTID": f"{name}-sim{h}"} if share else {})
        out.append((f"{name}-sim{h}", env))
    return out


def _rank_main(rank: int, n: int, store: str, device: str, target: str,
               args, out_dir: str, timeout_s: float, host=None,
               env=None) -> None:
    """A spawned rank: take its host's environment (before any CUDA call),
    join the world, run ``target`` (``module:function``), write its result
    or its traceback."""
    os.environ.update(env or {})
    import importlib

    import torch
    import torch.distributed as dist
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        from sml_tpu_torch.parallel.multihost import init_distributed
        from sml_tpu_torch.train import graphs
        dev = init_distributed(store, n, rank, device=device,
                               timeout_s=timeout_s, host=host)
        # one thread per rank: worlds may run beside other work
        torch.set_num_threads(1)
        mod, fn = target.split(":")
        try:
            result = ("ok", getattr(importlib.import_module(mod), fn)(
                str(dev), *args))
        finally:
            graphs.release_all()
        # no rank leaves while a peer may still be connecting to it
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(path + ".tmp", path)


def run_world(target: str, n: int, device: str = "cuda", args=(),
              timeout_s: float = DEFAULT_WORLD_TIMEOUT_S,
              hosts: int = 1) -> list:
    """``target(rank_device, *args)`` on every rank of an ``n``-rank world
    (``target`` is ``"module:function"``, a function of this package);
    returns the results in rank order. Raises, with the failing rank's
    traceback, if a rank fails, and kills every rank if the world is not
    done within ``timeout_s``. ``device="cuda"`` raises here, before any
    rank starts, when there is no card. ``hosts``: the ranks run as that
    many simulated hosts (:func:`simulated_hosts`); 1 leaves every rank on
    this machine's host with its environment as it is."""
    import multiprocessing as mp

    from sml_tpu_torch.device import resolve_device
    resolve_device(device)
    placed = simulated_hosts(n, hosts, device)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="sml_world_")
    store = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, store, device, target, args, tmp,
                               timeout_s, *placed[r]))
             for r in range(n)]
    def result(r):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            if procs[r].is_alive():
                return _PENDING
            raise RuntimeError(f"rank {r} of {target} exited "
                               f"{procs[r].exitcode} without a result")
        with open(path, "rb") as fh:
            status, value = pickle.load(fh)
        if status != "ok":
            raise RuntimeError(f"rank {r} of {target} failed:\n{value}")
        return value

    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        results = [_PENDING] * n
        # the first rank to fail ends the world (its peers would wait on
        # it until the collectives' timeout)
        while any(x is _PENDING for x in results):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target} on {n} ranks outlived "
                                   f"{timeout_s} s")
            for r in range(n):
                if results[r] is _PENDING:
                    results[r] = result(r)
            time.sleep(0.05)
        return results
    finally:
        for p in procs:
            if p.pid is None:          # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)


def run_cli_world(argv, n: int, device: str = "cuda",
                  timeout_s: float = DEFAULT_WORLD_TIMEOUT_S,
                  env: Optional[dict] = None) -> list:
    """``python -m sml_tpu_torch --device device ...`` as ``n`` processes of
    one world over a free local TCP port (one process alone, with no world
    flags, for ``n == 1``), all started at once from the checkout that holds
    this package. ``argv`` is the command line of every process, or a
    function of the process id giving each its own; ``env`` adds to the
    environment. Returns ``(returncode, stdout, stderr)`` per process, in
    process order; every process is killed if the run is not done within
    ``timeout_s``. ``device="cuda"`` raises here, before any process
    starts, when there is no card."""
    import socket
    import subprocess
    import sys

    from sml_tpu_torch.device import resolve_device
    resolve_device(device)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def command(r):
        world = (["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                  str(n), "--process-id", str(r)] if n > 1 else [])
        return ([sys.executable, "-m", "sml_tpu_torch", "--device", device]
                + world + list(argv(r) if callable(argv) else argv))
    procs = [subprocess.Popen(command(r), cwd=root,
                              env={**os.environ, **(env or {})},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    deadline = time.monotonic() + timeout_s
    out = []
    try:
        for p in procs:
            so, se = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@dataclasses.dataclass
class StepSpec:
    """What :func:`full_step` runs: the config and counts, the mesh shape
    (None: one rank alone; ``"global"``: ``make_global_mesh()``, the
    hosts' layout), the phases the step trains (each as the driver's
    unfused phase makes it, after one ``snapshot_last``; ``fused``:
    through ``SMLEngine.phase_step``, whose first call is the program's
    warm-up and whose second captures it), and an ``.npz`` holding
    ``inner_rows``,
    ``outer_rows``, ``test_rows`` and ``serve_users`` (and the pretrained
    tables ``user_emb``/``item_emb``/``user_bias``/``item_bias``, if
    any)."""
    cfg: object
    n_users: int
    n_items: int
    data: str
    mesh: object = None
    phases: int = 1
    fused: bool = False
    serve_k: int = 20
    topk_methods: tuple = ("exact",)


def _kernel_modules():
    from sml_tpu_torch.ops import adam_kernel, eval_kernel, transfer_kernel
    return {"decay_adam_kernel": adam_kernel.decay_adam_cuda,
            "transfer_rows_kernel": transfer_kernel.transfer_rows_cuda,
            "masked_rank_gather_kernel": eval_kernel.masked_rank_cuda}


def spec_mesh(shape):
    """The mesh of a shape: a ``(data, model)`` tuple over the world's
    ranks, or ``"global"``, the hosts' layout (``make_global_mesh``)."""
    from sml_tpu_torch.parallel.multihost import make_global_mesh
    from sml_tpu_torch.parallel.sharding import make_mesh
    return make_global_mesh() if shape == "global" else make_mesh(*shape)


def full_step(device: str, spec: StepSpec) -> dict:
    """One full SML step (``spec.phases`` phases), a test and top-K
    serving on this rank; see the module note. Returns this rank's
    launches per kernel, wall seconds, host, card, transport and graph
    counts, the driver's fusion rule for this engine
    (:func:`_fusion_rule`), on a mesh also :func:`check_transport`'s
    answers (run before the step), and (rank 0) the whole tables, Θ, the
    losses, the test's hit and NDCG sums and the served scores and ids."""
    import torch

    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import process_index
    from sml_tpu_torch.train.engine import SMLEngine

    with np.load(spec.data) as blob:
        data = {k: blob[k] for k in blob.files}
    pretrained = (MFParams(*(data[f] for f in MFParams._fields))
                  if "user_emb" in data else None)
    eng = SMLEngine(spec.cfg, spec.n_users, spec.n_items, device=device)
    dev = eng.device
    mesh, checked = None, None
    if spec.mesh is not None:
        checked = check_transport(device)
        mesh = spec_mesh(spec.mesh)
        state = eng.init_state_sharded(mesh, pretrained_mf=pretrained)
    else:
        state = eng.init_state(pretrained_mf=pretrained)
    counters = _kernel_modules()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    state = eng.snapshot_last(state)
    prep_t = eng.prep_inner(data["inner_rows"])
    prep_tt = eng.prep_outer(data["outer_rows"])
    for _ in range(spec.phases):
        if spec.fused:
            state, il, ol = eng.phase_step(state, prep_t, prep_tt)
            continue
        state, il = eng.inner_epoch(state, *prep_t)
        state = eng.refresh(eng.snapshot_hat(state))
        state, ol = eng.outer_epoch(state, *prep_tt)
        state = eng.refresh(state)
    sums, _ = eng.evaluate_deferred(
        state.mf, eng.make_eval_set(data["test_rows"], build_mask=True))
    served = {}
    users = torch.from_numpy(data["serve_users"]).to(dev)
    for method in spec.topk_methods:
        parts = [eng.serve_topk(state.mf, users[s:s + SERVE_BATCH],
                                spec.serve_k, topk_method=method)
                 for s in range(0, users.shape[0], SERVE_BATCH)]
        served[method] = tuple(torch.cat(x).cpu().numpy()
                               for x in zip(*parts))
    sync()
    wall = time.perf_counter() - t0
    out = {"launches": {k: c.launches for k, c in counters.items()},
           "wall_s": wall,
           "transport": ("local" if mesh is None
                         else {a: collective.transport(mesh.group(a))
                               for a in ("data", "model")}),
           "collectives": checked, "fusion": _fusion_rule(spec.cfg, eng),
           "graphs": dict(eng.graph_stats),
           **{k: (collective.WORLD.get(f"{k}s") or [None])[process_index()]
              for k in ("host", "card")}}
    whole = eng.whole_state(state)
    if process_index() == 0:
        out.update(
            user_emb=whole.mf.user_emb.detach().cpu().numpy(),
            item_emb=whole.mf.item_emb.detach().cpu().numpy(),
            theta={k: p.detach().cpu().numpy()
                   for k, p in theta_leaves(whole.theta).items()},
            inner_losses=il.cpu().numpy(), outer_losses=ol.cpu().numpy(),
            eval={k: (float(h), float(nd)) for k, (h, nd) in sums.items()},
            served=served, serve_users=data["serve_users"])
    return out


def _fusion_rule(cfg, eng) -> dict:
    """What the driver's fusion rule makes of this engine: why its
    programs cannot be captured (None where they can), and the route
    ``fuse_period="auto"`` and ``True`` take (True raises where the
    programs cannot be captured: its message)."""
    from sml_tpu_torch.train.driver import fusion_route
    out = {"refusal": eng.capture_refusal()}
    for fuse in ("auto", True):
        try:
            out[str(fuse)] = fusion_route(
                cfg.replace(fuse_phases=True, fuse_period=fuse), eng)
        except ValueError as exc:
            out[str(fuse)] = str(exc)
    return out


def check_transport(device: str) -> dict:
    """Every collective of ``parallel.collective`` over the world (a
    ``(1, R)`` mesh's ``model`` axis) on tensors of this rank's device,
    checked against the sums, concatenations and copies they must give;
    returns the transport of each and this rank's answers' errors."""
    import torch

    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh(1)
    group = mesh.group("model")
    n, r = mesh.shape["model"], mesh.index("model")
    x = torch.arange(6, dtype=torch.float32, device=device) + 10 * r
    want_sum = (torch.arange(6, dtype=torch.float32) * n
                + 10 * sum(range(n)))
    want_cat = torch.cat([torch.arange(6, dtype=torch.float32) + 10 * q
                          for q in range(n)])
    got = {"all_reduce": collective.all_reduce(x.clone(), group),
           "all_gather": collective.all_gather(x.clone(), group),
           "broadcast": collective.broadcast(x.clone(), group, src=n - 1)}
    want = {"all_reduce": want_sum, "all_gather": want_cat,
            "broadcast": torch.arange(6, dtype=torch.float32)
            + 10 * (n - 1)}
    return {"transport": collective.transport(group),
            "device": str(x.device),
            "errors": {k: float((got[k].cpu() - want[k]).abs().max())
                       for k in got},
            "on_device": all(t.device == x.device for t in got.values())}


def fused_parts(device: str, cfg_c, cfg_d, n_users: int, n_items: int,
                data: str, mesh: Optional[tuple],
                fused: bool = True) -> dict:
    """The JAX dry run's fused parts on this rank (``mesh=None``: one rank
    alone):

    (c) ``snapshot_last`` then ``phase_step`` on the 'all'-mode rows
        (``cfg_c``: ``mf_sample="all"``), twice (on the card the first is
        the program's warm-up, the second its capture), then the test;
    (d) ``snapshot_last``, the masked eval set of the test rows, then
        ``period_step`` of two phases with the in-training evals inside
        (``cfg_d``).

    ``fused=False`` runs the same phases through the engine's per-epoch
    calls instead (:func:`_unfused_phases`). On a mesh every rank then
    runs them unfused, under ``"unfused"`` (the witness), and rank 0 fused
    alone, under ``"one"``. Returns, per part, the whole tables and Θ, the
    test's metrics (c) or the expanded eval records (d), and this rank's
    launches; on cards under a mesh of ranks sharing a card (gloo), where
    the programs cannot be captured, ``{"refused": why}`` instead."""
    import torch

    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.parallel.multihost import process_index
    from sml_tpu_torch.train.engine import SMLEngine
    with np.load(data) as blob:
        d = {k: blob[k] for k in blob.files}
    out = {}
    grid = None if mesh is None else spec_mesh(mesh)
    counters = _kernel_modules()
    for part, cfg in (("c", cfg_c), ("d", cfg_d)):
        eng = SMLEngine(cfg, n_users, n_items, device=device)
        state = (eng.init_state() if grid is None
                 else eng.init_state_sharded(grid))
        why = eng.capture_refusal() if fused else None
        if why is not None:
            out[part] = {"refused": why}
            continue
        state = eng.snapshot_last(state)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        val = (None if part == "c"
               else eng.make_eval_set(d["test_rows"], build_mask=True))
        prep_t = eng.prep_inner(d["all_inner" if part == "c"
                                  else "inner_rows"])
        prep_tt = eng.prep_outer(d["outer_rows"])
        n_phases = 2
        if not fused:
            state, records = _unfused_phases(eng, state, prep_t, prep_tt,
                                             n_phases, val)
        elif part == "c":
            for _ in range(n_phases):
                state, il, ol = eng.phase_step(state, prep_t, prep_tt)
                if not (torch.isfinite(il).all()
                        and torch.isfinite(ol).all()):
                    raise AssertionError("fused part (c): a loss is not "
                                         "finite")
        else:
            state, evals, _, _ = eng.period_step(state, prep_t, prep_tt,
                                                 n_phases, val)
            records = eng.resolve_stacked_evals(
                [(evals, d["test_rows"].shape[0])])[0]
        res = ({"metrics": eng.evaluate(state.mf, d["test_rows"])}
               if part == "c" else {"records": records})
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        res["wall_s"] = time.perf_counter() - t0
        res["launches"] = {k: c.launches for k, c in counters.items()}
        res["graphs"] = dict(eng.graph_stats)
        whole = eng.whole_state(state)
        res["user_emb"] = whole.mf.user_emb.detach().cpu().numpy()
        res["item_emb"] = whole.mf.item_emb.detach().cpu().numpy()
        res["theta"] = {k: p.detach().cpu().numpy().copy()
                        for k, p in theta_leaves(whole.theta).items()}
        eng.release_programs()
        out[part] = res
    if mesh is not None and fused and "refused" not in out["c"]:
        out["unfused"] = fused_parts(device, cfg_c, cfg_d, n_users, n_items,
                                     data, mesh, fused=False)
        if process_index() == 0:
            out["one"] = fused_parts(device, cfg_c, cfg_d, n_users, n_items,
                                     data, None)
    return out


def _unfused_phases(eng, state, prep_t, prep_tt, n_phases: int, val):
    """``n_phases`` SML phases through the engine's per-epoch calls, as the
    driver's unfused phase makes them (``SMLDriver._one_phase``), with the
    in-training evals of ``val`` (None: none). Returns the state and the
    eval records in the order ``resolve_stacked_evals`` expands a fused
    period's."""
    cfg = eng.cfg
    keys, sums = [], []

    def evaluate(kind, epoch, mf):
        if val is not None and (cfg.eval_during_inner if kind == "inner_eval"
                                else cfg.eval_during_outer):
            keys.append((kind, epoch))
            sums.append(eng.evaluate_deferred(mf, val))
    for _ in range(n_phases):
        for e in range(cfg.mf_epochs):
            state, _ = eng.inner_epoch(state, *prep_t)
            evaluate("inner_eval", e, state.mf)
        state = eng.refresh(eng.snapshot_hat(state))
        for e in range(cfg.tr_epochs):
            state, _ = eng.outer_epoch(state, *prep_tt)
            if cfg.refresh_after_outer_epoch:
                state = eng.refresh(state)
                evaluate("outer_eval", e, state.mf)
        if cfg.load_w_hat:
            state = eng.load_hat_into_mf(state)
    return state, [(k, e, m) for (k, e), m in zip(keys,
                                                   eng.resolve_evals(sums))]


def _metric_gap(a: dict, b: dict, n_test: int) -> tuple:
    """Part (c)'s test metrics or part (d)'s eval records of two runs:
    ``(hits, ndcg)``, the largest difference in hits of ``n_test`` rows
    and in NDCG over every K (and record); raises where (d)'s records
    differ in kind or epoch."""
    if "metrics" in a:
        pairs = [(a["metrics"], b["metrics"])]
    else:
        ra, rb = a["records"], b["records"]
        if len(ra) != len(rb) or not ra or any(
                (k1, e1) != (k2, e2)
                for (k1, e1, _), (k2, e2, _) in zip(ra, rb)):
            raise AssertionError(f"fused part (d): records {ra} vs {rb}")
        pairs = [(m1, m2) for (_, _, m1), (_, _, m2) in zip(ra, rb)]
    hits = max(abs(m1[k]["recall"] - m2[k]["recall"]) * n_test
               for m1, m2 in pairs for k in m1)
    ndcg = max(abs(m1[k]["ndcg"] - m2[k]["ndcg"])
               for m1, m2 in pairs for k in m1)
    return round(hits, 6), ndcg


def check_fused_parts(result: dict, n_test: int, n_data: int) -> dict:
    """Part (c) and (d) of a mesh (:func:`fused_parts` of its rank 0) held
    to the same phases unfused on the mesh (the witness): tables and Θ
    bit-equal, equal hits, NDCG within 1e-6; and to one rank: tables and Θ
    within 1e-4 and, on a mesh of one 'data' rank, equal hits and NDCG
    within 1e-6, as the JAX dry run holds them. A 'data' axis of several
    ranks sums Θ's gradients in another order than one rank, so there the
    hits against one rank are reported (``vs_one``) and held only through
    the witness, which the unfused modes hold to one rank with equal hits.
    Returns the largest differences; raises on a disagreement. A part the
    mesh refused (ranks sharing a card) reports its reason and is
    not compared."""
    refused = {p: result[p]["refused"] for p in ("c", "d")
               if "refused" in result[p]}
    if refused:
        return {p: {"refused": why} for p, why in refused.items()}
    report = {}
    for part in ("c", "d"):
        got = result[part]
        wit, one = result["unfused"][part], result["one"][part]
        delta, wit_delta = max_delta(got, one), max_delta(got, wit)
        if max(delta.values()) >= 1e-4 or max(wit_delta.values()) != 0.0:
            raise AssertionError(
                f"fused part ({part}): divergence from one rank {delta}, "
                f"from the unfused mesh {wit_delta}")
        vs_wit, vs_one = (_metric_gap(got, wit, n_test),
                          _metric_gap(got, one, n_test))
        held = [("the unfused mesh", vs_wit)]
        if n_data == 1:
            held.append(("one rank", vs_one))
        for who, (hits, ndcg) in held:
            if hits != 0 or ndcg > 1e-6:
                raise AssertionError(
                    f"fused part ({part}): hits differ by {hits}, NDCG by "
                    f"{ndcg} from {who}'s")
        report[part] = {"max_delta": delta, "wall_s": got["wall_s"],
                        "graphs": got["graphs"],
                        "vs_one": {"hits": vs_one[0], "ndcg": vs_one[1]}}
    report["c"]["recall@20"] = result["c"]["metrics"][20]["recall"]
    report["d"]["records"] = len(result["d"]["records"])
    return report


def tiny_config(n_model: int, **kw):
    """The dry run's configuration (``__graft_entry__._tiny_setup``'s):
    d=16, H=64, batches 64/32, the row-sparse table Adam forced on."""
    from sml_tpu_torch.config import SMLConfig, TransferConfig
    base = dict(mf_batch_size=64, tr_batch_size=32, eval_batch_size=64,
                latent_dim=16, multi_num=1,
                transfer=TransferConfig(latent_dim=16, fc_hidden=64),
                mf_sample="alone", tr_sample_type="alone",
                fast_table_adam=True)
    base.update(kw)
    return SMLConfig(**base), 32 * n_model, 16 * n_model


def _write_data(path: str, n_users: int, n_items: int, seed: int = 0):
    rng = np.random.default_rng(seed)

    def pairs():
        return np.unique(np.stack([rng.integers(0, n_users, 300),
                                   rng.integers(0, n_items, 300)], 1),
                         axis=0)
    set_t, set_tt = pairs(), pairs()
    # eval protocol negatives: 999 per row, so recall@20 is a real number
    test_rows = np.stack([rng.integers(0, n_users, 64),
                          rng.integers(0, n_items, 64)]
                         + [rng.integers(0, n_items, 64)
                            for _ in range(999)], axis=1)
    def neg(n, k):
        return rng.integers(0, n_items, (n, k))
    np.savez(path, test_rows=test_rows,
             serve_users=rng.integers(0, n_users, 16),
             # 'alone' mode draws its negatives; replay reads column 2;
             # 'all' reads one column of the eval-format rows
             inner_rows=set_t, outer_rows=set_tt,
             replay_inner=np.concatenate([set_t, neg(len(set_t), 1)], 1),
             replay_outer=np.concatenate([set_tt, neg(len(set_tt), 1)], 1),
             all_inner=np.concatenate([set_t, neg(len(set_t), 9)], 1))


def _mode_data(src: str, dst: str, mode: str) -> None:
    """A copy of the dry run's data with the training rows of ``mode``."""
    with np.load(src) as blob:
        d = {k: blob[k] for k in blob.files}
    if mode == "replay":
        d["inner_rows"], d["outer_rows"] = d["replay_inner"], \
            d["replay_outer"]
    elif mode == "all":
        d["inner_rows"] = d["all_inner"]
    np.savez(dst, **d)


def max_delta(a: dict, b: dict) -> dict:
    """Largest absolute differences of two :func:`full_step` results."""
    return {"user": float(np.max(np.abs(a["user_emb"] - b["user_emb"]))),
            "item": float(np.max(np.abs(a["item_emb"] - b["item_emb"]))),
            "theta": max(float(np.max(np.abs(a["theta"][k] - b["theta"][k])))
                         for k in a["theta"])}


def step_against_one_rank(device: str, specs) -> list:
    """:func:`full_step` for each spec on the mesh; rank 0 then runs each
    again alone (no mesh, no collective). Returns ``[(sharded, one), ...]``
    (``one`` is None on the other ranks)."""
    out = [full_step(device, spec) for spec in specs]
    from sml_tpu_torch.parallel.multihost import process_index
    if process_index() != 0:
        return [(r, None) for r in out]
    return [(r, full_step(device, dataclasses.replace(spec, mesh=None)))
            for r, spec in zip(out, specs)]


def dryrun_multichip(n: int, device: str = "cuda",
                     timeout_s: float = DEFAULT_WORLD_TIMEOUT_S,
                     hosts: int = 1) -> dict:
    """One full step on an ``n``-rank mesh (``(2, n/2)`` for an even
    ``n >= 4``, else ``(1, n)``; with ``hosts`` > 1 the ranks run as that
    many simulated hosts on their global mesh, ``(hosts, n/hosts)``)
    against one rank, for 'alone' sampling,
    replay and 'all' mode: tables and Θ within 1e-4, equal recall at 999
    negatives and NDCG within 1e-6; the fused parts (c) and (d) against
    the same phases unfused on the mesh and against one rank
    (:func:`check_fused_parts`); then sharded top-K serving against
    dense serving on the same tables (``exact`` and ``exact_bucket``):
    equal id sets per row, scores within 1e-5. Prints a line per part and
    returns the numbers; raises on any disagreement, and raises for
    ``device="cuda"`` when there is no card."""
    from sml_tpu_torch.device import resolve_device
    resolve_device(device)
    if hosts > 1:
        n_data, n_model = hosts, n // hosts
    else:
        n_data, n_model = (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)
    shape = "global" if hosts > 1 else (n_data, n_model)
    tmp = tempfile.mkdtemp(prefix="sml_dryrun_")
    report = {"mesh": {"data": n_data, "model": n_model}}
    modes = ("alone", "replay", "all")
    try:
        base = os.path.join(tmp, "base.npz")
        _, n_users, n_items = tiny_config(n_model)
        _write_data(base, n_users, n_items)
        specs = []
        for mode in modes:
            kw = ({"replay_mode": True} if mode == "replay"
                  else {"mf_sample": "all"} if mode == "all" else {})
            cfg, _, _ = tiny_config(n_model, **kw)
            path = os.path.join(tmp, f"{mode}.npz")
            _mode_data(base, path, mode)
            specs.append(StepSpec(cfg, n_users, n_items, path, shape,
                                  serve_k=8,
                                  topk_methods=("exact", "exact_bucket")))
        ranks = run_world(f"{__name__}:step_against_one_rank", n, device,
                          (specs,), timeout_s, hosts)
        cfg_c, _, _ = tiny_config(n_model, mf_sample="all")
        cfg_d, _, _ = tiny_config(n_model, multi_num=2,
                                  eval_during_inner=True,
                                  eval_during_outer=True)
        fused = run_world(f"{__name__}:fused_parts", n, device,
                          (cfg_c, cfg_d, n_users, n_items, base, shape),
                          timeout_s, hosts)
        for k, mode in enumerate(modes):
            got, one = ranks[0][k]
            delta = max_delta(got, one)
            if max(delta.values()) >= 1e-4:
                raise AssertionError(f"{mode}: sharded-vs-single "
                                     f"divergence {delta}")
            for kk, (h, nd) in got["eval"].items():
                h1, nd1 = one["eval"][kk]
                if h != h1 or abs(nd - nd1) > 1e-6:
                    raise AssertionError(f"{mode}: eval@{kk} {(h, nd)} vs "
                                         f"{(h1, nd1)}")
            recall = got["eval"][20][0] / 64
            print(f"dryrun_multichip({n}) {mode}: mesh=({n_data}, {n_model}) "
                  f"recall@20={recall:.3f} max_delta(user={delta['user']:.2e},"
                  f" item={delta['item']:.2e}, theta={delta['theta']:.2e}) "
                  "sharded==single OK", flush=True)
            report[mode] = {"max_delta": delta, "recall@20": recall,
                            "launches": [r[k][0]["launches"] for r in ranks]}
        report["fused"] = check_fused_parts(fused[0], 64, n_data)
        # each rank's parts: on the card captured once (after the warm-up
        # phase), on the CPU run eagerly
        captures = {(r, p): res[p]["graphs"]["captures"]
                    for r, res in enumerate(fused) for p in ("c", "d")
                    if "refused" not in res[p]}
        if any(c != int(device == "cuda") for c in captures.values()):
            raise AssertionError(f"fused parts' captures by (rank, part): "
                                 f"{captures}")
        if "refused" in report["fused"]["c"]:
            print(f"dryrun_multichip({n}) fused parts not run on this "
                  f"mesh: {report['fused']['c']['refused']}", flush=True)
        else:
            report["fused"]["launches"] = [
                {p: r[p]["launches"] for p in ("c", "d")} for r in fused]
            fz = report["fused"]
            print(f"dryrun_multichip({n}) fused phase_step + 'all' mode: "
                  f"recall@20={fz['c']['recall@20']:.3f} "
                  f"max_delta={fz['c']['max_delta']} vs one rank "
                  f"{fz['c']['vs_one']} fused==unfused OK", flush=True)
            print(f"dryrun_multichip({n}) fused period_step (evals "
                  f"in-program): {fz['d']['records']} eval records, "
                  f"max_delta={fz['d']['max_delta']} vs one rank "
                  f"{fz['d']['vs_one']} fused==unfused OK", flush=True)
        # (e) sharded serving against dense serving on the same tables
        report["serving"] = _serving_parity(ranks[0][0][0])
        print(f"dryrun_multichip({n}) sharded full-catalog top-8 serving: "
              f"id-sets == dense (exact, exact_bucket), max|score delta|="
              f"{report['serving']:.2e} OK", flush=True)
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _serving_parity(result: dict) -> float:
    """The served (scores, ids) of a sharded :func:`full_step` against a
    dense top-K over its own whole tables; returns the largest score
    difference."""
    import torch

    from sml_tpu_torch.eval.full_ranking import dense_full_topk
    worst = 0.0
    for method, (s_sh, i_sh) in result["served"].items():
        users = result["serve_users"]
        s_d, i_d = dense_full_topk(torch.from_numpy(result["user_emb"][users]),
                                   torch.from_numpy(result["item_emb"]),
                                   s_sh.shape[1], topk_method=method)
        s_d, i_d = s_d.numpy(), i_d.numpy()
        for b in range(s_sh.shape[0]):
            if set(i_sh[b].tolist()) != set(i_d[b].tolist()):
                raise AssertionError(f"{method}: row {b} ids "
                                     f"{sorted(i_sh[b])} vs {sorted(i_d[b])}")
        worst = max(worst, float(np.max(np.abs(np.sort(s_sh, 1)
                                               - np.sort(s_d, 1)))))
        if worst > 1e-5:
            raise AssertionError(f"{method}: scores differ by {worst}")
    return worst
