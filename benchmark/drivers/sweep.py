"""The retraining sweep's window: ``SMLDriver.run_period``, what ``python
-m sml_tpu_torch sml`` runs, on the route ``fuse_period="auto"`` takes.

Set-up makes the dataset and the pretrained tables from the seed, builds
the driver and its state (the benchmark's tables, Θ and run generator
written in), adopts the state as ``SMLDriver.run`` does, and drives it
through the traffic's ``setup_periods`` (the captures), recording what
the reference follows over the first ``compared_periods``; it ends with a
copy on the host of the state the window starts from. The window runs
whole periods until ``--seconds`` have passed, then resolves the deferred
tests on the host; its first period is recorded too. After it, the
window's last refresh is held to the reference's refresh of the
program's final state, the reference follows the compared periods from
the seed's inputs, and the window's first period from the copied state
(``checks.py``).
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

import checks
import costs
import generate
import harness
from reference import sml as ref
from reference.precision import precision


VARIANTS = ("tf32/sound", "f32/unchanged", "f32/half", "f32/altered",
            "f32/sound")


def smlconfig(cfg: dict):
    from sml_tpu_torch.config import SMLConfig, TransferConfig
    return SMLConfig(
        multi_num=cfg["multi_num"], mf_lr=cfg["mf_lr"],
        mf_epochs=cfg["mf_epochs"], mf_l2=cfg["mf_l2"],
        mf_batch_size=cfg["mf_batch_size"], latent_dim=cfg["latent_dim"],
        mf_sample=cfg["mf_sample"], tr_lr=cfg["tr_lr"], tr_l2=cfg["tr_l2"],
        tr_epochs=cfg["tr_epochs"], tr_batch_size=cfg["tr_batch_size"],
        tr_sample_type=cfg["tr_sample_type"],
        transfer=TransferConfig(
            latent_dim=cfg["latent_dim"],
            conv1_channels=cfg["conv1_channels"],
            conv2_channels=cfg["conv2_channels"],
            fc_hidden=cfg["fc_hidden"], kind=cfg["transfer_kind"]),
        neg_tries=cfg["neg_tries"], eval_batch_size=cfg["eval_batch_size"],
        topk=tuple(cfg["topk"]), dtype=cfg["dtype"],
        snapshot_dtype=cfg["snapshot_dtype"],
        fuse_period=cfg.get("fuse_period", "auto"))


def tables(cfg: dict, seed: int, device):
    """The pretrained ``(user, item)`` f32 tables, N(0,1), on the device."""
    g = generate.generator(seed, 10, device)
    d = cfg["latent_dim"]
    return (torch.randn((cfg["n_users"], d), generator=g, device=device),
            torch.randn((cfg["n_items"], d), generator=g, device=device))


def theta0(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return ref.init_theta(generate.generator(seed, 11, torch.device("cpu")),
                          cfg["latent_dim"], cfg["conv1_channels"],
                          cfg["conv2_channels"], cfg["fc_hidden"], device)


def run_generator(seed: int, device) -> torch.Generator:
    return generate.generator(seed, 12, device)


class Files:
    """The dataset's periods as the driver's feeder serves them."""

    def __init__(self, spec: dict):
        self.path = os.path.join(spec["root"], spec["name"])
        self.test_start = spec["online_test_start"]
        self.n = spec["num_periods"]

    def load(self, kind: str, p: int) -> np.ndarray:
        return np.load(os.path.join(self.path, kind, f"{p}.npy"))

    def rows(self, kind: str, p: int) -> int:
        return int(np.load(os.path.join(self.path, kind, f"{p}.npy"),
                           mmap_mode="r").shape[0])

    def period(self, d: int):
        """``(set_t, set_tt, now_test)`` of period ``d`` (mf_sample 'all',
        tr_sample_type 'alone'; tests from ``online_test_start``)."""
        now = self.load("test", d + 1) if d + 1 >= self.test_start else None
        return self.load("test", d), self.load("train", d + 1), now

    def bounds(self) -> Dict[str, int]:
        return {"set_t": max(self.rows("test", p) for p in range(self.n)),
                "set_tt": max(self.rows("train", p) for p in range(self.n))}


# ----------------------------------------------------------- recording
class Patch:
    """Instance attributes wrapping an object's methods; :meth:`undo`
    puts back what each wrapped, in the reverse order."""

    def __init__(self):
        self.done = []

    def wrap(self, obj, name: str, make):
        self.done.append((obj, name, obj.__dict__.get(name, Patch)))
        setattr(obj, name, make(getattr(obj, name)))

    def undo(self):
        for obj, name, prev in reversed(self.done):
            if prev is Patch:
                delattr(obj, name)
            else:
                setattr(obj, name, prev)
        self.done = []


def record_losses(engine, patch: Patch, out: List):
    """Every epoch's per-step losses in the order they ran, tagged
    ``"inner"`` or ``"outer"``: a fused period's last epoch of each phase
    and each eager epoch."""
    def period_step(orig):
        def f(*a, **k):
            res = orig(*a, **k)
            ils, ols = res[2]
            for p in range(ils.shape[0]):
                out.extend([("inner", ils[p]), ("outer", ols[p])])
            return res
        return f

    def epoch(kind):
        def make(orig):
            def f(*a, **k):
                st, losses = orig(*a, **k)
                out.append((kind, losses))
                return st, losses
            return f
        return make
    patch.wrap(engine, "period_step", period_step)
    patch.wrap(engine, "inner_epoch", epoch("inner"))
    patch.wrap(engine, "outer_epoch", epoch("outer"))


def phase_losses(entries, cfg, n_t: int, n_tt: int):
    """Each phase's last inner and last outer epoch, their real steps'
    losses (the vectors are padded), from :func:`record_losses`' entries
    of one period: a phase is a run of inner epochs, then of outer ones."""
    phases, cur = [], {}
    for kind, v in entries:
        if kind == "inner" and "outer" in cur:
            phases.append(cur)
            cur = {}
        cur[kind] = v
    phases.append(cur)
    nb = (-(-n_t // cfg["mf_batch_size"]), -(-n_tt // cfg["tr_batch_size"]))
    return [tuple(ph[kind].detach().cpu().numpy()[:n]
                  for kind, n in zip(("inner", "outer"), nb))
            for ph in phases]


def record_spans(driver, patch: Patch, host_s: Dict[str, float]):
    """The traced run's spans around the driver's calls into each layer:
    a ``record_function`` for the trace and the host seconds by name."""
    def span(name):
        def make(orig):
            def f(*a, **k):
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    res = orig(*a, **k)
                host_s[name] = host_s.get(name, 0.0) + (time.perf_counter()
                                                         - t0)
                return res
            return f
        return make
    eng = driver.engine
    patch.wrap(driver, "run_period", span("bench.period"))
    patch.wrap(driver.feeder, "next_train", span("bench.data"))
    for m in ("make_eval_set", "evaluate_deferred", "resolve_evals",
              "period_step", "inner_epoch", "outer_epoch", "refresh"):
        patch.wrap(eng, m, span(f"bench.{m}"))


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's 2-norm, a 0-d tensor on its device (read later)."""
    return {k: torch.linalg.vector_norm(v.detach().float())
            for k, v in leaves.items()}


def changes(now: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]):
    return {k: torch.linalg.vector_norm((v.detach() - start[k]).float())
            for k, v in now.items()}


def host(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in d.items()}


def program_leaves(state) -> Dict[str, torch.Tensor]:
    """The trained leaves by the reference's names: the tables, then Θ."""
    from sml_tpu_torch.models.transfer import theta_leaves
    return {"user_emb": state.mf.user_emb, "item_emb": state.mf.item_emb,
            **theta_leaves(state.theta)}


def program_moments(state) -> Dict[str, torch.Tensor]:
    mu = state.mf_opt.mu
    return {"user_emb": mu["user_emb"], "item_emb": mu["item_emb"],
            **state.tr_opt.mu}


def program_snapshot(state) -> dict:
    """The state a period starts from, copied to the host, in the
    reference's layout (``reference.sml.Sweep.resume``)."""
    from sml_tpu_torch.models.transfer import theta_leaves

    def cpu(leaves):
        return {k: v.detach().to("cpu", copy=True) for k, v in leaves.items()}
    mf = ("user_emb", "item_emb")
    return {"U": state.mf.user_emb.to("cpu", copy=True),
            "I": state.mf.item_emb.to("cpu", copy=True),
            "theta": cpu(theta_leaves(state.theta)),
            "mf_mu": cpu({k: state.mf_opt.mu[k] for k in mf}),
            "mf_nu": cpu({k: state.mf_opt.nu[k] for k in mf}),
            "tr_mu": cpu(state.tr_opt.mu), "tr_nu": cpu(state.tr_opt.nu),
            "mf_count": int(state.mf_opt.count),
            "tr_count": int(state.tr_opt.count),
            "gen": state.gen.get_state()}


def test_index(files: Files, d: int) -> int:
    """Period ``d``'s place among the tests (every period tests from
    ``online_test_start - 1`` on)."""
    return d - max(files.test_start - 1, 0)


def program_record(entries, cfg, files, d: int, origin: str, report,
                   moments, change) -> dict:
    """Period ``d`` of the program as :func:`checks.sweep_numbers` reads
    it (``report``: the driver's, its tests resolved)."""
    n_t, n_tt = files.rows("test", d), files.rows("train", d + 1)
    hits, n_test = None, 0
    if d + 1 >= files.test_start:
        j = test_index(files, d)
        n_test = report.test_counts[j]
        hits = {k: int(round(report.per_period[k][j] * n_test))
                for k in cfg["topk"]}
    return {"from": origin, "phases": phase_losses(entries, cfg, n_t, n_tt),
            "hits": hits, "n_test": n_test, "moments": host(moments),
            "change": host(change)}


def reference_period(sw: ref.Sweep, files: Files, d: int, origin: str,
                     mode: str) -> dict:
    """Period ``d`` of the reference sweep ``sw``, read as the program's
    (:func:`program_record`): every leaf's change when it runs from the
    seed, Θ's when from a state."""
    start = {**({"user_emb": sw.U.clone(), "item_emb": sw.I.clone()}
                if origin == "seed" else {}),
             **{k: v.clone() for k, v in sw.theta.items()}}
    set_t, set_tt, now = files.period(d)
    with precision(mode):
        rec = sw.period(set_t, set_tt, now)
    leaves = {"user_emb": sw.U, "item_emb": sw.I, **sw.theta}
    out = {"from": origin,
           "phases": [(a.cpu().numpy(), b.cpu().numpy())
                      for a, b in zip(rec["inner"], rec["outer"])],
           "hits": rec["hits"],
           "n_test": 0 if now is None else now.shape[0],
           "moments": host(norms(sw.first_moments())),
           "change": host(changes({k: leaves[k] for k in start}, start))}
    del start
    return out


def reference_from_seed(cfg, files, periods: int, seed: int, device,
                        mode: str = "f32", fault=None):
    """``(records, sweep)``: the reference sweep from the seed's inputs
    over its first ``periods`` periods."""
    with precision(mode):
        sw = ref.Sweep(cfg, tables(cfg, seed, device),
                       theta0(cfg, seed, device),
                       run_generator(seed, device), files.bounds(), fault)
    recs = {d: reference_period(sw, files, d, "seed", mode)
            for d in range(periods)}
    return recs, sw


def reference_from_state(cfg, files, d: int, snap: dict, device) -> dict:
    """Period ``d`` of the f32 reference from the state ``snap``."""
    sw = ref.Sweep.resume(cfg, snap, files.bounds(), device)
    out = reference_period(sw, files, d, "state", "f32")
    del sw
    return out


def refresh_number(cfg, theta: Dict[str, torch.Tensor], last_u, hat_u,
                   last_i, hat_i, got_u, got_i) -> float:
    """The ``refresh`` number: tables against the f32 reference refresh
    of the snapshots and Θ they were made from."""
    with precision("f32"):
        want = (ref.refresh_table(ref.side(theta, "user"), last_u, hat_u),
                ref.refresh_table(ref.side(theta, "item"), last_i, hat_i))
    return checks.refresh_gap((got_u, got_i), want)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def setup_program(ctx: dict, spec: dict, files: Files):
    """The driver and its adopted state, driven through the set-up
    periods; returns ``(driver, state, records, n_setup)``, ``records``
    the compared periods as :func:`program_record` reads them."""
    from sml_tpu_torch.config import DataSpec
    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.train.driver import SMLDriver

    cfg, tr, dev = ctx["config"], ctx["traffic"], ctx["device"]
    seed = ctx["seed"]
    driver = SMLDriver(smlconfig(cfg), DataSpec(**spec), device=dev)
    eng = driver.engine
    u, i = tables(cfg, seed, dev)
    z = torch.zeros
    state = eng.init_state(pretrained_mf=MFParams(
        u, i, z((cfg["n_users"], 1), device=dev),
        z((cfg["n_items"], 1), device=dev)))
    del u, i
    th = theta0(cfg, seed, dev)
    with torch.no_grad():
        for k, leaf in theta_leaves(state.theta).items():
            leaf.copy_(th[k])
    state = eng.adopt(state._replace(gen=run_generator(seed, dev)))

    compared = int(tr["compared_periods"])
    n_setup = max(int(tr["setup_periods"]), compared)
    patch, entries, read = Patch(), [], {}
    record_losses(eng, patch, entries)
    for d in range(n_setup):
        mark = len(entries)
        if d < compared:
            start = {k: v.detach().clone()
                     for k, v in program_leaves(state).items()}
        state, ok = driver.run_period(state, d)
        if not ok:
            raise RuntimeError(f"the dataset ended at period {d}")
        if d < compared:
            read[d] = (entries[mark:], host(norms(program_moments(state))),
                       host(changes(program_leaves(state), start)))
            del start
            free(dev)
        if d == compared - 1:
            patch.undo()
    patch.undo()
    driver.finalize()
    records = {d: program_record(e, cfg, files, d, "seed", driver.report,
                                 m, c)
               for d, (e, m, c) in read.items()}
    return driver, state, records, n_setup


# ----------------------------------------------------------- the run
def run(ctx: dict) -> dict:
    from sml_tpu_torch.models.transfer import theta_leaves

    cfg, tr, dev = ctx["config"], ctx["traffic"], ctx["device"]
    seed, seconds, traced = ctx["seed"], ctx["seconds"], ctx["trace"]
    tmp = tempfile.mkdtemp(prefix="bench_sweep_")
    try:
        spec = generate.sweep_dataset(tr, cfg["n_users"], cfg["n_items"],
                                      seed, tmp, dev)
        files = Files(spec)
        driver, state, prog, n_setup = setup_program(ctx, spec, files)
        eng = driver.engine
        compared = int(tr["compared_periods"])
        capture_s = float(eng.graph_stats.get("capture_s", 0.0))
        k1, k3 = _launches()
        # the state the window's first period starts from: on the host for
        # the reference, Θ on the card for that period's change
        snap = program_snapshot(state)
        theta_start = {k: v.detach().clone()
                       for k, v in theta_leaves(state.theta).items()}

        # ------------------------------------------------------ window
        host_s: Dict[str, float] = {}
        patch = Patch()
        if traced:
            record_spans(driver, patch, host_s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak_setup = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = harness.process_age_s()
        periods, examples, least, d, inner_steps = 0, 0, 0.0, n_setup, 0
        entries, first = [], Patch()
        record_losses(eng, first, entries)
        trace = harness.Trace(torch, dev) if traced else None
        with trace or contextlib.nullcontext():
            t0 = time.perf_counter()
            while True:
                state, ok = driver.run_period(state, d)
                if not ok:
                    raise RuntimeError(f"the dataset ended at period {d}; "
                                       "the traffic needs more periods")
                if d == n_setup:
                    first.undo()
                    w_moments = norms(program_moments(state))
                    w_change = changes(dict(theta_leaves(state.theta)),
                                       theta_start)
                n_t, n_tt = files.rows("test", d), files.rows("train", d + 1)
                cnt = costs.sweep_counts(
                    cfg, n_t, n_tt, ref.bucket_rows(n_t,
                                                    cfg["mf_batch_size"]),
                    ref.bucket_rows(n_tt, cfg["tr_batch_size"]))
                examples += cnt["examples"]
                inner_steps += cnt["inner_steps"]
                least += costs.sweep_period_least_s(
                    cfg, cnt, files.rows("test", d + 1) if d + 1 >=
                    files.test_start else 0, 1 + tr["neg_num"])
                periods += 1
                d += 1
                if (time.perf_counter() - t0 >= seconds
                        or (trace and periods >= tr["traced_periods"])):
                    break
            driver.finalize()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            window = time.perf_counter() - t0
        patch.undo()
        peak_window = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        k1, k3 = (a - b for a, b in zip(_launches(), (k1, k3)))
        t_dig = time.perf_counter()
        if trace:
            dig = harness.digest(trace, spans=(
                "bench.period", "bench.data", "bench.make_eval_set",
                "bench.evaluate_deferred", "bench.resolve_evals",
                "bench.period_step", "bench.inner_epoch",
                "bench.outer_epoch", "bench.refresh"))
        t_dig = time.perf_counter() - t_dig

        # ------------------------------------------------------ checks
        prog[n_setup] = program_record(entries, cfg, files, n_setup, "state",
                                       driver.report, w_moments, w_change)
        final = {k: v.detach().clone() for k, v in
                 theta_leaves(state.theta).items()}
        snaps = (state.last_user.clone(), state.hat_user.clone(),
                 state.last_item.clone(), state.hat_item.clone())
        got = (state.mf.user_emb.clone(), state.mf.item_emb.clone())
        eng.release_programs()
        driver.close()
        del driver, eng, state, entries, theta_start
        free(dev)
        numbers = {"refresh": refresh_number(cfg, final, *snaps, *got)}
        del final, snaps, got
        free(dev)
        t_ref = time.perf_counter()
        want, sw = reference_from_seed(cfg, files, compared, seed, dev)
        del sw
        free(dev)
        want[n_setup] = reference_from_state(cfg, files, n_setup, snap, dev)
        del snap
        worst_at: Dict[str, list] = {}
        numbers.update(checks.sweep_numbers(prog, want, worst_at))
        ref_s = time.perf_counter() - t_ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = {
        "numbers": numbers, "attempted": periods, "failed": 0,
        "setup_s": setup_s, "window_s": window,
        "memory_peak_bytes": max(peak_setup, peak_window)
        if dev.type == "cuda" else 0,
        "e2e": {"sweep_examples_per_s": (examples / window, "examples/s")},
        "info": {"periods": periods, "examples": examples,
                 "reference_s": ref_s, "k1_launches": k1,
                 "k3_launches": k3, "capture_s": capture_s,
                 "trace_read_s": t_dig, "worst_at": worst_at},
    }
    if traced:
        out["trace"] = dig
        out["layer_ctx"] = {
            "trace": dig, "periods": periods, "host_s": host_s,
            "capture_s": capture_s, "least_s": least,
            "peak_window_bytes": peak_window, "config": cfg,
            "refreshes": periods * costs.sweep_counts(
                cfg, 1, 1, 1, 1)["refreshes"],
            "inner_steps": inner_steps}
    return out


def _launches():
    """K1's and K3's launch counters (``<wrapper>.launches``)."""
    from sml_tpu_torch.ops import adam_kernel, transfer_kernel
    return (getattr(transfer_kernel.transfer_rows_cuda, "launches", 0),
            getattr(adam_kernel.decay_adam_cuda, "launches", 0))


# ----------------------------------------------------------- controls
def control_numbers(ctx: dict, variants) -> Dict[str, Dict[str, float]]:
    """The check's numbers with the reference put in the program's place,
    for each ``(precision, fault)`` of ``variants`` (the control
    ``("tf32", None)``, the planted faults, and ``("f32", None)``, the
    reference against itself), at the cell's sizes from its seed: the
    stand-in runs the set-up periods and the window's first period, and
    is held to the f32 reference as the program is (the compared periods
    from the seed, the window's first from the stand-in's own state)."""
    cfg, tr, dev, seed = (ctx["config"], ctx["traffic"], ctx["device"],
                          ctx["seed"])
    tmp = tempfile.mkdtemp(prefix="bench_sweep_")
    try:
        spec = generate.sweep_dataset(tr, cfg["n_users"], cfg["n_items"],
                                      seed, tmp, dev)
        files = Files(spec)
        compared = int(tr["compared_periods"])
        n_setup = max(int(tr["setup_periods"]), compared)
        sound, sw = reference_from_seed(cfg, files, compared, seed, dev)
        del sw
        free(dev)
        out = {}
        for prec, fault in variants:
            got, sw = reference_from_seed(cfg, files, compared, seed, dev,
                                          prec, fault)
            for d in range(compared, n_setup):
                set_t, set_tt, now = files.period(d)
                with precision(prec):
                    sw.period(set_t, set_tt, now)
            snap = sw.snapshot()
            got[n_setup] = reference_period(sw, files, n_setup, "state",
                                            prec)
            with precision(prec):
                sw.refresh()
                if fault == "altered":
                    sw.U[0, 0] += 1.0
            want = dict(sound)
            want[n_setup] = reference_from_state(cfg, files, n_setup, snap,
                                                 dev)
            nums = checks.sweep_numbers(got, want)
            nums["refresh"] = refresh_number(
                cfg, sw.theta, sw.last_u, sw.hat_u, sw.last_i, sw.hat_i,
                sw.U, sw.I)
            out[f"{prec}/{fault or 'sound'}"] = nums
            del sw, got, snap, want
            free(dev)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
