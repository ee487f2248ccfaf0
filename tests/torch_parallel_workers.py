"""Rank functions for the port's multi-process tests.

``sml_tpu_torch.parallel.dryrun.run_world`` spawns each rank, which
imports the module holding its function: this module imports neither JAX
nor ``sml_tpu``, so a rank starts without them. Every function takes the
rank's device first and returns numpy arrays (rank 0's answer is the one
the tests read; the others return theirs too).
"""

import numpy as np
import torch


def _mesh(shape):
    """A ``(data, model)`` mesh over the world, or ``"global"``: the hosts'
    layout (``make_global_mesh``)."""
    from sml_tpu_torch.parallel.dryrun import spec_mesh
    return spec_mesh(shape)


def _block(n, mesh):
    per = n // mesh.shape["model"]
    lo = mesh.index("model") * per
    return slice(lo, lo + per)


def gather_and_grad(device, table, idx, w, n_model):
    """``collective_gather`` of ``idx`` from the rank's block of ``table``
    and the gradient of ``sum(rows * w)`` in that block."""
    from sml_tpu_torch.parallel.collective import collective_gather
    mesh = _mesh((1, n_model))
    shard = torch.from_numpy(table[_block(table.shape[0], mesh)].copy())
    shard.requires_grad_()
    rows = collective_gather(shard, torch.from_numpy(idx),
                             mesh.group("model"))
    (g,) = torch.autograd.grad(torch.sum(rows * torch.from_numpy(w)),
                               [shard])
    return rows.detach().numpy(), g.numpy()


def mf_step(device, ut, it, u, i, j, n_model):
    """One ``make_sharded_mf_train_step`` on the rank's blocks; returns
    the updated blocks and the loss."""
    from sml_tpu_torch.parallel.collective import make_sharded_mf_train_step
    mesh = _mesh((1, n_model))
    us = torch.from_numpy(ut[_block(ut.shape[0], mesh)].copy())
    its = torch.from_numpy(it[_block(it.shape[0], mesh)].copy())
    step = make_sharded_mf_train_step(mesh, lr=0.01, l2=1e-5)
    nu, ni, loss = step(us, its, *(torch.from_numpy(x) for x in (u, i, j)))
    return nu.numpy(), ni.numpy(), float(loss)


def transport(device):
    """The three collectives over each axis of a (2, 2) mesh,
    ``replicate``, ``global_batch`` and ``process_slice``."""
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.sharding import replicate
    mesh = _mesh((2, 2))
    d, m = mesh.index("data"), mesh.index("model")
    rank = 2 * d + m
    out = {"coords": (d, m),
           "local_rank": mesh.device_mesh.get_local_rank("model"),
           "transport": collective.transport(mesh.group("model"))}
    for axis in ("data", "model"):
        g = mesh.group(axis)
        out[f"sum_{axis}"] = collective.all_reduce(
            torch.full((3,), float(rank)), g).numpy()
        out[f"gather_{axis}"] = collective.all_gather(
            torch.full((2, 1), float(rank)), g).numpy()
        out[f"bcast_{axis}"] = collective.broadcast(
            torch.full((2,), float(rank)), g, src=1).numpy()
    out["replicated"] = replicate({"a": torch.full((2,), float(rank))},
                                  mesh)["a"].numpy()
    # this rank's rows of a padded set, by data index and by process
    from sml_tpu_torch.ops.batching import pad_rows
    from sml_tpu_torch.parallel.multihost import global_batch, process_slice
    padded = pad_rows(np.arange(10).reshape(5, 2), 4, device="cpu")
    block = global_batch(padded, mesh)
    out["batch"] = (block.rows.numpy(), block.mask.numpy(), block.n_real)
    out["process_slice"] = process_slice(8)
    return out


def sharded_refresh(device, theta_tree, tcfg, tables, n_model):
    """``apply_tables_sharded`` on the rank's row blocks of the four
    snapshots; returns the refreshed tables made whole."""
    from sml_tpu_torch.models.transfer import (apply_tables_sharded,
                                               theta_from_numpy)
    from sml_tpu_torch.parallel import collective
    mesh = _mesh((1, n_model))
    theta = theta_from_numpy(theta_tree, device="cpu")
    blocks = [torch.from_numpy(t[_block(t.shape[0], mesh)].copy())
              for t in tables]
    new = apply_tables_sharded(theta, tcfg, *blocks)
    return [collective.all_gather(t, mesh.group("model")).numpy()
            for t in new]


def born_sharded(device, cfg, n_users, n_items, mesh_shape, pretrained):
    """``init_state_sharded`` against ``init_state`` then ``shard_state``,
    leaf for leaf: ``{path: (equal, local rows)}`` and the plan."""
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.parallel.sharding import shard_state, table_leaves
    from sml_tpu_torch.train.engine import SMLEngine
    mesh = _mesh(mesh_shape)
    eng = SMLEngine(cfg, n_users, n_items, device=device)
    want = shard_state(eng.init_state(pretrained_mf=pretrained), mesh,
                       n_users, n_items)
    got = eng.init_state_sharded(mesh, pretrained_mf=pretrained)
    a, b = table_leaves(got), table_leaves(want)
    out = {p: (bool(torch.equal(a[p], b[p])), a[p].shape[0]) for p in a}
    ta, tb = theta_leaves(got.theta), theta_leaves(want.theta)
    out["theta"] = (all(torch.equal(ta[k], tb[k]) for k in ta), 0)
    out["gen"] = (bool(torch.equal(got.gen.get_state(),
                                   want.gen.get_state())), 0)
    return out, {p: (None if blk is None else tuple(blk))
                 for p, blk in eng.plan.items()}


def _load_state(path, device):
    """The port's state from an ``.npz`` written by the tests (a JAX
    engine's state carried across)."""
    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.models.transfer import theta_from_numpy
    from sml_tpu_torch.train.engine import SMLState
    from sml_tpu_torch.train.optim import AdamState
    z = np.load(path)

    def t(k):
        return torch.from_numpy(z[k].copy())

    mf = MFParams(*(t(f"mf/{f}") for f in MFParams._fields))
    theta = theta_from_numpy(
        {s: {k.split("/")[2]: z[k] for k in z.files
             if k.startswith(f"theta/{s}/")} for s in ("user", "item")},
        device=device)

    def opt(name, names):
        return AdamState(int(z[f"{name}/count"]),
                         {n: t(f"{name}/mu/{n}") for n in names},
                         {n: t(f"{name}/nu/{n}") for n in names})
    from sml_tpu_torch.models.transfer import theta_leaves
    return SMLState(mf=mf, theta=theta,
                    **{f: t(f) for f in ("last_user", "last_item",
                                         "hat_user", "hat_item")},
                    mf_opt=opt("mf_opt", MFParams._fields),
                    tr_opt=opt("tr_opt", theta_leaves(theta)),
                    gen=torch.Generator().manual_seed(0))


def replay_phases(device, cfg, n_users, n_items, state_path, inner_rows,
                  outer_rows, test_rows, mesh_shape, phases=2,
                  with_one=False):
    """``phases`` replay-mode SML phases from the carried state on a mesh
    (``mesh_shape=None``: one rank alone), then a test, plain and
    attributed, and the weight diagnostics: the whole tables, Θ, the
    losses, the test's records and the diagnostics. ``with_one``: rank 0
    also runs them alone (no mesh) and returns that run under ``"one"``."""
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.parallel.sharding import shard_state
    from sml_tpu_torch.train.engine import SMLEngine
    eng = SMLEngine(cfg, n_users, n_items, device=device)
    state = _load_state(state_path, device)
    mesh = None
    if mesh_shape is not None:
        mesh = _mesh(mesh_shape)
        eng.set_mesh(mesh)
        state = shard_state(state, mesh, n_users, n_items)
    losses = []
    for _ in range(phases):
        state = eng.snapshot_last(state)
        state, il = eng.inner_epoch(state, *eng.prep_inner(inner_rows))
        state = eng.refresh(eng.snapshot_hat(state))
        state, ol = eng.outer_epoch(state, *eng.prep_outer(outer_rows))
        state = eng.refresh(state)
        losses.append((il.numpy(), ol.numpy()))
    metrics = eng.evaluate(state.mf, test_rows)
    # every fifth user and item new: the attributed evaluation's masks
    masks = eng.new_entity_masks(np.arange(0, n_users, 5),
                                 np.arange(0, n_items, 5))
    attributed = eng.evaluate_attributed(state.mf, test_rows, *masks)
    diagnostics = eng.diagnostics(state)
    whole = eng.whole_state(state)
    out = {"attributed": attributed, "diagnostics": diagnostics,
           "user_emb": whole.mf.user_emb.numpy(),
           "item_emb": whole.mf.item_emb.numpy(),
           "theta": {k: p.detach().numpy()
                     for k, p in theta_leaves(whole.theta).items()},
           "losses": losses, "metrics": metrics,
           "mf_count": state.mf_opt.count}
    if with_one and mesh.index("data") + mesh.index("model") == 0:
        out["one"] = replay_phases(device, cfg, n_users, n_items, state_path,
                                   inner_rows, outer_rows, test_rows, None,
                                   phases)
    return out


def sampled_run(device, cfg, n_users, n_items, set_t, set_tt, mesh_shape,
                with_one=False):
    """Two sampled ('alone') phases from a fresh state; the whole tables
    and Θ (``mesh_shape=None``: one rank alone; ``with_one``: rank 0 also
    runs them alone and returns that run under ``"one"``)."""
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.train.engine import SMLEngine
    eng = SMLEngine(cfg, n_users, n_items, device=device)
    state = (eng.init_state() if mesh_shape is None
             else eng.init_state_sharded(_mesh(mesh_shape)))
    for _ in range(2):
        state = eng.snapshot_last(state)
        state, _ = eng.inner_epoch(state, *eng.prep_inner(set_t))
        state = eng.refresh(eng.snapshot_hat(state))
        state, _ = eng.outer_epoch(state, *eng.prep_outer(set_tt))
        state = eng.refresh(state)
    whole = eng.whole_state(state)
    out = {"user_emb": whole.mf.user_emb.numpy(),
           "item_emb": whole.mf.item_emb.numpy(),
           "theta": {k: p.detach().numpy()
                     for k, p in theta_leaves(whole.theta).items()}}
    if with_one and eng.mesh.index("data") + eng.mesh.index("model") == 0:
        out["one"] = sampled_run(device, cfg, n_users, n_items, set_t,
                                 set_tt, None)
    return out


def sharded_topk(device, user_rows, items, k, methods, n_model):
    """``make_sharded_full_topk`` on the rank's block of ``items`` per
    method, and ``recommend(mesh=...)`` of every user of ``user_rows``."""
    from sml_tpu_torch.eval.full_ranking import (make_sharded_full_topk,
                                                 recommend)
    from sml_tpu_torch.models.mf import MFParams
    mesh = _mesh((1, n_model))
    shard = torch.from_numpy(items[_block(items.shape[0], mesh)].copy())
    rows = torch.from_numpy(user_rows)
    out = {m: tuple(t.numpy() for t in
                    make_sharded_full_topk(mesh, k, None, m)(rows, shard))
           for m in methods}
    mf = MFParams(rows, shard, torch.zeros(rows.shape[0], 1),
                  torch.zeros(shard.shape[0], 1))
    out["recommend"] = tuple(t.numpy() for t in recommend(
        mf, torch.arange(rows.shape[0]), k, mesh=mesh))
    return out


class _Records:
    """A driver logger keeping its records in memory, without their
    wall-clock fields."""

    def __init__(self):
        self.records = []

    def log(self, **record):
        for k in ("ts", "seconds", "total_seconds"):
            record.pop(k, None)
        self.records.append(record)

    def close(self):
        pass


def _state_arrays(eng, state):
    """Every leaf of the whole state as a numpy array by path (snapshots
    upcast, exactly), the step counts and the generator's state."""
    from sml_tpu_torch.models.transfer import theta_leaves
    w = eng.whole_state(state)
    out = {f"mf/{f}": t for f, t in w.mf._asdict().items()}
    for f in ("last_user", "last_item", "hat_user", "hat_item"):
        out[f] = getattr(w, f)
    out.update({f"theta/{k}": p for k, p in theta_leaves(w.theta).items()})
    for name in ("mf_opt", "tr_opt"):
        opt = getattr(w, name)
        for part in ("mu", "nu"):
            out.update({f"{name}/{part}/{k}": v
                        for k, v in getattr(opt, part).items()})
    arr = {k: v.detach().float().cpu().numpy().copy()
           for k, v in out.items()}
    arr["counts"] = np.array([w.mf_opt.count, w.tr_opt.count])
    arr["gen"] = w.gen.get_state().numpy()
    return arr


def _differences(a, b):
    """The largest absolute difference of each leaf of two
    :func:`_state_arrays` results (0.0 where they are bit-equal)."""
    return {k: float(np.max(np.abs(a[k].astype(np.float64)
                                   - b[k].astype(np.float64)), initial=0.0))
            for k in a}


def fused_drivers(device, cases, dspec, n_users, n_items, mesh_shape):
    """For each ``(name, cfg_unfused, cfg_fused)`` of ``cases``: the
    driver's sweep on the mesh unfused, then fused, each from a state born
    sharded: the differences of the final whole states, whether the
    records are equal, the retries, and the fused programs' calls."""
    from sml_tpu_torch.train.driver import SMLDriver
    mesh = _mesh(mesh_shape)
    out = {}
    for name, cfg_u, cfg_f in cases:
        runs = []
        for cfg in (cfg_u, cfg_f):
            logger = _Records()
            drv = SMLDriver(cfg, dspec, logger=logger, device=device)
            eng = drv.engine
            calls = {"period_step": 0, "phase_step": 0}
            for fn in calls:
                def counted(*a, _fn=getattr(eng, fn), _name=fn, **k):
                    calls[_name] += 1
                    return _fn(*a, **k)
                setattr(eng, fn, counted)
            report = drv.run(eng.init_state_sharded(mesh))
            drv.close()
            runs.append((_state_arrays(eng, drv.final_state),
                         logger.records, report.saddle_retries_used, calls,
                         report.per_period))
        (su, ru, nu, cu, pu), (sf, rf, nf, cf, pf) = runs
        out[name] = {"diff": _differences(su, sf),
                     "records_equal": ru == rf, "records": len(rf),
                     "kinds": sorted({r["kind"] for r in rf}),
                     "retries": (nu, nf), "unfused_calls": cu,
                     "fused_calls": cf, "metrics_equal": pu == pf}
    return out


def period_on_mesh(device, cfg, n_users, n_items, state_path, inner, outer,
                   val_rows, mesh_shape, phases):
    """``period_step`` from the carried state on a mesh for each count of
    ``phases`` in turn (in-program evals of ``val_rows``, diagnostics):
    the whole state, the loss stacks, the eval records and the norms."""
    from sml_tpu_torch.parallel.sharding import shard_state
    from sml_tpu_torch.train.engine import SMLEngine
    eng = SMLEngine(cfg, n_users, n_items, device=device)
    mesh = _mesh(mesh_shape)
    eng.set_mesh(mesh)
    state = shard_state(_load_state(state_path, device), mesh, n_users,
                        n_items)
    val = eng.make_eval_set(val_rows)
    out = []
    for n_phases in phases:
        state, evals, (il, ol), diags = eng.period_step(
            state, eng.prep_inner(inner), eng.prep_outer(outer), n_phases,
            val, want_diag=True)
        keep = n_phases if n_phases < cfg.multi_num else None
        out.append({"state": _state_arrays(eng, state), "il": il.numpy(),
                    "ol": ol.numpy(),
                    "records": eng.resolve_stacked_evals(
                        [(evals, val_rows.shape[0], keep)])[0],
                    "diags": [d.numpy() for d in diags]})
    return out


def unequal_slots(device, cfg, n_users, n_items, rows):
    """A fused phase whose ranks hold inputs of one padded shape but
    different row counts (rank ``r`` the first ``rows[r]`` rows): the
    error each rank raises, or None."""
    from sml_tpu_torch.train.engine import SMLEngine
    import torch.distributed as dist
    eng = SMLEngine(cfg, n_users, n_items, device=device)
    state = eng.init_state_sharded(_mesh((dist.get_world_size(), 1)))
    eng.shape_targets = {"set_t": max(rows), "set_tt": max(rows)}
    mine = rows[dist.get_rank()]
    rng = np.random.default_rng(0)
    pairs = np.stack([rng.integers(0, n_users, max(rows)),
                      rng.integers(0, n_items, max(rows))], 1)[:mine]
    try:
        eng.phase_step(eng.snapshot_last(state), eng.prep_inner(pairs),
                       eng.prep_outer(pairs))
    except ValueError as exc:
        return str(exc)
    return None



def split_lookup(device, table, idx, w, n_model):
    """The lookup taken apart as a split step takes it (the owned rows
    into a buffer, its all-reduce, the rows from the summed buffer) and
    whole (``collective_gather``), on the rank's block of ``table``: each
    way's rows and the gradient of ``sum(rows * w)`` in the block."""
    from sml_tpu_torch.parallel.collective import (all_reduce,
                                                   collective_gather)
    from sml_tpu_torch.parallel.sharding import TableLayout
    mesh = _mesh((1, n_model))
    layout = TableLayout(mesh, table.shape[0], table.shape[0] + n_model)
    shard = torch.from_numpy(table[_block(table.shape[0], mesh)].copy())
    shard.requires_grad_()
    ids, weight = torch.from_numpy(idx), torch.from_numpy(w)
    out = []
    for split in (False, True):
        if split:
            lookup = [(shard, ids, "user")]
            buf = torch.zeros((ids.shape[0], table.shape[1]))
            owned = layout.owned_into(buf, lookup)
            (rows,) = layout.rows_from(lookup, all_reduce(buf, mesh.group(
                "model")), owned)
        else:
            rows = collective_gather(shard, ids, mesh.group("model"))
        (g,) = torch.autograd.grad(torch.sum(rows * weight), [shard])
        out.append((rows.detach().numpy(), g.numpy()))
    return out


def split_slots(device, cfgs, n_users, n_items, mesh_shape, n_rows):
    """For each of ``cfgs``: three SML phases on the mesh from one state
    born sharded, on inputs of ``n_rows`` (inner, outer) real rows padded
    to twice as many (so every epoch skips step slots), unfused
    (``dryrun._unfused_phases``) and fused (``phase_step``, then a
    ``period_step`` of two phases). The fused phase runs with a recorder
    in place of ``graphs.step_if`` and counters on ``collective``'s
    ``all_reduce`` and ``all_gather``. Returns per config: the largest
    differences of the whole states, the step slots taken and held (inner,
    outer), the IF-node openings and collectives the recorded phase made,
    and how many collectives ran inside an open body."""
    import contextlib

    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.dryrun import _unfused_phases
    from sml_tpu_torch.train import graphs
    from sml_tpu_torch.train.engine import SMLEngine
    mesh = _mesh(mesh_shape)
    rng = np.random.default_rng(0)
    set_t, set_tt = (np.stack([rng.integers(0, n_users, n),
                               rng.integers(0, n_items, n)], 1)
                     for n in n_rows)
    events = []

    @contextlib.contextmanager
    def recorder(slots, b, segment=0):
        events.append("open")
        try:
            yield bool(slots.host[b])
        finally:
            events.append("close")

    def counted(name, fn):
        def call(t, group):
            events.append(name)
            return fn(t, group)
        return call
    out = []
    for cfg in cfgs:
        runs = []
        for fused in (False, True):
            eng = SMLEngine(cfg, n_users, n_items, device=device)
            eng.shape_targets = {"set_t": 2 * n_rows[0],
                                 "set_tt": 2 * n_rows[1]}
            state = eng.snapshot_last(eng.init_state_sharded(mesh))
            prep_t, prep_tt = eng.prep_inner(set_t), eng.prep_outer(set_tt)
            if not fused:
                state, _ = _unfused_phases(eng, state, prep_t, prep_tt, 3,
                                           None)
                runs.append(_state_arrays(eng, state))
                continue
            saved = (graphs.step_if, collective.all_reduce,
                     collective.all_gather)
            graphs.step_if = recorder
            collective.all_reduce = counted("all_reduce", saved[1])
            collective.all_gather = counted("all_gather", saved[2])
            try:
                state, _, _ = eng.phase_step(state, prep_t, prep_tt)
            finally:
                (graphs.step_if, collective.all_reduce,
                 collective.all_gather) = saved
            prog = next(iter(eng._programs.values()))
            state, _, _, _ = eng.period_step(state, prep_t, prep_tt, 2)
            runs.append(_state_arrays(eng, state))
        depth, inside = 0, 0
        for e in events:
            depth += {"open": 1, "close": -1}.get(e, 0)
            inside += e.startswith("all_") and depth > 0
        out.append({"diff": _differences(*runs),
                    "taken": (prog.t.taken, prog.tt.taken),
                    "slots": (prog.t.slots.host.shape[0],
                              prog.tt.slots.host.shape[0]),
                    "opens": events.count("open"),
                    "collectives": sum(e.startswith("all_")
                                       for e in events),
                    "inside": inside})
        events.clear()
    return out


def host_layout(device):
    """The world's hosts as this rank sees them: the global mesh's shape,
    each axis's ranks and transport, this rank's local rank, host and
    card, the world's backend, and a sum over each axis."""
    import torch.distributed as dist

    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import make_global_mesh
    world = collective.WORLD
    mesh = make_global_mesh()
    rank = dist.get_rank()
    out = {"shape": (mesh.shape["data"], mesh.shape["model"]),
           "coords": (mesh.index("data"), mesh.index("model")),
           "local_rank": world["local_rank"],
           "local_world": world["local_world"], "hosts": world["hosts"],
           "cards": world["cards"], "backend": world["backend"],
           "device": str(world["device"])}
    for axis in ("data", "model"):
        g = mesh.group(axis)
        out[f"ranks_{axis}"] = dist.get_process_group_ranks(g)
        out[f"transport_{axis}"] = collective.transport(g)
        out[f"sum_{axis}"] = float(collective.all_reduce(
            torch.full((1,), float(rank), device=device), g))
    return out


def bad_layouts(device):
    """The errors ``make_global_mesh`` raises on this rank when the world's
    hosts are made uneven or interleaved (restored after)."""
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import make_global_mesh
    world = collective.WORLD
    hosts, n = world["hosts"], len(world["hosts"])
    made_up = {"uneven": [hosts[0]] * (n - 1) + [hosts[-1]],
               "interleaved": [hosts[r % 2 * (n - 1)] for r in range(n)]}
    errors = {}
    try:
        for name, fake in made_up.items():
            world["hosts"] = fake
            try:
                make_global_mesh()
                errors[name] = None
            except ValueError as exc:
                errors[name] = str(exc)
    finally:
        world["hosts"] = hosts
    return errors


def two_hosts(device, replay_args, sampled_args):
    """One world of two simulated hosts: :func:`host_layout` and
    :func:`bad_layouts`, then :func:`replay_phases` and
    :func:`sampled_run` (rank 0 also alone) on the global mesh."""
    return {"layout": host_layout(device), "errors": bad_layouts(device),
            "replay": replay_phases(device, *replay_args, "global"),
            "sampled": sampled_run(device, *sampled_args, "global", True)}


def data_axis_capture(device):
    """An all-reduce and an all-gather over the global mesh's 'data' axis
    run eagerly, then captured in one CUDA graph (``graphs.CapturedCall``)
    and replayed: both results, each bit-equal to the eager run's and to
    the exact values (integer-valued f32), with the world's layout
    (:func:`host_layout`). The graph is freed before the world ends."""
    import gc

    import torch.distributed as dist

    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import make_global_mesh
    from sml_tpu_torch.train import graphs
    out = host_layout(device)
    mesh = make_global_mesh()
    group, dev = mesh.group("data"), torch.device(device)
    rank, n = dist.get_rank(), 4096
    ranks = dist.get_process_group_ranks(group)
    x = torch.arange(n, dtype=torch.float32, device=dev) * (rank + 1)
    summed = torch.empty_like(x)
    gathered = torch.empty(len(ranks) * n, device=dev)

    def body():
        summed.copy_(x)
        collective.all_reduce(summed, group)
        gathered.copy_(collective.all_gather(x, group))
    side = torch.cuda.Stream(dev)
    graphs.run_on(side, body)
    torch.cuda.synchronize(dev)
    eager = (summed.clone(), gathered.clone())
    summed.fill_(-1.0)
    gathered.fill_(-1.0)
    captured = graphs.CapturedCall(body, side)
    captured.replay()
    torch.cuda.synchronize(dev)
    base = torch.arange(n, dtype=torch.float32)
    want_sum = base * sum(r + 1 for r in ranks)
    want_cat = torch.cat([base * (r + 1) for r in ranks])
    out.update(
        eager_exact=bool(torch.equal(eager[0].cpu(), want_sum)
                         and torch.equal(eager[1].cpu(), want_cat)),
        replay_equal=bool(torch.equal(summed, eager[0])
                          and torch.equal(gathered, eager[1])),
        if_nodes=captured.if_nodes)
    del captured
    gc.collect()
    torch.cuda.synchronize(dev)
    return out
