"""Multi-process execution (counterpart of ``sml_tpu/parallel/multihost.py``).

One process per rank; every process runs the same program on the same
period files and holds the whole padded epoch, so every rank makes the
same random draws and keeps its own block of each batch
(``train/steps.py``). Layout, as in the JAX package: the **model axis runs
inside a host** (the row-sharded lookups and the refresh exchange
activation rows between ranks of one host) and the **data axis runs across
hosts** (gradients are reduced over it). :func:`make_global_mesh` lays the
ranks out so, and raises on every rank where the hosts hold different
numbers of ranks or a host's ranks are not contiguous.

:func:`init_distributed` starts the world and places each rank: rank ``r``
runs on ``cuda:{local_rank % device_count}`` of the cards its process
sees, its local rank found from an exchange of host names, or on the CPU
when the caller asks for it. The same exchange carries the identity (UUID)
of the card each rank takes, and the transport follows from it
(``collective.backend_for``): NCCL when no two ranks of the world hold the
same card, gloo when ranks share a card (two ranks of one host on one GPU,
or two hosts that see the same GPU) or run on the CPU. No count of cards
decides it, so a launcher that shows each process only its own card gets
NCCL. Every collective carries the world's finite timeout and raises when
it runs out.

A host is what ``socket.gethostname()`` names, unless the caller names it
(``host=``): ``parallel.dryrun.run_world(..., hosts=H)`` runs H simulated
hosts on one machine, each seeing its own share of the cards, the port's
counterpart of the JAX worker's per-process virtual devices
(``scripts/multihost_worker.py --local-devices``).

With one process every helper here is a pass-through, as in JAX.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.parallel import collective
from sml_tpu_torch.parallel.collective import backend_for
from sml_tpu_torch.parallel.sharding import (Mesh, RowBlock,
                                             replace_table_leaves, replicate,
                                             shard_batch, shard_state,
                                             state_shardings, table_leaves)

DEFAULT_TIMEOUT_S = 300


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
                     host: Optional[str] = None) -> torch.device:
    """Join a world of ``num_processes`` ranks as rank ``process_id`` and
    return this rank's device.

    ``coordinator`` is ``host:port`` (a TCP store that rank 0 serves) or a
    ``file://`` path shared by the ranks. Every collective of the world
    raises after ``timeout_s`` seconds. ``device="cuda"`` places the rank on
    ``cuda:{local_rank % device_count}`` (and raises without a card);
    ``device="cpu"`` keeps it on the CPU, with its share of the host's
    cores (``torch.set_num_threads``). ``host`` names this rank's host
    (None: ``socket.gethostname()``; the simulated hosts of
    ``parallel.dryrun.run_world`` name theirs). The world's own group runs
    on gloo (it only exchanges the hosts and cards); the meshes' groups
    follow ``collective.backend_for``."""
    dev = resolve_device(device)
    init_method = (coordinator if coordinator.startswith("file://")
                   else f"tcp://{coordinator}")
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    # every rank's host and the cards its process sees, so each rank can
    # tell which card every rank takes
    seen = ([str(torch.cuda.get_device_properties(i).uuid)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [])
    world = [None] * num_processes
    dist.all_gather_object(world, (host or socket.gethostname(), seen))
    hosts = [h for h, _ in world]
    local_ranks, cards = place_ranks(world)
    local_rank = local_ranks[process_id]
    local_world = hosts.count(hosts[process_id])
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        # CPU ranks of one host split its cores: oversubscribed, a rank's
        # idle threads spin while its peers compute (a 2-rank sweep on 8
        # cores ran ~40x slower with 8 threads each)
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // local_world))
    collective.WORLD.update(local_rank=local_rank, local_world=local_world,
                            backend=backend_for(dev.type, cards),
                            hosts=hosts, cards=cards, device=dev)
    return dev


def place_ranks(world: Sequence) -> tuple:
    """``(local_ranks, cards)`` by rank, from each rank's ``(host, cards
    its process sees)`` (by rank, as ``init_distributed`` gathers them):
    a rank's local rank counts the ranks before it on its host, and it
    takes the card ``local_rank % len(seen)`` of those it sees (None on
    the CPU, where it sees none)."""
    hosts = [h for h, _ in world]
    local_ranks = [hosts[:r].count(h) for r, h in enumerate(hosts)]
    cards = [seen[lr % len(seen)] if seen else None
             for (_, seen), lr in zip(world, local_ranks)]
    return local_ranks, cards


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_layout(hosts: Sequence, n_model: Optional[int] = None) -> tuple:
    """``(n_data, n_model)`` of the global mesh over ranks on ``hosts`` (by
    rank): ``model`` holds the ranks of one host (or ``n_model`` of them)
    and ``data`` runs across hosts. Raises where the hosts hold different
    numbers of ranks (the ranks would build different meshes and hang),
    where a host's ranks are not contiguous, or where ``n_model`` does not
    divide a host's ranks; every rank holds the same ``hosts``, so every
    rank raises alike."""
    counts = {}
    for h in hosts:
        counts[h] = counts.get(h, 0) + 1
    if len(set(counts.values())) > 1:
        raise ValueError(f"every host must hold as many ranks as the "
                         f"others: ranks by host {counts}")
    local = counts[hosts[0]]
    if any(hosts[r] != hosts[r - r % local] for r in range(len(hosts))):
        raise ValueError(f"ranks of one host must be contiguous: {hosts}")
    if n_model is None:
        n_model = local
    if local % n_model:
        raise ValueError(f"{local} ranks per host do not divide into model "
                         f"groups of {n_model}")
    return len(hosts) // n_model, n_model


def make_global_mesh(n_model: Optional[int] = None) -> Mesh:
    """Mesh over every rank: ``model`` holds the ranks of one host and
    ``data`` runs across hosts (:func:`host_layout`). With ``n_model``
    given, a host's ranks are split further (``local // n_model`` data
    ways per host)."""
    hosts = collective.WORLD.get("hosts") or [None] * process_count()
    return Mesh(*host_layout(hosts, n_model))


def process_slice(n: int) -> slice:
    """This process's contiguous block of ``n`` rows."""
    p, count = process_index(), process_count()
    if n % count:
        raise ValueError(f"rows {n} must divide process count {count}")
    per = n // count
    return slice(p * per, (p + 1) * per)


def global_batch(padded, mesh: Mesh):
    """This rank's block over 'data' of a padded set that every process
    holds whole."""
    return shard_batch(padded, mesh)


def global_state(state, mesh: Mesh, n_users: int, n_items: int):
    """Every process holds the whole state (same seed, same values) and
    keeps its row blocks: ``sharding.shard_state``."""
    if process_count() == 1:
        return state
    return shard_state(state, mesh, n_users, n_items)


def global_replicated(tree, mesh: Mesh):
    """Rank 0's values of a tree on every rank."""
    if process_count() == 1:
        return tree
    return replicate(tree, mesh)


def fetch(x, mesh: Optional[Mesh] = None,
          block: Optional[RowBlock] = None) -> np.ndarray:
    """A leaf as a numpy array on every rank: a row-sharded leaf's blocks
    are all-gathered over 'model' first (every rank calls this for it)."""
    if isinstance(x, (int, float, np.ndarray)):
        return np.asarray(x)
    if block is not None and process_count() > 1:
        x = collective.all_gather(x.detach(), mesh.group("model"))
    return x.detach().cpu().numpy()


def whole_state(state, mesh: Mesh, n_users: int, n_items: int):
    """The global state on every rank: the sharded table leaves
    all-gathered over 'model' (as CPU tensors; every rank calls this), the
    others as they are."""
    plan = state_shardings(None, mesh, n_users, n_items)
    leaves = table_leaves(state)
    return replace_table_leaves(state, {
        p: torch.from_numpy(fetch(leaves[p], mesh, b))
        for p, b in plan.items()})


class MultihostPlacement:
    """The placement that ``SMLEngine.placement`` takes: the mesh, the
    per-leaf plan and every move of state and data onto it. Also valid
    with one process, where it passes everything through."""

    def __init__(self, mesh: Mesh, n_users: int, n_items: int):
        self.mesh = mesh
        self.n_users = n_users
        self.n_items = n_items

    def batch(self, padded):
        return global_batch(padded, self.mesh)

    def replicated(self, tree):
        return None if tree is None else global_replicated(tree, self.mesh)

    def state(self, state):
        return global_state(state, self.mesh, self.n_users, self.n_items)

    def fetch(self, x, block: Optional[RowBlock] = None) -> np.ndarray:
        return fetch(x, self.mesh, block)

    @staticmethod
    def is_main() -> bool:
        return process_index() == 0

