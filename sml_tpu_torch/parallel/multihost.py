"""Multi-process execution (counterpart of ``sml_tpu/parallel/multihost.py``).

One process per rank; every process runs the same program on the same
period files and holds the whole padded epoch, so every rank makes the
same random draws and keeps its own block of each batch
(``train/steps.py``). Layout, as in the JAX package: the **model axis runs
inside a host** (the row-sharded lookups and the refresh exchange
activation rows between ranks of one host) and the **data axis runs across
hosts** (gradients are reduced over it).

:func:`init_distributed` starts the world and places each rank: rank ``r``
runs on ``cuda:{local_rank % device_count}``, its local rank found from an
exchange of host names, or on the CPU when the caller asks for it. The
backend follows from the layout: NCCL when every rank of a host has a card
of its own, gloo when ranks share a card (two ranks on one GPU) or run on
the CPU. Every collective carries the world's finite timeout and raises
when it runs out.

With one process every helper here is a pass-through, as in JAX.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

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
                     device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join a world of ``num_processes`` ranks as rank ``process_id`` and
    return this rank's device.

    ``coordinator`` is ``host:port`` (a TCP store that rank 0 serves) or a
    ``file://`` path shared by the ranks. Every collective of the world
    raises after ``timeout_s`` seconds. ``device="cuda"`` places the rank on
    ``cuda:{local_rank % device_count}`` (and raises without a card);
    ``device="cpu"`` keeps it on the CPU, with its share of the host's
    cores (``torch.set_num_threads``). The world's own group runs on
    gloo (it only exchanges host names); the meshes' groups follow
    ``collective.backend_for``."""
    dev = resolve_device(device)
    init_method = (coordinator if coordinator.startswith("file://")
                   else f"tcp://{coordinator}")
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    hosts = [None] * num_processes
    dist.all_gather_object(hosts, socket.gethostname())
    mine = hosts[process_id]
    local_rank = hosts[:process_id].count(mine)
    local_world = hosts.count(mine)
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
                            backend=backend_for(dev, local_world),
                            hosts=hosts)
    return dev


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(n_model: Optional[int] = None) -> Mesh:
    """Mesh over every rank: ``model`` holds the ranks of one host and
    ``data`` runs across hosts. With ``n_model`` given, a host's ranks are
    split further (``local // n_model`` data ways per host)."""
    local = collective.WORLD["local_world"]
    hosts = collective.WORLD.get("hosts") or [None] * process_count()
    if any(hosts[r] != hosts[r - r % local] for r in range(len(hosts))):
        raise ValueError(f"ranks of one host must be contiguous: {hosts}")
    if n_model is None:
        n_model = local
    if local % n_model:
        raise ValueError(f"{local} ranks per host do not divide into model "
                         f"groups of {n_model}")
    return Mesh(process_count() // n_model, n_model)


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

