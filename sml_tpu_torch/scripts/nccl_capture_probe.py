"""Where a CUDA graph can hold an NCCL collective across ranks, as the
fused programs would place it: each case in a fresh world of ``--ranks``
ranks, one card each, its values or its error on every rank.

    python -m sml_tpu_torch.scripts.nccl_capture_probe [--ranks 2]

Every case all-reduces a ``(1024,)`` f32 vector (rank ``r`` starts at
``r + 1``) over a group of the whole world, after one eager run of the
same work that sets up the communicator and its buffers:

  plain-global  the all-reduce captured alone with ``torch.cuda.graph``'s
                default (global) capture mode on its own side stream, as
                torch's own tests capture NCCL collectives;
  plain         the same through ``graphs.CapturedCall`` (thread-local
                mode, a side stream), as the fused programs are captured;
  if            two step slots (``graphs.step_if``), each an IF node whose
                body holds its work and its all-reduce (the capture ends
                with ``cudaErrorInvalidValue`` on H100s);
  split         the same two slots each split around the collective: an
                IF node for the work before it, the all-reduce outside
                any IF node over the slot's contribution (zero where the
                slot is skipped), an IF node for the work after it, as the
                fused programs split their step slots
                (``train/steps.py`` ``run_slots``).

A captured case is replayed with 1, 0, 2 and 1 of its slots taken, and
every rank checks each replay's values against the eager version's.
Worlds run side by side on disjoint cards, each with a deadline; a rank
that hangs is killed and its last progress line kept. Prints one JSON
line per case and exits 1 unless every case ran and agreed.
"""

from __future__ import annotations

import argparse
import gc
import json
import socket
import subprocess
import sys
import time

CASES = ("plain-global", "plain", "if", "split")
DEADLINE_S = 60.0       # per world: start, NCCL set-up, capture, replays
N = 1024


def _expected(case: str, rank: int, world: int, taken: int) -> float:
    """The value every element holds after a run with ``taken`` slots."""
    tot = world * (world + 1) / 2
    if case.startswith("plain"):
        return tot
    want = float(rank + 1)
    if taken >= 1:
        want = 2 * tot
    if taken >= 2:
        want = world * (want + 1000.0)
    return want


def rank_main(case: str, rank: int, world: int, first_card: int,
              port: int) -> dict:
    import torch
    import torch.distributed as dist

    from sml_tpu_torch.train import graphs

    def step(msg):
        print(f"rank {rank}: {msg}", file=sys.stderr, flush=True)
    dev = torch.device("cuda", first_card + rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, device_id=dev)
    group = dist.new_group(list(range(world)), backend="nccl")
    base = torch.full((N,), float(rank + 1), device=dev)
    x = torch.empty_like(base)
    contrib = torch.empty_like(base)
    slots = graphs.SlotTable(2, dev)

    def body():
        x.copy_(base)
        if case.startswith("plain"):
            dist.all_reduce(x, group=group)
            return
        for b, (scale, shift) in enumerate(((2.0, 0.0), (1.0, 1000.0))):
            if case == "if":
                with graphs.step_if(slots, b) as run:
                    if run:
                        x.mul_(scale).add_(shift)
                        dist.all_reduce(x, group=group)
                continue
            contrib.zero_()
            with graphs.step_if(slots, b) as run:
                if run:
                    torch.add(x * scale, shift, out=contrib)
            dist.all_reduce(contrib, group=group)
            with graphs.step_if(slots, b) as run:
                if run:
                    x.copy_(contrib)
    slots.fill(2)
    side = torch.cuda.Stream(dev)
    graphs.run_on(side, body)
    torch.cuda.synchronize(dev)
    eager_ok = bool((x == _expected(case, rank, world, 2)).all())
    step(f"eager run done, values {'right' if eager_ok else 'WRONG'}")
    t0 = time.perf_counter()
    if case == "plain-global":
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured, stream=side):
            body()
    else:
        captured = graphs.CapturedCall(body, side)
    torch.cuda.synchronize(dev)
    out = {"eager_ok": eager_ok, "capture_s": time.perf_counter() - t0,
           "replays": []}
    step("captured")
    for taken in (1, 0, 2, 1):
        slots.fill(taken)
        captured.replay()
        torch.cuda.synchronize(dev)
        want = _expected(case, rank, world, taken)
        got = float(x[0])
        out["replays"].append({"taken": taken, "got": got, "want": want,
                               "ok": bool((x == want).all())})
        step(f"replay with {taken} taken: {got} (want {want})")
    # the world is torn down after the graph is gone (with the graph
    # alive, the barrier or the teardown after the replays hung)
    del captured
    gc.collect()
    torch.cuda.synchronize(dev)
    step("graph released")
    dist.barrier(group=group, device_ids=[dev.index])
    step("barrier passed")
    dist.destroy_process_group()
    step("world destroyed")
    out["ok"] = eager_ok and all(r["ok"] for r in out["replays"])
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(case: str, world: int, first_card: int) -> dict:
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sml_tpu_torch.scripts.nccl_capture_probe",
         "--rank", str(r), "--case", case, "--ranks", str(world),
         "--first-card", str(first_card), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    return {"case": case, "procs": procs, "t0": time.perf_counter()}


def finish_world(w: dict) -> dict:
    """Each rank's result, or its exit code and last lines; a world past
    its deadline is killed and reported as hung."""
    hung = False
    ranks = []
    for p in w["procs"]:
        left = DEADLINE_S - (time.perf_counter() - w["t0"])
        try:
            out, err = p.communicate(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            hung = True
            for q in w["procs"]:
                q.kill()
            out, err = p.communicate()
        res = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if res and p.returncode == 0:
            ranks.append(json.loads(res[-1][len("RESULT "):]))
        else:
            ranks.append({"rc": p.returncode,
                          "err": err.strip().splitlines()[-6:]})
    ok = not hung and all(r.get("ok") for r in ranks)
    return {"case": w["case"], "ok": ok, "hung": hung,
            "wall_s": time.perf_counter() - w["t0"], "ranks": ranks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("nccl_capture_probe")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--case", choices=CASES, default=None)
    p.add_argument("--first-card", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    if args.rank is not None:
        res = rank_main(args.case, args.rank, args.ranks, args.first_card,
                        args.port)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    import torch

    from sml_tpu_torch import _build
    if not torch.cuda.is_available():
        print("nccl_capture_probe needs CUDA cards", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    if cards < args.ranks:
        print(f"nccl_capture_probe: {args.ranks} ranks need as many cards, "
              f"found {cards}", file=sys.stderr)
        return 1
    _build.load_library()           # built once, before the ranks start
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "card": torch.cuda.get_device_name(0),
                      "ranks": args.ranks}), flush=True)
    side_by_side = cards // args.ranks
    results = []
    for i in range(0, len(CASES), side_by_side):
        worlds = [start_world(case, args.ranks, j * args.ranks)
                  for j, case in enumerate(CASES[i:i + side_by_side])]
        for w in worlds:
            results.append(finish_world(w))
            print(json.dumps(results[-1]), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
