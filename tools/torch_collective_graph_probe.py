#!/usr/bin/env python3
"""Whether NCCL collectives can be captured inside a CUDA graph's
conditional bodies (krylov_tpu_torch's graph route on several GPUs).

Run under ``torchrun``, one rank a GPU.  For one ``--kind``:

* ``plain``: the collectives captured into the graph itself, no
  conditional node;
* ``if``: captured into an IF node's body (``_graphs`` guard), replayed
  once with the flag up (the body runs) and once with it down (skipped);
* ``while``: captured into a WHILE node's body run three times a replay;
* ``if_if``: captured into an IF node's body inside another IF node's
  body (a periodic replacement inside a guarded step before
  ``guard.sibling``), replayed with the inner flag up, then down;
* ``sibling``: the same through ``guard.sibling``, the structure the
  driver captures now: the outer body split around an IF node beside it,
  one level deep;
* ``if_if_after``, ``sibling_after``: those two with the collectives
  launched in the outer body too, before the inner IF node (a guarded
  step's own reductions and halo exchanges before its replacement's).

Each captures one ``all_reduce`` over the world and one halo exchange
(``Mesh.start_exchange``: a ``batch_isend_irecv`` to both neighbours),
replays the graph, and checks the values.  The ranks agree on every
capture on a gloo group before any replays, so a rank whose capture
failed never leaves the others waiting in a replayed collective.  Rank 0
prints one JSON line: the kind, the capture mode, ``NCCL_GRAPH_MIXING_SUPPORT``,
torch's and NCCL's versions, and per rank whether capture and replay
succeeded, with the error.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tools/torch_collective_graph_probe.py --kind if
"""

import argparse
import functools
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=("plain", "if", "while", "if_if", "sibling",
                                       "if_if_after", "sibling_after"), required=True)
    ap.add_argument("--mode", choices=("global", "thread_local"), default="global",
                    help="the capture's error mode (torch.cuda.CUDAGraph.capture_begin)")
    args = ap.parse_args()

    from krylov_tpu_torch import _graphs
    from krylov_tpu_torch.parallel import mesh as pm, multihost

    multihost.initialize()
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = multihost.global_mesh()
    dev = mesh.device
    agree = dist.new_group(backend="gloo")
    if args.mode != "global":
        torch.cuda.CUDAGraph.capture_begin = functools.partialmethod(
            torch.cuda.CUDAGraph.capture_begin, capture_error_mode=args.mode)

    n = 1024
    x = torch.full((n,), float(rank + 1), device=dev)
    # warm both transports eagerly: a communicator is made at first use
    mesh.all_reduce(x)
    mesh.start_exchange(x, x).wait()
    torch.cuda.synchronize()

    total = torch.zeros((n,), device=dev)
    prev = torch.zeros((n,), device=dev)
    nxt = torch.zeros((n,), device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    inner = torch.ones((), dtype=torch.bool, device=dev)
    outer = torch.zeros((), dtype=torch.bool, device=dev)  # the step guard's flag, down
    before = torch.zeros((n,), device=dev)
    after = torch.zeros((n,), device=dev)
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    limit = torch.full((), 3, dtype=torch.int64, device=dev)

    def work():
        total.add_(mesh.all_reduce(x))
        got = mesh.start_exchange(x, x).wait()
        prev.add_(got[0])
        nxt.add_(got[1])

    after_kind = args.kind.endswith("_after")

    def step(guard, nest):
        # a guarded step: work before, a conditional replacement, work after
        if after_kind:
            work()
        before.add_(1.0)
        nest(inner, work)
        after.add_(before)

    def body(guard):
        if args.kind == "plain":
            work()
        elif args.kind == "if":
            guard(flag, True, work)
        elif args.kind == "while":
            guard.loop(counter, limit, lambda c: work())
        elif args.kind.startswith("if_if"):
            guard(outer, False, lambda: step(guard, lambda p, fn: guard(p, True, fn)))
        else:
            guard(outer, False, lambda: step(guard, guard.sibling))

    out = {"rank": rank, "captured": False, "replayed": False, "error": None}
    graph = None
    try:
        graph = _graphs.capture(body, dev)
        out["captured"] = True
    except Exception as exc:  # noqa: BLE001 - reported, then agreed on
        out["error"] = f"capture: {type(exc).__name__}: {exc}"[:600]
    ok = torch.tensor([int(out["captured"])])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=agree)
    if int(ok) == 1:
        try:
            total.zero_(), prev.zero_(), nxt.zero_(), before.zero_(), after.zero_()
            reps = 3 if args.kind == "while" else 2 if after_kind else 1
            counter.zero_()
            graph.replay()
            torch.cuda.synchronize()
            s = world * (world + 1) / 2
            want_prev = float(rank) if rank > 0 else 0.0  # rank r - 1 sent r
            want_next = float(rank + 2) if rank + 1 < world else 0.0
            good = (torch.all(total == reps * s) and torch.all(prev == reps * want_prev)
                    and torch.all(nxt == reps * want_next))
            if args.kind != "plain" and args.kind != "while":
                (flag if args.kind == "if" else inner).fill_(False)
                graph.replay()  # the (inner) body is skipped on every rank
                torch.cuda.synchronize()
                good = good and torch.all(total == (reps + after_kind) * s)
            if args.kind not in ("plain", "if", "while"):
                # the step's own work ran on both replays, in order
                good = good and torch.all(before == 2) and torch.all(after == 3)
            out["replayed"] = bool(good)
            if not good:
                out["error"] = (f"replay: wrong values total {float(total[0])} prev "
                                f"{float(prev[0])} next {float(nxt[0])}")
        except Exception as exc:  # noqa: BLE001 - reported
            out["error"] = f"replay: {type(exc).__name__}: {exc}"[:600]
    outs = [None] * world
    dist.all_gather_object(outs, out, group=agree)
    if rank == 0:
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
        print(json.dumps({
            "kind": args.kind, "mode": args.mode,
            "NCCL_GRAPH_MIXING_SUPPORT": os.environ.get("NCCL_GRAPH_MIXING_SUPPORT"),
            "torch": torch.__version__, "cuda": torch.version.cuda, "nccl": nccl,
            "ok": all(o["replayed"] for o in outs), "ranks": outs,
            "counts": dict(pm.COUNTS)}), flush=True)
    if graph is not None:
        graph.release()
    dist.barrier(group=agree)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
