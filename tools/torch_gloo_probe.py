#!/usr/bin/env python3
"""Which collectives a gloo group takes on CUDA tensors, on one card.

    python3 tools/torch_gloo_probe.py

Two processes on cuda:0 join a gloo group (as ``chip_smoke.py``'s mesh
and pipeline phases do: NCCL takes one rank a device) and try all-reduce,
broadcast, all-gather (a list, and into one tensor), reduce-scatter into
one tensor, bf16 all-gather and all-reduce, the port's ring permute
(``parallel/mesh.py:ring_permute``, forward and backward), a barrier and a
subgroup's all-reduce on CUDA tensors, each checked for its value; last a
send/recv (each rank's exit code recorded: a failed send can end its
process). Then one process all-reduces in a one-rank nccl group. Prints
the card's name and power limit, then one JSON line: op -> "ok" or the
error. Raises when a rank does not answer the main probes.
"""

import datetime
import json
import os
import queue as queue_mod
import subprocess
import sys
import tempfile


def _try(res, name, fn, want=None):
    import torch
    try:
        got = fn()
        torch.cuda.synchronize()
        res[name] = "ok" if want is None or got == want else f"got {got}"
    except Exception as e:  # the finding is the error itself
        res[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def gloo_rank(rank, path, queue):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://" + path, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    res = {}

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return x.tolist()

    def broadcast():
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.broadcast(x, 0)
        return x.tolist()

    def all_gather():
        x = torch.full((2,), float(rank + 1), device=dev)
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        return [o.tolist() for o in out]

    def all_gather_into_tensor():
        x = torch.full((2,), float(rank + 1), device=dev)
        out = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.tolist()

    def reduce_scatter_tensor():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.ones(4, device=dev))
        return out.tolist()

    def bf16_all_gather_into_tensor():
        x = torch.full((2,), float(rank + 1), device=dev,
                       dtype=torch.bfloat16)
        out = torch.empty(4, device=dev, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(out, x)
        return out.tolist()

    def bf16_all_reduce():
        x = torch.full((4,), float(rank + 1), device=dev,
                       dtype=torch.bfloat16)
        dist.all_reduce(x)
        return x.tolist()

    def ring_permute():
        # parallel/mesh.py:ring_permute on a 1 x 2 mesh: rank r receives
        # rank (r - 1) % 2's tensor, forward and (inverse) backward
        from lifelong_clip_tpu_torch.parallel import mesh as mesh_lib
        m = mesh_lib.Mesh((1, 2), rank, dev)
        x = torch.full((2, 3), float(rank + 1), device=dev,
                       dtype=torch.bfloat16, requires_grad=True)
        y = mesh_lib.ring_permute(x, m)
        (y * float(rank + 1)).sum().backward()
        return [y[0, 0].item(), x.grad[0, 0].item()]

    def send_recv():
        x = torch.full((3,), float(rank + 1), device=dev)
        if rank == 0:
            dist.send(x, 1)
            return None
        dist.recv(x, 0)
        return x.tolist()

    def subgroup_all_reduce():
        x = torch.ones(3, device=dev)
        dist.all_reduce(x, group=dist.new_group([0, 1]))
        return x.tolist()

    _try(res, "all_reduce", all_reduce, [3.0] * 4)
    _try(res, "broadcast", broadcast, [1.0] * 4)
    _try(res, "all_gather", all_gather, [[1.0, 1.0], [2.0, 2.0]])
    _try(res, "all_gather_into_tensor", all_gather_into_tensor,
         [1.0, 1.0, 2.0, 2.0])
    _try(res, "reduce_scatter_tensor", reduce_scatter_tensor, [2.0, 2.0])
    _try(res, "bf16_all_gather_into_tensor", bf16_all_gather_into_tensor,
         [1.0, 1.0, 2.0, 2.0])
    _try(res, "bf16_all_reduce", bf16_all_reduce, [3.0] * 4)
    _try(res, "ring_permute", ring_permute, [2.0 - rank, 2.0 - rank])
    _try(res, "barrier", dist.barrier)
    _try(res, "subgroup_all_reduce", subgroup_all_reduce, [2.0] * 3)
    queue.put((rank, res))
    # last: a failed send can take the process down with it
    p2p = {}
    _try(p2p, "send_recv", send_recv, None if rank == 0 else [1.0] * 3)
    queue.put((f"{rank} p2p", p2p))
    dist.destroy_process_group()


def nccl_one_rank(path, queue):
    import torch
    import torch.distributed as dist
    res = {}

    def one():
        dist.init_process_group("nccl", init_method="file://" + path,
                                rank=0, world_size=1)
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x)
        return x.tolist()

    _try(res, "nccl_one_rank_all_reduce", one, [1.0] * 4)
    queue.put(("nccl", res))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def main():
    import multiprocessing as mp
    import torch
    if not torch.cuda.is_available():
        print("torch_gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=gloo_rank,
                             args=(r, os.path.join(tmp, "pg"), queue))
                 for r in range(2)]
        procs.append(ctx.Process(target=nccl_one_rank,
                                 args=(os.path.join(tmp, "nccl"), queue)))
        for p in procs[:2]:
            p.start()
        for _ in range(2):
            rank, res = queue.get(timeout=300)
            out[f"gloo rank {rank}"] = res
        for _ in range(2):
            try:
                rank, res = queue.get(timeout=120)
            except queue_mod.Empty:
                break
            out[f"gloo rank {rank}"] = res
        for r, p in enumerate(procs[:2]):
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(10)
            out[f"gloo rank {r} exit code"] = p.exitcode
        procs[2].start()
        _, res = queue.get(timeout=300)
        out.update(res)
        procs[2].join(60)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
