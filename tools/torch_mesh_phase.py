#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh phase alone, on one card: the kernels built
first, then every case of ``MESH_CASES`` (the data-parallel, model-axis and
bf16 model-axis steps, the one-rank nccl step and the planted-fault
controls) with the card's name and power limit.

    python3 tools/torch_mesh_phase.py [--out FILE]

Writes the phase's record as JSON to ``--out`` (default
``chiprun_out/mesh_phase.json``) and exits 1 if a check failed.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "mesh_phase.json"))
    args = p.parse_args()
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from lifelong_clip_tpu_torch.ops import _kernels
    if not torch.cuda.is_available():
        print("torch_mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    _kernels.build()
    _kernels.library()
    try:
        res = cs.mesh_phase(card)
    except AssertionError as e:
        cs.log(f"mesh phase failed: {e}")
        return 1
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, default=str)
    cs.log(f"mesh phase ok in {res['wall_s']:.1f} s; record in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
