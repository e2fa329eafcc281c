#!/usr/bin/env python3
"""The batches ``chip_smoke.py``'s ProtoCLIP and MVP gates could use, side
by side, on one GPU:

    python3 tools/torch_gate_sweep.py [--steps 22]

ProtoCLIP's stage-1 step (``chip_smoke.py:prompt_trainer``, ViT-B/16 with
seeded weights, AdamW 5e-4) on a 64-slot class table with ``live`` classes
of 64 / ``live`` samples each: one uint8 image a class, noise, a solid
colour or the synthetic set's class pattern; the synthetic set's class
names ("pattern 0" ..) or made-up ones (``chip_smoke.py:gate_names``); the
seeded logit scale or the published checkpoints' 100. Then MVP's step with
the scripts' flags (GSF on), whose loss and cross entropy before GSF are
both printed. One JSON line a run: the losses of ``--steps`` steps, their
fall, and for ProtoCLIP how far the last ends below log(live).
"""

import argparse
import json
import math
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTO = "adapter-clip-proto_prompt"
# (image kind, live classes, logit scale or None for the seeded one,
# made-up class names)
RUNS = (("noise", 64, None, True), ("noise", 8, None, True),
        ("noise", 8, None, False), ("noise", 8, 100.0, True),
        ("pattern", 8, None, True), ("pattern", 8, 100.0, True),
        ("solid", 8, None, True), ("solid", 8, 100.0, True),
        ("solid", 8, 100.0, False), ("solid", 4, 100.0, True),
        ("solid", 2, None, True))


def gate_images(kind, live, seed=1):
    """64 uint8 images of ``live`` classes, one image a class, and labels."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    per = 64 // live
    labels = np.repeat(rng.permutation(100)[:live], per)
    if kind == "noise":
        im = rng.integers(0, 255, (live, 32, 32, 3), dtype=np.uint8)
    elif kind == "solid":
        im = np.broadcast_to(rng.integers(0, 255, (live, 1, 1, 3)).astype(
            np.uint8), (live, 32, 32, 3))
    else:
        from lifelong_clip_tpu_torch.data.registry import make_synthetic
        d = make_synthetic(n_classes=live, per_class=1, image_size=32, seed=0)
        im = d.images[np.argsort(d.targets)]
    return torch.from_numpy(np.repeat(im, per, 0)), torch.from_numpy(labels)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=22)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_gate_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from lifelong_clip_tpu_torch.ops import _kernels
    _kernels.build()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    for kind, live, scale, made_up in RUNS + (("mvp", 64, None, False),):
        method = "mvp" if kind == "mvp" else PROTO
        with tempfile.TemporaryDirectory() as tmp:
            tr = cs.prompt_trainer(method, tmp, class_names=(
                cs.gate_names() if made_up else None))
            if scale is not None:
                tr.state.frozen["logit_scale"] = torch.tensor(
                    math.log(scale), device=dev)
            images, labels = (cs.gate_batch(tr.clip_cfg, 64, 64)[:2]
                              if method == "mvp" else gate_images(kind, live))
            step, batch = cs.gate_step(tr, method, images, labels, dev)
            ces = cs.record_ce(tr) if method == "mvp" else []
            losses = [float(step(batch)["loss"]) for _ in range(args.steps)]
        out = {"method": method, "images": kind, "live": live,
               "logit_scale": scale or "seeded", "made_up_names": made_up,
               "losses": losses, "fall": losses[0] - losses[-1]}
        if method == PROTO:
            out["below_log_live"] = math.log(live) - losses[-1]
        else:
            ce = [float(c) for c in ces]
            out.update(cross_entropy=ce, cross_entropy_fall=ce[0] - ce[-1])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
