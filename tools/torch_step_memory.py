#!/usr/bin/env python3
"""Peak device memory of the port's train steps, for one checkout, on one
GPU:

    python3 tools/torch_step_memory.py [--root DIR] [--label NAME]

Runs 3 steps of each ViT-B/16 train step that the checkout's own
``chip_smoke.py`` gates (lora-clip, mvp-clip, MaPLe and prompted-LoRA, at
bs 64), with its learning-gate loop replaced by those 3 steps, and prints,
for each, the peak bytes allocated while they ran beside what was
allocated before them and the card's memory. (``chip_smoke.py``'s gates
print their own steps' peak memory; this measures a tree whose gates do
not.)
``--root`` is the checkout whose ``lifelong_clip_tpu_torch`` and
``chip_smoke.py`` are used (its kernels are built there at first use), so
two trees are compared by running this once on each in one run on the card.
Prints the card and one JSON line.
"""

import argparse
import gc
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose train steps are measured")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_step_memory: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    assert os.path.abspath(fba.__file__).startswith(root), fba.__file__
    torch.backends.cuda.matmul.allow_tf32 = False

    def three_steps(label, run_step, bs, card, **info):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(run_step()) for _ in range(3)]
        torch.cuda.synchronize()
        return {"label": label, "losses": losses,
                "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "allocated_before_steps_gb": before / 1e9}

    cs.gate_loop = three_steps
    gates = [cs.learning_gate, cs.mvp_learning_gate, cs.maple_learning_gate,
             cs.prompted_lora_gate]
    card = cs.card_line()
    rows = []
    for gate in gates:
        rows.append(gate(card))
        gc.collect()
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"label": args.label,
                      "root": os.path.relpath(root, HERE),
                      "card_gb": torch.cuda.get_device_properties(0)
                      .total_memory / 1e9, "steps": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
