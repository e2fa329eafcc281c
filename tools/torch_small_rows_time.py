#!/usr/bin/env python3
"""Time the port's fused LN-attention chains (kernel #1 forward, #2
backward) at the ER family's small batches on one GPU, beside the library
calls, as ``chip_smoke.py``'s kernel phase does, without the rest of that
script:

    python3 tools/torch_small_rows_time.py [--root DIR] [--label NAME]
        [--gates] [--others] [--out FILE]

ViT-B/16's vision block (T = 197, D = 768, 12 heads, bf16, no LoRA, no
mask) at 8, 16, 64 and 128 rows, the backward with and without the weight
grads (Finetuning's whole-tower step, and its 8 rows a rank under ``--mesh
2x1``). For each: the checks against the plain versions, the forward and
backward chains' CUDA-event and device-busy ms beside the plain version and
the library yardstick (LN + ``F.linear`` + SDPA + ``F.linear``, backward by
autograd), their bounds, the attention backward's kernels, and every launch
of both chains in order by device ms. ``--gates`` adds the ER and
Finetuning learning gates of ``chip_smoke.py`` (device ms a step, idle
share, kernel events a step); ``--others`` the rows that share these
kernels without being the small batches' (#1/#2 with LoRA at 64 rows,
ViT-L/14, L2P's K1, ProtoCLIP's K3 text prefix, the text tower's causal
K=20 and K=64 class rows; #3/#4 at the mvp shape and ProtoCLIP's K2), to
hold them against another tree. ``--root`` is the
checkout whose ``lifelong_clip_tpu_torch`` and ``chip_smoke.py`` are used
(its kernels are
built there at first use), so a parent and a change are compared by running
this on each in one run on the card (parent, change, change, parent).
Prints the card's name and power limit, the build time and one JSON line
(also written to ``--out``).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (rows, weight_grads, seed): the ER family's rows (16; 8 a rank of --mesh
# 2x1), the adapter family's 64 and the eval batch of 128
CASES = ((8, False, 40), (8, True, 41), (16, False, 42), (16, True, 43),
         (64, False, 44), (64, True, 45), (128, False, 46))
# #1/#2 (label, B, T, D, heads, LoRA r, causal, seed) and #3/#4 (label,
# live slots, seed, shape) cases as chip_smoke.py runs them
OTHERS = (("vision, LoRA r=4", 64, 197, 768, 12, 4, False, 0),
          ("ViT-L/14 vision", 64, 257, 1024, 16, 4, False, 12),
          ("L2P prompted, T = 222", 64, 222, 768, 12, 0, False, 19),
          ("ProtoCLIP text prefix, T = 25", 64, 25, 512, 8, 0, True, 20),
          ("text K=20", 20, 77, 512, 8, 0, True, 1),
          ("text K=64", 64, 77, 512, 8, 0, True, 2))
PREFIX_OTHERS = (("mvp prefix, 5 of 20 live", 5, 4, (64, 197, 768, 12, 20)),
                 ("ProtoCLIP image, P = 4, 4 live", 4, 21,
                  (64, 197, 768, 12, 4)))
KEEP = ("label", "fwd_ms", "fwd_device_ms", "fwd_library_ms",
        "fwd_library_device_ms", "fwd_plain_ms", "fwd_bound_ms", "bwd_ms",
        "bwd_device_ms", "bwd_library_ms", "bwd_library_device_ms",
        "bwd_plain_ms", "bwd_bound_ms", "bwd_attention_device_ms",
        "fwd_max_abs_err", "bwd_max_abs_err", "forward_chain_split",
        "chain_split")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose lifelong_clip_tpu_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--gates", action="store_true",
                    help="also run the ER and Finetuning learning gates")
    ap.add_argument("--others", action="store_true",
                    help="also time the rows that share the kernels")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_small_rows_time: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lifelong_clip_tpu_torch.ops import _kernels
    assert os.path.abspath(_kernels.__file__).startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    cases, gates = [], {}
    with contextlib.redirect_stdout(io.StringIO()):
        for rows, wg, seed in CASES:
            label = f"{rows} x 197 x 768, r = 0" + (
                ", weight_grads" if wg else "")
            res = cs.kernel_case(label, rows, 197, 768, 12, 0, False, wg,
                                 seed)
            cases.append({k: res.get(k) for k in KEEP})
            torch.cuda.synchronize()
        for label, b, t, d, h, r, causal, seed in (
                OTHERS if args.others else ()):
            res = cs.kernel_case(label, b, t, d, h, r, causal, False, seed)
            cases.append({k: res.get(k) for k in KEEP})
            torch.cuda.synchronize()
        for label, live, seed, shape in PREFIX_OTHERS if args.others else ():
            res = cs.prefix_kernel_case(label, live, False, seed, shape=shape)
            cases.append({k: res.get(k) for k in KEEP})
            torch.cuda.synchronize()
        if args.gates:
            cs.annotate_augmentation()
            for method in ("er", "Finetuning"):
                g = cs.er_family_gate(card, method)
                prof = g["profile"]
                gates[method] = {
                    "step_ms": g["step_ms"], "loss_first": g["loss_first"],
                    "loss_last": g["loss_last"],
                    "launches": g["launches"],
                    **{k: prof.get(k) for k in (
                        "device_busy_ms_per_step", "idle_share_of_step",
                        "kernel_events_per_step", "top")}}
                torch.cuda.synchronize()
    for c in cases:
        print(f"{c['label']}: fwd device {cs.fmt(c['fwd_device_ms'])} "
              f"(library {cs.fmt(c['fwd_library_device_ms'])}, bound "
              f"{c['fwd_bound_ms']:.4f}), bwd device "
              f"{cs.fmt(c['bwd_device_ms'])} (library "
              f"{cs.fmt(c['bwd_library_device_ms'])}, bound "
              f"{c['bwd_bound_ms']:.4f})", flush=True)
    line = json.dumps({"label": args.label,
                       "root": os.path.relpath(root, HERE), "card": card,
                       "cases": cases, "gates": gates})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
