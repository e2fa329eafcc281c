#!/usr/bin/env python3
"""Time the port's KV-prefix chains (kernels #3, #4) at ProtoCLIP's suffix
shapes on one GPU, as ``chip_smoke.py``'s kernel phase does, without the
rest of that script:

    python3 tools/torch_suffix_time.py [--root DIR] [--label NAME] [--others]

K4 (64 rows x 512 tokens, D = 512, 8 heads, P = 25, the (512, 537)
block-diagonal causal mask of 64 classes x 8 tokens: the tiled roads) and
the main path's shape (64 x 160 tokens, the (160, 185) mask: the register
roads). For each: the checks against the plain versions, the forward and
backward chains' CUDA-event and device-busy ms beside the plain version and
the library yardstick, the attention backward's kernels; then, where the
tree has it, ``chip_smoke.tile_map_phase``: the attention kernels' outputs
with the tile map and with a null map (every block swept) bit for bit, and
both chains' device ms both ways. ``--others`` adds the cases that share
the attention kernels (#1/#2 at the vision, ViT-L/14, L2P and per-rank
shapes, #3/#4 at the mvp shape), to hold them against another tree.
``--root`` is the checkout whose ``lifelong_clip_tpu_torch`` and
``chip_smoke.py`` are used (its kernels are built there at first use), so
a parent and a change are compared by running this on each in one run on
the card (parent, change, change, parent). Prints the card, the build time
and one JSON line.
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

# (label, B, T, D, heads, LoRA r, seed): #1/#2 cases as chip_smoke.py runs them
OTHERS = (("vision", 64, 197, 768, 12, 4, 0),
          ("ViT-L/14 vision", 64, 257, 1024, 16, 4, 12),
          ("L2P prompted, T = 222", 64, 222, 768, 12, 0, 19),
          ("per rank of 2x1: lora-clip, 32 rows", 32, 197, 768, 12, 4, 27))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose lifelong_clip_tpu_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--others", action="store_true",
                    help="also time the cases that share the kernels")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_suffix_time: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lifelong_clip_tpu_torch.models.proto_clip import suffix_mask
    from lifelong_clip_tpu_torch.ops import _kernels
    assert os.path.abspath(_kernels.__file__).startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    quiet = contextlib.redirect_stdout(io.StringIO())
    with quiet:
        cases = [cs.prefix_kernel_case(
            "ProtoCLIP suffix, C x S = 64 x 8, lp = 25", 25, False, 23,
            shape=(64, 512, 512, 8, 25), shared=True,
            mask=suffix_mask(64, 8, 25, device="cuda"))]
        cases.extend(cs.proto_main_suffix_cases())
        if args.others:
            cases += [cs.kernel_case(lab, b, t, d, h, r, False, False, seed)
                      for lab, b, t, d, h, r, seed in OTHERS]
            cases.append(cs.prefix_kernel_case("mvp prefix, 5 of 20 live", 5,
                                               False, 4))
        tile_maps = (cs.tile_map_phase() if hasattr(cs, "tile_map_phase")
                     else None)
    keep = ("label", "tile_liveness", "fwd_ms", "fwd_device_ms",
            "fwd_library_device_ms", "fwd_bound_ms", "bwd_ms",
            "bwd_device_ms", "bwd_library_device_ms", "bwd_bound_ms",
            "bwd_attention_device_ms", "fwd_max_abs_err", "bwd_max_abs_err")
    print(json.dumps({"label": args.label,
                      "root": os.path.relpath(root, HERE),
                      "cases": [{k: c.get(k) for k in keep} for c in cases],
                      "tile_map_phase": tile_maps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
