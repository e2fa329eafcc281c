#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh, pipeline or whole-run phase alone, on one
card: the kernels built first, then every case of ``MESH_CASES`` (the
data-parallel, model-axis and bf16 model-axis steps, the one-rank nccl step
and the planted-fault controls), of ``PP_CASES`` (lora-clip's vision tower
in two pipeline stages: ViT-B/16 in fp32 and bf16, ViT-L/14 in bf16, and
the planted fault) or of ``WHOLE_RUN_PATHS`` (lora-clip, Finetuning and
mvp-clip through ``main`` on the kernel road, the library road and in fp32,
then lora-clip with each planted fault of ``WHOLE_RUN_FAULTS``) or the
text prompts (the #3/#4 and #5/#6 kernel cases at the text prompt path's
shapes, then ``text_prompt_phase``), with the card's name and power limit.

    python3 tools/torch_mesh_phase.py
        [--phase mesh|pipeline|whole_run|text_prompts] [--out FILE]

Writes the phase's record as JSON to ``--out`` (default
``chiprun_out/<phase>_phase.json``) and exits 1 if a check failed.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def text_prompts_phase(card):
    """The kernel cases of the text prompt path (the last of
    ``FLASH_CASES`` with its seed in ``chip_smoke.main``), then its
    phase."""
    import chip_smoke as cs
    t0 = time.perf_counter()
    prefix = cs.text_prompt_prefix_case()
    flash = cs.flash_kernel_case(*cs.FLASH_CASES[-1],
                                 seed=7 + len(cs.FLASH_CASES) - 1)
    launches, res = cs.text_prompt_phase(card)
    return {"prefix_case": prefix, "flash_case": flash,
            "launches": launches, **res,
            "wall_s": time.perf_counter() - t0}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phase", choices=("mesh", "pipeline", "whole_run",
                                       "text_prompts"), default="mesh")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   f"{args.phase}_phase.json")
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
    phase = {"mesh": cs.mesh_phase, "pipeline": cs.pipeline_phase,
             "whole_run": cs.whole_run_phase,
             "text_prompts": text_prompts_phase}[args.phase]
    try:
        res = phase(card)
    except AssertionError as e:
        cs.log(f"{args.phase} phase failed: {e}")
        return 1
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, default=str)
    cs.log(f"{args.phase} phase ok in {res['wall_s']:.1f} s; record in "
           f"{out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
