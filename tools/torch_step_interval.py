#!/usr/bin/env python3
"""Step ms against device-busy ms of a lora-clip run through ``main`` on one
GPU, for a tree of the repo (the change, or a parent unpacked beside it).

    python3 tools/torch_step_interval.py [--root TREE] --label L \
        [-- main flags]

Runs ``lifelong_clip_tpu_torch.main`` from ``TREE`` (default: this checkout)
on ViT-B/16, bs 64, synthetic-100x64 (6400 samples, one task of ~100 steps
with ``--n_tasks 1``), no periodic eval; extra flags after ``--`` go to
``main`` (default ``--transforms`` with no values: the parent of the
AutoAugment port cannot run it). Around the trainer's ``online_step`` it
takes the step ms over steps 10-40 from the host clock between two
synchronizations (so it is the rate the run sustains, gather and upload
included), and the device-busy ms a step over steps 45-55 from
torch.profiler (the union of kernel intervals). Prints one JSON line with
the card's name and power limit.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", required=True)
    args, extra = p.parse_known_args()
    extra = [a for a in extra if a != "--"] or ["--transforms"]
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lifelong_clip_tpu_torch import main as cli
    from lifelong_clip_tpu_torch.methods import adapter_clip
    assert torch.cuda.is_available(), "needs an NVIDIA GPU"

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    marks, prof = {}, {}
    window, busy_window = (10, 40), (45, 55)
    orig = adapter_clip.AdapterCLIP.online_step

    def online_step(self, *a, **kw):
        n = marks.setdefault("n", 0)
        if n in window or n in busy_window:
            torch.cuda.synchronize()
            marks[n] = time.perf_counter()
        if n == busy_window[0]:
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if n == busy_window[1]:
            prof["p"].__exit__(None, None, None)
        marks["n"] = n + 1
        return orig(self, *a, **kw)

    adapter_clip.AdapterCLIP.online_step = online_step
    with tempfile.TemporaryDirectory() as tmp:
        cli.main(["--method", "lora-clip", "--model_name", "ViT-B/16",
                  "--dataset", "synthetic-100x64", "--n_tasks", "1",
                  "--batchsize", "64", "--eval_period", "1000000",
                  "--log_path", tmp, "--device", "cuda"] + extra)
    assert marks["n"] > busy_window[1], f"only {marks['n']} steps"
    step_ms = (marks[window[1]] - marks[window[0]]) / (
        window[1] - window[0]) * 1e3
    kern = sorted((e for e in prof["p"].events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    busy, end = 0.0, -math.inf
    for e in kern:
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
    steps = busy_window[1] - busy_window[0]
    device_ms = busy / 1e3 / steps if kern else None
    profiled_ms = (marks[busy_window[1]] - marks[busy_window[0]]) / steps * 1e3
    print(json.dumps({
        "label": args.label, "root": args.root, "flags": extra,
        "step_ms": step_ms, "device_busy_ms": device_ms,
        "idle_share": None if device_ms is None else 1 - device_ms / step_ms,
        "profiled_step_ms": profiled_ms, "steps": marks["n"], "card": card}),
        flush=True)


if __name__ == "__main__":
    main()
