#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from lifelong_clip_tpu_torch/csrc.
3. Kernel phase: the fused LN-attention block, forward and backward, at the
   ViT-B/16 vision shape (64 x 197 x 768, 12 heads, LoRA r=4, bf16, no mask,
   and with no LoRA and dx only, as adapter-clip and moe-clip run it, and
   at 128 x 197 x 768 with no LoRA, continual-clip's eval batch),
   the text shape (20 and 64 x 77 x 512, 8 heads, causal), ViT-L/14's
   vision shape (64 x 257 x 1024, 16 heads, LoRA r=4) and T = 512 (8 x 512 x
   768, weight_grads), the KV-prefix block at the mvp-clip shape (64 x 197 x
   768, P = 20 prompt slots, 12 heads, bf16; 5 live slots, none live, 5
   live with one prompt tensor as pk and pv as mvp-clip passes them, and 20
   live with weight_grads=True) and at S = P + T = 512 (8 x 197 x 768, P =
   315, 40 live, weight_grads); the new shapes of the prompt-pool methods:
   L2P's prompted block (64 x 222 x 768, no LoRA, dx only); the ER
   family's (no LoRA: Finetuning's whole-tower step at 16 x 197 x 768 with
   the weight grads, whose library yardstick's autograd computes the same
   weight and LN grads, ER's step at the same shape, CLIB's miss recompute
   at 256 x 197 x 768, and the small batches where the attention kernels
   split each (head, batch row) over blocks: 8 rows (Finetuning's with the
   weight grads, ER's forward and dx) and one row); ProtoCLIP's
   text prefix (64 x 25 x 512, 8 heads, causal), its CoPL image prefix (pk
   != pv, P = 4, all and none live) and its suffix pass (64 x 512 x 512, 8
   heads, one prompt tensor as pk and pv, P = 25, the block-diagonal
   causal (512, 537) mask of 64 classes x 8 tokens, whose bound counts the
   (query, key) pairs the mask leaves live), and the same at its main
   path's 20 classes (64 and 90 rows x 160 tokens, the (160, 185) mask);
   the text tower with KV-prefix prompts (100 class rows x 77 tokens, 512
   wide, 8 heads, P = 20, one prompt tensor as pk and pv, the causal
   (77, 97) mask with the prompts always visible);
   and the flash-attention op at
   six shapes (the
   prompted-LoRA block, B*H = 768, T = 197, S = 217, dh 64, with no mask and
   with a (S,) key row of 5 live prompt slots; the text tower, 64 rows x 8
   heads, T = S = 77, causal; ViT-L/14 with no prefix, 64 x 257 x 1024, 16
   heads, S = 257; T = 77, S = 700, causal, the bf16 forward's tiled road;
   the prompted text tower with LoRA, 100 rows x 8 heads, T = 77, S = 97,
   causal),
   each run through its op's autograd Function as the
   train step runs it, against the plain PyTorch versions on the same
   inputs on the card, with the tolerances stated in
   ``lifelong_clip_tpu_torch/ops/kernel_check.py``; timed beside the plain
   version and a library yardstick the port never calls (an SDPA-based
   composition of the block; for flash, ``scaled_dot_product_attention`` on
   the fp32-upcast inputs), with each case's bound and, for flash, the
   fp32 CUDA-core ceiling (the fp32 road's; the bf16 kernels run on tensor
   cores). Each case's device-busy ms (torch.profiler, host gaps left out)
   stands beside its library call's, every launch of its forward and
   backward chains is logged by device ms, and each timed backward's
   attention kernels (dq, dk/dv) are split out beside the attention
   backward's bound. The timed backwards read the forward's kept
   intermediates, as a train step does. Each case under a 2-D mask first
   prints what its tile map leaves live of its road (64-key tiles, 16 x
   16 blocks, the dk/dv kernel's 32-query steps). Then the tile-map phase:
   the suffix pass's K4 and main-path shapes with the mask's tile map and
   with a null map (every block swept), ctx, dqkv, dkvp and the weight
   grads' bias partials bit for bit equal, each chain's device ms both
   ways; the same for #1/#2 under the causal (T, T) mask at ``text K=100
   LoRA`` and K3 (ctx, y, dx, the LoRA grads). Then batch invariance: ctx,
   y and dx of 1, 8 and 16 rows (split attention kernels) bit for bit
   those of the same rows in a 64-row batch (unsplit), and of the text
   tower's 20 and 64 causal class rows in its 100. Then the port's GEMM
   at the qkv, out and dh shapes with the chain's epilogue terms, beside
   ``torch.matmul``.
4. Augmentation: the train pipeline alone (AutoAugment, resize + pad +
   crop, flip, normalize) at bs 64 on 32 x 32 uint8 under each policy and
   on 224 x 224, timed by CUDA events, host ms and device-busy ms, and
   held against the CPU at the same draws (every op, each stage, the whole
   pipeline within 1e-5; equalize and the other integer ops bit for bit).
5. Main paths, each with the launch counters set to 0 just before it and
   read just after: ``lifelong_clip_tpu_torch.main.main`` runs lora-clip on
   ViT-B/16 at bs=64 as ``scripts/lora_clip.sh`` sets it (synthetic-20, 2
   tasks, LoRA on both towers, every class visible, the default
   ``--transforms``, the batch prefetcher: 24 fused block forwards and
   backwards a step), lora-clip on ViT-L/14 (random weights; kernels #1/#2
   past 256 keys, their attention on the long warpgroup-MMA road; no
   augmentation), mvp-clip (online_iter 3, --use_mask
   --use_contrastiv) and MaPLe (online_iter 3, AdamW, lr 5e-4,
   ``scripts/maple.sh``) with the default ``--transforms``; the kernels'
   launch counters must grow in every pass (MaPLe train: 12 vision and 12
   text block forwards and backwards a step), every loss must be finite,
   mvp-clip's prompt counts must move and result.txt must exist. Then the
   prompted-LoRA path, which no registered method builds (``encode_image``
   with LoRA r=4 and (12, 64, 20, 768) raw KV prompts, bs 64,
   ``ce_on_probs_loss``, AdamW over LoRA and prompts): 3 train steps and
   one eval forward, 12 flash launches forward and 12 backward a step.
   Then the text prompt path (``text_prompt_phase``; no registered method
   passes text prompts): (12, 20, 512) KV-prefix prompts through
   ``encode_text`` on ViT-B/16's text tower over 100 class rows, alone and
   beside a text LoRA r=4, 10 AdamW steps fitting the class features to
   64 fixed image features under cross entropy, on the kernel road, the
   library road (bf16) and in fp32: each kernel-road step launches #3/#4
   12 + 12 times (with tile maps of the (77, 97) mask) without LoRA, #5/#6
   12 + 12 with it, nothing else; on the losses and on the prompts at the
   end the kernel road's distance from fp32 must be within
   ``WHOLE_RUN_MULTIPLE`` times the library road's; the device ms of a
   forward with and without the prompts, and of a step.
   Then adapter-clip and moe-clip as ``scripts/adapter_clip.sh`` sets them
   (image tower, online_iter 3; kernel #1 in all 12 vision blocks and #2,
   dx only, in blocks 1-11 of every step); an OpenAI-layout ViT-B/16
   checkpoint, its keys and shapes written out here from a seed (not from
   the converter's tables), saved with ``torch.save`` and read by
   ``models/convert.py`` onto the card, each tensor held to the file's by
   the reference layout and the patch kernel by its conv2d; continual-clip as
   ``scripts/continual_clip.sh`` sets it from that checkpoint
   (``--pretrained_path``) with ``--zero_shot_evaluation`` on synthetic-20,
   whose line must close result.txt; and continual-clip's eval throughput
   at test_batchsize 128 (the eval step alone, the text-cache pass and
   ``evaluate`` end to end). Then l2p, dualprompt and mvp as
   ``scripts/{l2p,dualprompt,mvp}.sh`` set them for cifar100
   (``vit_base_patch16_224``, bs 64, online_iter 3, Adam 5e-3; mvp with
   mask, contrastive, AFS and GSF) and ProtoCLIP
   (``adapter-clip-proto_prompt``, ViT-B/16, bs 64, online_iter 3) over two
   tasks: its stage 1, task-end sweeps, drift, CoPL advance, stage 2 (one
   epoch of its five) and the cached eval; every train step's launches
   exactly as ``STEP_LAUNCHES``. Then the ER family through ``main``: er,
   Finetuning, lwf and ewc++ as ``scripts/er.sh`` sets them (ViT-B/16, bs
   16 = 8 stream + 8 memory samples, memory 500, AdamW 3e-4, CutMix and
   AutoAugment, 5 tasks), clib as ``scripts/clib.sh synthetic-20`` sets it,
   and rm with ``--memory_epoch 2 --rm_uncertainty`` (2 tasks of
   synthetic-20x20, memory 128); every train step's launches exactly
   ``STEP_LAUNCHES`` (the frozen tower forward only; EWC++ two forwards;
   FT forward and backward with the weight grads in all 12 blocks). And
   continual-clip from a seeded OpenAI RN50-layout checkpoint (the
   ModifiedResNet tower on cuDNN; every tensor held to the file's) with
   zero-shot eval, and its eval throughput at test_batchsize 128.
6. Learning gates (bench.py:98-104): 22 steps of the ViT-B/16 lora-clip
   step (AutoAugment cifar10, as bench.py), the same with LoRA on both
   towers at 100 uncached class rows, the mvp-clip, MaPLe and
   prompted-LoRA steps, the ViT-L/14 lora-clip step and the adapter-clip
   and moe-clip steps, and the l2p, dualprompt, mvp and ProtoCLIP stage-1
   steps (built from their main paths' argv; MVP read on its cross entropy
   before GSF; ProtoCLIP on 8 classes of one solid colour each on a
   64-slot class table, its suffix pass at 64 x 512 tokens, ending 0.1
   below log 8 too), and the ER, FT (whole tower) and CLIB (clib.sh's
   cifar100 row: bs 64, AdamW 5e-3, weight decay 1e-4) steps on the
   synthetic set's images, on one batch lower the loss by more than 0.02;
   each
   prints step ms, samples/s and the peak
   device memory of its steps, then a torch.profiler window over 3 more
   steps (device ms a step by kernel, the device's idle share, the
   augmentation's device ms by its profiler range). The lora-clip,
   adapter-clip and moe-clip gates also count their launches (one fused
   forward a layer of each trained tower a step, and one backward, but for
   block 0 with the adapter or the MoE); the text tower's share of the
   both-tower step is its device time less the image-only step's.
7. Remat: the lora-clip and mvp-clip gate steps without remat and with it
   (each vision block, or mvp-clip's prompted tower, checkpointed), from
   the same seeds: bitwise equal loss and grads, a lower peak memory with
   remat for lora-clip, and each one's peak memory, device-busy ms and
   step ms.
8. Checkpoint: ``main`` runs lora-clip as ``scripts/lora_clip.sh`` sets
   it (as in 5) three times with ``--ckpt_dir``: uninterrupted, stopped
   right after task 0's checkpoint, and ``--resume_from`` that checkpoint;
   the resumed run's task-1 losses, result and final LoRA tensors must be
   bitwise those of the uninterrupted run. The same for moe-clip with
   ``scripts/adapter_clip.sh``'s flags, whose gate noise the resumed run
   must draw as the uninterrupted one does, for l2p (its frequency
   counter) and for ProtoCLIP (prototypes, covariances, task counter and
   the CoPL pools after the next task's advance and stage 2); since the ER
   family for ewc++ (Fisher, score, importance, task snapshot) and rm (the
   lr after its memory epochs, the memory and its generators, the view
   generator); every checkpoint phase also holds the memory and the lr.
9. Mesh (``mesh_phase``): two ranks sharing this one card in a gloo group
   over CUDA tensors (so no scaling is measured), at full ViT-B/16 width
   with augmentation off: 3 steps of lora-clip (``scripts/lora_clip.sh``),
   mvp-clip and Finetuning under ``--mesh 2x1``, one step of lora-clip
   (tensor parallel) and moe-clip (expert parallel) under ``--mesh 1x2``,
   each held against the 1-process step on the same card and batches
   (tolerances in ``mesh_phase``), then the lora-clip DP step in a
   one-rank nccl group; each prints its backend, step ms, all-reduce
   bytes and ms a step. The kernel phase times the per-rank shapes of
   2x1 (lora-clip's 32 rows, Finetuning's 8, mvp-clip's prefix at 32).
10. Pipeline (``pipeline_phase``): lora-clip's step with its vision tower
   in two stages of a ``--mesh 1x2`` (``parallel/pipeline.py``; two gloo
   ranks sharing this card, no scaling), 4 microbatches of 16 rows, the
   fused kernels #1/#2 in every stage: ViT-B/16 in fp32 (the loss at JAX's
   rtol 1e-5 against the 1-process step, the grads and leaves as the mesh
   phase holds a row split) and in bf16 (the mesh phase's witness rule),
   ViT-L/14 in bf16;
   each stage's launches of #1/#2, step and device ms, idle share beside
   the bubble share, and the ring permutes' bytes and ms; then a planted
   fault (the permute's backward dropped) that the check must catch. The
   kernel phase times #1/#2 at the microbatch shapes.
11. Whole runs (``whole_run_phase``): lora-clip, Finetuning and mvp-clip
   through ``main`` with their main paths' flags, three times each from the
   same seed and augmentation draws: the kernel road (bf16; the main path
   run of 5, its losses and eval accuracies recorded), the library road
   (``"unfused"``: cuBLAS and SDPA, no hand-written kernel, bf16; the
   trainer's class attribute set, no CLI flag) and the reference (the
   library road in fp32, ``--no_bf16``). Each path prints its step count,
   each bf16 road's distances from the reference (max |loss difference|
   over the first 10 steps, the mean-loss difference, the L2 distance of
   the trained leaves at the end), their ratios (kernel over library) and
   every eval accuracy of the three runs; the ratios of the first and the
   last must be within ``WHOLE_RUN_MULTIPLE``. Then lora-clip's kernel road
   with planted faults (the dx that the fused op's backward returns for
   its last vision block scaled): the sign flip must read at least five
   times the multiple, half the rows halved must fail the check.

Any failure raises and exits non-zero. Two lines before the last, the
script's wall seconds, each phase's (``phase_wall_s``, by ``clocked``) and
each kernel case's. The line before the last is the
``kernels`` JSON object (six kernels; each one's launches summed over
every main path of 5 and the sound steps of 9 and 10; the whole runs of 11
add none); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import datetime
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
REPLACES = {
    "fused_ln_attention_fwd":
        "lifelong_clip_tpu/ops/fused_block_attn.py:56",
    "fused_ln_attention_bwd":
        "lifelong_clip_tpu/ops/fused_block_attn.py:258",
    "fused_prefix_attention_fwd":
        "lifelong_clip_tpu/ops/fused_block_attn.py:524",
    "fused_prefix_attention_bwd":
        "lifelong_clip_tpu/ops/fused_block_attn.py:699",
    "flash_attention_fwd": "lifelong_clip_tpu/ops/flash_attention.py:32",
    "flash_attention_bwd": "lifelong_clip_tpu/ops/flash_attention.py:128",
}
MVP_SHAPE = (64, 197, 768, 12, 20)   # B, T, D, heads, prompt slots P
AUG_RANGE = "augmentation"           # torch.profiler range of the pipeline


def log(msg):
    print(msg, flush=True)


# where the script's wall time goes: each clocked phase's seconds summed
# over its outermost calls, and each kernel case's by its label
PHASE_WALL_S = {}
CASE_WALL_S = {}
_CLOCK_DEPTH = [0]


def clocked(fn):
    """Add the wall seconds of each outermost call of ``fn`` to
    ``PHASE_WALL_S`` under its name and, for a ``*_case`` function, to
    ``CASE_WALL_S`` under the label it is called with."""
    @functools.wraps(fn)
    def run(*a, **k):
        _CLOCK_DEPTH[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            _CLOCK_DEPTH[0] -= 1
            if not _CLOCK_DEPTH[0]:
                dt = time.perf_counter() - t0
                name = fn.__name__
                PHASE_WALL_S[name] = PHASE_WALL_S.get(name, 0.0) + dt
                if name.endswith("_case"):
                    label = k.get("label", a[0] if a else name)
                    CASE_WALL_S[label] = CASE_WALL_S.get(label, 0.0) + dt
    return run


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, iters=10, warmup=2):
    """Mean ms per call on the card (CUDA events around ``iters`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=10, warmup=2):
    """Mean host ms to enqueue one call (host clock, no synchronisation
    inside the loop): where it reaches the device time, the host sets the
    pace."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def busy_us(prof):
    """The union of the device kernels' intervals in a torch.profiler
    window, in us, and each kernel name's summed time; (None, {}) where the
    profiler saw no device time."""
    import torch
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != AUG_RANGE]
    if not kern:
        return None, {}
    busy, end, by_name = 0.0, -math.inf, {}
    for e in sorted(kern, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    return busy, by_name


def device_split(fn, iters=5, warmup=1):
    """Device-busy ms per call from torch.profiler (the time the device ran
    kernels, the gaps where it waited for the host left out) and each
    kernel name's ms per call; (None, {}) where the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy, by_name = busy_us(prof)
    if busy is None:
        return None, {}
    return busy / 1e3 / iters, {k: v / 1e3 / iters for k, v in by_name.items()}


def device_ms(fn, iters=5, warmup=1):
    """Device-busy ms per call (``device_split``); None where the profiler
    saw no device time."""
    return device_split(fn, iters, warmup)[0]


def device_sequence(fn, iters=5, warmup=1):
    """Every kernel one call of ``fn`` launches, in launch order, as [label,
    device ms] (torch.profiler, mean over ``iters`` calls); the port's
    GEMMs labelled by M, N, K in the order ``fn`` calls them, ``+ LoRA r=``
    where the launch forms the LoRA products too (``llc_gemm_lora``), and
    ``gemm rank-r tile`` where it runs on the mma.sync tiles
    (``gemm_kernel``). None where the profiler saw no device time or the
    calls launched different kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lifelong_clip_tpu_torch.ops import _kernels
    orig, gemms = _kernels.call, []

    def tagged(name, *a):
        if name == "llc_gemm":
            gemms.append(f"M={a[1]} N={a[2]} K={a[3]}")
        elif name == "llc_gemm_lora":
            gemms.append(f"M={a[1]} N={a[2]} K={a[3]} + LoRA r={a[14]}")
        return orig(name, *a)

    _kernels.call = tagged
    try:
        fn()
    finally:
        _kernels.call = orig
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not kern or len(kern) % iters:
        return None
    n = len(kern) // iters
    names = [kernel_short(e.name) for e in kern[:n]]
    if any(kernel_short(e.name) != names[i % n] for i, e in enumerate(kern)):
        return None
    tags = iter(gemms)
    return [[("gemm rank-r tile " if nm == "gemm_kernel" else "gemm ")
             + next(tags, "") if nm.startswith("gemm") else nm,
             sum(kern[c * n + i].time_range.elapsed_us()
                 for c in range(iters)) / iters / 1e3]
            for i, nm in enumerate(names)]


def kernel_short(name):
    """A profiler kernel name without ``void``, its namespace, template
    arguments and parameters: ``attn_bwd_dq_kernel``."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


def fmt(v, digits=3):
    return "not measured" if v is None else f"{v:.{digits}f}"


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def block_cost(b, t, d, heads, r, weight_grads, backward, es=2, pairs=None):
    """(flops, bytes) the function needs: each input read once, each output
    written once. ``pairs``: the (query, key) pairs the mask leaves live
    (default every one of T x T), the attention products this data needs
    (a dead pair has p = 0 exactly). The backward is the chain as a train
    step runs it: given x, the output grad and the forward's kept qkv16
    (with LoRA or weight_grads also h16 and ctx16, with LoRA z16 and z2), it
    recomputes none of the forward."""
    m = b * t
    # the attention's products: s and p v; s, dp, dv, dq and dk
    attn = attention_cost(b, t, d, heads, backward, pairs=pairs)[0]
    w_bytes = 4 * d * d * 2 + 5 * d * 4 + (2 * d * r + 4 * d * r) * 2
    if not backward:
        lora_fwd = 2 * m * r * (d + 3 * d + d + d)
        flops = 2 * m * d * 3 * d + attn + 2 * m * d * d + lora_fwd
        return flops, 2 * m * d * es + w_bytes
    flops = (2 * m * d * d                         # dctx
             + attn                                # s, dp, dv, dq, dk
             + 2 * m * 3 * d * d)                  # dh
    kept = 3 * m * d * 2                           # qkv16
    if r:   # dz2, dB_out, dA_out, dctx += , dz, dA_in, dB_in, dh +=
        flops += 2 * m * r * (d + d + d + d + 3 * d + d + 3 * d + d)
        kept += 2 * m * r * 2
    if r or weight_grads:
        kept += 2 * m * d * 2                      # h16, ctx16
    if weight_grads:
        flops += 2 * m * d * d + 2 * m * d * 3 * d
    out_bytes = m * d * es + (w_bytes if weight_grads else 6 * d * r * 4)
    return flops, 2 * m * d * es + kept + w_bytes + out_bytes


def prefix_cost(b, t, d, heads, p, live, weight_grads, backward, es=2,
                pairs=None, mask_bytes=0):
    """(flops, bytes) of the KV-prefix block for this run's data: only the
    ``live`` prefix slots need their K/V projections, scores and grads
    (dead slots contribute exact zeros); dpk and dpv are written whole.
    ``pairs``: the (query, key) pairs a row's mask leaves live (default
    every one of T x (live + T)), the attention products this data needs;
    ``mask_bytes``: the mask's, read once.
    The backward is the chain as a train step runs it: given x, the output
    grad and the forward's kept qkv16 and prefix K/V (with weight_grads
    also h16, ctx16 and the prompts), it recomputes none of the forward."""
    m, dh, s = b * t, d // heads, live + t
    bp = b * live
    pairs = t * s if pairs is None else pairs
    attn = 2 * b * heads * pairs * dh              # one T x S x dh product
    w_bytes = 4 * d * d * 2 + 5 * d * 4
    if not backward:
        proj = 2 * m * d * 3 * d + 2 * bp * d * 2 * d  # token qkv, prefix K/V
        flops = proj + 2 * attn + 2 * m * d * d
        return flops, (m * d * es + 2 * bp * d * es + w_bytes + mask_bytes
                       + m * d * es)
    flops = (2 * m * d * d                       # dctx
             + 5 * attn                          # s, dp, dv, dq, dk
             + 2 * m * 3 * d * d                 # dh
             + 2 * bp * 2 * d * d)               # dpk, dpv
    kept = 3 * m * d * 2 + 2 * bp * d * 2        # qkv16, live rows of kvp16
    out_bytes = m * d * es + 2 * b * p * d * es
    if weight_grads:
        flops += 2 * m * d * d + 2 * m * d * 3 * d + 2 * bp * d * 2 * d
        kept += 2 * m * d * 2 + 2 * bp * d * es  # h16, ctx16, live pk, pv
        out_bytes += w_bytes
    return flops, 2 * m * d * es + kept + w_bytes + mask_bytes + out_bytes


def bound_ms(flops, nbytes):
    tc, tb = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(tc, tb) * 1e3, ("operations" if tc >= tb else "bytes")


def library_block(x, blk, lora, s, mask, heads):
    """LN + linear + scaled_dot_product_attention + linear: the yardstick."""
    import torch
    import torch.nn.functional as F
    b, t, d = x.shape
    h = F.layer_norm(x, (d,), blk["ln_scale"], blk["ln_bias"], 1e-5)
    qkv = F.linear(h, blk["w_qkv_t"], blk["b_qkv"])
    if lora is not None:
        qkv = qkv + s * F.linear(F.linear(h, lora["a_in_t"]), lora["b_in_t"])
    q, k, v = (a.reshape(b, t, heads, d // heads).transpose(1, 2)
               for a in qkv.split(d, dim=-1))
    am = None if mask is None else mask.to(x.dtype)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    ctx = ctx.transpose(1, 2).reshape(b, t, d)
    out = F.linear(ctx, blk["w_out_t"], blk["b_out"])
    if lora is not None:
        out = out + s * F.linear(F.linear(ctx, lora["a_out_t"]),
                                 lora["b_out_t"])
    return x + out


def library_prefix_block(x, pk, pv, blk, mask, heads):
    """LN + linear (tokens and prompts) + scaled_dot_product_attention over
    the concatenated keys and values + linear: the prefix yardstick."""
    import torch
    import torch.nn.functional as F
    b, t, d = x.shape
    h = F.layer_norm(x, (d,), blk["ln_scale"], blk["ln_bias"], 1e-5)
    w, bq = blk["w_qkv_t"], blk["b_qkv"]
    q, k, v = F.linear(h, w, bq).split(d, dim=-1)
    k = torch.cat([F.linear(pk, w[d:2 * d], bq[d:2 * d]), k], 1)
    v = torch.cat([F.linear(pv, w[2 * d:], bq[2 * d:]), v], 1)
    q, k, v = (a.reshape(b, -1, heads, d // heads).transpose(1, 2)
               for a in (q, k, v))
    am = None if mask is None else mask.to(x.dtype)
    if am is not None and am.dim() == 1:
        am = am.reshape(1, -1)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    ctx = ctx.transpose(1, 2).reshape(b, t, d)
    return x + F.linear(ctx, blk["w_out_t"], blk["b_out"])


def launch_breakdown(run_fwd, run_bwd, reps=3):
    """Device ms of each launch in one forward and one backward chain, from
    CUDA events around every call into the kernel library (GEMMs labelled
    by M, N, K; where the device waits for the host, the gap counts), and
    the host ms of each call (``host_fwd``, ``host_bwd``), averaged over
    ``reps`` runs."""
    import torch
    from lifelong_clip_tpu_torch.ops import _kernels
    orig = _kernels.call
    rec = []

    def evented(name, *a):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        t0 = time.perf_counter()
        orig(name, *a)
        host = time.perf_counter() - t0
        e.record()
        tag = name[4:] if name != "llc_gemm" else \
            f"gemm M={a[1]} N={a[2]} K={a[3]}"
        rec.append((phase, tag, s, e, host))

    _kernels.call = evented
    try:
        with torch.no_grad():
            for _ in range(reps):
                phase = "fwd"
                run_fwd()
                phase = "bwd"
                run_bwd()
    finally:
        _kernels.call = orig
    torch.cuda.synchronize()
    out = {"fwd": {}, "bwd": {}, "host_fwd": {}, "host_bwd": {}}
    for ph, tag, s, e, host in rec:
        out[ph][tag] = out[ph].get(tag, 0.0) + s.elapsed_time(e) / reps
        h = out[f"host_{ph}"]
        h[tag] = h.get(tag, 0.0) + host * 1e3 / reps
    return out


def attention_cost(b, t, d, heads, backward, pairs=None, keys=None):
    """(flops, bytes) of the chains' attention alone: the forward's 2
    products (scores, p v) or the backward's 5 (scores, dp, dv, dq, dk) of
    2 x (live pairs) x dh each, for every (batch row, head), over ``pairs``
    live (query, key) pairs where a mask kills the rest (default every one
    of T x ``keys``; ``keys`` default T); bytes: q, k and v read once and
    ctx16 written (forward), or q, k, v and dctx16 read and dq, dk and dv
    written (backward), bf16, nothing else (weight_grads off)."""
    dh, s = d // heads, t if keys is None else keys
    pairs = t * s if pairs is None else pairs
    flops = (5 if backward else 2) * 2 * b * heads * pairs * dh
    rows = (2 * (t + 2 * s) + t) if backward else (2 * t + 2 * s)
    return flops, rows * b * d * 2


# The launch counters of #1/#2's warpgroup-MMA attention, forward and
# backward, by road (``fba.attention_road``)
WGMMA_ROAD_KEYS = {"wgmma": ("attn_fwd_wgmma", "attn_bwd_wgmma"),
                   "wgmma_long": ("attn_fwd_wgmma_long",
                                  "attn_bwd_wgmma_long")}
WGMMA_ROAD_KERNELS = {"wgmma": ("attn_fwd_wgmma_kernel",
                                "attn_bwd_wgmma_kernel"),
                      "wgmma_long": ("attn_fwd_wgmma_long_kernel",
                                     "attn_bwd_wgmma_long_kernel")}


def wgmma_road(fba, t, d, heads, mask):
    """The warpgroup-MMA attention road #1/#2 take: "wgmma" (no mask, head
    dim 64, up to 256 keys), "wgmma_long" (the same past 256 keys up to
    ``fba.WGMMA_LONG_TMAX``) or None (the mma.sync kernels)."""
    road = fba.attention_road(t, d // heads,
                              None if mask is None else "matrix")
    return None if road == "mma_sync" else road


def prefix_wgmma_road(fba, p, t, d, heads, mask):
    """Whether #3/#4 take the warpgroup-MMA attention kernels (a key-mask
    row, head dim 64, P + T <= 256 keys)."""
    kind = None if mask is None else (
        "matrix" if fba._prefix_mask_arg(mask, t, p + t, mask.device)[1]
        else "row")
    return fba.prefix_wgmma_road(p, t, d // heads, kind)


def assert_wgmma_road(label, res, road, fwd, bwd, tries=3):
    """#1's and #2's attention on the warpgroup-MMA road ``road``: one
    launch of its forward kernel (attn_fwd_wgmma_kernel, or
    attn_fwd_wgmma_long_kernel past 256 keys) in the forward chain, one of
    its backward kernel in the backward chain, and none of the mma.sync
    kernels (the register roads' and the tiled roads'), by the kernels the
    profiler saw in each chain (``fwd`` and ``bwd`` run it again, up to
    ``tries`` windows in all, where a window saw no chain; past 256 keys a
    chain never seen fails)."""
    import torch
    for _ in range(tries - 1):
        if res.get("forward_chain_split") and res.get("chain_split"):
            break
        log(f"{label}: the chains' kernels not seen by the profiler; "
            f"another window")
        with torch.no_grad():
            res["forward_chain_split"] = (res.get("forward_chain_split")
                                          or device_sequence(fwd))
        res["chain_split"] = res.get("chain_split") or device_sequence(bwd)
    fwd_names = [nm for nm, _ in res.get("forward_chain_split") or ()]
    bwd_names = [nm for nm, _ in res.get("chain_split") or ()]
    if not fwd_names or not bwd_names:
        assert road != "wgmma_long", \
            f"{label}: the chains' kernels not seen in {tries} windows"
        log(f"{label}: the chains' kernels not seen by the profiler")
        return
    old = ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel",
           "attn_fwd_tiled_kernel", "attn_bwd_dq_tiled_kernel")
    fk, bk = WGMMA_ROAD_KERNELS[road]
    assert fwd_names.count(fk) == 1, (label, fwd_names)
    assert bwd_names.count(bk) == 1, (label, bwd_names)
    assert not any(nm in old for nm in fwd_names + bwd_names), \
        (label, fwd_names, bwd_names)


@clocked
def kernel_case(label, b, t, d, heads, lora_r, masked, weight_grads, seed,
                time_it=True, library_parts=False):
    """#1/#2 at one shape: checked against the plain versions, and with
    ``time_it`` timed beside them and the library yardstick (with
    ``library_parts`` the yardstick's forward and backward launch by
    launch too)."""
    import torch
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    x, blk, lora, gy, mask = kc.make_inputs(b, t, d, heads, lora_r, masked,
                                            seed)
    s = 0.25 if lora_r else 0.0
    road = wgmma_road(fba, t, d, heads, mask)
    before = dict(fba.LAUNCHES)
    # the (query, key) pairs the causal mask leaves live, and what its tile
    # map leaves the kernels
    pairs = None if mask is None else int((~torch.isneginf(mask)).sum())
    live_tiles = None if mask is None else tile_liveness(mask, t, 0)
    if live_tiles:
        log(f"{label}: live of the road under the tile map "
            f"{json.dumps(live_tiles)}")
    args = (blk["ln_scale"], blk["ln_bias"], blk["w_qkv"], blk["b_qkv"],
            blk["w_out"], blk["b_out"], heads, s, mask, lora)
    bargs = (blk["ln_scale"], blk["ln_bias"], blk["w_qkv"], blk["b_qkv"],
             blk["w_out"], heads, s, mask, lora, weight_grads)
    # the op forward and backward through autograd, each output held to its
    # plain version on the part the kernels compute (kernel_check.py)
    checks = kc.check_case(x, blk, lora, gy, mask, heads, s, weight_grads)
    torch.cuda.synchronize()
    errs = {k: v["max_abs_err"] for k, v in checks.items()
            if isinstance(v, dict) and "max_abs_err" in v}
    fwd_err = max(v for k, v in errs.items() if k in ("y", "qkv"))
    bwd_err = max(v for k, v in errs.items() if k not in ("y", "qkv"))
    log(f"{label}: checks {json.dumps(checks)}")
    res = {"label": label, "shape": [b, t, d], "heads": heads,
           "lora_r": lora_r, "masked": masked, "weight_grads": weight_grads,
           "live_pairs_per_row": pairs, "tile_liveness": live_tiles,
           "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err}
    # the op's launches of the warpgroup-MMA attention: one a chain on its
    # road, none on the other road or off both
    ran = {k: fba.LAUNCHES[k] - before[k]
           for keys in WGMMA_ROAD_KEYS.values() for k in keys}
    res["wgmma_road"], res["wgmma_launches"] = road, ran
    want = WGMMA_ROAD_KEYS.get(road, ())
    assert all((n > 0) == (k in want) for k, n in ran.items()), (label, ran)
    if lora_r or road:
        # no float atomics (the LoRA grads from fixed-order partials; the
        # warpgroup-MMA attention's sums in a fixed order): two runs on the
        # same inputs agree bit for bit, every output on that road
        one, two = (kc.block_outputs(x, blk, lora, s, gy, mask, heads,
                                     weight_grads=weight_grads)
                    for _ in range(2))
        keys = list(one) if road else [f"d{k}" for k in lora]
        res["bitwise_repeatable"] = {k: kc.same_bits(one[k], two[k])
                                     for k in keys}
        log(f"{label}: bit for bit over two runs: "
            f"{json.dumps(res['bitwise_repeatable'])}")
        assert all(res["bitwise_repeatable"].values()), label
    fl, by = block_cost(b, t, d, heads, lora_r, weight_grads, False,
                        pairs=pairs)
    res["fwd_bound_ms"], res["fwd_bound_by"] = bound_ms(fl, by)
    fl, by = block_cost(b, t, d, heads, lora_r, weight_grads, True,
                        pairs=pairs)
    res["bwd_bound_ms"], res["bwd_bound_by"] = bound_ms(fl, by)
    if not time_it:
        return res

    ll = None if lora is None else {
        "a_in_t": lora["a_in"].T.contiguous(),
        "b_in_t": lora["b_in"].T.contiguous(),
        "a_out_t": lora["a_out"].T.contiguous(),
        "b_out_t": lora["b_out"].T.contiguous()}
    lb = library_weights(blk)
    wrt = [x.detach().clone().requires_grad_(True)] + (
        [] if ll is None else [a.requires_grad_(True) for a in ll.values()])
    if weight_grads:
        # the yardstick's autograd computes the same weight and LN grads
        lb = {k: v.detach().clone().requires_grad_(k in LIBRARY_WEIGHTS)
              for k, v in lb.items()}
        wrt += [lb[k] for k in LIBRARY_WEIGHTS]
    res["attn_fwd_bound_ms"] = bound_ms(
        *attention_cost(b, t, d, heads, False, pairs=pairs))[0]
    res["attn_bwd_bound_ms"] = bound_ms(
        *attention_cost(b, t, d, heads, True, pairs=pairs))[0]
    # the backward as a train step runs it: reading the forward's kept
    # intermediates
    kept = fba._keep_for_backward(fba._cuda_forward(x, *args, keep=True)[1],
                                  weight_grads)

    def fwd():
        return fba._cuda_forward(x, *args)

    def bwd():
        return fba._cuda_backward(x, gy, *bargs, saved=kept)

    res = time_case(
        label, res, fwd,
        lambda: fba.fused_ln_attention_block_reference(x, *args), bwd,
        lambda: fba.fused_ln_attention_block_reference_bwd(x, gy, *bargs),
        lambda xg, *_: library_block(xg, lb, ll, s, mask, heads), wrt, gy,
        library_parts)
    if road:
        assert_wgmma_road(label, res, road, fwd, bwd)
    if 0 < lora_r <= fba.FOLD_RMAX and d % fba.FOLD_DMULT == 0:
        assert_lora_folded(label, res, fwd, bwd)
    return res


def kernel_calls(fn):
    """The kernel library's entry points one call of ``fn`` goes through,
    in order, with their arguments."""
    from lifelong_clip_tpu_torch.ops import _kernels
    orig, calls = _kernels.call, []

    def record(name, *a):
        calls.append((name, a))
        return orig(name, *a)

    _kernels.call = record
    try:
        fn()
    finally:
        _kernels.call = orig
    return calls


def assert_lora_folded(label, res, fwd, bwd):
    """#1's and #2's LoRA chains form the rank-r products inside the GEMMs
    that stream their operands: no GEMM on the rank-r tiles (``llc_gemm``
    with M or N <= 16, ``gemm_kernel``) and none split over K (its sum,
    ``splitk_reduce_kernel``) in either chain, by the entry points each
    chain calls and, where the profiler saw them, by its kernels."""
    calls = kernel_calls(fwd) + kernel_calls(bwd)
    bad = [f"llc_gemm M={a[1]} N={a[2]} splits={a[25]}"
           for name, a in calls
           if name == "llc_gemm" and (min(a[1], a[2]) <= 16 or a[25] > 1)]
    names = [nm for chain in (res["forward_chain_split"], res["chain_split"])
             for nm, _ in chain or ()]
    bad += [nm for nm in names
            if "rank-r tile" in nm or nm == "splitk_reduce_kernel"]
    assert not bad, (label, bad)
    log(f"{label}: LoRA folded: no rank-r tile and no split-K sum in "
        f"{len(calls)} entry points ({', '.join(n for n, _ in calls)})"
        + (f", {len(names)} kernels" if names else
           ", kernels not seen by the profiler"))


LIBRARY_WEIGHTS = ("ln_scale", "ln_bias", "w_qkv_t", "b_qkv", "w_out_t",
                   "b_out")


def library_weights(blk):
    """The yardstick's block weights in F.linear's (out, in) layout."""
    return dict(blk, w_qkv_t=blk["w_qkv"].T.contiguous(),
                w_out_t=blk["w_out"].T.contiguous())


def time_case(label, res, fwd, plain_fwd, bwd, plain_bwd, library, wrt, gy,
              library_parts=False):
    """Time a case's kernel chains, their plain versions and the library
    yardstick (``library(*wrt)``; its backward is autograd of it w.r.t.
    ``wrt`` minus its forward) by CUDA events and, for the chains and the
    yardstick, by device-busy time; break the chains down by launch (with
    ``library_parts`` the yardstick's too), log and return ``res`` with the
    times."""
    import torch
    with torch.no_grad():
        res["fwd_host_ms"] = host_ms(fwd)
        res["fwd_ms"] = timed(fwd)
        res["fwd_plain_ms"] = timed(plain_fwd, iters=3)
        res["fwd_library_ms"] = timed(lambda: library(*wrt))
        res["fwd_device_ms"], names = device_split(fwd)
        # the forward's attention kernel by device ms a call
        res["fwd_attention_device_ms"] = {
            kernel_short(k): v for k, v in names.items()
            if "attn_fwd" in k or "flash_fwd" in k}
        res["fwd_library_device_ms"] = device_ms(lambda: library(*wrt))
        # every launch of the forward chain, in order, by device ms a call
        res["forward_chain_split"] = device_sequence(fwd)
    log(f"{label}: forward chain by launch, device ms "
        f"{json.dumps(res['forward_chain_split'])}")
    res["bwd_ms"] = timed(bwd)
    res["bwd_plain_ms"] = timed(plain_bwd, iters=3)
    res["bwd_device_ms"], names = device_split(bwd)
    # the attention backward's kernels (dq, dk/dv) by device ms a call
    res["bwd_attention_device_ms"] = {
        kernel_short(k): v for k, v in names.items()
        if "attn_bwd" in k or "flash_bwd" in k}
    # every launch of the backward chain, in order, by device ms a call
    res["chain_split"] = device_sequence(bwd)
    log(f"{label}: backward chain by launch, device ms "
        f"{json.dumps(res['chain_split'])}")

    def lib_fwd_bwd():
        torch.autograd.grad(library(*wrt), wrt, gy)

    res["bwd_library_ms"] = max(timed(lib_fwd_bwd) - res["fwd_library_ms"],
                                0.0)
    both, lib_fwd = device_ms(lib_fwd_bwd), res["fwd_library_device_ms"]
    res["bwd_library_device_ms"] = None if both is None or lib_fwd is None \
        else max(both - lib_fwd, 0.0)
    if library_parts:
        # the yardstick launch by launch: its forward, and its backward
        # alone (autograd over one kept forward graph)
        with torch.no_grad():
            res["library_forward_by_launch"] = device_sequence(
                lambda: library(*wrt))
        out = library(*wrt)
        res["library_backward_by_launch"] = device_sequence(
            lambda: torch.autograd.grad(out, wrt, gy, retain_graph=True))
        del out
        log(f"{label}: library forward by launch, device ms "
            f"{json.dumps(res['library_forward_by_launch'])}; backward "
            f"{json.dumps(res['library_backward_by_launch'])}")
    res["breakdown"] = launch_breakdown(fwd, bwd)
    log(f"{label}: per-launch device ms {json.dumps(res['breakdown'])}")
    log(f"{label}: fwd {res['fwd_ms']:.3f} ms (host {res['fwd_host_ms']:.3f}, "
        f"plain {res['fwd_plain_ms']:.3f},"
        f" library {res['fwd_library_ms']:.3f}, bound "
        f"{res['fwd_bound_ms']:.4f}); bwd {res['bwd_ms']:.3f} ms (plain "
        f"{res['bwd_plain_ms']:.3f}, library {res['bwd_library_ms']:.3f}, "
        f"bound {res['bwd_bound_ms']:.4f}); device busy fwd "
        f"{fmt(res['fwd_device_ms'])} (library "
        f"{fmt(res['fwd_library_device_ms'])}), bwd "
        f"{fmt(res['bwd_device_ms'])} (library "
        f"{fmt(res['bwd_library_device_ms'])}); attention device ms "
        f"forward {json.dumps(res['fwd_attention_device_ms'])}"
        + (f" (bound {res['attn_fwd_bound_ms']:.4f})"
           if "attn_fwd_bound_ms" in res else "")
        + f", backward {json.dumps(res['bwd_attention_device_ms'])}"
        + (f" (bound {res['attn_bwd_bound_ms']:.4f})"
           if "attn_bwd_bound_ms" in res else ""))
    return res


@clocked
def prefix_kernel_case(label, live, weight_grads, seed, time_it=True,
                       shape=MVP_SHAPE, shared=False, mask=None):
    """The KV-prefix block at ``shape`` (B, T, D, heads, P; the mvp-clip
    shape by default) with ``live`` of P prompt slots live (``shared``: one
    prompt tensor as pk and pv, as mvp-clip passes them; ``mask``: a (T, P +
    T) mask in place of the key row, with every prefix slot live): checked
    through the op's autograd Function and, with ``time_it``, timed beside
    its plain version and the yardstick."""
    import torch
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    b, t, d, heads, p = shape
    x, pk, pv, blk, gy, row = kc.make_prefix_inputs(b, t, d, heads, p, live,
                                                    seed, shared=shared)
    assert mask is None or live == p
    mask = row if mask is None else mask
    # the (query, key) pairs the mask leaves live in a row
    pairs = int((~torch.isneginf(torch.broadcast_to(
        mask, (t, p + t)))).sum())
    args = (pk, pv, *[blk[k] for k in kc.BLOCK_KEYS], heads, mask)
    bargs = (pk, pv, *[blk[k] for k in kc.BLOCK_KEYS[:5]], heads, mask,
             weight_grads)
    road = prefix_wgmma_road(fba, p, t, d, heads, mask)
    before = dict(fba.LAUNCHES)
    checks = kc.check_prefix_case(x, pk, pv, blk, gy, mask, heads,
                                  weight_grads)
    torch.cuda.synchronize()
    errs = {k: v["max_abs_err"] for k, v in checks.items()
            if "max_abs_err" in v}
    log(f"{label}: checks {json.dumps(checks)}")
    live_tiles = tile_liveness(mask, t, p) if mask.dim() == 2 else None
    if live_tiles:
        log(f"{label}: live of the road under the tile map "
            f"{json.dumps(live_tiles)}")
    res = {"label": label, "shape": [b, t, d], "heads": heads, "prompts": p,
           "live": live, "weight_grads": weight_grads, "shared": shared,
           "live_pairs_per_row": pairs, "tile_liveness": live_tiles,
           "fwd_max_abs_err": errs["y"],
           "bwd_max_abs_err": max(v for k, v in errs.items() if k != "y")}
    # the op's launches of the warpgroup-MMA attention: one a chain on its
    # road (a key-mask row), none off it
    ran = [fba.LAUNCHES[k] - before[k]
           for k in ("attn_prefix_fwd_wgmma", "attn_prefix_bwd_wgmma")]
    res["wgmma_road"], res["wgmma_launches"] = road, ran
    assert all(n > 0 for n in ran) if road else ran == [0, 0], (label, ran)
    if road:
        # the warpgroup-MMA attention's sums in a fixed order: two runs on
        # the same inputs agree bit for bit (ctx16, dqkv16, dkvp16 and the
        # weight grads' bias partials)
        one, two = (kc.prefix_attention_outputs(x, pk, pv, blk, gy, mask,
                                                heads) for _ in range(2))
        res["bitwise_repeatable"] = {k: kc.same_bits(one[k], two[k])
                                     for k in one}
        log(f"{label}: bit for bit over two runs: "
            f"{json.dumps(res['bitwise_repeatable'])}")
        assert all(res["bitwise_repeatable"].values()), label
        del one, two
    for pre, bwd in (("fwd", False), ("bwd", True)):
        fl, by = prefix_cost(b, t, d, heads, p, live, weight_grads, bwd,
                             pairs=pairs, mask_bytes=mask.numel() * 4)
        res[f"{pre}_bound_ms"], res[f"{pre}_bound_by"] = bound_ms(fl, by)
    if not time_it:
        return res

    lb = library_weights(blk)
    res["attn_fwd_bound_ms"] = bound_ms(*attention_cost(
        b, t, d, heads, False, pairs=pairs, keys=live + t))[0]
    res["attn_bwd_bound_ms"] = bound_ms(*attention_cost(
        b, t, d, heads, True, pairs=pairs, keys=live + t))[0]
    kept = fba._keep_for_prefix_backward(
        fba._cuda_prefix_forward(x, *args, keep=True)[1], weight_grads)

    def fwd():
        return fba._cuda_prefix_forward(x, *args)

    def bwd():
        return fba._cuda_prefix_backward(x, gy, *bargs, saved=kept)

    res = time_case(
        label, res, fwd,
        lambda: fba.fused_prefix_attention_block_reference(x, *args), bwd,
        lambda: fba.fused_prefix_attention_block_reference_bwd(x, gy, *bargs),
        lambda *a: library_prefix_block(*a, lb, mask, heads),
        [a.detach().clone().requires_grad_(True) for a in (x, pk, pv)], gy)
    if road:
        # the key-row instances of the short road's kernels
        assert_wgmma_road(label, res, "wgmma", fwd, bwd)
    return res


@clocked
def text_prompt_prefix_case():
    """#3/#4 at the shape the text prompt path (``text_prompt_phase``)
    gives them without LoRA: K = 100 class rows x 77 tokens, 512 wide, 8
    heads, P = 20 slots, one prompt tensor as pk and pv (as ``_block``
    passes ``encode_text``'s prompts), the causal mask with the 20 prompts
    always visible, (77, 97)."""
    from lifelong_clip_tpu_torch.ops.attention import causal_mask
    return prefix_kernel_case(
        "text prompts K=100, P=20, causal", TP_SLOTS, False, 35,
        shape=(TP_CLASSES, 77, 512, 8, TP_SLOTS), shared=True,
        mask=causal_mask(77, prefix=TP_SLOTS, device="cuda"))


@clocked
def proto_main_suffix_cases():
    """ProtoCLIP's suffix pass at the shapes its main path (``PROTO_ARGV``:
    synthetic-20, 20 class slots, S = 8, lp = 25) gives #3/#4: stage 1's and
    stage 2's 64 rows and the eval cache's 90 prompt combinations, each of
    20 x 8 = 160 tokens under the block-diagonal causal (160, 185) mask,
    which takes the register road (S <= 256)."""
    from lifelong_clip_tpu_torch.models.proto_clip import suffix_mask
    mask = suffix_mask(20, 8, 25, device="cuda")
    return [prefix_kernel_case(
        f"ProtoCLIP suffix (main path), {b} x 20 x 8, lp = 25", 25, False,
        seed, time_it=time_it, shape=(b, 160, 512, 8, 25), shared=True,
        mask=mask) for b, seed, time_it in ((64, 24, True), (90, 25, False))]


def tile_liveness(mask, t, p):
    """What the tile map of a (T, P + T) mask (P = 0: the block kernels'
    (T, T) mask) leaves the attention kernels, as
    [live, total]: the tiled roads' 64-key tiles of each 64-query tile, the
    16 x 16 blocks (the tiled roads' warps and the register roads' warp
    pairs walk these), and the dk/dv kernel's 32-query steps of each 16-key
    group; and the road S = P + T takes."""
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    buf = fba.mask_tile_map(mask)
    tm = fba.unpack_tile_map(buf, t, p + t)[0].bool().cpu()
    nrb, nkb = tm.shape
    nk = -(-(p + t) // 64)
    tiles = [bool(tm[q:q + 4, 4 * k:4 * k + 4].any())
             for q in range(0, nrb, 4) for k in range(nk)]
    steps = [bool(tm[r:r + 2, g].any())
             for g in range(nkb) for r in range(0, nrb, 2)]
    return {"road": "tiled" if 16 * nkb > 256 else "register",
            "key_tiles_64": [sum(tiles), len(tiles)],
            "blocks_16x16": [int(tm.sum()), nrb * nkb],
            "dkv_steps_32": [sum(steps), len(steps)]}


@clocked
def tile_map_phase():
    """ProtoCLIP's suffix pass at K4 (64 x 512 x 512) and at its main path's
    shape (64 x 160 x 512), the inputs of the kernel phase's cases: the
    prefix attention kernels with the mask's tile map and with a null map
    (every block swept) give ctx, dqkv, dkvp and the bias partials bit for
    bit equal (a difference raises), and each chain's device ms both ways in this run,
    with the attention kernels' and the map kernel's own. Then #1/#2 under
    the causal (T, T) mask at the kernel phase's ``text K=100 LoRA`` and K3
    inputs: ctx, y, dx and the LoRA grads bit for bit equal both ways."""
    import torch
    from lifelong_clip_tpu_torch.models.proto_clip import suffix_mask
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    out = []
    for label, c, seed in (("K4 suffix, 64 x 512 x 512", 64, 23),
                           ("main-path suffix, 64 x 160 x 512", 20, 24)):
        t, p, heads = 8 * c, 25, 8
        mask = suffix_mask(c, 8, p, device="cuda")
        x, pk, pv, blk, gy, _ = kc.make_prefix_inputs(64, t, 512, heads, p, p,
                                                      seed, shared=True)
        skip, full = (kc.prefix_attention_outputs(x, pk, pv, blk, gy, mask,
                                                  heads, tile_map=m)
                      for m in (True, False))
        differ = [k for k in skip if not kc.same_bits(skip[k], full[k])]
        res = {"label": label, "tile_liveness": tile_liveness(mask, t, p),
               "bitwise_equal": not differ, "differ": differ}
        args = (pk, pv, *[blk[k] for k in kc.BLOCK_KEYS], heads, mask)
        bargs = (*args[:7], heads, mask, False)
        for name, tm in (("map", True), ("null_map", False)):
            kept = fba._keep_for_prefix_backward(fba._cuda_prefix_forward(
                x, *args, keep=True, tile_map=tm)[1], False)
            res[f"fwd_device_ms_{name}"], fsplit = device_split(
                lambda: fba._cuda_prefix_forward(x, *args, tile_map=tm))
            res[f"bwd_device_ms_{name}"], bsplit = device_split(
                lambda: fba._cuda_prefix_backward(x, gy, *bargs, saved=kept,
                                                  tile_map=tm))
            res[f"kernels_device_ms_{name}"] = {
                f"{d} {kernel_short(k)}": v
                for d, sp in (("fwd", fsplit), ("bwd", bsplit))
                for k, v in sp.items() if "attn" in k or "tile_map" in k}
        log(f"tile map: {json.dumps(res)}")
        assert not differ, f"{label}: the tile map changed {differ}"
        out.append(res)
    # #1/#2 under the text tower's causal mask: lora-clip's text tower
    # (both towers, 100 class rows) and ProtoCLIP's K3 text prefix
    for label, b, t, r, seed in (("text K=100 LoRA", 100, 77, 4, 16),
                                 ("K3 text prefix, T = 25", 64, 25, 0, 20)):
        x, blk, lora, gy, mask = kc.make_inputs(b, t, 512, 8, r, True, seed)
        s = 0.25 if r else 0.0
        skip, full = (kc.block_outputs(x, blk, lora, s, gy, mask, 8,
                                       tile_map=m) for m in (True, False))
        differ = [k for k in skip if not kc.same_bits(skip[k], full[k])]
        res = {"label": label, "tile_liveness": tile_liveness(mask, t, 0),
               "bitwise_equal": not differ, "differ": differ,
               "compared": sorted(skip)}
        wb = [blk[k] for k in kc.BLOCK_KEYS]
        args = (*wb, 8, s, mask, lora)
        bargs = (*wb[:5], 8, s, mask, lora, False)
        for name, tm in (("map", True), ("null_map", False)):
            kept = fba._keep_for_backward(fba._cuda_forward(
                x, *args, keep=True, tile_map=tm)[1], False)
            res[f"fwd_device_ms_{name}"], fsplit = device_split(
                lambda: fba._cuda_forward(x, *args, tile_map=tm))
            res[f"bwd_device_ms_{name}"], bsplit = device_split(
                lambda: fba._cuda_backward(x, gy, *bargs, saved=kept,
                                           tile_map=tm))
            res[f"kernels_device_ms_{name}"] = {
                f"{d} {kernel_short(k)}": v
                for d, sp in (("fwd", fsplit), ("bwd", bsplit))
                for k, v in sp.items() if "attn" in k}
        # the map kernel alone: one launch a tower pass (fba._tile_map)
        res["tile_map_device_ms"] = device_ms(lambda: fba.mask_tile_map(mask))
        log(f"tile map: {json.dumps(res)}")
        assert not differ, f"{label}: the tile map changed {differ}"
        out.append(res)
    return out


@clocked
def batch_invariance_phase():
    """The rows of the ER family's small batches (8 and 16 rows, where the
    attention kernels split each (head, batch row) over blocks, and one)
    against the same rows inside a 64-row batch (unsplit), the same for
    ViT-L/14's vision block (the long warpgroup-MMA road), and the text
    tower's 20 and 64 class rows (causal, LoRA r=4, under the mask's tile
    map) against the same rows inside its 100: ctx, y and dx of the #1/#2
    chains bit for bit (a difference raises); then 1, 8 and 16 rows of
    the KV-prefix attention at mvp-clip's shape against its 64."""
    import torch
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    out = []
    for label, shape, r, causal, parts, seed in (
            ("vision", (64, 197, 768, 12), 0, False, (1, 8, 16), 32),
            ("ViT-L/14 vision", (64, 257, 1024, 16), 0, False, (1, 8, 16),
             38),
            ("text, causal, LoRA r=4", (100, 77, 512, 8), 4, True, (20, 64),
             36)):
        t0 = time.perf_counter()
        b, t, d, heads = shape
        x, blk, lora, gy, mask = kc.make_inputs(b, t, d, heads, r, causal,
                                                seed)
        s = 0.25 if r else 0.0
        whole = kc.batch_rows(x, blk, gy, heads, lora, s, mask)
        for n in parts:
            part = kc.batch_rows(x[:n], blk, gy[:n], heads, lora, s, mask)
            torch.cuda.synchronize()
            differ = [k for k in part
                      if not kc.same_bits(part[k], whole[k][:n])]
            res = {"block": label, "rows": n, "of": b,
                   "bitwise_equal": not differ, "differ": differ}
            log(f"batch invariance: {json.dumps(res)}")
            assert not differ, \
                f"{label}, {n} of {b} rows: the batch changed {differ}"
            out.append(res)
        CASE_WALL_S[f"batch invariance: {label}"] = time.perf_counter() - t0
    # #3/#4's attention at mvp-clip's shape (P = 20, 5 live; the
    # warpgroup-MMA kernels under the key row): ctx16, the tokens' dqkv16
    # and the prefix rows' dkvp16
    b, t, d, heads, p = MVP_SHAPE
    x, pk, pv, blk, gy, row = kc.make_prefix_inputs(b, t, d, heads, p, 5, 37)
    whole = kc.prefix_attention_outputs(x, pk, pv, blk, gy, row, heads)
    for n in (1, 8, 16):
        part = kc.prefix_attention_outputs(x[:n], pk[:n], pv[:n], blk, gy[:n],
                                           row, heads)
        torch.cuda.synchronize()
        differ = [k for k, rows in (("ctx16", t), ("dqkv16", t),
                                    ("dkvp16", p))
                  if not kc.same_bits(part[k], whole[k][:n * rows])]
        res = {"block": "mvp prefix, P = 20, 5 live", "rows": n, "of": b,
               "bitwise_equal": not differ, "differ": differ}
        log(f"batch invariance: {json.dumps(res)}")
        assert not differ, f"mvp prefix, {n} of {b} rows: {differ}"
        out.append(res)
    return out


# (label, B, T, S, D, heads, mask): the prompted-LoRA block of ViT-B/16
# (20 raw KV prompt slots, S = 217) with no mask and with mvp-clip's (S,)
# key row of 5 live slots; the text tower's causal shape; ViT-L/14 with no
# prefix, S = 257 > 256 (no key limit), and S = 700 (a long prefix, as
# ProtoCLIP's grows with its classes): the bf16 forward's tiled road; the
# text tower with 20 KV prompt slots and a text LoRA (text_prompt_phase):
# 100 class rows, S = 97, causal with the prompts always visible
FLASH_CASES = (("prompted-LoRA", 64, 197, 217, 768, 12, None),
               ("prompted-LoRA, 5 of 20 slots live", 64, 197, 217, 768, 12,
                5),
               ("text causal", 64, 77, 77, 512, 8, "causal"),
               ("ViT-L/14, S = 257", 64, 257, 257, 1024, 16, None),
               ("tiled road, S = 700, causal", 64, 77, 700, 768, 12,
                "causal"),
               ("text prompts + LoRA, K=100, P=20", 100, 77, 97, 512, 8,
                "causal"))


def flash_cost(b, t, s, d, heads, mask, backward, es=2):
    """(flops, bytes) of attention on projected q, k, v for this run's
    data: the products over the (query, key) pairs the mask leaves live (2
    forward: q k^T and p v; 5 backward: the recomputed scores, dv, dp, dq,
    dk); each input read once and each output written once (q, k, v and o;
    q, k, v, g and dq, dk, dv), the mask included."""
    import torch
    dh = d // heads
    if mask is None:
        pairs, mbytes = t * s, 0
    else:
        full = torch.broadcast_to(mask.float(), (t, s))
        pairs, mbytes = int(torch.isfinite(full).sum()), mask.numel() * 4
    flops = (5 if backward else 2) * 2 * b * heads * pairs * dh
    rows = 3 * t + 4 * s if backward else 2 * t + 2 * s
    return flops, rows * b * d * es + mbytes


def library_flash(q, k, v, heads, mask):
    """F.scaled_dot_product_attention on (B, L, D) fp32 inputs under the
    same additive mask: the yardstick."""
    import torch.nn.functional as F
    b, t, d = q.shape
    q, k, v = (a.reshape(b, -1, heads, d // heads).transpose(1, 2)
               for a in (q, k, v))
    am = None if mask is None else \
        mask.float().broadcast_to(t, k.shape[2]).contiguous()
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    return out.transpose(1, 2).reshape(b, t, d)


@clocked
def flash_kernel_case(label, b, t, s, d, heads, mask, seed):
    """The flash op at one shape: checked through its autograd Function
    against the plain versions, timed beside them and beside SDPA on the
    fp32-upcast inputs (its backward by autograd)."""
    import torch
    from lifelong_clip_tpu_torch.ops import flash_attention as fa
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    q, k, v, gy, m = kc.make_flash_inputs(b, t, s, d, heads, seed, mask)
    checks = kc.check_flash_case(q, k, v, gy, m, heads)
    torch.cuda.synchronize()
    log(f"flash {label}: checks {json.dumps(checks)}")
    res = {"label": label, "shape": [b, t, s, d], "heads": heads,
           "mask": None if mask is None else str(mask),
           "fwd_max_abs_err": checks["o"]["max_abs_err"],
           "bwd_max_abs_err": max(checks[n]["max_abs_err"]
                                  for n in ("dq", "dk", "dv"))}
    for pre, bwd in (("fwd", False), ("bwd", True)):
        fl, by = flash_cost(b, t, s, d, heads, m, bwd)
        res[f"{pre}_bound_ms"], res[f"{pre}_bound_by"] = bound_ms(fl, by)
        res[f"{pre}_gflop"], res[f"{pre}_mbytes"] = fl / 1e9, by / 1e6
        res[f"{pre}_fp32_ceiling_ms"] = fl / PEAK_FP32_FLOPS * 1e3
    wrt = [a.detach().float().requires_grad_(True) for a in (q, k, v)]
    res = time_case(
        f"flash {label}", res, lambda: fa._cuda_forward(q, k, v, heads, m),
        lambda: fa.flash_attention_reference(q, k, v, heads, m),
        lambda: fa._cuda_backward(q, k, v, gy, heads, m),
        lambda: fa.flash_attention_reference_bwd(q, k, v, gy, heads, m),
        lambda *a: library_flash(*a, heads, m), wrt, gy.float())
    log(f"flash {label}: fp32 CUDA-core ceiling fwd "
        f"{res['fwd_fp32_ceiling_ms']:.4f} ms, bwd "
        f"{res['bwd_fp32_ceiling_ms']:.4f} ms")
    return res


# (label, M, N, K, layout, out dtype, epilogue terms): the vision block's
# qkv projection (NN, bf16 out) with its bias, and with its bias and rank-4
# LoRA term as the forward chain runs it; the out projection with bias,
# LoRA and residual as the chain runs it, and with each term alone (what
# each costs); the backward's dh product (NT, fp32 out). ViT-B/16 at bs 64
_OUT = ("NN", "bf16")
GEMM_SHAPES = (("qkv NN bf16 + bias", 12608, 2304, 768, *_OUT, "bias"),
               ("qkv NN bf16 + bias + LoRA", 12608, 2304, 768, *_OUT,
                "bias,lora"),
               ("out NN bf16 + bias + LoRA + resid", 12608, 768, 768, *_OUT,
                "bias,lora,resid"),
               ("out NN bf16", 12608, 768, 768, *_OUT, ""),
               ("out NN bf16 + bias", 12608, 768, 768, *_OUT, "bias"),
               ("out NN bf16 + LoRA", 12608, 768, 768, *_OUT, "lora"),
               ("out NN bf16 + resid", 12608, 768, 768, *_OUT, "resid"),
               ("dh NT fp32", 12608, 768, 2304, "NT", "f32", ""))


@clocked
def gemm_phase():
    """The port's GEMM (``llc_gemm``: wgmma fed by TMA, the tile the
    launcher picks by shape) at ``GEMM_SHAPES`` with their epilogue terms,
    beside ``torch.matmul`` of the same bf16 operands (cuBLAS, bf16 out, no
    epilogue) as the yardstick the port never calls; ms per call from CUDA
    events, TFLOP/s of the product, and the host ms to enqueue one call."""
    import torch
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for label, m, n, k, layout, odt, terms in GEMM_SHAPES:
        a = torch.randn(m, k, generator=g, device="cuda").to(bf)
        if layout == "NN":
            b = torch.randn(k, n, generator=g, device="cuda").to(bf)
            b_arg, lib = (b, (n, 1)), (lambda a=a, b=b: torch.matmul(a, b))
        else:
            bt = torch.randn(n, k, generator=g, device="cuda").to(bf)
            b_arg = (bt, (1, k))
            lib = (lambda a=a, bt=bt: torch.matmul(a, bt.t()))
        kw = {}
        if "bias" in terms:
            kw["bias"] = torch.randn(n, generator=g, device="cuda")
        if "lora" in terms:
            z = torch.randn(m, 4, generator=g, device="cuda").to(bf)
            lb = torch.randn(4, n, generator=g, device="cuda").to(bf)
            kw.update(lz=(z, 4, 1), lb=(lb, n, 1), lscale=0.25)
        if "resid" in terms:
            kw["resid"] = torch.randn(m, n, generator=g, device="cuda").to(bf)
        out = torch.empty(m, n, device="cuda",
                          dtype=bf if odt == "bf16" else torch.float32)
        tflop = 2 * m * n * k / 1e12
        row = {"gemm": label, "M": m, "N": n, "K": k}
        def port():
            fba._gemm(out, a, (k, 1), *b_arg, m, n, k, **kw)

        ms = timed(port, iters=20)
        row["port_ms"], row["port_tflops"] = ms, tflop / ms * 1e3
        row["port_host_ms"] = host_ms(port, iters=50)
        ms = timed(lib, iters=20)
        row["torch_matmul_ms"], row["torch_matmul_tflops"] = ms, tflop / ms * 1e3
        log(f"gemm {json.dumps(row)}")
        rows.append(row)
    return rows


# (label, B, T, D, heads, LoRA r, weight grads, prefix slots): the chains
# whose launches schedule_check reads
SCHEDULE_ROWS = (("FT, no LoRA, weight_grads", 16, 197, 768, 12, 0, True, 0),
                 ("vision", 64, 197, 768, 12, 4, False, 0),
                 ("ViT-L/14 vision", 64, 257, 1024, 16, 4, False, 0),
                 ("mvp prefix, 5 of 20 live", 64, 197, 768, 12, 0, False, 20))


@clocked
def schedule_check(tries=3):
    """The chains' products on the ping-pong GEMM and their LN backward on
    the bulk-copy kernel: in one forward and backward of each
    ``SCHEDULE_ROWS`` chain, every launch through ``llc_gemm`` /
    ``llc_gemm_lora`` on the wgmma tiles (neither M nor N <= 16) runs
    ``gemm_pingpong_kernel`` and every ``llc_ln_bwd`` runs
    ``ln_bwd_bulk_kernel``, by the kernels the profiler saw (up to
    ``tries`` windows where one lost events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    out = []
    for label, b, t, d, heads, r, wg, p in SCHEDULE_ROWS:
        if p:
            x, pk, pv, blk, gy, row = kc.make_prefix_inputs(b, t, d, heads,
                                                            p, 5, 40)
            wb = [blk[k] for k in kc.BLOCK_KEYS]

            def fn():
                _, saved = fba._prefix_forward(x, pk, pv, *wb, heads, row,
                                               keep=wg)
                fba._prefix_backward(x, gy, pk, pv, *wb[:5], heads, row, wg,
                                     saved=saved)
        else:
            x, blk, lora, gy, _ = kc.make_inputs(b, t, d, heads, r, False, 41)

            def fn():
                kc.block_outputs(x, blk, lora, 0.25 if r else 0.0, gy, None,
                                 heads, weight_grads=wg)
        calls = kernel_calls(fn)
        gemms = sum(1 for name, a in calls
                    if name in ("llc_gemm", "llc_gemm_lora")
                    and a[1] > 16 and a[2] > 16)
        lns = sum(1 for name, _ in calls if name == "llc_ln_bwd")
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [kernel_short(e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            seen = {"gemm_pingpong_kernel": names.count("gemm_pingpong_kernel"),
                    "ln_bwd_bulk_kernel": names.count("ln_bwd_bulk_kernel")}
            if seen == {"gemm_pingpong_kernel": gemms,
                        "ln_bwd_bulk_kernel": lns}:
                break
        row_out = {"label": label, "gemm_launches": gemms,
                   "ln_bwd_launches": lns, "seen": seen}
        log(f"schedule {json.dumps(row_out)}")
        assert seen == {"gemm_pingpong_kernel": gemms,
                        "ln_bwd_bulk_kernel": lns} and gemms and lns, row_out
        out.append(row_out)
    return out


# ---------------------------------------------------------------------------
# main path and learning gate
# ---------------------------------------------------------------------------

def launch_counts():
    """Every kernel op's launch count, in one dict."""
    from lifelong_clip_tpu_torch.ops import flash_attention as fa
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    return {**fba.LAUNCHES, **fa.LAUNCHES}


def reset_launches():
    from lifelong_clip_tpu_torch.ops import flash_attention as fa
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    fba.reset_launches()
    fa.reset_launches()


def wrap_step(owner, attr, hook):
    """Set ``owner.attr`` so that ``hook`` wraps every train or eval step
    it runs: a trainer class's step method is wrapped itself, a method
    module's step factory has each step it makes wrapped. Returns a
    function restoring it."""
    orig = getattr(owner, attr)
    setattr(owner, attr, hook(orig) if isinstance(owner, type) else
            (lambda *a, **kw: hook(orig(*a, **kw))))
    return lambda: setattr(owner, attr, orig)


def run_main_path(label, owner, passes, argv, loss_of, in_result=None,
                  record=None):
    """Drive ``main(argv)`` with the launch counters set to 0 just before
    and read just after, counting each pass's launches by wrapping its step
    (``passes``: pass -> ``owner``'s attribute, or an (owner, attribute)
    pair, through ``wrap_step``). The outputs of every pass whose name
    starts with ``train`` are collected in call order, and with one every
    loss must be finite; ``in_result``: a text result.txt must hold;
    ``record``: a dict that gets the run's train losses, eval accuracies
    (``eval_curve``), result and trained leaves at the end (``trained``:
    one fp32 vector on the card). Returns (launches, per-pass launches,
    train-step outputs, wall s)."""
    import numpy as np
    import torch
    from lifelong_clip_tpu_torch import main as cli

    per_pass = {p: {k: 0 for k in launch_counts()} for p in passes}
    outs = []

    def counting(pass_name, fn):
        def wrapped(*a, **kw):
            before = launch_counts()
            out = fn(*a, **kw)
            for k, n in launch_counts().items():
                per_pass[pass_name][k] += n - before[k]
            if pass_name.startswith("train"):
                outs.append(out)
            return out
        return wrapped

    restore = [wrap_step(*(spec if isinstance(spec, tuple)
                           else (owner, spec)),
                         lambda fn, _p=p: counting(_p, fn))
               for p, spec in passes.items()]
    if record is not None:
        restore.append(record_trained(record))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches()
            t0 = time.perf_counter()
            result = cli.main(argv + ["--log_path", tmp, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            found = [os.path.join(r, "result.txt")
                     for r, _, fs in os.walk(tmp) if "result.txt" in fs]
            assert found, f"{label} main path wrote no result.txt"
            text = open(found[0]).read()
            if record is not None:
                record.update(eval_curve(os.path.dirname(found[0])),
                              result=result, wall_s=wall)
    finally:
        for r in restore:
            r()
    assert in_result is None or in_result in text, \
        f"{label} result.txt lacks {in_result!r}: {text[-300:]!r}"
    losses = [loss_of(o) for o in outs]
    assert not any(p.startswith("train") for p in passes) or (
        losses and np.isfinite(losses).all()), f"{label} losses {losses}"
    if record is not None:
        record["losses"] = losses
    trained = (f"{len(losses)} train steps, loss {losses[0]:.4f} -> "
               f"{losses[-1]:.4f}" if losses else "no train steps")
    log(f"{label} main path: {trained} in {wall:.1f} s, result {result}, "
        f"launches {launches}, per pass {per_pass}, result.txt ends "
        f"{text[-120:]!r}")
    return launches, per_pass, outs, wall


def record_trained(record):
    """Wraps the trainers' ``run`` so that ``record["trained"]`` gets the
    trained leaves at the end of the run, flattened into one fp32 vector;
    returns the undo."""
    import torch
    from lifelong_clip_tpu_torch.methods import base
    from lifelong_clip_tpu_torch.methods.engine import tree_leaves
    real = base.OnlineTrainer.__dict__["run"]

    def run(self, *a, **kw):
        out = real(self, *a, **kw)
        record["trained"] = torch.cat(
            [p.detach().float().flatten()
             for p in tree_leaves(self.state.trainable)])
        return out
    base.OnlineTrainer.run = run
    return lambda: setattr(base.OnlineTrainer, "run", real)


def eval_curve(result_dir):
    """A run's eval accuracies from its files: each periodic eval's
    (``seed_k_eval.npy``) and each task end's (``seed_k.npy``)."""
    import numpy as np
    out = {}
    for f in os.listdir(result_dir):
        if f.startswith("seed_") and f.endswith("_eval.npy"):
            out["periodic_acc"] = np.load(
                os.path.join(result_dir, f)).tolist()
        elif f.startswith("seed_") and f[5:-4].isdigit():
            out["task_acc"] = np.load(os.path.join(result_dir, f)).tolist()
    return out


# scripts/lora_clip.sh's flags on synthetic-20, 2 tasks
LORA_SCRIPT_ARGV = ["--method", "lora-clip", "--model_name", "ViT-B/16",
                    "--dataset", "synthetic-20", "--n_tasks", "2",
                    "--batchsize", "64", "--online_iter", "1",
                    "--eval_period", "640", "--peft_encoder", "both",
                    "--visible_classes", "all"]


@clocked
def main_path_phase(record=None):
    """lora-clip on ViT-B/16 through ``main`` with ``scripts/lora_clip.sh``'s
    flags: LoRA on both towers (``--peft_encoder both``), every exposed
    class visible (the (20, 77) token table), the default ``--transforms``
    (AutoAugment), the batch prefetcher uploading through pinned memory.
    Kernels #1 and #2 run in the vision and the text tower of every train
    step (12 + 12 forward and backward), #1 in the eval and text passes.
    ``record``: as ``run_main_path`` (the whole-run phase's kernel road)."""
    from lifelong_clip_tpu_torch.methods import adapter_clip
    launches, per_pass, outs, wall = run_main_path(
        "lora-clip", adapter_clip,
        {"train": "make_train_step", "eval": "make_eval_step",
         "text": "make_text_feature_fn"},
        LORA_SCRIPT_ARGV, lambda st: float(st["loss"]), record=record)
    tr, ev, tx = per_pass["train"], per_pass["eval"], per_pass["text"]
    steps = len(outs)
    assert tr["fused_ln_attention_fwd"] == tr["fused_ln_attention_bwd"] \
        == 24 * steps and tr["flash_attention_fwd"] == 0, \
        f"train pass launches {tr} over {steps} steps"
    assert ev["fused_ln_attention_fwd"] > 0, f"eval pass launches {ev}"
    assert tx["fused_ln_attention_fwd"] > 0, f"text pass launches {tx}"
    # the text tower's causal mask: one tile map a step, its 12 blocks'
    # forwards and backwards sharing it
    assert tr["block_tile_map"] == steps and tx["block_tile_map"] > 0, \
        (tr, tx)
    return launches, {"train_steps": steps, "wall_s": wall,
                      "per_pass": per_pass}


@clocked
def vit_l14_main_path_phase():
    """lora-clip on ViT-L/14 (T = 257 tokens, width 1024, 16 heads; random
    weights from the seed) through ``main``: kernels #1 and #2 past 256
    keys, their vision tower's attention on the long warpgroup-MMA road
    (the text tower's causal blocks on the masked road)."""
    from lifelong_clip_tpu_torch.methods import adapter_clip
    launches, per_pass, _, wall = run_main_path(
        "lora-clip ViT-L/14", adapter_clip,
        {"train": "make_train_step", "eval": "make_eval_step",
         "text": "make_text_feature_fn"},
        ["--method", "lora-clip", "--model_name", "ViT-L/14", "--dataset",
         "synthetic-20", "--n_tasks", "2", "--batchsize", "64",
         "--online_iter", "1", "--eval_period", "640", "--transforms"],
        lambda st: float(st["loss"]))
    tr, ev, tx = per_pass["train"], per_pass["eval"], per_pass["text"]
    assert tr["fused_ln_attention_fwd"] > 0 and \
        tr["fused_ln_attention_bwd"] > 0 and tr["flash_attention_fwd"] == 0, \
        f"train pass launches {tr}"
    long_keys = WGMMA_ROAD_KEYS["wgmma_long"]
    assert all(tr.get(k, 0) > 0 for k in long_keys) and \
        ev.get(long_keys[0], 0) > 0, f"long road launches {tr} {ev}"
    assert ev["fused_ln_attention_fwd"] > 0, f"eval pass launches {ev}"
    assert tx["fused_ln_attention_fwd"] > 0, f"text pass launches {tx}"
    return launches, {"wall_s": wall, "per_pass": per_pass}


MVP_CLIP_ARGV = ["--method", "mvp-clip", "--model_name", "ViT-B/16",
                 "--dataset", "synthetic-20", "--n_tasks", "2", "--batchsize",
                 "64", "--online_iter", "3", "--use_mask", "--use_contrastiv",
                 "--eval_period", "640"]


@clocked
def mvp_main_path_phase(record=None):
    """mvp-clip on ViT-B/16 through ``main`` (``scripts/mvp_clip.sh``'s
    method flags, the default ``--transforms``): the prompted pass runs
    kernels #3 and #4, the query and text passes kernel #1. ``record``: as
    ``run_main_path``."""
    import torch
    from lifelong_clip_tpu_torch.methods import mvp_clip
    launches, per_pass, outs, wall = run_main_path(
        "mvp-clip", mvp_clip,
        {"train": "make_mvp_train_step", "eval": "make_mvp_eval_step",
         "text": "make_mvp_text_fn"},
        MVP_CLIP_ARGV, lambda out: float(out[1]["loss"]), record=record)
    tr, ev, tx = per_pass["train"], per_pass["eval"], per_pass["text"]
    assert tr["fused_prefix_attention_fwd"] > 0 and \
        tr["fused_prefix_attention_bwd"] > 0 and \
        tr["fused_ln_attention_fwd"] > 0, f"train pass launches {tr}"
    assert ev["fused_prefix_attention_fwd"] > 0 and \
        ev["fused_ln_attention_fwd"] > 0, f"eval pass launches {ev}"
    assert tx["fused_ln_attention_fwd"] > 0, f"text pass launches {tx}"
    counts = [o[0] for o in outs]
    assert float(counts[-1].sum()) > float(counts[0].sum()) > 0, \
        f"prompt counts did not move: {counts[0]} -> {counts[-1]}"
    log(f"mvp-clip prompt counts after the run: {counts[-1].tolist()}")
    steps = len(outs)
    return launches, {"train_steps": steps, "wall_s": wall,
                      "per_pass": per_pass,
                      "count": torch.stack(counts)[-1].tolist()}


@clocked
def maple_main_path_phase():
    """MaPLe on ViT-B/16 through ``main`` (``scripts/maple.sh``, the
    default ``--transforms``): kernels #1 and #2 in the vision tower (T =
    197 + 3 = 200) and in the trained text tower (causal, one row a class
    of the step) in every train step, #1 in the eval and text passes."""
    from lifelong_clip_tpu_torch.methods import maple
    launches, per_pass, outs, wall = run_main_path(
        "maple", maple,
        {"train": "make_train_step", "eval": "make_maple_eval_step",
         "text": "make_maple_text_fn"},
        ["--method", "maple", "--model_name", "ViT-B/16", "--dataset",
         "synthetic-20", "--n_tasks", "2", "--batchsize", "64",
         "--online_iter", "3", "--lr", "5e-4", "--opt_name", "adamw"],
        lambda st: float(st["loss"]))
    tr, ev, tx = per_pass["train"], per_pass["eval"], per_pass["text"]
    steps = len(outs)
    # 12 vision and 12 text blocks a step, forward and backward
    assert tr["fused_ln_attention_fwd"] == tr["fused_ln_attention_bwd"] \
        == 24 * steps, f"train pass launches {tr} over {steps} steps"
    assert ev["fused_ln_attention_fwd"] > 0, f"eval pass launches {ev}"
    assert tx["fused_ln_attention_fwd"] > 0, f"text pass launches {tx}"
    return launches, {"train_steps": steps, "wall_s": wall,
                      "per_pass": per_pass}


# scripts/adapter_clip.sh's flags on synthetic-20, 2 tasks
ADAPTER_ARGV = ["--dataset", "synthetic-20", "--n_tasks", "2", "--n", "50",
                "--m", "10", "--rnd_NM", "--model_name", "ViT-B/16",
                "--batchsize", "64", "--lr", "5e-4", "--opt_name", "adamw",
                "--online_iter", "3", "--eval_period", "1000",
                "--peft_encoder", "image", "--visible_classes", "all"]


@clocked
def adapter_main_path_phase(method):
    """adapter-clip or moe-clip on ViT-B/16 through ``main`` with
    ``scripts/adapter_clip.sh``'s flags (image tower, every class visible,
    the default ``--transforms``): the adapter and the MoE sit outside the
    fused op, so every train step runs kernel #1 forward in each of the 12
    vision blocks with no LoRA and #2 (dx only, ``weight_grads=False``) in
    blocks 1-11 (block 0's input needs no grad); the eval and text passes
    run #1."""
    from lifelong_clip_tpu_torch.methods import adapter_clip
    launches, per_pass, outs, wall = run_main_path(
        method, adapter_clip,
        {"train": "make_train_step", "eval": "make_eval_step",
         "text": "make_text_feature_fn"},
        ["--method", method] + ADAPTER_ARGV,
        lambda st: float(st["loss"]))
    tr, ev, tx = per_pass["train"], per_pass["eval"], per_pass["text"]
    steps = len(outs)
    assert tr["fused_ln_attention_fwd"] == 12 * steps and \
        tr["fused_ln_attention_bwd"] == 11 * steps and \
        tr["flash_attention_fwd"] == 0, \
        f"train pass launches {tr} over {steps} steps"
    assert ev["fused_ln_attention_fwd"] > 0, f"eval pass launches {ev}"
    assert tx["fused_ln_attention_fwd"] > 0, f"text pass launches {tx}"
    return launches, {"train_steps": steps, "wall_s": wall,
                      "per_pass": per_pass}


# scripts/{l2p,dualprompt,mvp}.sh's cifar100 row (vit_base_patch16_224, bs
# 64, online_iter 3, Adam 5e-3, no memory, the default --transforms) on
# synthetic-20, 2 tasks
VIT_PROMPT_ARGV = ["--model_name", "vit_base_patch16_224", "--dataset",
                   "synthetic-20", "--n_tasks", "2", "--n", "50", "--m",
                   "10", "--rnd_NM", "--batchsize", "64", "--lr", "5e-3",
                   "--opt_name", "adam", "--sched_name", "default",
                   "--online_iter", "3", "--eval_period", "1000",
                   "--memory_size", "0"]
MVP_FLAGS = ["--use_mask", "--use_contrastiv", "--use_afs", "--use_gsf"]
STEP_KEYS = ("fused_ln_attention_fwd", "fused_ln_attention_bwd",
             "fused_prefix_attention_fwd", "fused_prefix_attention_bwd")
# kernel launches a train step, in STEP_KEYS order, at 12 layers:
# L2P: the query and the prompted pass on #1, the prompted one backward
# through all 12 blocks (the prompts enter before block 0); DualPrompt: the
# query pass on #1, the prompted pass on #3/#4 in every block (layers 5-11
# with all 20 slots dead); MVP: the query pass over 11 blocks
# (--use_last_layer off), the prompted pass as DualPrompt's; ProtoCLIP
# stage 1: #1 in the image query pass (12) and the text prefix pass (11:
# the last block's output is no layer's input), #2 in the latter, #3 in
# the CoPL image pass, the suffix pass and the suffix pass's per-layer
# recompute (3 x 12), #4 in the image and suffix passes (2 x 12)
STEP_LAUNCHES = {"l2p": (24, 12, 0, 0), "dualprompt": (12, 0, 12, 12),
                 "mvp": (11, 0, 12, 12),
                 "adapter-clip-proto_prompt": (23, 11, 36, 24)}


def capture_trainers(cls):
    """Patch ``cls.setup_model`` to record each trainer it sets up; returns
    (the list, a function restoring it)."""
    made, setup = [], cls.setup_model

    def recording(self):
        setup(self)
        made.append(self)

    cls.setup_model = recording

    def restore():
        cls.setup_model = setup
    return made, restore


# of those, #3's and #4's attention on the warpgroup-MMA kernels (every
# prompted layer passes a key-mask row; ProtoCLIP's suffix pass, under its
# 2-D mask, keeps the mma.sync kernels); none on the other paths
PREFIX_WGMMA_STEP = {"dualprompt": (12, 12), "mvp": (12, 12),
                     "adapter-clip-proto_prompt": (12, 12)}


def per_step_launches(method, launches, steps):
    want = {k: n * steps for k, n in zip(STEP_KEYS, STEP_LAUNCHES[method])}
    got = {k: launches[k] for k in STEP_KEYS}
    assert got == want and launches["flash_attention_fwd"] == 0, (
        f"{method}: {steps} train steps launched {launches}, want {want}")
    if "attn_prefix_fwd_wgmma" in launches:
        keys = ("attn_prefix_fwd_wgmma", "attn_prefix_bwd_wgmma")
        want = [n * steps for n in PREFIX_WGMMA_STEP.get(method, (0, 0))]
        assert [launches[k] for k in keys] == want, (
            f"{method}: {steps} train steps launched {launches}, want "
            f"{dict(zip(keys, want))}")


@clocked
def vit_prompt_main_path_phase(method):
    """l2p, dualprompt or mvp through ``main`` as ``scripts/{method}.sh``
    sets it for cifar100 (``vit_base_patch16_224``: exact GELU, no ln_pre;
    random weights from the seed), on synthetic-20: the train steps'
    launches exactly as ``STEP_LAUNCHES``, the eval passes on the same ops,
    and the usage counter advanced by every step's selections."""
    from lifelong_clip_tpu_torch.methods import vit_prompt_methods as vpm
    made, restore = capture_trainers(vpm._PromptPoolTrainer)
    try:
        launches, per_pass, outs, wall = run_main_path(
            method, vpm._PromptPoolTrainer,
            {"train": "train_step", "eval": "predict"},
            ["--method", method] + VIT_PROMPT_ARGV
            + (MVP_FLAGS if method == "mvp" else []),
            lambda st: float(st["loss"]))
    finally:
        restore()
    tr, ev = per_pass["train"], per_pass["eval"]
    steps = len(outs)
    per_step_launches(method, tr, steps)
    op = "fused_ln_attention_fwd" if method == "l2p" \
        else "fused_prefix_attention_fwd"
    assert ev[op] > 0 and ev["fused_ln_attention_fwd"] > 0, \
        f"eval pass launches {ev}"
    trainer = made[-1]
    # selections a step: L2P 5 of 10 a sample; DualPrompt and MVP one e-prompt
    start, per = ((trainer.pool_size, trainer.selection_size)
                  if method == "l2p" else (2 if method == "dualprompt" else 0,
                                           1))
    per *= trainer.cfg.batchsize
    counter = trainer.counter.float().cpu()
    assert float(counter.sum()) == start + per * steps, \
        f"{method} counter {counter.tolist()} after {steps} steps"
    log(f"{method} usage counter after the run: {counter.tolist()}")
    return launches, {"train_steps": steps, "wall_s": wall,
                      "per_pass": per_pass, "counter": counter.tolist()}


# ProtoCLIP (`adapter-clip-proto_prompt`) at the adapter script's row
# (ViT-B/16, bs 64, online_iter 3, AdamW 5e-4, the default --transforms)
# on synthetic-20, 2 tasks
PROTO_ARGV = ["--method", "adapter-clip-proto_prompt", "--model_name",
              "ViT-B/16", "--dataset", "synthetic-20", "--n_tasks", "2",
              "--n", "50", "--m", "10", "--rnd_NM", "--batchsize", "64",
              "--lr", "5e-4", "--opt_name", "adamw", "--online_iter", "3",
              "--eval_period", "1000"]


@clocked
def proto_main_path_phase():
    """ProtoCLIP through ``main`` on ViT-B/16 (random weights), two tasks:
    stage 1 (launches exactly as ``STEP_LAUNCHES``), the task-end feature
    sweeps, the drift displacement of task 0's prototypes, the CoPL advance,
    stage 2 after task 2 (its text passes on #1-#4; one epoch in place of
    ``--ca_epochs``' five), and the eval through the 90-combination text
    cache."""
    import numpy as np
    from lifelong_clip_tpu_torch.methods import proto_clip
    cls = proto_clip.Trainer_ProtoCLIP
    made, restore = capture_trainers(cls)
    try:
        launches, per_pass, outs, wall = run_main_path(
            "ProtoCLIP", cls,
            {"train": "stage1_step", "stage2": "_stage2", "eval": "predict",
             "cache": "prepare_eval", "sweep": "extract_plain"},
            PROTO_ARGV + ["--ca_epochs", "1"], lambda st: float(st["loss"]))
    finally:
        restore()
    steps = len(outs)
    per_step_launches("adapter-clip-proto_prompt", per_pass["train"], steps)
    s2, ev, cache = per_pass["stage2"], per_pass["eval"], per_pass["cache"]
    assert all(s2[k] > 0 for k in STEP_KEYS), f"stage 2 launches {s2}"
    assert ev["fused_prefix_attention_fwd"] > 0 and \
        ev["fused_ln_attention_fwd"] > 0, f"eval pass launches {ev}"
    assert cache["fused_prefix_attention_fwd"] > 0 and \
        cache["fused_ln_attention_fwd"] > 0, f"text cache launches {cache}"
    assert per_pass["sweep"]["fused_ln_attention_fwd"] > 0, per_pass["sweep"]
    # the suffix pass's 2-D mask: its chains built the tile map
    assert all(per_pass[k]["prefix_tile_map"] > 0 for k in
               ("train", "stage2", "cache")), per_pass
    tr = made[-1]
    means = tr._class_means[tr._have_proto]
    assert tr.task_count == 1 and int(tr._have_proto.sum()) == 20 and \
        np.isfinite(means).all() and np.isfinite(tr._class_covs).all(), \
        (tr.task_count, tr._have_proto)
    info = {"train_steps": steps, "wall_s": wall, "per_pass": per_pass,
            "suffix_len": tr.suffix_len, "prototypes": int(
                tr._have_proto.sum()), "task_count": tr.task_count}
    log(f"ProtoCLIP: {json.dumps(info)}")
    return launches, info


def openai_state_dict(cfg, seed=5):
    """A seeded OpenAI CLIP state dict of ``cfg``'s sizes on the CPU, a ViT
    or (``cfg.tower == "rn"``) a ModifiedResNet: the reference
    ``build_model``'s key names and shapes (conv kernels OIHW, Linear
    weights (out, in), BatchNorm running statistics and counters), written
    out here and not taken from ``models/convert.py``, so that
    ``check_loaded`` holds the converter's key map and transposes to the
    reference layout."""
    import math
    import torch
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(*shape, generator=g)

    def ln(name, w):
        return {f"{name}.weight": rnd(w, scale=0.1, shift=1.0),
                f"{name}.bias": rnd(w, scale=0.1)}

    def bn(name, c):
        return {**ln(name, c), f"{name}.running_mean": rnd(c, scale=0.1),
                f"{name}.running_var": 0.5 + torch.rand(c, generator=g),
                f"{name}.num_batches_tracked": torch.tensor(0)}

    def conv(cout, cin, k):
        return rnd(cout, cin, k, k, scale=(cin * k * k) ** -0.5)

    def blocks(prefix, w, layers):
        sd = {}
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            sd.update({**ln(f"{p}.ln_1", w), **ln(f"{p}.ln_2", w),
                       f"{p}.attn.in_proj_weight":
                           rnd(3 * w, w, scale=w ** -0.5),
                       f"{p}.attn.in_proj_bias": rnd(3 * w, scale=0.02),
                       f"{p}.attn.out_proj.weight":
                           rnd(w, w, scale=w ** -0.5),
                       f"{p}.attn.out_proj.bias": rnd(w, scale=0.02),
                       f"{p}.mlp.c_fc.weight":
                           rnd(4 * w, w, scale=w ** -0.5),
                       f"{p}.mlp.c_fc.bias": rnd(4 * w, scale=0.02),
                       f"{p}.mlp.c_proj.weight":
                           rnd(w, 4 * w, scale=(4 * w) ** -0.5),
                       f"{p}.mlp.c_proj.bias": rnd(w, scale=0.02)})
        return sd

    def resnet():
        # reference ModifiedResNet (model.py:113-191): a 3-conv stem, four
        # stages of bottlenecks (downsample in each stage's first block),
        # the attention pool over the (image / 32)^2 grid + the mean token
        w = cfg.vision_width
        sd = {"visual.conv1.weight": conv(w // 2, 3, 3),
              "visual.conv2.weight": conv(w // 2, w // 2, 3),
              "visual.conv3.weight": conv(w, w // 2, 3),
              **bn("visual.bn1", w // 2), **bn("visual.bn2", w // 2),
              **bn("visual.bn3", w)}
        inplanes = w
        for s, depth in enumerate(cfg.vision_layers):
            planes = w * 2 ** s
            for b in range(depth):
                p = f"visual.layer{s + 1}.{b}"
                sd.update({f"{p}.conv1.weight": conv(planes, inplanes, 1),
                           f"{p}.conv2.weight": conv(planes, planes, 3),
                           f"{p}.conv3.weight": conv(planes * 4, planes, 1),
                           **bn(f"{p}.bn1", planes), **bn(f"{p}.bn2", planes),
                           **bn(f"{p}.bn3", planes * 4)})
                if b == 0:
                    sd.update({f"{p}.downsample.0.weight":
                               conv(planes * 4, inplanes, 1),
                               **bn(f"{p}.downsample.1", planes * 4)})
                inplanes = planes * 4
        c, grid = w * 32, cfg.image_size // 32
        sd["visual.attnpool.positional_embedding"] = rnd(
            grid * grid + 1, c, scale=c ** -0.5)
        for name, dout in (("q", c), ("k", c), ("v", c),
                           ("c", cfg.embed_dim)):
            sd[f"visual.attnpool.{name}_proj.weight"] = rnd(
                dout, c, scale=c ** -0.5)
            sd[f"visual.attnpool.{name}_proj.bias"] = rnd(dout, scale=0.02)
        return sd

    def vit():
        w, p = cfg.vision_width, cfg.patch_size
        grid = cfg.image_size // p
        return {"visual.class_embedding": rnd(w, scale=w ** -0.5),
                "visual.positional_embedding":
                    rnd(grid * grid + 1, w, scale=w ** -0.5),
                "visual.proj": rnd(w, cfg.embed_dim, scale=w ** -0.5),
                "visual.conv1.weight": rnd(w, 3, p, p, scale=0.05),
                **ln("visual.ln_pre", w), **ln("visual.ln_post", w),
                **blocks("visual.transformer", w, cfg.vision_layers)}

    tw = cfg.text_width
    return {**(resnet() if cfg.tower == "rn" else vit()),
            "positional_embedding":
                rnd(cfg.context_length, tw, scale=0.01),
            "text_projection": rnd(tw, cfg.embed_dim, scale=tw ** -0.5),
            "logit_scale": torch.tensor(math.log(1 / 0.07)),
            "token_embedding.weight":
                rnd(cfg.vocab_size, tw, scale=0.02),
            **ln("ln_final", tw),
            **blocks("transformer", tw, cfg.text_layers)}


def check_loaded(params, sd, cfg):
    """The tree ``load_clip_params`` read against the state dict it was
    written from, by the reference layout: Linear weights (out, in) acting
    as x @ W.T are kept as x @ W, blocks stacked on axis 0, conv kernels
    (RN) OIHW as HWIO, every tensor exact, every key of ``sd`` used but the
    BatchNorm counters; the ViT's patch kernel is held by what it computes,
    the port's patch embedding of a seeded image against ``conv2d`` with
    the file's kernel, within 1e-5 of the output's max (fp32, two summation
    orders). Returns the number of tensors checked."""
    import torch
    from lifelong_clip_tpu_torch.methods.engine import tree_leaves
    from lifelong_clip_tpu_torch.models.clip import extract_patches
    v, t = params["vision"], params["text"]
    used, checked = set(), []

    def same(got, *keys, transposed=False, stack=False, conv=False):
        want = [sd[k].T if transposed else sd[k] for k in keys]
        want = [a.permute(2, 3, 1, 0) if conv else a for a in want]
        want = torch.stack(want) if stack else want[0]
        assert torch.equal(got.cpu(), want), keys[0]
        used.update(keys)
        checked.append(got)

    for got, key in ((t["token_embedding"], "token_embedding.weight"),
                     (t["pos_embed"], "positional_embedding"),
                     (t["text_projection"], "text_projection")):
        same(got, key)
    assert float(params["logit_scale"]) == float(sd["logit_scale"])
    used.add("logit_scale")
    checked.append(params["logit_scale"])
    same(t["ln_final"]["scale"], "ln_final.weight")
    same(t["ln_final"]["bias"], "ln_final.bias")
    stacks = [(t["blocks"], "transformer", cfg.text_layers)]
    if cfg.tower == "rn":
        def bn(tree, name):
            for leaf, stat in (("scale", "weight"), ("bias", "bias"),
                               ("mean", "running_mean"),
                               ("var", "running_var")):
                same(tree[leaf], f"{name}.{stat}")
            used.add(f"{name}.num_batches_tracked")

        for i, st in enumerate(v["stem"], 1):
            same(st["w"], f"visual.conv{i}.weight", conv=True)
            bn(st["bn"], f"visual.bn{i}")
        for s, stage in enumerate(v["layers"], 1):
            for b, blk in enumerate(stage):
                p = f"visual.layer{s}.{b}"
                for j in (1, 2, 3):
                    same(blk[f"conv{j}"], f"{p}.conv{j}.weight", conv=True)
                    bn(blk[f"bn{j}"], f"{p}.bn{j}")
                if blk["downsample"] is not None:
                    same(blk["downsample"]["conv"],
                         f"{p}.downsample.0.weight", conv=True)
                    bn(blk["downsample"]["bn"], f"{p}.downsample.1")
        ap = v["attnpool"]
        same(ap["pos_embed"], "visual.attnpool.positional_embedding")
        for name in ("q", "k", "v", "c"):
            same(ap[name]["w"], f"visual.attnpool.{name}_proj.weight",
                 transposed=True)
            same(ap[name]["b"], f"visual.attnpool.{name}_proj.bias")
    else:
        for got, key in ((v["class_embedding"], "visual.class_embedding"),
                         (v["pos_embed"], "visual.positional_embedding"),
                         (v["proj"], "visual.proj")):
            same(got, key)
        for tree, name in ((v["ln_pre"], "visual.ln_pre"),
                           (v["ln_post"], "visual.ln_post")):
            same(tree["scale"], f"{name}.weight")
            same(tree["bias"], f"{name}.bias")
        stacks.append((v["blocks"], "visual.transformer", cfg.vision_layers))
        conv = sd["visual.conv1.weight"]
        img = torch.randn(2, 3, cfg.image_size, cfg.image_size,
                          generator=torch.Generator().manual_seed(6))
        want = torch.nn.functional.conv2d(img, conv, stride=cfg.patch_size)
        want = want.flatten(2).transpose(1, 2)
        got = extract_patches(img.permute(0, 2, 3, 1), cfg.patch_size) @ \
            v["patch_kernel"].cpu()
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), f"patch kernel err {err}"
        used.add("visual.conv1.weight")
        checked.append(v["patch_kernel"])
    for blk, prefix, layers in stacks:
        for got, suffix, tr in (
                (blk["ln_1"]["scale"], "ln_1.weight", False),
                (blk["ln_1"]["bias"], "ln_1.bias", False),
                (blk["attn"]["w_qkv"], "attn.in_proj_weight", True),
                (blk["attn"]["b_qkv"], "attn.in_proj_bias", False),
                (blk["attn"]["w_out"], "attn.out_proj.weight", True),
                (blk["attn"]["b_out"], "attn.out_proj.bias", False),
                (blk["ln_2"]["scale"], "ln_2.weight", False),
                (blk["ln_2"]["bias"], "ln_2.bias", False),
                (blk["mlp"]["w_fc"], "mlp.c_fc.weight", True),
                (blk["mlp"]["b_fc"], "mlp.c_fc.bias", False),
                (blk["mlp"]["w_proj"], "mlp.c_proj.weight", True),
                (blk["mlp"]["b_proj"], "mlp.c_proj.bias", False)):
            same(got, *(f"{prefix}.resblocks.{i}.{suffix}"
                        for i in range(layers)), transposed=tr, stack=True)
    assert used == set(sd), sorted(set(sd) - used)
    leaves = tree_leaves(params)
    assert len(checked) == len(leaves) and \
        {id(a) for a in checked} == {id(a) for a in leaves}, \
        "a tensor of the loaded tree was not checked"
    return len(leaves)


@clocked
def write_pretrained(tmp, model="ViT-B/16", device="cuda"):
    """An OpenAI-layout checkpoint of ``model``'s sizes written with
    ``torch.save`` from seed 5 (``openai_state_dict``), read back by
    ``models/convert.py:load_clip_params`` onto ``device``: the inferred
    architecture must be the preset's and the tree must hold the file's
    tensors (``check_loaded``). Returns (path, MB, s to write, s to
    load)."""
    import dataclasses
    import torch
    from lifelong_clip_tpu_torch.config import resolve_clip_preset
    from lifelong_clip_tpu_torch.models.convert import load_clip_params
    cfg = resolve_clip_preset(model)
    sd = openai_state_dict(cfg)
    path = os.path.join(tmp, model.replace("/", "-") + ".pt")
    t0 = time.perf_counter()
    torch.save(sd, path)
    t1 = time.perf_counter()
    loaded, lcfg = load_clip_params(path, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    # the RN tower has no patches: JAX's and the port's inference set its
    # unused patch_size to 32, the preset leaves the default
    unused = {"patch_size"} if cfg.tower == "rn" else set()
    assert {k: v for k, v in dataclasses.asdict(lcfg).items()
            if k not in unused} == {k: v for k, v in
                                    dataclasses.asdict(cfg).items()
                                    if k not in unused}, lcfg
    n = check_loaded(loaded, sd, lcfg)
    mb = os.path.getsize(path) / 1e6
    log(f"pretrained {model} checkpoint: {mb:.1f} MB written in "
        f"{t1 - t0:.2f} s, read onto the card in {t2 - t1:.2f} s, "
        f"{n} tensors held to the file's by the reference layout")
    return path, mb, t1 - t0, t2 - t1


@clocked
def continual_main_path_phase(ckpt):
    """continual-clip through ``main`` as ``scripts/continual_clip.sh`` sets
    it (5 tasks, test_batchsize 128), from the OpenAI-layout checkpoint at
    ``ckpt`` (``--pretrained_path``), with ``--zero_shot_evaluation`` on
    synthetic-20: no train step; kernel #1 runs forward in both towers in
    the eval and text passes and in the zero-shot pass, whose line must
    close result.txt."""
    from lifelong_clip_tpu_torch.methods import continual_clip
    launches, per_pass, _, wall = run_main_path(
        "continual-clip", continual_clip,
        {"eval": "make_eval_step", "text": "make_text_feature_fn"},
        ["--method", "continual-clip", "--dataset", "synthetic-20",
         "--n_tasks", "5", "--n", "50", "--m", "10", "--model_name",
         "ViT-B/16", "--test_batchsize", "128", "--eval_period", "1000",
         "--pretrained_path", ckpt, "--zero_shot_evaluation",
         "--zero_shot_dataset", "synthetic-20"],
        None, in_result="Dataset:synthetic-20 | test_acc:")
    ev, tx = per_pass["eval"], per_pass["text"]
    assert ev["fused_ln_attention_fwd"] > 0 and \
        ev["fused_ln_attention_bwd"] == 0, f"eval pass launches {ev}"
    assert tx["fused_ln_attention_fwd"] > 0, f"text pass launches {tx}"
    # the zero-shot pass: 12 vision blocks a batch, 12 text blocks
    zero_shot = launches["fused_ln_attention_fwd"] - \
        ev["fused_ln_attention_fwd"] - tx["fused_ln_attention_fwd"]
    assert zero_shot >= 24, f"zero-shot pass launches {zero_shot}"
    return launches, {"wall_s": wall, "per_pass": per_pass,
                      "zero_shot_fused_fwd": zero_shot}


@clocked
def continual_eval_phase(card, ckpt, bs=128, iters=10, model="ViT-B/16"):
    """continual-clip's eval on the card (``scripts/continual_clip.sh``'s
    test_batchsize 128; ``model`` from the checkpoint at ``ckpt``): the eval
    step alone on one batch of uint8 32 x 32 images (resize to 224, the
    vision tower, logits against the cached text features) by CUDA events
    and device-busy ms, as images/s; the text-cache pass (every class of
    synthetic-20, and 100 rows as CIFAR-100's) likewise; and ``evaluate``
    end to end over synthetic-20's 1000 test images (host gather, upload,
    predictions read back)."""
    import torch
    from lifelong_clip_tpu_torch.config import StreamConfig, TrainConfig
    from lifelong_clip_tpu_torch.methods import get_method
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(method="continual-clip", dataset="synthetic-20",
                          model_name=model, pretrained_path=ckpt,
                          test_batchsize=bs, log_path=tmp, device="cuda",
                          stream=StreamConfig(n_tasks=5, n=50, m=10))
        tr = get_method("continual-clip")(cfg)
        tr.vocab.expose(tr.train_dataset.targets)
        tr.prepare_eval()
        images = tr._tensor(tr.test_dataset.images[:bs])
        tokens20 = tr._tensor(tr.vocab.token_table, torch.int64)
        tokens100 = gate_batch(tr.clip_cfg, 100, 1)[2].cuda()

        def eval_step():
            return tr._eval_fn(tr.params, None, images, tr._txt_cache,
                               tr._mask)

        out = {"eval_step_ms": timed(eval_step, iters=iters),
               "eval_step_device_ms": device_ms(eval_step),
               "eval_step_host_ms": host_ms(eval_step)}
        out["eval_images_per_s"] = bs / out["eval_step_ms"] * 1e3
        for k, tok in (("text_pass_20", tokens20),
                       ("text_pass_100", tokens100)):
            fn = lambda: tr._text_fn(tr.params, None, tok)   # noqa: E731
            out[f"{k}_ms"] = timed(fn, iters=iters)
            out[f"{k}_device_ms"] = device_ms(fn)
        n = len(tr.test_dataset)
        tr.evaluate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        correct, total = tr.evaluate()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        assert int(total.sum()) == n, (int(total.sum()), n)
        out.update({"evaluate_images": n, "evaluate_s": dt,
                    "evaluate_images_per_s": n / dt,
                    "evaluate_acc": float(correct.sum() / total.sum()),
                    "test_batchsize": bs, "model": model, "card": card})
    log(f"continual-clip eval {json.dumps(out)}")
    return out


# scripts/er.sh as written on synthetic-20 (ViT-B/16, bs 16 = 8 stream + 8
# memory samples, memory 500, AdamW 3e-4, the default --transforms: CutMix
# and AutoAugment); the other ER-family methods take the same flags
ER_ARGV = ["--dataset", "synthetic-20", "--n_tasks", "5", "--n", "50",
           "--m", "10", "--batchsize", "16", "--temp_batchsize", "8",
           "--memory_size", "500", "--lr", "3e-4", "--opt_name", "adamw",
           "--online_iter", "1", "--eval_period", "1000"]
# RM with its memory epochs and the Monte-Carlo rebuild, cut to 2 tasks of
# synthetic-20 at 20 samples a class and a memory of 128: each stream batch
# trains online_iter x temp_batchsize = 8 steps, and each memory epoch
# walks the memory len // bs times over
def argv_with(argv, **flags):
    """``argv`` with the value of each ``--flag`` in ``flags`` replaced."""
    out = list(argv)
    for flag, value in flags.items():
        out[out.index(f"--{flag}") + 1] = str(value)
    return out


RM_ARGV = ["--method", "rm"] + argv_with(ER_ARGV, dataset="synthetic-20x20",
                                         n_tasks=2, memory_size=128) + [
    "--memory_epoch", "2", "--rm_uncertainty"]
# scripts/clib.sh synthetic-20 as written: its synthetic row (memory 64, bs
# 16, online_iter 1, Adam 1e-3, which CLIB replaces by optax.adamw's
# defaults at that lr), 5 tasks
CLIB_ARGV = ["--method", "clib", "--dataset", "synthetic-20", "--n_tasks",
             "5", "--n", "50", "--m", "10", "--rnd_NM", "--model_name",
             "ViT-B/16", "--batchsize", "16", "--lr", "1e-3", "--opt_name",
             "adam", "--sched_name", "default", "--online_iter", "1",
             "--eval_period", "200", "--memory_size", "64", "--lr_step",
             "0.95", "--lr_length", "10", "--lr_period", "10",
             "--imp_update_period", "1", "--seed", "1", "--rnd_seed", "1"]
ER_FAMILY_ARGV = {m: ["--method", m] + ER_ARGV
                  for m in ("er", "Finetuning", "lwf", "ewc++")}
ER_FAMILY_ARGV.update(clib=CLIB_ARGV, rm=RM_ARGV)
# the ER family's train steps: the frozen tower's forward and no backward
# (no grad reaches it); EWC++ two forwards (two updates); FT forward and
# backward, the latter with the weight grads, in all 12 blocks (block 0's
# weights train)
STEP_LAUNCHES.update({"er": (12, 0, 0, 0), "Finetuning": (12, 12, 0, 0),
                      "lwf": (12, 0, 0, 0), "ewc++": (24, 0, 0, 0),
                      "clib": (12, 0, 0, 0), "rm": (12, 0, 0, 0)})


@clocked
def er_family_main_path_phase(method, record=None):
    """``method`` of the ER family through ``main`` on ViT-B/16 (random
    weights) with ``ER_FAMILY_ARGV``'s flags: every train step's launches
    exactly ``STEP_LAUNCHES`` (LwF's plain and KD steps, EWC++'s double
    update, CLIB's memory steps, RM's stream and memory-epoch steps), the
    eval passes on kernel #1, CLIB's incoming-feature pass and RM's
    Monte-Carlo views on #1 too. ``record``: as ``run_main_path``."""
    import numpy as np
    from lifelong_clip_tpu_torch.methods import clib, er_baseline, ewcpp
    from lifelong_clip_tpu_torch.methods import lwf
    from lifelong_clip_tpu_torch.methods import rainbow_memory as rm
    from lifelong_clip_tpu_torch.methods.engine import tree_leaves
    passes = {"train": {"ewc++": (ewcpp.EWCpp, "ewc_step"),
                        "clib": (clib.CLIB, "clib_step")}.get(
                  method, (er_baseline, "make_train_step")),
              "eval": (er_baseline.ER, "predict")}
    if method == "lwf":
        passes["train_kd"] = (lwf.LwF, "kd_step")
    if method == "clib":
        passes["feats"] = (clib.CLIB, "eval_feats")
    if method == "rm":
        passes["mc"] = (rm.RM, "mc_uncertainty")
    made, restore = capture_trainers(er_baseline.ER)
    try:
        launches, per_pass, outs, wall = run_main_path(
            method, None, passes, ER_FAMILY_ARGV[method],
            lambda st: float(st["loss"]), record=record)
    finally:
        restore()
    steps = len(outs)
    train = {k: per_pass["train"][k] + per_pass.get("train_kd", {}).get(k, 0)
             for k in per_pass["train"]}
    per_step_launches(method, train, steps)
    for p in set(per_pass) - {"train", "train_kd"}:
        assert per_pass[p]["fused_ln_attention_fwd"] > 0 and \
            per_pass[p]["fused_ln_attention_bwd"] == 0, (p, per_pass[p])
    tr = made[-1]
    info = {"train_steps": steps, "wall_s": wall, "per_pass": per_pass,
            "memory": len(tr.memory),
            "lr": tr.state.opt.param_groups[0]["lr"]}
    if method == "lwf":
        info["kd_steps"] = per_pass["train_kd"]["fused_ln_attention_fwd"] // 12
        assert info["kd_steps"] > 0, info
    if method == "ewc++":
        assert float(tr.ewc_state["has_reg"]) == 1.0
        info["importance_max"] = max(float(a.abs().max()) for a in
                                     tree_leaves(tr.ewc_state["importance"]))
    if method == "clib":
        info["lr_high"], info["lr_low"] = tr._lr_high, tr._lr_low
        assert tr._loss_sweep is not None and \
            np.isfinite(tr._loss_sweep).all(), tr._loss_sweep
    log(f"{method}: {json.dumps(info)}")
    return launches, info


@clocked
def rn_continual_main_path_phase(ckpt):
    """continual-clip through ``main`` as ``scripts/continual_clip.sh`` sets
    it, from the OpenAI RN50-layout checkpoint at ``ckpt`` (the ModifiedResNet
    tower on cuDNN convolutions; JAX runs them outside any Pallas kernel),
    with ``--zero_shot_evaluation``: the eval passes launch no fused kernel,
    the text passes kernel #1 in every text block."""
    from lifelong_clip_tpu_torch.methods import continual_clip
    launches, per_pass, _, wall = run_main_path(
        "continual-clip RN50", continual_clip,
        {"eval": "make_eval_step", "text": "make_text_feature_fn"},
        ["--method", "continual-clip", "--dataset", "synthetic-20",
         "--n_tasks", "5", "--n", "50", "--m", "10", "--model_name",
         "RN50", "--test_batchsize", "128", "--eval_period", "1000",
         "--pretrained_path", ckpt, "--zero_shot_evaluation",
         "--zero_shot_dataset", "synthetic-20"],
        None, in_result="Dataset:synthetic-20 | test_acc:")
    ev, tx = per_pass["eval"], per_pass["text"]
    assert ev["fused_ln_attention_fwd"] == 0, f"eval pass launches {ev}"
    assert tx["fused_ln_attention_fwd"] > 0 and \
        tx["fused_ln_attention_fwd"] % 12 == 0, f"text pass launches {tx}"
    # the zero-shot pass: its text pass's 12 blocks
    zero_shot = launches["fused_ln_attention_fwd"] - \
        tx["fused_ln_attention_fwd"]
    assert zero_shot >= 12, f"zero-shot pass launches {zero_shot}"
    return launches, {"wall_s": wall, "per_pass": per_pass,
                      "zero_shot_fused_fwd": zero_shot}


def er_family_trainer(argv, tmp, dataset=None):
    """A trainer built as ``main`` builds it from ``argv`` (``dataset`` in
    place of its own) on the card."""
    from lifelong_clip_tpu_torch import main as cli
    parser = cli.base_parser()
    args = parser.parse_args(argv + ["--log_path", tmp, "--device", "cuda"]
                             + (["--dataset", dataset] if dataset else []))
    return cli.trainer_class(args.method, args, parser)(
        cli.args_to_config(args))


# the ER family's gates: (argv, batch size, dataset, what the step is)
ER_GATES = {
    "er": (ER_FAMILY_ARGV["er"], 16, None,
           "ViT-B/16 ER step from scripts/er.sh (head over the frozen "
           "tower, AdamW 3e-4, CutMix + AutoAugment)"),
    "Finetuning": (ER_FAMILY_ARGV["Finetuning"], 16, None,
                   "ViT-B/16 FT step (the whole CLIP tree, AdamW 3e-4, #2 "
                   "with weight grads in 12 blocks, CutMix + AutoAugment)"),
    "clib": (argv_with(CLIB_ARGV, batchsize=64, lr="5e-3", memory_size=2000,
                       online_iter=3), 64, "synthetic-100",
             "ViT-B/16 CLIB step at scripts/clib.sh's cifar100 row (bs 64, "
             "AdamW lr 5e-3, weight decay 1e-4, AutoAugment)")}


@clocked
def er_family_gate(card, method):
    """The learning gate of ``method``'s train step (``ER_GATES``) on one
    batch of the synthetic set's class-structured images, with the launch
    counters set to 0 just before and read just after: every step
    launches exactly ``STEP_LAUNCHES``."""
    import numpy as np
    import torch
    from lifelong_clip_tpu_torch.methods.engine import tree_leaves
    argv, bs, dataset, model = ER_GATES[method]
    with tempfile.TemporaryDirectory() as tmp:
        tr = er_family_trainer(argv, tmp, dataset)
        idx = np.random.default_rng(0).permutation(len(tr.train_dataset))[:bs]
        images, labels = tr.train_dataset.gather(idx)
        tr.vocab.expose(labels)
        batch = tr._batch(images, labels)
        step = (tr.clib_step if method == "clib"
                else tr._train_step)
        steps = []

        def one_step():
            steps.append(1)
            return step(tr.state, batch)["loss"]

        reset_launches()
        out = gate_loop(method, one_step, bs, card, model=model,
                        trainable_params=sum(
                            p.numel() for p in tree_leaves(
                                tr.state.trainable)))
        torch.cuda.synchronize()
        launches = launch_counts()
        per_step_launches(method, launches, len(steps))
        out["launches"] = launches
        log(f"{method} gate: {len(steps)} steps, launches {launches}")
        del tr
    return out


MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
MVP_GATE_LR = 1e-2   # AdamW moves keys and prompts ~lr a step


def gate_batch(cfg, n_cls, bs):
    """One uint8 CIFAR-size batch, its labels and a class-token table, from
    a numpy seed (on the CPU)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    tokens = np.zeros((n_cls, cfg.context_length), np.int64)
    tokens[:, 0] = 49406
    tokens[:, 1:8] = rng.integers(1000, 40000, (n_cls, 7))
    tokens[:, 8] = 49407
    images = rng.integers(0, 255, (bs, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, n_cls, (bs,))
    return (torch.from_numpy(images), torch.from_numpy(labels),
            torch.from_numpy(tokens))


def gate_loop(label, run_step, bs, card, **info):
    """The learning gate (bench.py:98-104): 22 steps of ``run_step`` (one
    train step on one batch, returning its loss) must lower the loss by more
    than 0.02. Returns the losses, step ms and samples/s of the last 20
    steps, the peak device memory the steps allocated (beside what was
    allocated before them and the card's memory), and a torch.profiler
    window over 3 more steps."""
    import gc
    import torch
    gc.collect()   # what earlier phases left in reference cycles
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss_first = float(run_step())
    float(run_step())
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = run_step()
    loss_last = float(loss)
    dt = time.perf_counter() - t0
    assert loss_last < loss_first - 0.02, (
        f"{label} train steps did not learn: loss {loss_first:.4f} -> "
        f"{loss_last:.4f} after {iters + 2} updates on one batch")
    step_ms = dt / iters * 1e3
    memory = {"peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              "allocated_before_steps_gb": before / 1e9,
              "card_gb": torch.cuda.get_device_properties(0).total_memory
              / 1e9}
    log(f"{label} train step memory: {json.dumps(memory)}")
    return {"learning_gate": "ok", "label": label, "loss_first": loss_first,
            "loss_last": loss_last, "step_ms": step_ms,
            "samples_per_s": bs * iters / dt, "batchsize": bs, **info,
            "memory": memory, "card": card,
            "profile": step_profile(run_step, step_ms)}


def frozen_clip(dev, model="ViT-B/16"):
    """A CLIP preset from seed 0, its towers cast to bf16 once."""
    import torch
    from lifelong_clip_tpu_torch.models import build_clip
    from lifelong_clip_tpu_torch.models.clip import cast_towers
    params, cfg = build_clip(model, gen=torch.Generator().manual_seed(0),
                             device=dev)
    return params, cast_towers(params, torch.bfloat16), cfg


def lora_setup(model="ViT-B/16", remat=False, method="lora"):
    """lora-clip's train step as ``bench.py:41-60`` times it (LoRA r=4 on
    the image tower, AutoAugment's cifar10 policy, AdamW 5e-4) on one batch
    of 64 against 64 cached class-text features; ``remat`` checkpoints each
    vision block; ``method`` "adapter" or "moe" trains adapter-clip's or
    moe-clip's tree instead (``scripts/adapter_clip.sh``'s defaults:
    adapters of 64, two experts, both selected; the MoE step draws its gate
    noise). The launch counters are set to 0 just before the text pass.
    Returns (cfg, state, one step returning its loss, the text pass's
    launches)."""
    import torch
    from lifelong_clip_tpu_torch.config import PEFTConfig
    from lifelong_clip_tpu_torch.methods.engine import (
        TrainState, make_text_feature_fn, make_train_step)
    from lifelong_clip_tpu_torch.models import build_peft
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer

    dev = torch.device("cuda")
    _, frozen, cfg = frozen_clip(dev, model)
    peft_cfg = PEFTConfig(method=method, encoder="image", lora_r=4)
    peft = build_peft(torch.Generator().manual_seed(1), cfg, peft_cfg,
                      device=dev)
    state = TrainState(trainable=peft, frozen=frozen,
                       make_opt=lambda lv: make_optimizer("adamw", lv, 5e-4),
                       gen=torch.Generator().manual_seed(2))
    step = make_train_step(cfg, peft_cfg, image_size=cfg.image_size,
                           mean=MEAN, std=STD, augment=True, remat=remat,
                           use_autoaug=True, autoaug_policy="cifar10",
                           cached_text=True)
    n_cls, bs = 64, 64
    images, labels, tokens = gate_batch(cfg, n_cls, bs)
    reset_launches()
    txt = make_text_feature_fn(cfg, peft_cfg)(frozen, peft, tokens.to(dev))
    text = launch_counts()
    batch = {"images": images.to(dev), "labels": labels.to(dev),
             "tokens": txt, "mask": torch.zeros(n_cls, device=dev)}
    return cfg, state, lambda: step(state, batch)["loss"], text


GATE_PEFT = {"lora": "LoRA r=4", "adapter": "adapters of 64",
             "moe": "MoE of 2 adapters of 64, top 2, gate noise"}


@clocked
def learning_gate(card, model="ViT-B/16", method="lora"):
    """The lora-clip, adapter-clip or moe-clip gate (``lora_setup``). The
    launch counters are set to 0 just before the text pass and the gate and
    read just after each: the text pass must run the fused block forward in
    every text layer, every step the fused block forward once a vision
    layer and its backward once a vision layer (with LoRA; the adapter and
    the MoE sit outside the fused op, so block 0, whose input needs no
    grad, has no backward), and nothing runs the flash op."""
    import torch
    cfg, _, run_step, text = lora_setup(model, method=method)
    steps = []

    def one_step():
        steps.append(1)
        return run_step()

    label = f"{method}-clip" + ("" if model == "ViT-B/16" else f" {model}")
    reset_launches()
    out = gate_loop(label, one_step, 64, card,
                    model=f"{model} {GATE_PEFT[method]}, AutoAugment cifar10")
    torch.cuda.synchronize()
    launches = launch_counts()
    n = len(steps) * cfg.vision_layers
    n_bwd = n if method == "lora" else n - len(steps)
    assert launches["fused_ln_attention_fwd"] == n and \
        launches["fused_ln_attention_bwd"] == n_bwd and \
        launches["flash_attention_fwd"] == 0, (launches, len(steps))
    assert text["fused_ln_attention_fwd"] > 0 and \
        text["fused_ln_attention_fwd"] % cfg.text_layers == 0, text
    out["launches"], out["text_pass_launches"] = launches, text
    log(f"{label} gate: {len(steps)} steps, launches {launches}, text pass "
        f"{text}")
    return out


def lora_both_setup(n_cls=100, bs=64):
    """lora-clip with LoRA r=4 on both towers (``scripts/lora_clip.sh``'s
    ``--peft_encoder both``), AutoAugment cifar10, AdamW 5e-4, on one batch
    of 64 against ``n_cls`` class-token rows (CIFAR-100's class count):
    the text tower runs forward and backward every step, kernels #1/#2
    under the causal mask at K x 77 x 512. Returns (cfg, state, one step
    returning its loss)."""
    import torch
    from lifelong_clip_tpu_torch.config import PEFTConfig
    from lifelong_clip_tpu_torch.methods.engine import (TrainState,
                                                        make_train_step)
    from lifelong_clip_tpu_torch.models import build_peft
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer

    dev = torch.device("cuda")
    _, frozen, cfg = frozen_clip(dev)
    peft_cfg = PEFTConfig(method="lora", encoder="both", lora_r=4)
    peft = build_peft(torch.Generator().manual_seed(1), cfg, peft_cfg,
                      device=dev)
    state = TrainState(trainable=peft, frozen=frozen,
                       make_opt=lambda lv: make_optimizer("adamw", lv, 5e-4),
                       gen=torch.Generator().manual_seed(2))
    step = make_train_step(cfg, peft_cfg, image_size=cfg.image_size,
                           mean=MEAN, std=STD, augment=True,
                           use_autoaug=True, autoaug_policy="cifar10",
                           cached_text=False)
    images, labels, tokens = gate_batch(cfg, n_cls, bs)
    batch = {"images": images.to(dev), "labels": labels.to(dev),
             "tokens": tokens.to(dev), "mask": torch.zeros(n_cls, device=dev)}
    return cfg, state, lambda: step(state, batch)["loss"]


@clocked
def lora_both_gate(card):
    """The both-tower gate (``lora_both_setup``), with the launch counters
    set to 0 just before it and read just after: every step runs the fused
    block forward and backward once a layer of each tower."""
    import torch
    cfg, _, run_step = lora_both_setup()
    steps = []

    def one_step():
        steps.append(1)
        return run_step()

    reset_launches()
    out = gate_loop("lora-clip both towers", one_step, 64, card,
                    model="ViT-B/16 LoRA r=4 on both towers, 100 uncached "
                    "class rows, AutoAugment cifar10")
    torch.cuda.synchronize()
    launches = launch_counts()
    n = len(steps) * (cfg.vision_layers + cfg.text_layers)
    assert launches["fused_ln_attention_fwd"] == n and \
        launches["fused_ln_attention_bwd"] == n and \
        launches["flash_attention_fwd"] == 0, (launches, len(steps))
    out["launches"] = launches
    log(f"lora-clip both towers gate: {len(steps)} steps, launches "
        f"{launches}")
    return out


def mvp_setup(lr=MVP_GATE_LR, remat=False):
    """mvp-clip's train step (with the class mask) on one batch of 64;
    ``remat`` checkpoints its ``mvp_features`` call. The contrastive
    similarity loss is off: it rescales by the prompt usage counts, which
    grow by the batch size every step whatever the step learns, so on one
    batch it is no learning signal; the mean selected-key distance that
    replaces it is (and costs the same to compute). Returns (state, one
    step returning its loss)."""
    import torch
    from lifelong_clip_tpu_torch.methods.engine import TrainState
    from lifelong_clip_tpu_torch.methods.mvp_clip import (
        make_mvp_text_fn, make_mvp_train_step)
    from lifelong_clip_tpu_torch.models.mvp_clip import init_mvp_params
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer

    dev = torch.device("cuda")
    _, frozen, cfg = frozen_clip(dev)
    n_cls, bs = 64, 64
    mvp = init_mvp_params(torch.Generator().manual_seed(1), cfg, e_pool=10,
                          num_classes=n_cls, device=dev)
    state = TrainState(trainable=mvp, frozen=frozen,
                       make_opt=lambda lv: make_optimizer("adamw", lv, lr),
                       gen=torch.Generator().manual_seed(2))
    step = make_mvp_train_step(cfg, image_size=cfg.image_size, mean=MEAN,
                               std=STD, use_mask=True, remat=remat)
    images, labels, tokens = gate_batch(cfg, n_cls, bs)
    batch = {"images": images.to(dev), "labels": labels.to(dev),
             "txt": make_mvp_text_fn(cfg)(frozen, tokens.to(dev)),
             "mask": torch.zeros(n_cls, device=dev),
             "slot_globals": torch.arange(n_cls, device=dev)}
    holder = [torch.zeros(10, device=dev)]

    def one_step():
        holder[0], m = step(state, batch, holder[0])
        return m["loss"]

    return state, one_step


@clocked
def mvp_learning_gate(card, lr=MVP_GATE_LR):
    """mvp-clip's gate (``mvp_setup``): 22 steps must lower the loss by more
    than 0.02."""
    _, one_step = mvp_setup(lr)
    return gate_loop("mvp-clip", one_step, 64, card, lr=lr,
                     model="ViT-B/16 mvp-clip (mask, P = 20), no AutoAugment")


# each gate's trainer: its main path's argv (the scripts' row)
GATE_ARGV = {"l2p": ["--method", "l2p"] + VIT_PROMPT_ARGV,
             "dualprompt": ["--method", "dualprompt"] + VIT_PROMPT_ARGV,
             "mvp": ["--method", "mvp"] + VIT_PROMPT_ARGV + MVP_FLAGS,
             "adapter-clip-proto_prompt": PROTO_ARGV}


def prompt_trainer(method, tmp, device="cuda", class_names=None):
    """A trainer of ``method`` built as ``main`` builds it from
    ``GATE_ARGV``, over a 100-class synthetic set (so a batch can hold 64
    classes; ``class_names`` in place of its own)."""
    import dataclasses
    from lifelong_clip_tpu_torch import main as cli
    from lifelong_clip_tpu_torch.data.registry import make_synthetic
    parser = cli.base_parser()
    args = parser.parse_args(GATE_ARGV[method] + [
        "--dataset", "synthetic-100", "--log_path", tmp, "--device", device])
    data = make_synthetic(n_classes=100, per_class=2, image_size=32, seed=0)
    if class_names is not None:
        data = dataclasses.replace(data, class_names=list(class_names))
    return cli.trainer_class(method, args, parser)(
        cli.args_to_config(args), train_dataset=data, test_dataset=data)


def gate_names(n=100, seed=3):
    """``n`` distinct made-up class names of six letters (two or three BPE
    tokens each): unlike the synthetic set's "pattern 0" .. "pattern 99",
    which differ in a digit token, their rows give a random text tower
    class features that differ."""
    import numpy as np
    rng = np.random.default_rng(seed)
    names = set()
    while len(names) < n:
        names.add("".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), 6)))
    return sorted(names)


def proto_gate_batch(seed=1):
    """ProtoCLIP's gate batch of 64, on the CPU: ``PROTO_LIVE`` classes of
    64 / ``PROTO_LIVE`` samples, each class one solid colour (a random
    image tower tells noise images too little apart for the step to learn
    their classes: PERF.md). Returns (images, labels)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    per = 64 // PROTO_LIVE
    labels = np.repeat(rng.permutation(100)[:PROTO_LIVE], per)
    colours = rng.integers(0, 255, (PROTO_LIVE, 1, 1, 3)).astype(np.uint8)
    images = np.repeat(np.broadcast_to(colours, (PROTO_LIVE, 32, 32, 3)),
                       per, 0)
    return torch.from_numpy(images), torch.from_numpy(labels)


def gate_step(tr, method, images, labels, dev):
    """(the train step, its batch on the card) of ``tr`` on ``images`` /
    ``labels``: ProtoCLIP's stage 1 on a class table of 64 slots (the
    batch's classes, the rest -inf padding), the other trainers' step over
    the exposed classes."""
    import numpy as np
    import torch
    tr.vocab.expose(labels.numpy())
    if method == "adapter-clip-proto_prompt":
        tokens, mask, y, _ = tr.vocab.batch_table(labels.numpy(), 64)
        batch = {"tokens": torch.from_numpy(tokens).long().to(dev)}
        step = tr.stage1_step
    else:
        mask, y = tr.vocab.logit_mask(), tr.vocab.remap(labels.numpy())
        batch, step = {}, tr.train_step
    batch.update(images=images.to(dev), labels=torch.from_numpy(
        np.asarray(y)).long().to(dev), mask=torch.from_numpy(
        np.asarray(mask, np.float32)).to(dev))
    return step, batch


def record_ce(tr):
    """Wrap ``tr.objective`` to keep each step's cross entropy of its
    logits (MVP's before GSF weights it and the key loss is added).
    Returns the list it appends to."""
    import torch.nn.functional as F
    ces, objective = [], tr.objective

    def recording(frozen, trainable, images, batch, count):
        loss, logits, new_count = objective(frozen, trainable, images, batch,
                                            count)
        ces.append(F.cross_entropy(logits.detach(), batch["labels"]))
        return loss, logits, new_count

    tr.objective = recording
    return ces


# ProtoCLIP's gate: PROTO_LIVE classes on its 64-slot class table
# (``proto_gate_batch``); the loss must end PROTO_MARGIN below
# log(PROTO_LIVE), the loss of a step that tells no class from another
PROTO_LIVE = 8
PROTO_MARGIN = 0.1
GATE_MODELS = {
    "l2p": "vit_base_patch16_224 L2P (pool 10, 5 of length 5 selected, "
           "T = 222), Adam 5e-3, AutoAugment",
    "dualprompt": "vit_base_patch16_224 DualPrompt (g 5 at layers 0-1, e 20 "
                  "at 2-4), Adam 5e-3, AutoAugment",
    "mvp": "vit_base_patch16_224 MVP (mask, contrastive, AFS, GSF), Adam "
           "5e-3, AutoAugment; gated on the cross entropy before GSF",
    "adapter-clip-proto_prompt": f"ViT-B/16 ProtoCLIP stage 1, {PROTO_LIVE} "
                                 f"classes (made-up names, one solid "
                                 f"colour each) on a 64-slot "
                                 f"class table (suffix 64 x 8 = 512 tokens, "
                                 f"lp = 25), AdamW 5e-4, AutoAugment"}


@clocked
def prompt_gate(card, method, device="cuda"):
    """The learning gate of ``method``'s train step (``prompt_trainer``) on
    one batch of 64, with the launch counters set to 0 just before and read
    just after: every step launches exactly ``STEP_LAUNCHES``. MVP's gate
    reads the cross entropy before GSF weights it: GSF scales the loss by
    mean(ign ** gamma), a statistic of the head's per-sample gradients that
    grows as the head trains, so the loss it scales can rise while the
    step learns (PERF.md). ProtoCLIP's (``proto_gate_batch``) runs its
    suffix pass at 64 x 512 x 512 under the block-diagonal mask, and must
    also end ``PROTO_MARGIN`` below log(``PROTO_LIVE``)."""
    import torch
    proto = method == "adapter-clip-proto_prompt"
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        tr = prompt_trainer(method, tmp, device,
                            class_names=gate_names() if proto else None)
        if proto:
            images, labels = proto_gate_batch()
        else:
            images, labels, _ = gate_batch(tr.clip_cfg, 64, 64)
        step, batch = gate_step(tr, method, images, labels, dev)
        ces = record_ce(tr) if method == "mvp" else None
        steps = []

        def one_step():
            steps.append(1)
            loss = step(batch)["loss"]
            return loss if ces is None else ces[-1]

        label = {"adapter-clip-proto_prompt": "ProtoCLIP stage 1"}.get(
            method, method)
        reset_launches()
        out = gate_loop(label, one_step, 64, card, model=GATE_MODELS[method],
                        **({"suffix_len": tr.suffix_len} if proto else {}))
        torch.cuda.synchronize()
        launches = launch_counts()
        per_step_launches(method, launches, len(steps))
        out["launches"] = launches
        if proto:
            chance = math.log(PROTO_LIVE)
            out["chance_loss"] = chance
            assert out["loss_last"] < chance - PROTO_MARGIN, (
                f"{label} ended at {out['loss_last']:.4f}, not "
                f"{PROTO_MARGIN} below log {PROTO_LIVE} = {chance:.4f}")
        log(f"{label} gate: {len(steps)} steps, launches {launches}")
        del tr
    return out


def host_step_ms(run_step, steps=5):
    """Host ms a train step over ``steps`` steps, closed by a loss read."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = run_step()
    float(loss)
    return (time.perf_counter() - t0) / steps * 1e3


@clocked
def remat_phase(card):
    """The lora-clip and mvp-clip gate steps (``lora_setup``,
    ``mvp_setup``) without remat and with it, each from the same seeds on
    the same batch: one step's loss and trainable grads must agree bit for
    bit (the kernels are deterministic, and remat only reschedules the
    work: the backward recomputes the forward instead of keeping its
    intermediates), and lora-clip's peak device memory over that step must
    fall. Each prints the peak memory, the device-busy ms of a step
    (torch.profiler over 3 more steps) and the step ms (``host_step_ms``)."""
    import gc
    import torch
    from lifelong_clip_tpu_torch.methods.engine import tree_leaves
    out = {}
    for label, setup in (("lora-clip", lambda r: lora_setup(remat=r)[1:3]),
                         ("mvp-clip", lambda r: mvp_setup(remat=r))):
        runs, kept = {}, {}
        for remat in (False, True):
            state, run_step = setup(remat)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            loss = run_step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            kept[remat] = (loss.detach().clone(),
                           [p.grad.detach().clone()
                            for p in tree_leaves(state.trainable)])
            runs[remat] = {"loss": float(loss), "peak_allocated_gb": peak / 1e9,
                           "allocated_before_step_gb": before / 1e9,
                           "device_busy_ms_per_step": device_ms(
                               run_step, iters=3, warmup=1),
                           "step_ms": host_step_ms(run_step)}
            del state, run_step
        same = torch.equal(kept[False][0], kept[True][0]) and all(
            torch.equal(a, b) for a, b in zip(kept[False][1], kept[True][1]))
        log(f"remat {label}: {json.dumps(runs)}, bitwise equal loss and "
            f"grads {same}")
        assert same, f"{label}: remat changed the loss or the grads"
        # per-block checkpoints lower lora-clip's peak; mvp-clip's one
        # checkpoint of the whole prompted tower (as JAX places it) holds
        # the tower's intermediates again while its recompute is
        # differentiated, so its peak need not fall
        assert label != "lora-clip" or runs[True]["peak_allocated_gb"] < \
            runs[False]["peak_allocated_gb"], (label, runs)
        out[label] = {"without_remat": runs[False], "with_remat": runs[True],
                      "bitwise_equal": same}
    return {"remat": out, "card": card}


def maple_setup(lr=5e-4):
    """MaPLe's train step (``scripts/maple.sh``: ViT-B/16, AdamW, lr 5e-4)
    through the engine's ``forward_fn`` on one batch of 64 images and a
    64-class token table."""
    import torch
    from lifelong_clip_tpu_torch.config import PEFTConfig
    from lifelong_clip_tpu_torch.methods.engine import (TrainState,
                                                        make_train_step)
    from lifelong_clip_tpu_torch.methods.maple import CTX_INIT
    from lifelong_clip_tpu_torch.models.maple import (init_maple_params,
                                                      maple_forward)
    from lifelong_clip_tpu_torch.utils.tokenizer import default_tokenizer
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer

    dev = torch.device("cuda")
    params, frozen, cfg = frozen_clip(dev)
    learner = init_maple_params(
        torch.Generator().manual_seed(1), params, cfg, n_ctx=3, depth=3,
        ctx_init_tokens=default_tokenizer().encode(CTX_INIT), device=dev)
    state = TrainState(trainable=learner, frozen=frozen,
                       make_opt=lambda lv: make_optimizer("adamw", lv, lr),
                       gen=torch.Generator().manual_seed(2))
    step = make_train_step(
        cfg, PEFTConfig(method="maple"), image_size=cfg.image_size,
        mean=MEAN, std=STD, augment=True,
        forward_fn=lambda f, tr, im, tok: maple_forward(f, tr, im, tok, cfg,
                                                        3))
    n_cls, bs = 64, 64
    images, labels, tokens = gate_batch(cfg, n_cls, bs)
    batch = {"images": images.to(dev), "labels": labels.to(dev),
             "tokens": tokens.to(dev), "mask": torch.zeros(n_cls, device=dev)}
    return state, step, batch


@clocked
def maple_learning_gate(card, lr=5e-4):
    state, step, batch = maple_setup(lr)
    return gate_loop("maple", lambda: step(state, batch)["loss"], 64, card,
                     lr=lr, model="ViT-B/16 MaPLe (n_ctx 3, depth 3, 64 "
                     "classes), no AutoAugment")


PL_PROMPTS = 20


def prompted_lora_setup(lr=5e-4, loss="ce_on_probs"):
    """The prompted-LoRA tower step: ``encode_image`` on ViT-B/16 with LoRA
    r=4, alpha 1 on the image tower and (12, 64, 20, 768) raw KV prompts,
    ``attn_impl="fused"``, ``base_grads=False``; logits against cached
    class-text features, ``ce_on_probs_loss``, AdamW over the LoRA tree and
    the prompts. Every block takes the flash-attention op (a KV prefix with
    LoRA). No registered method builds this block: it is the JAX package's
    only road to its flash kernels. ``loss="ce"``: plain cross entropy on
    the logits instead. Returns (cfg, state, step, batch, forward)."""
    import torch
    from lifelong_clip_tpu_torch.config import PEFTConfig
    from lifelong_clip_tpu_torch.methods.engine import (
        TrainState, ce_on_probs_loss, make_text_feature_fn, make_train_step)
    from lifelong_clip_tpu_torch.models import build_peft
    from lifelong_clip_tpu_torch.models import clip as clip_fns
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer

    dev = torch.device("cuda")
    _, frozen, cfg = frozen_clip(dev)
    peft_cfg = PEFTConfig(method="lora", encoder="image", lora_r=4)
    peft = build_peft(torch.Generator().manual_seed(1), cfg, peft_cfg,
                      device=dev)
    n_cls, bs = 64, 64
    prompts = torch.randn(cfg.vision_layers, bs, PL_PROMPTS,
                          cfg.vision_width,
                          generator=torch.Generator().manual_seed(3)).to(dev)
    state = TrainState(trainable={"vision": peft["vision"],
                                  "prompts": prompts},
                       frozen=frozen,
                       make_opt=lambda lv: make_optimizer("adamw", lv, lr),
                       gen=torch.Generator().manual_seed(2))

    def forward(frozen, trainable, images, txt):
        img = clip_fns.normalize(clip_fns.encode_image(
            frozen, images, cfg, peft_cfg=peft_cfg,
            peft=trainable["vision"], layer_prompts=trainable["prompts"],
            attn_impl="fused", base_grads=False))
        scale = torch.exp(frozen["logit_scale"]).float()
        return scale * (img.float() @ txt.float().T), img, txt

    step = make_train_step(cfg, peft_cfg, image_size=cfg.image_size,
                           mean=MEAN, std=STD, augment=True,
                           forward_fn=forward,
                           loss_fn=ce_on_probs_loss if loss == "ce_on_probs"
                           else None)
    images, labels, tokens = gate_batch(cfg, n_cls, bs)
    txt = make_text_feature_fn(cfg, peft_cfg)(frozen, peft, tokens.to(dev))
    batch = {"images": images.to(dev), "labels": labels.to(dev),
             "tokens": txt, "mask": torch.zeros(n_cls, device=dev)}
    return cfg, state, step, batch, forward


@clocked
def prompted_lora_phase(steps=3):
    """The flash kernels' path: ``steps`` prompted-LoRA train steps and one
    eval forward, with the launch counters set to 0 just before and read
    just after. Each step must launch flash 12 times forward and 12 times
    backward, the eval forward 12 times, and nothing else."""
    import numpy as np
    import torch
    from lifelong_clip_tpu_torch.ops import preprocess
    cfg, state, step, batch, forward = prompted_lora_setup()
    eval_pipe = preprocess.make_eval_pipeline(cfg.image_size, MEAN, STD)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    per_step, losses = [], []
    for _ in range(steps):
        before = launch_counts()
        losses.append(float(step(state, batch)["loss"]))
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    with torch.no_grad():
        logits, img, _ = forward(state.frozen, state.trainable,
                                 eval_pipe(batch["images"]), batch["tokens"])
    ok = bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    assert np.isfinite(losses).all() and ok, (losses, ok)
    assert tuple(img.shape) == (64, cfg.embed_dim), img.shape
    for d in per_step:
        assert d["flash_attention_fwd"] == d["flash_attention_bwd"] == \
            cfg.vision_layers, d
    assert launches["flash_attention_fwd"] == cfg.vision_layers * (steps + 1) \
        and launches["flash_attention_bwd"] == cfg.vision_layers * steps \
        and sum(launches.values()) == cfg.vision_layers * (2 * steps + 1), \
        launches
    log(f"prompted-LoRA path: {steps} train steps and one eval forward in "
        f"{wall:.1f} s, losses {losses}, launches {launches}, per step "
        f"{per_step}")
    return launches, {"train_steps": steps, "wall_s": wall, "losses": losses,
                      "per_step": per_step}


@clocked
def prompted_lora_gate(card):
    """22 prompted-LoRA steps on one batch, with plain cross entropy as the
    lora-clip gate has it: CE on softmaxed probabilities keeps the loss
    within ~1/C of ln C, where 22 steps on one batch move it by less than
    the gate's 0.02."""
    _, state, step, batch, _ = prompted_lora_setup(loss="ce")
    return gate_loop("prompted-LoRA", lambda: step(state, batch)["loss"], 64,
                     card, model="ViT-B/16 LoRA r=4 + 20 raw KV prompts a "
                     "layer (flash attention), no AutoAugment")


TP_SLOTS = MVP_SHAPE[4]     # text prompt slots a layer: mvp-clip's count
TP_CLASSES = 100            # CIFAR-100's class rows (lora_both_setup)
TP_IMAGES = 64              # fixed image features the class rows are fit to
TP_LR = 1e-3
# (label, text LoRA rank): prompts alone take #3/#4, with LoRA #5/#6
TP_VARIANTS = (("text prompts", 0), ("text prompts + LoRA r=4", 4))
# (road, attn_impl, bf16): the kernels, the library calls, the reference
TP_ROADS = (("kernel", "fused", True), ("library", "unfused", True),
            ("fp32", "unfused", False))


def text_prompt_setup(tower, lora_r, impl, bf16):
    """Text-side KV-prefix prompts trained on ViT-B/16's text tower at full
    width (12 layers, 512 wide, 8 heads) through ``encode_text(...,
    layer_prompts=...)``: (12, TP_SLOTS, 512) prompts broadcast over
    TP_CLASSES class-token rows (77 tokens, the causal mask with TP_SLOTS
    always-visible keys), with ``lora_r`` a text LoRA beside them; the
    class features fit to TP_IMAGES fixed unit image features under cross
    entropy over the classes, AdamW at TP_LR, ``base_grads=False``.
    ``tower``: (fp32 params, bf16 params, cfg) of ``frozen_clip``. Every
    road starts from the same seeds. Returns (trainable dict, step
    returning the loss, loss of a forward with or without the prompts)."""
    import torch
    import torch.nn.functional as F
    from lifelong_clip_tpu_torch.config import PEFTConfig
    from lifelong_clip_tpu_torch.models import build_peft
    from lifelong_clip_tpu_torch.models import clip as clip_fns
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer
    params, params16, cfg = tower
    dev = torch.device("cuda")
    frozen = params16 if bf16 else params
    dt = torch.bfloat16 if bf16 else torch.float32
    _, _, tokens = gate_batch(cfg, TP_CLASSES, 0)
    tokens = tokens.to(dev)
    g = torch.Generator().manual_seed(4)
    img = F.normalize(torch.randn(TP_IMAGES, cfg.embed_dim, generator=g),
                      dim=-1).to(dev)
    labels = torch.randint(0, TP_CLASSES, (TP_IMAGES,), generator=g).to(dev)
    trainable = {"prompts": torch.randn(
        cfg.text_layers, TP_SLOTS, cfg.text_width,
        generator=torch.Generator().manual_seed(3)).to(dev)}
    peft_cfg = None
    if lora_r:
        peft_cfg = PEFTConfig(method="lora", encoder="text", lora_r=lora_r)
        trainable["lora"] = build_peft(torch.Generator().manual_seed(1), cfg,
                                       peft_cfg, device=dev)["text"]
    leaves = [trainable["prompts"]] + (
        list(trainable["lora"]["lora"].values()) if lora_r else [])
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt, _ = make_optimizer("adamw", leaves, TP_LR)
    scale = torch.exp(params["logit_scale"]).float()

    def loss_of(prompts):
        txt = clip_fns.encode_text(
            frozen, tokens, cfg, peft_cfg=peft_cfg,
            peft=trainable.get("lora"), layer_prompts=prompts,
            compute_dtype=dt, attn_impl=impl, base_grads=False)
        logits = scale * (img @ clip_fns.normalize(txt).float().T)
        return F.cross_entropy(logits, labels)

    def step(prompts_on=True):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(trainable["prompts"] if prompts_on else None)
        loss.backward()
        opt.step()
        return loss.detach()

    def forward(prompts_on=True):
        with torch.no_grad():
            return loss_of(trainable["prompts"] if prompts_on else None)

    return trainable, step, forward


@clocked
def text_prompt_phase(card):
    """Each of ``TP_VARIANTS`` trained WHOLE_RUN_STEPS steps
    (``text_prompt_setup``) on each road of ``TP_ROADS`` from the same
    seeds, the launch counters set to 0 just before the kernel road and
    read just after. Each kernel-road step must launch #3/#4 once a text
    layer each (and build tile maps of the (77, 97) mask) without LoRA, and
    #5/#6 once a layer each with it, and nothing else; the library and fp32
    roads launch none. On the losses and on the prompts at the end
    (``whole_run_distances``: ``loss10``, ``trained``) the kernel road's
    distance from fp32 must be within WHOLE_RUN_MULTIPLE times the library
    road's. Then the kernel road's device ms a forward with the prompts
    and without them, and a step (without the prompts only where a LoRA
    trains). Returns (launches summed over the kernel roads, results)."""
    import numpy as np
    import torch
    tower = frozen_clip(torch.device("cuda"))
    cfg = tower[2]
    n = cfg.text_layers
    total = {k: 0 for k in launch_counts()}
    out, failed = [], []
    for label, lora_r in TP_VARIANTS:
        runs, per_step = {}, []
        for road, impl, bf16 in TP_ROADS:
            trainable, step, forward = text_prompt_setup(tower, lora_r, impl,
                                                         bf16)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            losses = []
            for _ in range(WHOLE_RUN_STEPS):
                before = launch_counts()
                losses.append(float(step()))
                if road == "kernel":
                    after = launch_counts()
                    per_step.append({k: after[k] - before[k] for k in after
                                     if after[k] != before[k]})
            torch.cuda.synchronize()
            launches = launch_counts()
            runs[road] = {"losses": losses,
                          "trained": trainable["prompts"].detach().float()
                          .clone(),
                          "lora": None if not lora_r else torch.cat(
                              [v.detach().float().flatten() for v in
                               trainable["lora"]["lora"].values()]),
                          "wall_s": time.perf_counter() - t0,
                          "launches": launches}
            assert np.isfinite(losses).all(), (label, road, losses)
            if road != "kernel":
                assert not any(launches.values()), \
                    f"{label}: the {road} road launched kernels {launches}"
                continue
            for k, v in launches.items():
                total[k] += v
            if lora_r:
                want = {"flash_attention_fwd": n, "flash_attention_bwd": n}
            else:
                want = {"fused_prefix_attention_fwd": n,
                        "fused_prefix_attention_bwd": n}
            for d in per_step:
                kernels = {k: v for k, v in d.items()
                           if k != "prefix_tile_map"}
                maps = d.get("prefix_tile_map", 0)
                assert kernels == want and (lora_r or maps > 0), \
                    (label, d, want)
            timing = {
                "fwd_device_ms_with_prompts": device_ms(forward),
                "fwd_device_ms_without_prompts": device_ms(
                    lambda: forward(False)),
                "step_device_ms_with_prompts": device_ms(step),
                # without LoRA nothing else trains: no step to time
                "step_device_ms_without_prompts": device_ms(
                    lambda: step(False)) if lora_r else None}
            tile_maps = launches["prefix_tile_map"]
        ref = runs["fp32"]
        dk = whole_run_distances(runs["kernel"], ref)
        dl = whole_run_distances(runs["library"], ref)
        row = {"variant": label, "steps": WHOLE_RUN_STEPS,
               "kernel": dk, "library": dl, "ratio": ratios(dk, dl),
               "losses": {r: runs[r]["losses"] for r in runs},
               "wall_s": {r: runs[r]["wall_s"] for r in runs},
               "launches_per_step": per_step[0],
               "tile_maps": tile_maps, **timing, "card": card}
        if lora_r:
            row["lora_l2"] = {r: float((runs[r]["lora"] - ref["lora"]).norm())
                              for r in ("kernel", "library")}
        over = [f"{k} {row['ratio'][k]:.3f}" for k in WHOLE_RUN_CHECKED
                if row["ratio"][k] > WHOLE_RUN_MULTIPLE]
        if over:
            failed.append(f"{label}: ratio {', '.join(over)}")
        log(f"{label}: {WHOLE_RUN_STEPS} steps; distance from fp32 (max "
            f"|dloss|, prompts' L2): kernel road {dk['loss10']:.4e}, "
            f"{dk['trained']:.4e}; library road {dl['loss10']:.4e}, "
            f"{dl['trained']:.4e}; ratio {row['ratio']['loss10']:.3f}, "
            f"{row['ratio']['trained']:.3f} (limit {WHOLE_RUN_MULTIPLE}); "
            f"launches a step {json.dumps(per_step[0])}; device ms a "
            f"forward with prompts {fmt(timing['fwd_device_ms_with_prompts'])}"
            f", without {fmt(timing['fwd_device_ms_without_prompts'])}; a "
            f"step with prompts "
            f"{fmt(timing['step_device_ms_with_prompts'])}"
            + (f", without {fmt(timing['step_device_ms_without_prompts'])}"
               if lora_r else "") + f"; {card}")
        log(json.dumps({"text_prompts": row}))
        out.append(row)
    assert not failed, f"text prompt phase checks failed: {failed}"
    return total, {"text_prompt_phase": out, "card": card}


def annotate_augmentation():
    """Run every train pipeline the port builds from here on inside a
    torch.profiler range (``AUG_RANGE``), so a step's profile splits out
    the augmentation's device time. Costs a range push and pop a step."""
    import torch
    from lifelong_clip_tpu_torch.ops import preprocess
    make = preprocess.make_train_pipeline

    def annotated(*a, **kw):
        pipe = make(*a, **kw)

        def run(gen, images_u8):
            with torch.profiler.record_function(AUG_RANGE):
                return pipe(gen, images_u8)
        return run

    preprocess.make_train_pipeline = annotated


# (label, image side, policy): CIFAR-size inputs under each policy, and the
# native high-resolution road (e.g. ImageNet-R), all resized to 224
AUG_CASES = (("32x32 cifar10", 32, "cifar10"), ("32x32 imagenet", 32,
                                                "imagenet"),
             ("32x32 svhn", 32, "svhn"), ("224x224 imagenet", 224,
                                          "imagenet"))
# exact on the card as on the CPU: integer arithmetic, selects, warps whose
# tap weights are 0 or 1; the rest within 1e-5 (sums in another order)
AUG_EXACT = ("Invert", "Posterize", "Solarize", "Equalize", "Identity",
             "TranslateX", "TranslateY")


@clocked
def augmentation_phase(card, bs=64):
    """The train pipeline alone (AutoAugment, resize + pad + crop, flip,
    normalize; bf16 out as the step) at bs 64 on uint8 images, timed with
    CUDA events and by device-busy ms, its host ms beside; then the card
    against the CPU at the same draws: every op of the table on the same
    input (``AUG_EXACT`` bit for bit, equalize among them; the rest within
    1e-5; translations by whole pixels), each AutoAugment stage from the
    same input within 1e-5, and the whole pipeline (fp32 out) within 1e-5
    at every element."""
    import numpy as np
    import torch
    from lifelong_clip_tpu_torch.ops import autoaugment as aa
    from lifelong_clip_tpu_torch.ops import preprocess
    dev = torch.device("cuda")
    make = preprocess.TrainPipeline    # the port's own, not annotated
    rows = []
    for label, side, policy in AUG_CASES:
        g = torch.Generator().manual_seed(side)
        u8 = torch.randint(0, 256, (bs, side, side, 3), dtype=torch.uint8,
                           generator=g)
        xd = u8.to(dev)
        pipe = make(224, MEAN, STD, use_autoaug=True, autoaug_policy=policy)
        gen = torch.Generator().manual_seed(0)
        row = {"case": label, "batchsize": bs, "policy": policy}
        row["ms"] = timed(lambda: pipe(gen, xd), iters=20)
        row["host_ms"] = host_ms(lambda: pipe(gen, xd), iters=20)
        row["device_busy_ms"] = device_ms(lambda: pipe(gen, xd), iters=10)
        # card against CPU
        x = u8[:8].float() / 255.0
        errs = {}
        for name, (fn, _, kind) in aa._OPS.items():
            mag = {True: -0.25, "enh": 1.6}.get(kind, 0.0)
            mag = {"Rotate": 17.0, "Posterize": 5.0,
                   "Solarize": 0.4}.get(name, mag)
            want, got = fn(x, mag), fn(x.to(dev), mag).cpu()
            errs[name] = float((got - want).abs().max())
            exact = name in AUG_EXACT
            assert (torch.equal(got, want) if exact else
                    errs[name] <= 1e-5), (label, name, errs[name])
        pick, gates, signs = aa.draw_auto_augment(
            torch.Generator().manual_seed(1), 8, policy)
        op_idx, _, mag = aa._policy_arrays(policy)
        stage_in = x
        for j in range(2):
            oi = op_idx[pick.numpy(), j]
            mg = aa._signed_mag(oi, mag[pick.numpy(), j], signs[j].numpy())
            want = aa._apply_stage_batched(stage_in, oi, mg, gates[j])
            got = aa._apply_stage_batched(stage_in.to(dev), oi, mg,
                                          gates[j]).cpu()
            errs[f"stage {j}"] = float((got - want).abs().max())
            assert errs[f"stage {j}"] <= 1e-5, (label, j, errs)
            stage_in = want
        pipe32 = make(224, MEAN, STD, use_autoaug=True, autoaug_policy=policy,
                      out_dtype=torch.float32)
        draws = pipe32.draw(torch.Generator().manual_seed(2), 8, side, side)
        want = pipe32.apply(u8[:8], draws)
        got = pipe32.apply(xd[:8], draws).cpu()
        errs["pipeline"] = float((got - want).abs().max())
        assert errs["pipeline"] <= 1e-5, (label, errs)
        assert tuple(got.shape) == (8, 224, 224, 3) and \
            bool(np.isfinite(got.numpy()).all())
        row["card_vs_cpu_max_abs_err"] = errs
        log(f"augmentation {json.dumps(row)}")
        rows.append(row)
    return {"augmentation": rows, "card": card}


class Preempted(Exception):
    """Stands for a run killed right after a checkpoint."""


def same_tree(a, b):
    """Bitwise equality of two checkpoint trees (dicts, lists, tensors,
    numpy arrays, numbers)."""
    import numpy as np
    import torch
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@clocked
def checkpoint_phase(label="lora-clip", argv=LORA_SCRIPT_ARGV, owner=None,
                     attr="make_train_step"):
    """Checkpoint/resume on the card through ``main``, by default with
    ``scripts/lora_clip.sh``'s flags (LoRA on both towers, AutoAugment,
    the prefetcher uploading through pinned memory; ViT-B/16,
    synthetic-20, bs 64, 2 tasks), and for moe-clip with
    ``scripts/adapter_clip.sh``'s (its gate noise drawn from the train
    state's generator, which the checkpoint keeps): an uninterrupted run; a
    run stopped right after task 0's checkpoint; and a run
    ``--resume_from`` that checkpoint, which trains task 1 through
    ``run``. The resumed run's task-1 losses, result and final PEFT
    tensors must equal the uninterrupted run's bit for bit (the kernels
    use no atomics), and so must the method state each run's last
    checkpoint keeps outside the train state (``checkpoint_extra``: L2P's
    frequency counter; ProtoCLIP's prototypes, covariances and task
    counter; EWC++'s Fisher, score, importance and task snapshot; RM's
    view generator), the replay memory with its generators, and the lr of
    the next update (RM's, after its memory epochs). The train steps'
    losses are collected through ``owner``'s ``attr`` (``wrap_step``)."""
    import torch
    from lifelong_clip_tpu_torch import main as cli
    from lifelong_clip_tpu_torch.methods import adapter_clip
    from lifelong_clip_tpu_torch.methods.base import OnlineTrainer
    from lifelong_clip_tpu_torch.utils.checkpoints import load_checkpoint

    argv = list(argv) + ["--device", "cuda"]
    owner = adapter_clip if owner is None else owner
    save = OnlineTrainer._maybe_checkpoint
    losses = []

    def collect(step):
        def run(*b, **k):
            out = step(*b, **k)
            losses.append(out["loss"])
            return out
        return run

    def preempt_after_task_0(self, task_id):
        save(self, task_id)
        if task_id == 0:
            raise Preempted

    def drive(tmp, name, *extra):
        losses.clear()
        log_path = os.path.join(tmp, name)
        try:
            result = cli.main(argv + ["--log_path", log_path, *extra])
        except Preempted:
            result = None
        torch.cuda.synchronize()
        found = [os.path.join(d, "result.txt")
                 for d, _, fs in os.walk(log_path) if "result.txt" in fs]
        text = open(found[0]).read() if found else None
        return result, text, list(losses)

    restore = wrap_step(owner, attr, collect)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck_full = os.path.join(tmp, "ck_full")
            ck_cut = os.path.join(tmp, "ck_cut")
            t0 = time.perf_counter()
            full, full_txt, full_l = drive(tmp, "full", "--ckpt_dir", ck_full)
            OnlineTrainer._maybe_checkpoint = preempt_after_task_0
            try:
                _, cut_txt, cut_l = drive(tmp, "cut", "--ckpt_dir", ck_cut)
            finally:
                OnlineTrainer._maybe_checkpoint = save
            cursor = load_checkpoint(ck_cut)["cursor"]
            got, got_txt, got_l = drive(tmp, "resumed", "--ckpt_dir", ck_cut,
                                        "--resume_from", ck_cut)
            wall = time.perf_counter() - t0
            want_ck, got_ck = load_checkpoint(ck_full), load_checkpoint(ck_cut)
            want_t = want_ck["state"]["trainable"]
            got_t = got_ck["state"]["trainable"]
            same_extra = same_tree(want_ck["extra"], got_ck["extra"])
            # the lr the next update takes (RM sets it in place) and the
            # replay memory, its generators' states included
            lrs = [[g["lr"] for g in ck["state"]["opt"]["param_groups"]]
                   for ck in (want_ck, got_ck)]
            same_memory = same_tree(want_ck["memory"], got_ck["memory"])
    finally:
        restore()
    n0 = len(cut_l)
    same_before = len(full_l) > n0 > 0 and all(
        torch.equal(a, b) for a, b in zip(full_l[:n0], cut_l))
    same_loss = len(got_l) == len(full_l) - n0 and all(
        torch.equal(a, b) for a, b in zip(full_l[n0:], got_l))
    same = [torch.equal(a, b) for a, b in zip(want_t, got_t)]
    out = {"checkpoint": {
        "method": label, "cursor": cursor, "task0_steps": n0,
        "task1_steps": len(got_l),
        "first_task1_loss": float(full_l[n0]) if len(full_l) > n0 else None,
        "resumed_first_task1_loss": float(got_l[0]) if got_l else None,
        "bitwise_equal_task0_losses": same_before,
        "bitwise_equal_task1_losses": same_loss,
        "bitwise_equal_peft_tensors": f"{sum(same)} of {len(same)}",
        "bitwise_equal_extra_state": same_extra,
        "extra_state_keys": sorted(want_ck["extra"]),
        "lr": lrs[0], "resumed_lr": lrs[1],
        "bitwise_equal_memory": same_memory,
        "equal_result": got == full and got_txt == full_txt,
        "result": full, "wall_s": wall}}
    log(json.dumps(out))
    assert cut_txt is None and cursor["task_id"] == 1, out
    assert same_before and same_loss and same and all(same), out
    assert same_extra and same_memory and lrs[0] == lrs[1], out
    assert full_txt is not None and got == full and got_txt == full_txt, out
    return out


PORT_KERNELS = ("gemm_kernel", "gemm_pingpong_kernel", "attn_fwd_kernel",
                "attn_fwd_tiled_kernel", "attn_bwd_dq_tiled_kernel",
                "attn_bwd_dq_tiled_map_kernel",
                "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel", "ln_fwd_kernel",
                "ln_bwd_bulk_kernel", "ln_partials_kernel", "cast_bf16_kernel",
                "partial_sums_kernel", "splitk_reduce_kernel",
                "mask_tile_map_kernel", "flash_fwd_kernel",
                "flash_fwd_tc_kernel", "flash_fwd_tc_tiled_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel",
                "attn_fwd_wgmma_kernel", "attn_bwd_wgmma_kernel",
                "attn_fwd_wgmma_long_kernel", "attn_bwd_wgmma_long_kernel")


# -- the mesh phase: 2 ranks sharing one card ---------------------------------

MESH_STEPS = 3
# mvp-clip with --use_mask --use_contrastiv; moe-clip as
# scripts/adapter_clip.sh at one update a batch (its online_iter 3 would
# take the grads the checks read from weights the two sides moved apart)
MVP_DP_ARGV = ["--method", "mvp-clip", "--model_name", "ViT-B/16",
               "--dataset", "synthetic-20", "--n_tasks", "2",
               "--batchsize", "64", "--use_mask", "--use_contrastiv"]
MOE_EP_ARGV = ["--method", "moe-clip"] + argv_with(ADAPTER_ARGV,
                                                    online_iter=1)
# the data-parallel cases: lora-clip as scripts/lora_clip.sh sets it,
# Finetuning at scripts/er.sh's batch of 16 with the whole tower training
# and neither a memory nor a temp batch (FT keeps no memory: under er.sh's
# temp batch of 8 each step tiles 8 stream samples to 16, and the two ranks
# would hold the same rows)
MESH_DP = [("lora-clip DP", LORA_SCRIPT_ARGV), ("mvp-clip DP", MVP_DP_ARGV),
           ("Finetuning DP", argv_with(ER_FAMILY_ARGV["Finetuning"],
                                       memory_size=0, temp_batchsize=0))]
# the planted faults of the controls (``plant``)
MESH_FAULTS = ("grads not reduced", "grads averaged twice")
# limits, each between the sound readings and the planted faults' (PERF.md
# section 6, PR 11; H100 80GB HBM3, 700 W): step 1's worst grad difference
# over that grad's largest entry on the data-parallel road (bf16, the
# kernels; sound 1.52e-3 to 2.14e-2, faults 0.50 to 2.0) and on the model
# axis in fp32 (sound 2.89e-6, 5.71e-6); the share of trainable entries
# whose step-1 update is more than one update off the reference's
# (AdamW's first update is lr times the grad's sign, so these are the
# entries whose grad changed sign; sound up to 2.30e-3, the unreduced
# grads of lora-clip and mvp-clip 1.21e-2 to 0.209); a bf16 model-axis
# step against the fp32 1-process step: each leaf's grad within
# BF16_FACTOR times as far as the bf16 1-process step's, the loss within
# BF16_LOSS_RTOL (sound 0.9e-5 to 7.9e-5; a row-parallel sum left
# partial moves a tiny tower's loss by 4.2e-3 to 5.1e-3)
DP_GRAD_LIMIT = 5e-2
MODEL_AXIS_GRAD_LIMIT = 1e-3
MOVED_LIMIT = 5e-3
BF16_FACTOR = 2.0
BF16_LOSS_RTOL = 5e-4


def mesh_case(label, argv, mesh, steps=1, ref_argv=None, fault=None):
    """A mesh phase case: ``argv`` under ``mesh`` for ``steps`` steps,
    held against the 1-process steps of ``ref_argv`` (default ``argv``;
    with a model axis on the ``"unfused"`` road, as the axis runs it);
    ``fault``: one of ``MESH_FAULTS``, planted in the ranks."""
    return {"label": label, "argv": argv, "mesh": tuple(mesh),
            "steps": steps, "ref_argv": ref_argv or argv, "fault": fault}


# the model-axis steps in fp32 (--no_bf16), where only the order of the
# partial sums differs from the 1-process step's, and in bf16, as users run
# them, against the same fp32 step beside the bf16 1-process step
MESH_CASES = (
    [mesh_case(lab, argv, (2, 1), MESH_STEPS) for lab, argv in MESH_DP]
    + [mesh_case("lora-clip TP", LORA_SCRIPT_ARGV + ["--no_bf16"], (1, 2)),
       mesh_case("moe-clip EP", MOE_EP_ARGV + ["--no_bf16"], (1, 2)),
       mesh_case("lora-clip TP, bf16", LORA_SCRIPT_ARGV, (1, 2),
                 ref_argv=LORA_SCRIPT_ARGV + ["--no_bf16"]),
       mesh_case("moe-clip EP, bf16", MOE_EP_ARGV, (1, 2),
                 ref_argv=MOE_EP_ARGV + ["--no_bf16"])]
    + [mesh_case(f"{lab}, {fault}", argv, (2, 1), fault=fault)
       for lab, argv in MESH_DP for fault in MESH_FAULTS])


@contextlib.contextmanager
def eval_pixels():
    """The train pipeline replaced by the eval preprocessing while the
    block runs, and put back after: the ranks draw their own augmentation
    by design, so the mesh steps are held on the same pixels."""
    from lifelong_clip_tpu_torch.ops import preprocess
    real = preprocess.make_train_pipeline

    def same_pixels(image_size, mean, std, out_dtype=None, **_):
        pipe = preprocess.make_eval_pipeline(image_size, mean, std,
                                             out_dtype=out_dtype)
        return lambda gen, x: pipe(x)

    preprocess.make_train_pipeline = same_pixels
    try:
        yield
    finally:
        preprocess.make_train_pipeline = real


def mesh_trainer(argv, mesh, device, tmp, unfused=False, **attrs):
    """The trainer ``main`` builds from ``argv``, here on ``device`` under
    ``mesh``; ``unfused``: its towers on the ``"unfused"`` road (a model
    axis chooses it by itself); ``attrs``: more class attributes."""
    import dataclasses
    from lifelong_clip_tpu_torch import main as cli
    parser = cli.base_parser()
    args = parser.parse_args(argv + ["--log_path", tmp, "--transforms"])
    cfg = dataclasses.replace(cli.args_to_config(args), device=str(device),
                              mesh_shape=tuple(mesh))
    cls = cli.trainer_class(cfg.method, args, parser)
    if unfused:
        attrs = {"_attn_impl": "unfused", **attrs}
    return type(cls.__name__, (cls,), attrs)(cfg) if attrs else cls(cfg)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_steps(tr, steps, calls=()):
    """``steps`` online steps on the first batches of the trainer's own
    stream (the same in every process): each step's loss and ms (host
    clock to a synchronize), the kernels' launches over them, the
    trainable tree before step 1 (``start``), after it with its grads
    (``first``: the one step both sides take from the same weights) and
    after the last (``last``); with ``calls`` (``collective_meter``'s
    record) each step's collective ms."""
    idx = tr.stream.task_indices[0]
    bs = tr.cfg.batchsize
    start = {k: p for k, (p, _) in trainable_of(tr).items()}
    reset_launches()
    losses, ms, coll_ms = [], [], []
    for i in range(steps):
        before = len(calls)
        batch_idx = idx[i * bs:(i + 1) * bs]
        images, labels = tr.train_dataset.gather(batch_idx)
        tr.vocab.expose(labels)
        sync(tr.device)
        t0 = time.perf_counter()
        st = tr.online_step(images, labels, batch_idx)
        sync(tr.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(sum(c[2] for c in calls[before:]))
        losses.append(float(st["loss"]))
        if i == 0:
            first = trainable_of(tr)
    return {"losses": losses, "step_ms": ms, "launches": launch_counts(),
            "start": start, "first": first, "coll_ms": coll_ms,
            "last": {k: p for k, (p, _) in trainable_of(tr).items()}}


def walk_tree(t, path=()):
    """("key/path", leaf) over a nested dict/list tree, None left out."""
    if isinstance(t, dict):
        for k, v in t.items():
            yield from walk_tree(v, path + (str(k),))
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from walk_tree(v, path + (str(i),))
    elif t is not None:
        yield "/".join(path), t


def host(t):
    """An fp32 copy on the host, also of a tensor on the CPU already."""
    import torch
    return t.detach().to("cpu", torch.float32, copy=True)


def trainable_of(tr):
    """{key path: (leaf, grad)} of the trainable tree, on the host."""
    return {k: (host(p), None if p.grad is None else host(p.grad))
            for k, p in walk_tree(tr.state.trainable)}


def step1_errors(got, ref, by_leaf=False):
    """A run's trainable tree against the reference's (``mesh_steps``'s
    records). After step 1, taken from the same weights: the worst grad
    difference over that grad's largest entry (and its leaf; with
    ``by_leaf`` each leaf's), and the
    share of entries whose update is more than one update (the reference's
    largest step-1 move) off the reference's; after the last step, where
    both took as many, the worst entry difference (reported: AdamW moves
    every entry by about lr a step whatever its grad, so it holds nothing
    beyond step 1; None where the steps differ)."""
    want, start = ref["first"], ref["start"]
    assert got["first"].keys() == want.keys() == start.keys()
    move = max(float((p - start[k]).abs().max())
               for k, (p, _) in want.items())
    same = len(got["losses"]) == len(ref["losses"])
    grad_rel, worst_leaf, moved, total, last = 0.0, "", 0, 0, 0.0
    rels = {}
    for k, (p, g) in want.items():
        q, h = got["first"][k]
        moved += int(((q - p).abs() > move).sum())
        total += p.numel()
        if same:
            last = max(last, float((got["last"][k] - ref["last"][k])
                                   .abs().max()))
        if g is not None and h is not None and float(g.abs().max()) > 0:
            rels[k] = rel = float((h - g).abs().max() / g.abs().max())
            if rel > grad_rel:
                grad_rel, worst_leaf = rel, k
    out = {"step1_grad_max_rel": grad_rel, "step1_worst_grad": worst_leaf,
           "step1_moved_share": moved / total, "step1_move": move,
           "last_max_diff": last if same else None}
    if by_leaf:
        out["step1_grad_rel_by_leaf"] = rels
    return out


def collective_meter(device):
    """Wrap ``torch.distributed.all_reduce`` and ``all_gather_into_tensor``
    to count each call's bytes and time it between two synchronizes;
    returns the record list, (op, bytes, ms) a call, and a function that
    puts the two back."""
    import torch.distributed as dist
    calls = []
    real = dist.all_reduce, dist.all_gather_into_tensor

    def restore():
        dist.all_reduce, dist.all_gather_into_tensor = real

    def metered(name, real):
        def run(t, *a, **kw):
            sync(device)
            t0 = time.perf_counter()
            out = real(t, *a, **kw)
            sync(device)
            calls.append((name, t.numel() * t.element_size(),
                          (time.perf_counter() - t0) * 1e3))
            return out
        return run

    dist.all_reduce = metered("all_reduce", dist.all_reduce)
    dist.all_gather_into_tensor = metered("all_gather",
                                          dist.all_gather_into_tensor)
    return calls, restore


def plant(fault):
    """Plant ``fault`` (``MESH_FAULTS``) in the data-parallel road, for
    the controls: the grads, and the loss and accuracy riding with them,
    kept as each rank's own (no all-reduce), or averaged a second time.
    Returns the function that takes it out."""
    import torch
    from lifelong_clip_tpu_torch.parallel.mesh import Mesh
    real = Mesh.all_mean

    def not_reduced(self, tensors, totals=()):
        return None

    def twice(self, tensors, totals=()):
        tensors = list(tensors)
        real(self, tensors, totals)
        with torch.no_grad():
            for t in tensors:
                t.div_(self.data)

    Mesh.all_mean = {"grads not reduced": not_reduced,
                     "grads averaged twice": twice}[fault]

    def undo():
        Mesh.all_mean = real
    return undo


def mesh_kind(case, world):
    if world == 1:
        return "one rank"
    if case["fault"]:
        return "fault"
    if case["mesh"][1] > 1:
        return ("bf16 model axis" if case["ref_argv"] != case["argv"]
                else "model axis")
    return "data parallel"


def mesh_case_on_rank(rank, world, backend, init_file, case, dev, **attrs):
    """One case on one rank: a ``backend`` group on ``dev``, the case's
    trainer (its fault planted), its steps, every leaf and grad held
    against the 1-process reference saved at ``case["ref"]``."""
    import torch
    import torch.distributed as dist
    undo = plant(case["fault"]) if case["fault"] else None
    dist.init_process_group(backend, init_method="file://" + init_file,
                            rank=rank, world_size=world)
    calls, restore = collective_meter(dev)
    try:
        mesh = case["mesh"] if world > 1 else (1, 1)
        with eval_pixels(), tempfile.TemporaryDirectory() as tmp:
            tr = mesh_trainer(case["argv"], mesh, dev, tmp, **attrs)
            assert mesh == (1, 1) or tr.mesh.shape == {
                "data": mesh[0], "model": mesh[1]}
            run = mesh_steps(tr, case["steps"], calls)
            del tr
        ref = torch.load(case["ref"], weights_only=False)
        errs = step1_errors(run, ref,
                            by_leaf=case["ref_argv"] != case["argv"])
        dist.barrier()
    finally:
        restore()
        if undo is not None:
            undo()
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    steps = case["steps"]
    reduce_calls = [(b, t) for n, b, t in calls if n == "all_reduce"]
    return {"label": case["label"] + (", one rank" if world == 1 else ""),
            "kind": mesh_kind(case, world), "backend": backend,
            "ranks": world, "mesh": list(mesh), "losses": run["losses"],
            "ref_losses": ref["losses"][:steps], "step_ms": run["step_ms"],
            "ref_step_ms": ref["step_ms"][:steps],
            "launches": run["launches"], **errs,
            "all_reduce_bytes_per_step": sum(b for b, _ in reduce_calls)
            / steps,
            "all_reduce_ms_per_step": sum(t for _, t in reduce_calls) / steps,
            "collective_ms_by_step": run["coll_ms"],
            "largest_all_reduce_bytes": max(
                (b for b, _ in reduce_calls), default=0),
            "all_gather_calls_per_step": sum(
                n == "all_gather" for n, _, _ in calls) / steps}


def mesh_rank(rank, tmp, cases, device, outbox):
    """One of the two ranks sharing ``device`` (cuda:0): every case of
    ``cases`` in a gloo group of two (the gloo collectives on CUDA
    tensors), then, rank 0 alone, the first case (lora-clip DP) in a
    one-rank nccl group. Puts (rank, result or traceback) to ``outbox`` per
    case."""
    import traceback
    sys.path.insert(0, REPO)
    try:
        import torch
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        for i, case in enumerate(cases):
            outbox.put((rank, mesh_case_on_rank(
                rank, 2, "gloo", os.path.join(tmp, f"pg{i}"), case, dev)))
        if rank == 0:
            from lifelong_clip_tpu_torch.parallel.mesh import Mesh
            one = Mesh((1, 1), 0, dev)
            outbox.put((rank, mesh_case_on_rank(
                0, 1, "nccl" if dev.type == "cuda" else "gloo",
                os.path.join(tmp, "pg_one"), cases[0], dev,
                resolve_dp_mesh=lambda self, *a, **k: one)))
    except BaseException:
        outbox.put((rank, traceback.format_exc()))


def kernels_ran(res):
    """A mesh case's kernels: the DP steps launch #1/#2 (mvp-clip's
    prompted pass #3/#4), the model axis none (the plain road)."""
    n = res["launches"]
    if res["mesh"] == [1, 2]:
        return not any(n.values())
    op = ("fused_prefix_attention" if res["label"].startswith("mvp")
          else "fused_ln_attention")
    return n[op + "_fwd"] > 0 and n[op + "_bwd"] > 0


def mesh_checks(res, witness, launched):
    """{check: passed} of one rank's result (``mesh_phase`` gives the
    limits); ``witness``: the bf16 1-process step against the fp32 one,
    for a bf16 model-axis case."""
    lo, ref = res["losses"], res["ref_losses"]
    checks = {"finite": all(math.isfinite(v) for v in lo),
              "all-reduce": res["all_reduce_bytes_per_step"] > 0,
              "kernels": not launched or kernels_ran(res),
              "all-gather": not res["label"].startswith("mvp") or
              res["all_gather_calls_per_step"] > 0}
    if res["kind"] == "bf16 model axis":
        w = witness[res["label"]]
        checks.update({
            "step 1 loss": abs(lo[0] - ref[0]) <= BF16_LOSS_RTOL * abs(ref[0]),
            "step 1 grads": res["step1_grad_worst_ratio_to_witness"] <=
            BF16_FACTOR,
            "step 1 leaves": res["step1_moved_share"] <=
            BF16_FACTOR * w["step1_moved_share"] + MOVED_LIMIT})
        return checks
    checks.update({
        "step 1 loss": abs(lo[0] - ref[0]) <= 1e-5 * abs(ref[0]),
        "losses": all(abs(a - b) <= 2e-3 * abs(b) for a, b in zip(lo, ref)),
        "step 1 grads": res["step1_grad_max_rel"] <= (
            MODEL_AXIS_GRAD_LIMIT if res["mesh"][1] > 1 else DP_GRAD_LIMIT),
        "step 1 leaves": res["step1_moved_share"] <= MOVED_LIMIT})
    if res["kind"] == "one rank":
        checks["bitwise"] = lo == ref and res["last_max_diff"] == 0
    return checks


@clocked
def mesh_phase(card, device="cuda:0", mesh_cases=None):
    """Data parallelism (lora-clip, mvp-clip, Finetuning: 3 steps under
    --mesh 2x1), tensor parallelism (lora-clip) and expert parallelism
    (moe-clip: one step under --mesh 1x2, in fp32 and in bf16) at full
    ViT-B/16 width, two ranks in a gloo group sharing this one card (so it
    measures no scaling), each held against the 1-process step on the same
    card and batches with augmentation off; then the lora-clip DP steps in
    a one-rank nccl group, which must equal the 1-process steps bitwise;
    then the controls: each DP case's step 1 with a fault planted in the
    ranks (``MESH_FAULTS``), which the checks must catch.

    Tolerances (the limits above ``mesh_case``): on the DP road (bf16, the
    kernels) step 1's loss within rtol 1e-5 (each row's forward is the
    1-process one; only the fp32 mean's order differs) and later steps'
    within 2e-3; step 1's grads within DP_GRAD_LIMIT of each grad's largest
    entry (each rank's partial grad goes through the bf16 backward, the
    kernels' bf16 LoRA grads and, with the text tower training, 12 text
    blocks' bf16 dx on its own, where the 1-process step rounds the sum).
    On the model axis in fp32 (TF32 off) the loss within rtol 1e-5 and the
    grads within MODEL_AXIS_GRAD_LIMIT: only the order of the partial sums
    differs; in bf16 each leaf's grad within BF16_FACTOR times the distance
    of the bf16 1-process step's from the fp32 one, the loss within
    BF16_LOSS_RTOL of the fp32 one. Step 1's
    moved share within MOVED_LIMIT (BF16_FACTOR times the witness's, plus
    it, in bf16). A planted fault must fail the grad check."""
    import multiprocessing as mp
    import queue as queue_mod
    import torch
    from lifelong_clip_tpu_torch.ops import preprocess
    real_pipeline = preprocess.make_train_pipeline
    t_phase = time.perf_counter()
    cases = [dict(c) for c in (mesh_cases or MESH_CASES)]
    out, witness = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        # the 1-process references, one per (argv, road), at the most steps
        # a case takes from it; the bf16 1-process steps of the bf16
        # model-axis cases against their fp32 references
        refs, need = {}, {}
        for c in cases:
            c["ref_key"] = (tuple(c["ref_argv"]), c["mesh"][1] > 1)
            need[c["ref_key"]] = max(need.get(c["ref_key"], 0), c["steps"])
        with eval_pixels():
            for c in cases:
                key = c["ref_key"]
                if key not in refs:
                    refs[key] = os.path.join(tmp, f"ref{len(refs)}.pt")
                    tr = mesh_trainer(list(key[0]), (1, 1), device, tmp,
                                      unfused=key[1])
                    run = mesh_steps(tr, need[key])
                    del tr
                    torch.save(run, refs[key])
                c["ref"] = refs[key]
                if c["ref_argv"] != c["argv"]:
                    tr = mesh_trainer(c["argv"], (1, 1), device, tmp,
                                      unfused=True)
                    run = mesh_steps(tr, 1)
                    del tr
                    ref = torch.load(c["ref"], weights_only=False)
                    witness[c["label"]] = {"loss": run["losses"][0],
                                           "ref_loss": ref["losses"][0],
                                           **step1_errors(run, ref, True)}
                if device.startswith("cuda"):
                    torch.cuda.empty_cache()
        for label, w in witness.items():
            log(f"mesh witness {label}: the bf16 1-process step against the "
                f"fp32 one: {json.dumps(w)}; {card}")
        ctx = mp.get_context("spawn")
        outbox = ctx.Queue()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, tmp, cases, device, outbox))
                 for r in range(2)]
        for p in procs:
            p.start()
        results = {0: [], 1: []}
        want = {0: len(cases) + 1, 1: len(cases)}
        deadline = time.monotonic() + 900
        try:
            while any(len(results[r]) < want[r] for r in results):
                try:
                    rank, res = outbox.get(timeout=5)
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        got = {r: len(v) for r, v in results.items()}
                        raise RuntimeError(f"mesh phase: ranks exited "
                                           f"{dead} or timed out ({got})")
                    continue
                if isinstance(res, str):
                    raise RuntimeError(f"mesh phase, rank {rank}:\n{res}")
                results[rank].append(res)
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
    assert preprocess.make_train_pipeline is real_pipeline
    launched = device.startswith("cuda")   # the counters count launches
    failed = []
    for res in results[0] + results[1]:
        if res["kind"] == "bf16 model axis":
            w = witness[res["label"]]["step1_grad_rel_by_leaf"]
            got = res.pop("step1_grad_rel_by_leaf")
            res["step1_grad_worst_ratio_to_witness"] = max(
                got[k] / v for k, v in w.items())
        checks = mesh_checks(res, witness, launched)
        res["failed_checks"] = [k for k, ok in checks.items() if not ok]
        if res["kind"] == "fault":
            ok = "step 1 grads" in res["failed_checks"]
        else:
            ok = not res["failed_checks"]
        if not ok:
            failed.append((res["label"], res["ranks"],
                           res["failed_checks"]))
        out.append(res)
        lo, ref = res["losses"], res["ref_losses"]
        log(f"mesh {res['label']} ({res['kind']}, {res['backend']}, "
            f"{res['ranks']} rank(s) sharing one card, mesh {res['mesh']}): "
            f"step ms {[round(v, 1) for v in res['step_ms']]} (1 process: "
            f"{[round(v, 1) for v in res['ref_step_ms']]}), all-reduce "
            f"{res['all_reduce_bytes_per_step']:.0f} B and "
            f"{res['all_reduce_ms_per_step']:.2f} ms a step (collectives "
            f"by step {[round(v, 2) for v in res['collective_ms_by_step']]} "
            f"ms), losses {lo} vs {ref}; step-1 grads within "
            f"{res['step1_grad_max_rel']:.2e} of the largest "
            f"({res['step1_worst_grad']}), moved share "
            f"{res['step1_moved_share']:.2e}, worst leaf's grad over the "
            f"bf16 1-process step's "
            f"{res.get('step1_grad_worst_ratio_to_witness', '-')}, "
            f"last step's worst entry "
            f"{res['last_max_diff']}; failed checks "
            f"{res['failed_checks']}; {card}")
    assert not failed, f"mesh phase checks failed: {failed}"
    return {"mesh_phase": out, "witness": witness,
            "limits": {"dp_grad": DP_GRAD_LIMIT,
                       "model_axis_grad": MODEL_AXIS_GRAD_LIMIT,
                       "moved_share": MOVED_LIMIT,
                       "bf16_factor": BF16_FACTOR,
                       "bf16_loss_rtol": BF16_LOSS_RTOL},
            "wall_s": time.perf_counter() - t_phase,
            "note": "2 ranks sharing one card: no scaling is measured",
            "card": card}


# -- the pipeline phase: 2 stages sharing one card ---------------------------

PP_MICRO = 4            # microbatches of 16 rows at bs 64
PP_BS = 64
PP_CLASSES = 20
PP_LR = 5e-4            # bench.py's AdamW
PP_TIMED = 2            # timed steps after the checked one
PP_FAULT = "permute backward dropped"
# (label, model, compute dtype, planted fault), each under --mesh 1x2: two
# stages of 6 layers on ViT-B/16, of 12 on ViT-L/14 (T = 257, the long
# warpgroup-MMA road), as JAX's pipeline docstring names it
PP_CASES = (("ViT-B/16 fp32", "ViT-B/16", "fp32", None),
            ("ViT-B/16 bf16", "ViT-B/16", "bf16", None),
            ("ViT-L/14 bf16", "ViT-L/14", "bf16", None),
            (f"ViT-B/16 fp32, {PP_FAULT}", "ViT-B/16", "fp32", PP_FAULT))
# JAX's own tolerances of the pipelined step (tests/test_pipeline.py:99-107):
# the fp32 loss is held to PP_LOSS_RTOL; the leaves' count outside PP_LEAF_*
# is reported. Through the kernels the step-1 grads are not that close: the
# kernels round h, qkv and ctx to bf16 a row, so a row's last-bit fp32
# difference (the MLP's cuBLAS GEMMs at 3152 rows against 12608) can move
# a rounding, and AdamW's first update is lr times the grad's sign, so any
# grad below that noise lands 2 lr off (H100 80GB HBM3, 700 W: grads
# within 3.46e-3 of the largest entry, 843 of 221184 leaf entries outside
# JAX's atol/rtol, every one 2 lr off; the planted fault 1.0 and 111069).
# So the leaves and grads are held as the mesh phase holds a row split
# through the kernels: DP_GRAD_LIMIT and MOVED_LIMIT.
PP_LOSS_RTOL = 1e-5
PP_LEAF_ATOL, PP_LEAF_RTOL = 1e-5, 1e-4


def pp_setup(model, dtype, dev, mesh):
    """lora-clip's step with its vision tower pipelined over ``mesh``'s
    model axis (``parallel/pipeline.py:make_pp_forward``, ``PP_MICRO``
    microbatches; the (1, 1) mesh gives the 1-process tower): LoRA r=4 on
    the image tower, every leaf that starts at zero given seeded N(0,
    0.02^2) draws (so that every grad is live), AutoAugment's cifar10
    policy, AdamW 5e-4, the text tower forward each step on ``PP_CLASSES``
    class rows, one batch of ``PP_BS``; the stages' slices from
    ``shard_params_pp``. Returns (cfg, state, one step returning its
    loss)."""
    import numpy as np
    import torch
    from lifelong_clip_tpu_torch.config import PEFTConfig
    from lifelong_clip_tpu_torch.methods.engine import (
        TrainState, make_train_step, tree_leaves)
    from lifelong_clip_tpu_torch.models import build_clip, build_peft
    from lifelong_clip_tpu_torch.models.clip import cast_towers
    from lifelong_clip_tpu_torch.parallel.mesh import shard_params_pp
    from lifelong_clip_tpu_torch.parallel.pipeline import make_pp_forward
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer
    cd = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    params, cfg = build_clip(model, gen=torch.Generator().manual_seed(0),
                             device=dev)
    frozen = shard_params_pp(cast_towers(params, cd), mesh)
    del params
    peft_cfg = PEFTConfig(method="lora", encoder="image", lora_r=4)
    peft = build_peft(torch.Generator().manual_seed(1), cfg, peft_cfg,
                      device=dev)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in tree_leaves(peft):
            if not p.any():
                p.copy_(torch.from_numpy(
                    0.02 * rng.standard_normal(tuple(p.shape))))
    state = TrainState(
        trainable=shard_params_pp(peft, mesh, match=("vision",)),
        frozen=frozen,
        make_opt=lambda lv: make_optimizer("adamw", lv, PP_LR),
        gen=torch.Generator().manual_seed(2))
    step = make_train_step(
        cfg, peft_cfg, image_size=cfg.image_size, mean=MEAN, std=STD,
        use_autoaug=True, autoaug_policy="cifar10", compute_dtype=cd,
        forward_fn=make_pp_forward(cfg, peft_cfg, mesh, PP_MICRO,
                                   compute_dtype=cd))
    images, labels, tokens = gate_batch(cfg, PP_CLASSES, PP_BS)
    batch = {"images": images.to(dev), "labels": labels.to(dev),
             "tokens": tokens.to(dev),
             "mask": torch.zeros(PP_CLASSES, device=dev)}
    return cfg, state, lambda: step(state, batch)["loss"]


def pp_snapshot(state, mesh, n_layers, loss):
    """The step's loss and the whole trainable tree after it, grads and
    leaves (the stages' slices gathered, ``gather_stages``), on the
    host."""
    from lifelong_clip_tpu_torch.methods.engine import tree_map
    from lifelong_clip_tpu_torch.parallel.mesh import gather_stages
    out = {"loss": float(loss)}
    for name, fn in (("grad", lambda p: p.grad), ("leaf", lambda p: p)):
        tree = gather_stages(tree_map(lambda p: fn(p).detach(),
                                      state.trainable),
                             mesh, n_layers, match=("vision",))
        out[name] = {k: host(v) for k, v in walk_tree(tree)}
    return out


def pp_errors(got, ref):
    """A step's snapshot (``pp_snapshot``) against a reference step's: the
    loss's relative distance; each leaf's worst grad difference over that
    grad's largest entry; the updated leaves' worst difference, the entries
    outside JAX's atol / rtol and the share of entries more than one update
    (AdamW's first: lr) off."""
    rels = {k: float((g - ref["grad"][k]).abs().max()
                     / ref["grad"][k].abs().max())
            for k, g in got["grad"].items()
            if float(ref["grad"][k].abs().max()) > 0}
    worst, outside, moved, total = 0.0, 0, 0, 0
    for k, v in got["leaf"].items():
        w = ref["leaf"][k]
        d = (v - w).abs()
        worst = max(worst, float(d.max()))
        outside += int((d > PP_LEAF_ATOL + PP_LEAF_RTOL * w.abs()).sum())
        moved += int((d > PP_LR).sum())
        total += d.numel()
    return {"loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_rel_by_leaf": rels, "grad_rel_max": max(rels.values()),
            "leaf_max_diff": worst, "leaf_entries_outside": outside,
            "leaf_entries": total, "moved_share": moved / total}


def pp_times(run, dev, steps=PP_TIMED, meter=True):
    """Host ms of each of ``steps`` steps (between two synchronizes), the
    device-busy ms of one more (torch.profiler) and, with ``meter``, over
    one more, every all-gather (the ring permutes) and all-reduce with its
    bytes and ms (``collective_meter``)."""
    ms = []
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        run()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    busy = device_ms(run, iters=1, warmup=0) if dev.type == "cuda" else None
    if not meter:
        return {"step_ms": ms, "device_ms": busy}
    calls, restore = collective_meter(dev)
    try:
        run()
        sync(dev)
    finally:
        restore()
    return {"step_ms": ms, "device_ms": busy, "collectives": calls}


def pp_reference(model, dtype, dev):
    """The 1-process step of ``pp_setup``: its snapshot after one step,
    then its step and device ms."""
    import torch
    from lifelong_clip_tpu_torch.parallel.mesh import Mesh
    one = Mesh((1, 1), 0, dev)
    cfg, state, run = pp_setup(model, dtype, dev, one)
    snap = pp_snapshot(state, one, cfg.vision_layers, run())
    snap["times"] = pp_times(run, dev, meter=False)
    log(f"pipeline reference {model} {dtype}: loss {snap['loss']}, step ms "
        f"{snap['times']['step_ms']}")
    del state, run
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return snap


def pp_plant(fault):
    """Plant ``fault`` (``PP_FAULT``): the ring permute's backward hands
    back zeros, so no grad reaches an earlier stage. Returns the function
    that takes it out."""
    import torch
    from lifelong_clip_tpu_torch.parallel import mesh as mesh_lib
    assert fault == PP_FAULT, fault
    real = mesh_lib._RingPermute.backward
    mesh_lib._RingPermute.backward = staticmethod(
        lambda ctx, g: (torch.zeros_like(g), None, None, None))
    return lambda: setattr(mesh_lib._RingPermute, "backward",
                           staticmethod(real))


def pp_case_on_rank(rank, world, init_file, case, dev, ref_file):
    """One case on one stage: a gloo group, the pipelined step, its step-1
    snapshot against the fp32 1-process step's (and the launches of step
    1), then the timed steps (but under a planted fault)."""
    import torch
    import torch.distributed as dist
    from lifelong_clip_tpu_torch.parallel.mesh import make_mesh
    label, model, dtype, fault = case
    undo = pp_plant(fault) if fault else None
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    try:
        mesh = make_mesh((1, world), dev)
        cfg, state, run = pp_setup(model, dtype, dev, mesh)
        log(f"pipeline stage {rank}: {label} built")
        reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        loss = run()
        sync(dev)
        first_ms = (time.perf_counter() - t0) * 1e3
        step1 = launch_counts()
        snap = pp_snapshot(state, mesh, cfg.vision_layers, loss)
        ref = torch.load(ref_file, weights_only=False)[(model, "fp32")]
        errs = pp_errors(snap, ref)
        log(f"pipeline stage {rank}: {label} step 1 checked")
        times = None if fault else pp_times(run, dev)
        launches = launch_counts()
        dist.barrier()
        del state, run
    finally:
        if undo is not None:
            undo()
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stage_layers = cfg.vision_layers // world
    return {"label": label, "model": model, "dtype": dtype, "fault": fault,
            "rank": rank, "loss": snap["loss"], "ref_loss": ref["loss"],
            "first_step_ms": first_ms, "times": times, "step1": step1,
            "launches": launches, **errs,
            "expected_fwd": (PP_MICRO + world - 1) * stage_layers
            + cfg.text_layers,
            "expected_bwd": (PP_MICRO + world - 1) * stage_layers}


def pp_rank(rank, tmp, cases, device, ref_file, outbox):
    """One of the two stages sharing ``device``: every case of ``cases``
    in a gloo group of two. Puts (rank, result or traceback) to ``outbox``
    per case."""
    import traceback
    sys.path.insert(0, REPO)
    try:
        import torch
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        for i, case in enumerate(cases):
            outbox.put((rank, pp_case_on_rank(
                rank, 2, os.path.join(tmp, f"pp{i}"), case, dev, ref_file)))
    except BaseException:
        outbox.put((rank, traceback.format_exc()))


def pp_checks(res, witness, launched):
    """{check: passed} of one stage's result: fp32 against the fp32
    1-process step, the loss at JAX's rtol, the grads and the moved share
    as the mesh phase holds a row split (above ``PP_LOSS_RTOL``); bf16 by
    the mesh phase's witness rule
    (each leaf's grad within BF16_FACTOR times the bf16 1-process step's
    distance from the fp32 one; the loss within BF16_LOSS_RTOL of it, or
    within BF16_FACTOR times the witness's distance where that is more: a
    tiny tower's bf16 loss moves 1.3e-3);
    both stages' launches of #1 and #2 in step 1: (M + S - 1) ticks x L/S
    layers each, #1 also the text tower's."""
    n = res["step1"]
    checks = {"finite": math.isfinite(res["loss"]),
              "kernels": not launched or (
                  n["fused_ln_attention_fwd"] == res["expected_fwd"]
                  and n["fused_ln_attention_bwd"] == res["expected_bwd"])}
    if res["dtype"] == "fp32":
        checks.update({
            "step 1 loss": res["loss_rel"] <= PP_LOSS_RTOL,
            "step 1 grads": res["grad_rel_max"] <= DP_GRAD_LIMIT,
            "step 1 leaves": res["moved_share"] <= MOVED_LIMIT})
    else:
        w = witness[res["model"]]
        res["grad_worst_ratio_to_witness"] = max(
            res["grad_rel_by_leaf"][k] / v
            for k, v in w["grad_rel_by_leaf"].items())
        checks.update({
            "step 1 loss": res["loss_rel"] <= max(
                BF16_LOSS_RTOL, BF16_FACTOR * w["loss_rel"]),
            "step 1 grads": res["grad_worst_ratio_to_witness"]
            <= BF16_FACTOR})
    return checks


@clocked
def pipeline_phase(card, device="cuda:0", cases=None):
    """Pipeline parallelism (``parallel/pipeline.py``): lora-clip's step
    (``pp_setup``) with its vision tower in two stages, two ranks in a
    gloo group sharing this one card (so it measures no scaling), ViT-B/16
    in fp32 and bf16 and ViT-L/14 in bf16, each held after step 1 against
    the 1-process step on the same card (``pp_checks``); then the fault
    control (``pp_plant``), which the grads check must catch 10 times past
    its limit. Each stage
    prints its step ms, device ms and idle share beside the bubble share
    (S - 1) / (M + S - 1), the permutes' bytes and ms a tick and its
    kernels' launches."""
    import multiprocessing as mp
    import queue as queue_mod
    import torch
    t_phase = time.perf_counter()
    cases = list(cases or PP_CASES)
    dev = torch.device(device)
    refs, witness, failed, out = {}, {}, [], []
    for _, model, dtype, _ in cases:
        for need in ("fp32", dtype):
            if (model, need) not in refs:
                refs[(model, need)] = pp_reference(model, need, dev)
        if dtype == "bf16" and model not in witness:
            witness[model] = pp_errors(refs[(model, "bf16")],
                                       refs[(model, "fp32")])
    for model, w in witness.items():
        log(f"pipeline witness {model}: the bf16 1-process step against the "
            f"fp32 one: loss {w['loss_rel']:.2e} relative, grads "
            f"{w['grad_rel_max']:.2e} of the largest entry; {card}")
    with tempfile.TemporaryDirectory() as tmp:
        ref_file = os.path.join(tmp, "refs.pt")
        torch.save(refs, ref_file)
        ctx = mp.get_context("spawn")
        outbox = ctx.Queue()
        procs = [ctx.Process(target=pp_rank, args=(r, tmp, cases, device,
                                                   ref_file, outbox))
                 for r in range(2)]
        for p in procs:
            p.start()
        results = {0: [], 1: []}
        deadline = time.monotonic() + 600
        try:
            while any(len(v) < len(cases) for v in results.values()):
                try:
                    rank, res = outbox.get(timeout=5)
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        got = {r: len(v) for r, v in results.items()}
                        raise RuntimeError(f"pipeline phase: ranks exited "
                                           f"{dead} or timed out ({got})")
                    continue
                if isinstance(res, str):
                    raise RuntimeError(f"pipeline phase, rank {rank}:\n{res}")
                results[rank].append(res)
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
    launched = dev.type == "cuda"   # the counters count launches
    bubble = (2 - 1) / (PP_MICRO + 2 - 1)
    for res in results[0] + results[1]:
        checks = pp_checks(res, witness, launched)
        res["failed_checks"] = [k for k, ok in checks.items() if not ok]
        if res["fault"]:
            # caught far outside: stage 0's grads wholly lost
            ok = "step 1 grads" in res["failed_checks"] and \
                res["grad_rel_max"] >= 10 * DP_GRAD_LIMIT
        else:
            ok = not res["failed_checks"]
        if not ok:
            failed.append((res["label"], res["rank"], res["failed_checks"]))
        t = res.pop("times")
        if t is not None:
            step_ms = sum(t["step_ms"]) / len(t["step_ms"])
            gathers = [(b, ms) for op, b, ms in t["collectives"]
                       if op == "all_gather"]
            reduces = [(b, ms) for op, b, ms in t["collectives"]
                       if op == "all_reduce"]
            res.update({
                "step_ms": t["step_ms"], "device_ms": t["device_ms"],
                "idle_share": (None if t["device_ms"] is None
                               else 1.0 - t["device_ms"] / step_ms),
                "bubble_share": bubble,
                "permutes_per_step": len(gathers),
                "permute_bytes_gathered": [b for b, _ in gathers],
                "permute_ms": [ms for _, ms in gathers],
                "all_reduce_bytes": [b for b, _ in reduces],
                "all_reduce_ms": [ms for _, ms in reduces]})
        ref = refs[(res["model"], res["dtype"])]["times"]
        res["ref_step_ms"], res["ref_device_ms"] = (ref["step_ms"],
                                                    ref["device_ms"])
        by_leaf = res.pop("grad_rel_by_leaf")
        out.append(res)
        log(f"pipeline {res['label']} (stage {res['rank']} of 2 sharing one "
            f"card, {PP_MICRO} microbatches of {PP_BS // PP_MICRO}): loss "
            f"{res['loss']} vs {res['ref_loss']} (fp32 1-process), grads "
            f"within {res['grad_rel_max']:.2e} of the largest entry "
            f"(worst leaf {max(by_leaf, key=by_leaf.get)}), leaves "
            f"{res['leaf_entries_outside']} of {res['leaf_entries']} entries "
            f"outside atol {PP_LEAF_ATOL} / rtol {PP_LEAF_RTOL} (worst "
            f"{res['leaf_max_diff']:.2e}), moved share "
            f"{res['moved_share']:.2e}; step 1 launches "
            f"{res['step1']} (expected #1 {res['expected_fwd']}, #2 "
            f"{res['expected_bwd']}); step ms {res.get('step_ms')} (1 "
            f"process {res['ref_step_ms']}), device ms "
            f"{res.get('device_ms')} (1 process {res['ref_device_ms']}), "
            f"idle share {res.get('idle_share')} beside the bubble "
            f"{bubble}; permutes {res.get('permutes_per_step')} a step, "
            f"{res.get('permute_bytes_gathered')} B gathered, ms "
            f"{res.get('permute_ms')}; all-reduce "
            f"{res.get('all_reduce_bytes')} B, ms {res.get('all_reduce_ms')};"
            f" failed checks {res['failed_checks']}; {card}")
    assert not failed, f"pipeline phase checks failed: {failed}"
    return {"pipeline_phase": out,
            "witness": {m: {k: v for k, v in w.items()
                            if k != "grad_rel_by_leaf"}
                        for m, w in witness.items()},
            "limits": {"loss_rtol": PP_LOSS_RTOL, "grad": DP_GRAD_LIMIT,
                       "moved_share": MOVED_LIMIT, "bf16_factor": BF16_FACTOR,
                       "bf16_loss_rtol": BF16_LOSS_RTOL},
            "wall_s": time.perf_counter() - t_phase,
            "note": "2 stages sharing one card: no scaling is measured",
            "card": card}


# ---------------------------------------------------------------------------
# whole runs: the kernel road and the library road, each against fp32
# ---------------------------------------------------------------------------

# the kernel road's distance from the fp32 run may be at most this many times
# the library road's, on each statistic of WHOLE_RUN_CHECKED (PERF.md §2:
# fixed before the final chip run, from the readings of an earlier one)
WHOLE_RUN_MULTIPLE = 1.5
WHOLE_RUN_STEPS = 10      # "loss10": max |loss difference| over these
WHOLE_RUN_CHECKED = ("loss10", "trained")
# each path: its main path's argv, the trainer class and its road attribute
# (module, class, attribute), the train pass and the loss of a step's output
WHOLE_RUN_PATHS = {
    "lora-clip": (LORA_SCRIPT_ARGV,
                  ("adapter_clip", "AdapterCLIP", "_attn_impl"),
                  ("adapter_clip", "make_train_step"), "stats"),
    "Finetuning": (ER_FAMILY_ARGV["Finetuning"],
                   ("er_baseline", "ER", "attn_impl"),
                   ("er_baseline", "make_train_step"), "stats"),
    "mvp-clip": (MVP_CLIP_ARGV, ("mvp_clip", "CLIP_MVP", "_attn_impl"),
                 ("mvp_clip", "make_mvp_train_step"), "count, stats"),
}
# planted faults in lora-clip's kernel road: the dx that the backward of its
# last vision block's fused op (_FusedLNAttention) returns, scaled by a factor
# on the first share of the batch rows. Each must read at least its need
# times WHOLE_RUN_MULTIPLE on one statistic of WHOLE_RUN_CHECKED: the sign
# flip gives the check's margin (five times), half the rows halved, as a
# fault in a split over rows would leave them, must fail the check. (One
# positive scale on every row scales every grad upstream of the block by one
# constant, which AdamW's m / sqrt(v) cancels: no run can see that.)
WHOLE_RUN_FAULTS = (
    # label, factor, share of the rows, need
    ("dx x -1, last vision block", -1.0, 1.0, 5.0),
    ("dx x 0.5 on the first half of the rows, last vision block", 0.5, 0.5,
     1.0),
)


def _methods(name):
    import importlib
    return importlib.import_module(f"lifelong_clip_tpu_torch.methods.{name}")


def road_run(path, impl, bf16):
    """One run of ``path`` through ``main`` with its trainer class on the
    ``impl`` road (``"fused"``: the kernels; ``"unfused"``: cuBLAS and
    SDPA, no hand-written kernel) in bf16 or fp32 (``--no_bf16``): its
    losses, eval accuracies, result, trained leaves, wall s and kernel
    launches."""
    script, (mod, cls, attr), (tmod, tattr), out_kind = WHOLE_RUN_PATHS[path]
    owner = getattr(_methods(mod), cls)
    real = owner.__dict__[attr]
    setattr(owner, attr, impl)
    rec = {}
    try:
        launches, _, _, _ = run_main_path(
            f"{path} ({impl}, {'bf16' if bf16 else 'fp32'})", None,
            {"train": (_methods(tmod), tattr)},
            script + ([] if bf16 else ["--no_bf16"]),
            (lambda st: float(st["loss"])) if out_kind == "stats" else
            (lambda out: float(out[1]["loss"])), record=rec)
    finally:
        setattr(owner, attr, real)
    rec["launches"] = launches
    return rec


@contextlib.contextmanager
def planted_dx_fault(factor, share, vision_tokens, n_blocks):
    """The fused op's backward with the dx it returns for the last of
    ``n_blocks`` vision blocks (counted in forward order; vision inputs are
    those of ``vision_tokens`` tokens) scaled by ``factor`` on the first
    ``share`` of its rows; yields the list that gets one entry a faulty
    backward."""
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    op = fba._FusedLNAttention
    fwd, bwd = op.__dict__["forward"], op.__dict__["backward"]
    seen, hits = [0], []

    def forward(ctx, x, *args):
        ctx.planted = False
        if x.shape[1] == vision_tokens:
            ctx.planted = seen[0] % n_blocks == n_blocks - 1
            seen[0] += 1
        return fwd.__func__(ctx, x, *args)

    def backward(ctx, g):
        grads = bwd.__func__(ctx, g)
        if not ctx.planted:
            return grads
        hits.append(1)
        dx = grads[0].clone()
        dx[:round(dx.shape[0] * share)] *= factor
        return (dx,) + tuple(grads[1:])

    op.forward, op.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield hits
    finally:
        op.forward, op.backward = fwd, bwd


def whole_run_distances(run, ref):
    """A run's distances from the fp32 run ``ref``: max |loss difference|
    over the first WHOLE_RUN_STEPS steps (``loss10``), the difference of
    the mean losses (``mean``), max |loss difference| over every step
    (``loss_all``) and the L2 distance of the trained leaves at the end
    (``trained``)."""
    import numpy as np
    a, b = np.asarray(run["losses"]), np.asarray(ref["losses"])
    assert a.shape == b.shape, (a.shape, b.shape)
    n = WHOLE_RUN_STEPS
    return {"loss10": float(np.abs(a[:n] - b[:n]).max()),
            "mean": float(abs(a.mean() - b.mean())),
            "loss_all": float(np.abs(a - b).max()),
            "trained": float((run["trained"] - ref["trained"]).norm())}


def ratios(dist, lib):
    return {k: dist[k] / lib[k] if lib[k] > 0 else math.inf for k in dist}


@clocked
def whole_run_phase(card, kernel_runs=None):
    """Each path of ``WHOLE_RUN_PATHS`` run three times through ``main``
    with the same seed and augmentation draws: the kernel road (bf16; the
    main path phase's run, ``kernel_runs[path]``, where given), the library
    road (``"unfused"``, bf16: no hand-written kernel may launch) and the
    reference (``"unfused"``, fp32). On each statistic of
    ``WHOLE_RUN_CHECKED`` the kernel road's distance from the reference
    (``whole_run_distances``) must be within ``WHOLE_RUN_MULTIPLE`` times
    the library road's; then lora-clip's kernel road again with each
    planted fault of ``WHOLE_RUN_FAULTS``, which must read at least its
    need times the multiple on one of them."""
    from lifelong_clip_tpu_torch.config import resolve_clip_preset
    t_phase = time.perf_counter()
    kernel_runs = kernel_runs or {}
    rows, failed, ref_of, lib_of = [], [], {}, {}
    for path, spec in WHOLE_RUN_PATHS.items():
        kern = kernel_runs.get(path) or road_run(path, "fused", True)
        lib = road_run(path, "unfused", True)
        ref = road_run(path, "unfused", False)
        assert not any(lib["launches"].values()), \
            f"{path}: the library road launched kernels {lib['launches']}"
        dk = whole_run_distances(kern, ref)
        dl = whole_run_distances(lib, ref)
        ref_of[path], lib_of[path] = ref, dl
        for r in (kern, lib):
            r.pop("trained")
        runs = (("kernel", kern), ("library", lib), ("fp32", ref))
        row = {"path": path, "steps": len(ref["losses"]),
               "kernel": dk, "library": dl, "ratio": ratios(dk, dl),
               "losses": {road: r["losses"] for road, r in runs},
               "eval_acc": {road: {k: r.get(k) for k in
                                   ("periodic_acc", "task_acc")}
                            for road, r in runs},
               "result": {road: r["result"] for road, r in runs},
               "wall_s": {road: r["wall_s"] for road, r in runs}}
        over = [f"{k} {row['ratio'][k]:.3f}" for k in WHOLE_RUN_CHECKED
                if row["ratio"][k] > WHOLE_RUN_MULTIPLE]
        if over:
            failed.append(f"{path}: ratio {', '.join(over)}")
        rows.append(row)
        log(json.dumps({"whole_run": row}))
        log(f"whole run {path}: {row['steps']} steps; distance from fp32 "
            f"(max |dloss| over the first {WHOLE_RUN_STEPS} steps, trained "
            f"leaves' L2): kernel road {dk['loss10']:.4e}, "
            f"{dk['trained']:.4e}; library road {dl['loss10']:.4e}, "
            f"{dl['trained']:.4e}; ratio {row['ratio']['loss10']:.3f}, "
            f"{row['ratio']['trained']:.3f} (limit {WHOLE_RUN_MULTIPLE}); "
            f"mean-loss difference: kernel {dk['mean']:.4e}, library "
            f"{dl['mean']:.4e}; max |dloss| over every step: kernel "
            f"{dk['loss_all']:.4e}, library {dl['loss_all']:.4e}; eval "
            f"accuracies {json.dumps(row['eval_acc'])}; wall s "
            f"{row['wall_s']}; {card}")
    path = "lora-clip"
    argv = WHOLE_RUN_PATHS[path][0]
    cfg = resolve_clip_preset(argv[argv.index("--model_name") + 1])
    tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
    faults = []
    for label, factor, share, need in WHOLE_RUN_FAULTS:
        with planted_dx_fault(factor, share, tokens,
                              cfg.vision_layers) as hits:
            run = road_run(path, "fused", True)
        assert len(hits) == len(run["losses"]), (label, len(hits))
        df = whole_run_distances(run, ref_of[path])
        reads = ratios(df, lib_of[path])
        faults.append({"fault": label, "distance": df, "reads": reads,
                       "needs": need * WHOLE_RUN_MULTIPLE,
                       "losses": run["losses"], "wall_s": run["wall_s"]})
        log(f"whole run {path} with the planted fault '{label}': distance "
            f"from fp32 {df['loss10']:.4e} (max |dloss| over the first "
            f"{WHOLE_RUN_STEPS} steps), {df['trained']:.4e} (trained "
            f"leaves), {reads['loss10']:.2f} and {reads['trained']:.2f} x "
            f"the library road's (needs > {need * WHOLE_RUN_MULTIPLE} on "
            f"one); mean-loss difference {df['mean']:.4e}; {card}")
        log(json.dumps({"whole_run_fault": faults[-1]}))
        if max(reads[k] for k in WHOLE_RUN_CHECKED) <= \
                need * WHOLE_RUN_MULTIPLE:
            failed.append(f"the planted fault '{label}' reads {reads}")
    for r in ref_of.values():
        r.pop("trained")
    wall = time.perf_counter() - t_phase
    assert not failed, f"whole-run phase checks failed: {failed}"
    return {"whole_run_phase": rows, "planted_faults": faults,
            "multiple": WHOLE_RUN_MULTIPLE, "checked": WHOLE_RUN_CHECKED,
            "steps": WHOLE_RUN_STEPS, "wall_s": wall, "card": card}


def step_profile(run_step, step_ms, steps=3, top=12):
    """torch.profiler over ``steps`` train steps: device ms per step (the
    union of kernel intervals); the device's idle share of the profiled
    window (inflated by the profiler's host overhead) and of ``step_ms``, the
    step time measured without the profiler; the share of the port's own
    kernels in device time; the ``top`` kernels by time; and the kernel
    events the window holds a step (a window that lost events, as
    torch.profiler's can, shows fewer than the step launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name = busy_us(prof)
    if busy is None:
        log("train step profile: the profiler saw no device time")
        return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
                "device_busy_ms_per_step": "not measured"}
    # the train pipeline's kernels, by the profiler range each step's
    # pipeline call runs in (``annotate_augmentation``)
    aug = sum(e.device_time_total for e in prof.events()
              if e.name == AUG_RANGE
              and e.device_type == torch.autograd.DeviceType.CPU)
    total = sum(by_name.values()) or 1.0
    port = sum(v for k, v in by_name.items()
               if any(k.startswith(f"void {p}") or k.startswith(p)
                      or k.startswith(f"void (anonymous namespace)::{p}")
                      for p in PORT_KERNELS))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_busy_ms_per_step": busy / 1e3 / steps,
           "idle_share_profiled": 1.0 - busy / 1e3 / wall_ms,
           "idle_share_of_step": 1.0 - busy / 1e3 / steps / step_ms,
           "augmentation_device_ms_per_step": (aug / 1e3 / steps if aug
                                               else "not measured"),
           "port_kernel_share": port / total,
           "kernel_events_per_step": sum(
               1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != AUG_RANGE) / steps,
           "top": [{"kernel": k[:120], "ms_per_step": v / 1e3 / steps}
                   for k, v in ranked]}
    log(f"train step profile: {json.dumps(out)}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from lifelong_clip_tpu_torch.ops import _kernels
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    t0 = t_start = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    PHASE_WALL_S["build"] = time.perf_counter() - t0
    log(f"kernels built in {PHASE_WALL_S['build']:.1f} s: "
        f"{os.path.relpath(path, REPO)} (register report beside it)")
    annotate_augmentation()

    log(f"kernel checks: beyond one bf16 ulp (2**-7 of the value), y and "
        f"qkv within {kc.REL_FWD} and dx and every grad within {kc.REL_BWD} "
        f"of the max of the term each checks; each term a check must see is "
        f">= {kc.MARGIN} x (tolerance + one typical ulp)")
    cases = [kernel_case("vision", 64, 197, 768, 12, 4, False, False, 0)]
    torch.cuda.synchronize()
    cases.append(kernel_case("text K=20", 20, 77, 512, 8, 0, True, False, 1))
    cases.append(kernel_case("text K=64", 64, 77, 512, 8, 0, True, False, 2))
    # the text tower of lora-clip with LoRA on both towers, CIFAR-100's
    # 100 class rows: causal, r=4, the backward as its train step runs it
    cases.append(kernel_case("text K=100 LoRA", 100, 77, 512, 8, 4, True,
                             False, 16))
    # adapter-clip's and moe-clip's vision blocks: the adapter and the MoE
    # sit outside the op, so it runs with no LoRA, the backward dx only
    cases.append(kernel_case("vision, no LoRA", 64, 197, 768, 12, 0, False,
                             False, 17))
    # continual-clip's and its zero-shot pass's eval batch
    # (scripts/continual_clip.sh: test_batchsize 128): B*T = 25216 rows, no
    # partial tile; the eval runs the forward, the case checks both
    cases.append(kernel_case("eval bs 128, no LoRA", 128, 197, 768, 12, 0,
                             False, False, 18))
    cases.append(kernel_case("vision weight_grads", 64, 197, 768, 12, 4,
                             False, True, 3, time_it=False))
    # past 256 keys: ViT-L/14's vision block (the long warpgroup-MMA
    # road), T = 512 (past its 384 keys: the mma.sync tiled roads)
    cases.append(kernel_case("ViT-L/14 vision", 64, 257, 1024, 16, 4, False,
                             False, 12))
    cases.append(kernel_case("T = 512 weight_grads", 8, 512, 768, 12, 4,
                             False, True, 13, time_it=False))
    # K1, L2P's prompted pass: 1 + 5 x 5 + 196 = 222 tokens (a partial last
    # row tile), no LoRA, the backward dx only, in all 12 blocks
    cases.append(kernel_case("L2P prompted, T = 222", 64, 222, 768, 12, 0,
                             False, False, 19))
    # K3, ProtoCLIP's text prefix pass: [SOS] + 2 x 12 ctx tokens, T = 25
    # (far below one tile) under its causal (25, 25) mask, dx only
    cases.append(kernel_case("ProtoCLIP text prefix, T = 25", 64, 25, 512,
                             8, 0, True, False, 20))
    # the ER family: Finetuning's whole-tower step (#1 keeping h16/ctx16, #2
    # with the weight grads, r = 0, in all 12 blocks), ER's step (the
    # frozen tower, forward only on its path) and CLIB's miss recompute in
    # chunks of 256 rows (B*T = 50432, forward only on its path)
    cases.append(kernel_case("FT, no LoRA, weight_grads", 16, 197, 768, 12,
                             0, False, True, 24))
    cases.append(kernel_case("ER step, no LoRA", 16, 197, 768, 12, 0, False,
                             False, 25))
    cases.append(kernel_case("CLIB miss recompute, no LoRA", 256, 197, 768,
                             12, 0, False, False, 26))
    # the mesh phase's per-rank shapes (--mesh 2x1): lora-clip's 32 of 64
    # rows, Finetuning's 8 of 16 with the weight grads
    cases.append(kernel_case("per rank of 2x1: lora-clip, 32 rows", 32, 197,
                             768, 12, 4, False, False, 27))
    cases.append(kernel_case("per rank of 2x1: FT weight_grads, 8 rows", 8,
                             197, 768, 12, 0, False, True, 28))
    # ER's step at 8 rows and one row (r = 0, forward and dx only): the
    # attention kernels split each (head, batch row) over blocks
    cases.append(kernel_case("ER step, 8 rows, no LoRA", 8, 197, 768, 12, 0,
                             False, False, 33))
    cases.append(kernel_case("one row, no LoRA", 1, 197, 768, 12, 0, False,
                             False, 34))
    # the pipeline phase's microbatch of 16 rows on each stage (LoRA r=4):
    # ViT-B/16 and ViT-L/14 (T = 257, the long warpgroup-MMA road)
    cases.append(kernel_case("pipeline microbatch: ViT-B/16, 16 rows", 16,
                             197, 768, 12, 4, False, False, 30))
    cases.append(kernel_case("pipeline microbatch: ViT-L/14, 16 rows", 16,
                             257, 1024, 16, 4, False, False, 31))
    torch.cuda.synchronize()
    pcases = [prefix_kernel_case("mvp prefix, 5 of 20 live", 5, False, 4)]
    pcases.append(prefix_kernel_case("mvp prefix, none live", 0, False, 5))
    pcases.append(prefix_kernel_case(
        "mvp prefix, one prompt tensor (mvp-clip's), 5 of 20 live", 5, False,
        15, time_it=False, shared=True))
    pcases.append(prefix_kernel_case("mvp prefix weight_grads, 20 live", 20,
                                     True, 6, time_it=False))
    pcases.append(prefix_kernel_case(
        "prefix S = 512 (P = 315, 40 live) weight_grads", 40, True, 14,
        time_it=False, shape=(8, 197, 768, 12, 315)))
    # K2, ProtoCLIP's CoPL image pass: Ek != Ev, P = 4, all live (layers
    # 0-6) and none live (layers 7-11)
    pcases.append(prefix_kernel_case("ProtoCLIP image, P = 4, 4 live", 4,
                                     False, 21, shape=(64, 197, 768, 12, 4)))
    pcases.append(prefix_kernel_case(
        "ProtoCLIP image, P = 4, none live", 0, False, 22, time_it=False,
        shape=(64, 197, 768, 12, 4)))
    # K4, ProtoCLIP's suffix pass at bs 64: C = 64 classes x S = 8 tokens as
    # one 512-token row a sample, pk = pv = ln_1(prefix state) of lp = 25,
    # the block-diagonal causal (512, 537) mask: most 64-key tiles of most
    # rows are wholly dead
    from lifelong_clip_tpu_torch.models.proto_clip import suffix_mask
    pcases.append(prefix_kernel_case(
        "ProtoCLIP suffix, C x S = 64 x 8, lp = 25", 25, False, 23,
        shape=(64, 512, 512, 8, 25), shared=True,
        mask=suffix_mask(64, 8, 25, device="cuda")))
    pcases.extend(proto_main_suffix_cases())
    # mvp-clip's prompted block on one rank of --mesh 2x1
    pcases.append(prefix_kernel_case(
        "per rank of 2x1: mvp prefix, 32 rows, 5 of 20 live", 5, False, 29,
        shape=(32, 197, 768, 12, 20)))
    pcases.append(text_prompt_prefix_case())
    torch.cuda.synchronize()
    tile_maps = tile_map_phase()
    torch.cuda.synchronize()
    invariance = batch_invariance_phase()
    torch.cuda.synchronize()

    log(f"flash checks: o, dq, dk, dv against the plain versions within "
        f"{kc.FLASH_REL} of each output's max (bf16: beyond one bf16 ulp)")
    fcases = [flash_kernel_case(*c, seed=7 + i)
              for i, c in enumerate(FLASH_CASES)]
    torch.cuda.synchronize()
    gemms = gemm_phase()
    torch.cuda.synchronize()
    schedule = schedule_check()
    torch.cuda.synchronize()

    aug = augmentation_phase(card)
    torch.cuda.synchronize()
    # the whole-run phase's kernel road: these main paths' own runs
    kernel_road = {path: {} for path in WHOLE_RUN_PATHS}
    launches, lora_run = main_path_phase(kernel_road["lora-clip"])
    torch.cuda.synchronize()
    l14_launches, l14_run = vit_l14_main_path_phase()
    torch.cuda.synchronize()
    mvp_launches, mvp_run = mvp_main_path_phase(kernel_road["mvp-clip"])
    torch.cuda.synchronize()
    maple_launches, maple_run = maple_main_path_phase()
    torch.cuda.synchronize()
    pl_launches, pl_run = prompted_lora_phase()
    torch.cuda.synchronize()
    tp_launches, tp_run = text_prompt_phase(card)
    torch.cuda.synchronize()
    adapter_launches, adapter_run = adapter_main_path_phase("adapter-clip")
    torch.cuda.synchronize()
    moe_launches, moe_run = adapter_main_path_phase("moe-clip")
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        pretrained = write_pretrained(tmp)
        cc_launches, cc_run = continual_main_path_phase(pretrained[0])
        torch.cuda.synchronize()
        cc_eval = continual_eval_phase(card, pretrained[0])
        torch.cuda.synchronize()
        rn_pretrained = write_pretrained(tmp, "RN50")
        rn_launches, rn_run = rn_continual_main_path_phase(rn_pretrained[0])
        torch.cuda.synchronize()
        rn_eval = continual_eval_phase(card, rn_pretrained[0], model="RN50")
        torch.cuda.synchronize()
    prompt_runs = {}
    for method in ("l2p", "dualprompt", "mvp"):
        prompt_runs[method] = vit_prompt_main_path_phase(method)
        torch.cuda.synchronize()
    prompt_runs["ProtoCLIP"] = proto_main_path_phase()
    torch.cuda.synchronize()
    er_runs = {}
    for method in ER_FAMILY_ARGV:
        er_runs[method] = er_family_main_path_phase(
            method, kernel_road.get(method))
        torch.cuda.synchronize()
    whole_run = whole_run_phase(card, kernel_road)
    torch.cuda.synchronize()
    gates = []
    for gate in (learning_gate, lora_both_gate, mvp_learning_gate,
                 maple_learning_gate, prompted_lora_gate,
                 lambda c: learning_gate(c, model="ViT-L/14"),
                 lambda c: learning_gate(c, method="adapter"),
                 lambda c: learning_gate(c, method="moe"),
                 lambda c: prompt_gate(c, "l2p"),
                 lambda c: prompt_gate(c, "dualprompt"),
                 lambda c: prompt_gate(c, "mvp"),
                 lambda c: prompt_gate(c, "adapter-clip-proto_prompt"),
                 lambda c: er_family_gate(c, "er"),
                 lambda c: er_family_gate(c, "Finetuning"),
                 lambda c: er_family_gate(c, "clib")):
        gates.append(gate(card))
        torch.cuda.synchronize()
    remat = remat_phase(card)
    torch.cuda.synchronize()
    mesh = mesh_phase(card)
    torch.cuda.synchronize()
    pipeline = pipeline_phase(card)
    torch.cuda.synchronize()
    ckpt = checkpoint_phase()
    torch.cuda.synchronize()
    moe_ckpt = checkpoint_phase("moe-clip", ["--method", "moe-clip"]
                                + ADAPTER_ARGV)
    torch.cuda.synchronize()
    from lifelong_clip_tpu_torch.methods import proto_clip
    from lifelong_clip_tpu_torch.methods import vit_prompt_methods as vpm
    l2p_ckpt = checkpoint_phase("l2p", ["--method", "l2p"] + VIT_PROMPT_ARGV,
                                owner=vpm._PromptPoolTrainer,
                                attr="train_step")
    torch.cuda.synchronize()
    # one stage-2 epoch in place of five: the runs' stage 2 is most of
    # this phase's time, and the resume it checks is the same
    proto_ckpt = checkpoint_phase("ProtoCLIP", PROTO_ARGV + ["--ca_epochs",
                                                             "1"],
                                  owner=proto_clip.Trainer_ProtoCLIP,
                                  attr="stage1_step")
    torch.cuda.synchronize()
    from lifelong_clip_tpu_torch.methods import er_baseline, ewcpp
    ewc_ckpt = checkpoint_phase("ewc++", argv_with(
                                    ER_FAMILY_ARGV["ewc++"], n_tasks=2,
                                    dataset="synthetic-20x20"),
                                owner=ewcpp.EWCpp, attr="ewc_step")
    torch.cuda.synchronize()
    rm_ckpt = checkpoint_phase("rm", RM_ARGV, owner=er_baseline)
    torch.cuda.synchronize()
    # the text tower's share of a both-tower step: its device time less the
    # image-only step's (64 cached class features there)
    image, both = (gates[i]["profile"].get("device_busy_ms_per_step")
                   for i in (0, 1))
    text_share = (both - image) / both if all(
        isinstance(v, float) for v in (both, image)) else "not measured"
    log(json.dumps({"text_tower_share_of_both_tower_step": text_share,
                    "both_tower_device_ms": both, "image_only_device_ms":
                    image, "card": card}))

    src = "lifelong_clip_tpu_torch/csrc/fused_block_attn.cu"
    flash_src = "lifelong_clip_tpu_torch/csrc/flash_attention.cu"
    pl_shape = "prompted-LoRA 768 x 197 x 217 (B*H x T x S), dh 64, bf16"
    # each kernel's launches over every main path above (the mesh and
    # pipeline phases' controls, with their planted faults, left out)
    runs = {k: sum(r[k] for r in (
        launches, l14_launches, mvp_launches, maple_launches, pl_launches,
        tp_launches, adapter_launches, moe_launches, cc_launches, rn_launches,
        *[r[0] for r in prompt_runs.values()],
        *[r[0] for r in er_runs.values()],
        *[r["launches"] for r in mesh["mesh_phase"]
          if r["kind"] != "fault"],
        *[r["launches"] for r in pipeline["pipeline_phase"]
          if r["fault"] is None])) for k in launches}
    kernels = []
    for name, pre, case_list, source, shape in (
            ("fused_ln_attention_fwd", "fwd", cases, src,
             "vision 64x197x768, 12 heads, LoRA r=4, bf16"),
            ("fused_ln_attention_bwd", "bwd", cases, src,
             "vision 64x197x768, 12 heads, LoRA r=4, bf16"),
            ("fused_prefix_attention_fwd", "fwd", pcases, src,
             "mvp 64x197x768, P=20 (5 live), 12 heads, bf16"),
            ("fused_prefix_attention_bwd", "bwd", pcases, src,
             "mvp 64x197x768, P=20 (5 live), 12 heads, bf16"),
            ("flash_attention_fwd", "fwd", fcases, flash_src, pl_shape),
            ("flash_attention_bwd", "bwd", fcases, flash_src, pl_shape)):
        v = case_list[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": runs[name],
            "max_abs_err": max(c[f"{pre}_max_abs_err"] for c in case_list),
            "ms": v[f"{pre}_ms"],
            "plain_ms": v[f"{pre}_plain_ms"],
            "bound_ms": v[f"{pre}_bound_ms"],
            "bound_us": v[f"{pre}_bound_ms"] * 1e3,
            "bound_by": v[f"{pre}_bound_by"],
            "library_ms": v[f"{pre}_library_ms"],
            "device_ms": v[f"{pre}_device_ms"],
            "library_device_ms": v[f"{pre}_library_device_ms"],
            "shape": shape,
            "cases": [{k: c[k] for k in c if k.startswith(pre) or k in
                       ("label", "shape", "attn_fwd_bound_ms",
                        "attn_bwd_bound_ms")}
                      for c in case_list]})
    # the tile maps, each op's own: one a pass of #1/#2 under the text
    # tower's causal mask, one each prefix chain under a 2-D mask builds
    # (ProtoCLIP's suffix pass, text prompts)
    kernels[0]["tile_map_launches"] = runs["block_tile_map"]
    kernels[2]["tile_map_launches"] = runs["prefix_tile_map"]
    assert runs["block_tile_map"] > 0 and runs["prefix_tile_map"] > 0, runs
    # #1's and #2's attention on the road with no mask at head dim 64 (every
    # ViT tower's blocks): the warpgroup-MMA kernels, one launch a chain
    # there, on each of these main paths (er's tower is frozen: forward only)
    # (and past 256 keys, ViT-L/14's vision tower: the long kernels)
    wg_src = "lifelong_clip_tpu_torch/csrc/attn_wgmma.cu"
    for i, k in enumerate(kernels[:2]):
        for entry, road in (("attention_kernel", "wgmma"),
                            ("attention_kernel_long", "wgmma_long")):
            k[entry] = {"name": WGMMA_ROAD_KERNELS[road][i], "source": wg_src,
                        "launches": runs[WGMMA_ROAD_KEYS[road][i]]}
    wg_paths = {"lora-clip": (launches, True, "wgmma"),
                "lora-clip ViT-L/14": (l14_launches, True, "wgmma_long"),
                "adapter-clip": (adapter_launches, True, "wgmma"),
                "er": (er_runs["er"][0], False, "wgmma"),
                "Finetuning": (er_runs["Finetuning"][0], True, "wgmma"),
                "l2p": (prompt_runs["l2p"][0], True, "wgmma")}
    wg_counts = {p: [got[k] for k in WGMMA_ROAD_KEYS[road]]
                 for p, (got, _, road) in wg_paths.items()}
    log(json.dumps({"wgmma_attention_launches_by_path": wg_counts,
                    "card": card}))
    assert all(n[0] > 0 and (n[1] > 0 or not trains)
               for (n, (_, trains, _)) in zip(wg_counts.values(),
                                              wg_paths.values())), wg_counts
    # #3's and #4's attention under a key-mask row at head dim 64 (the
    # prompted passes): the warpgroup-MMA kernels' prefix instances, one
    # launch a chain there, forward and backward on each of these paths
    for k, key, kern in ((kernels[2], "attn_prefix_fwd_wgmma",
                          "attn_fwd_wgmma_kernel"),
                         (kernels[3], "attn_prefix_bwd_wgmma",
                          "attn_bwd_wgmma_kernel")):
        k["attention_kernel"] = {"name": kern, "instance": "PRE (key row)",
                                 "source": wg_src, "launches": runs[key]}
    pre_paths = {"mvp-clip": mvp_launches,
                 "dualprompt": prompt_runs["dualprompt"][0],
                 "mvp": prompt_runs["mvp"][0],
                 "ProtoCLIP": prompt_runs["ProtoCLIP"][0]}
    pre_counts = {p: [got["attn_prefix_fwd_wgmma"],
                      got["attn_prefix_bwd_wgmma"]]
                  for p, got in pre_paths.items()}
    log(json.dumps({"prefix_wgmma_attention_launches_by_path": pre_counts,
                    "card": card}))
    assert all(f > 0 and b > 0 for f, b in pre_counts.values()), pre_counts
    assert all(k["launches"] > 0 for k in kernels), \
        [(k["name"], k["launches"]) for k in kernels]
    log(json.dumps({"lora_clip_main_path": lora_run,
                    "lora_clip_launches": launches}))
    log(json.dumps(aug))
    log(json.dumps(ckpt))
    log(json.dumps({"vit_l14_main_path": l14_run,
                    "vit_l14_launches": l14_launches}))
    log(json.dumps({"mvp_main_path": mvp_run, "mvp_launches": mvp_launches}))
    log(json.dumps({"maple_main_path": maple_run,
                    "maple_launches": maple_launches}))
    log(json.dumps({"prompted_lora_path": pl_run,
                    "prompted_lora_launches": pl_launches,
                    "note": "no registered method builds this block"}))
    log(json.dumps({"text_prompt_path": tp_run,
                    "text_prompt_launches": tp_launches,
                    "note": "no registered method passes text prompts"}))
    log(json.dumps({"adapter_clip_main_path": adapter_run,
                    "adapter_clip_launches": adapter_launches}))
    log(json.dumps({"moe_clip_main_path": moe_run,
                    "moe_clip_launches": moe_launches}))
    log(json.dumps({"continual_clip_main_path": cc_run,
                    "continual_clip_launches": cc_launches,
                    "pretrained_checkpoint_mb": pretrained[1],
                    "pretrained_write_s": pretrained[2],
                    "pretrained_load_s": pretrained[3]}))
    log(json.dumps(cc_eval))
    log(json.dumps(moe_ckpt))
    for name, (run_launches, info) in prompt_runs.items():
        log(json.dumps({f"{name}_main_path": info,
                        f"{name}_launches": run_launches}))
    log(json.dumps(l2p_ckpt))
    log(json.dumps(proto_ckpt))
    for name, (run_launches, info) in er_runs.items():
        log(json.dumps({f"{name}_main_path": info,
                        f"{name}_launches": run_launches}))
    log(json.dumps({"continual_clip_rn50_main_path": rn_run,
                    "continual_clip_rn50_launches": rn_launches,
                    "pretrained_checkpoint_mb": rn_pretrained[1],
                    "pretrained_write_s": rn_pretrained[2],
                    "pretrained_load_s": rn_pretrained[3]}))
    log(json.dumps(rn_eval))
    log(json.dumps(ewc_ckpt))
    log(json.dumps(rm_ckpt))
    for g in gates:
        log(json.dumps(g))
    log(json.dumps(remat))
    log(json.dumps(mesh))
    log(json.dumps(pipeline))
    log(json.dumps({"tile_map_phase": tile_maps, "card": card}))
    log(json.dumps({"batch_invariance": invariance, "card": card}))
    log(json.dumps({"gemm": gemms, "schedule": schedule, "card": card}))
    log(json.dumps(whole_run))
    wall = time.perf_counter() - t_start
    log(json.dumps({"chip_smoke_wall_s": wall,
                    "whole_run_phase_wall_s": whole_run["wall_s"],
                    "phase_wall_s": PHASE_WALL_S,
                    "outside_the_phases_s": wall - sum(PHASE_WALL_S.values()),
                    "case_wall_s": CASE_WALL_S, "card": card}))
    log(json.dumps({"kernels": kernels, "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
