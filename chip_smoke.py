#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from lifelong_clip_tpu_torch/csrc.
3. Kernel phase: the fused LN-attention block, forward and backward, at the
   ViT-B/16 vision shape (64 x 197 x 768, 12 heads, LoRA r=4, bf16, no mask)
   and the text shape (20 and 64 x 77 x 512, 8 heads, causal), run through
   the op's autograd Function as the train step runs it, against the plain
   PyTorch versions on the same inputs on the card: y on y - x, qkv on the
   LoRA-in term, dx on dx - g and every grad (LoRA grads in the LoRA
   primal's dtype; once with weight_grads=True), each beyond one bf16 ulp
   within a stated fraction of the term it checks
   (``lifelong_clip_tpu_torch/ops/kernel_check.py``); timed beside the plain
   version and an SDPA-based composition (a yardstick only; the port never
   calls it).
4. Main path: ``lifelong_clip_tpu_torch.main.main`` runs lora-clip on
   ViT-B/16 at bs=64 (synthetic-20, 2 tasks, no AutoAugment); the kernels'
   launch counters must grow in the train, eval and text passes, every loss
   must be finite and result.txt must exist.
5. Learning gate (bench.py:98-104): 22 steps of the ViT-B/16 train step on
   one batch lower the loss by more than 0.02; prints step ms and samples/s,
   then a torch.profiler window over 3 more steps (device ms a step by
   kernel, the device's idle share).

Any failure raises and exits non-zero. The line before the last is the
``kernels`` JSON object; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

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
REPLACES = {
    "fused_ln_attention_fwd":
        "lifelong_clip_tpu/ops/fused_block_attn.py:56",
    "fused_ln_attention_bwd":
        "lifelong_clip_tpu/ops/fused_block_attn.py:258",
}


def log(msg):
    print(msg, flush=True)


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


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def block_cost(b, t, d, heads, r, weight_grads, backward, es=2):
    """(flops, bytes) the function needs: each input read once, each output
    written once; the backward recomputes qkv and p (it is given x only)."""
    m, dh = b * t, d // heads
    attn = 2 * b * heads * t * t * dh            # one T x T x dh product
    lora_fwd = 2 * m * r * (d + 3 * d + d + d) if r else 0
    w_bytes = 4 * d * d * 2 + 5 * d * 4 + (2 * d * r + 4 * d * r) * 2
    if not backward:
        flops = 2 * m * d * 3 * d + 2 * attn + 2 * m * d * d + lora_fwd
        return flops, 2 * m * d * es + w_bytes
    flops = (2 * m * d * 3 * d + 2 * attn          # recompute qkv, p, ctx
             + 2 * m * d * d                       # dctx
             + 4 * attn                            # dv, dp, dq, dk
             + 2 * m * 3 * d * d)                  # dh
    if r:
        flops += lora_fwd + 2 * m * r * (d + d + d + d + 3 * d + d + 3 * d + d)
    if weight_grads:
        flops += 2 * m * d * d + 2 * m * d * 3 * d
    out_bytes = m * d * es + (w_bytes if weight_grads else 6 * d * r * 4)
    return flops, 3 * m * d * es + w_bytes + out_bytes


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


def launch_breakdown(x, args, bargs, gy, reps=3):
    """Device ms of each launch in one forward and one backward chain, from
    CUDA events around every call into the kernel library (GEMMs labelled
    by M, N, K), averaged over ``reps`` runs."""
    import torch
    from lifelong_clip_tpu_torch.ops import _kernels
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    orig = _kernels.call
    rec = []

    def evented(name, *a):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        orig(name, *a)
        e.record()
        tag = name[4:] if name != "llc_gemm" else \
            f"gemm M={a[1]} N={a[2]} K={a[3]}"
        rec.append((phase, tag, s, e))

    _kernels.call = evented
    try:
        with torch.no_grad():
            for _ in range(reps):
                phase = "fwd"
                fba._cuda_forward(x, *args)
                phase = "bwd"
                fba._cuda_backward(x, gy, *bargs)
    finally:
        _kernels.call = orig
    torch.cuda.synchronize()
    out = {"fwd": {}, "bwd": {}}
    for ph, tag, s, e in rec:
        out[ph][tag] = out[ph].get(tag, 0.0) + s.elapsed_time(e) / reps
    return out


def kernel_case(label, b, t, d, heads, lora_r, masked, weight_grads, seed,
                time_it=True):
    import torch
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    x, blk, lora, gy, mask = kc.make_inputs(b, t, d, heads, lora_r, masked,
                                            seed)
    s = 0.25 if lora_r else 0.0
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
           "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err}
    fl, by = block_cost(b, t, d, heads, lora_r, weight_grads, False)
    res["fwd_bound_ms"], res["fwd_bound_by"] = bound_ms(fl, by)
    fl, by = block_cost(b, t, d, heads, lora_r, weight_grads, True)
    res["bwd_bound_ms"], res["bwd_bound_by"] = bound_ms(fl, by)
    if not time_it:
        return res

    # yardstick operands in F.linear's (out, in) layout, made once
    lb = dict(blk, w_qkv_t=blk["w_qkv"].T.contiguous(),
              w_out_t=blk["w_out"].T.contiguous())
    ll = None if lora is None else {
        "a_in_t": lora["a_in"].T.contiguous(),
        "b_in_t": lora["b_in"].T.contiguous(),
        "a_out_t": lora["a_out"].T.contiguous(),
        "b_out_t": lora["b_out"].T.contiguous()}
    with torch.no_grad():
        res["fwd_ms"] = timed(lambda: fba._cuda_forward(x, *args))
        res["fwd_plain_ms"] = timed(
            lambda: fba.fused_ln_attention_block_reference(x, *args), iters=3)
        res["fwd_library_ms"] = timed(
            lambda: library_block(x, lb, ll, s, mask, heads))
    res["bwd_ms"] = timed(lambda: fba._cuda_backward(x, gy, *bargs))
    res["bwd_plain_ms"] = timed(
        lambda: fba.fused_ln_attention_block_reference_bwd(x, gy, *bargs),
        iters=3)
    xg = x.detach().clone().requires_grad_(True)
    wrt = [xg] + ([] if ll is None else [a.requires_grad_(True)
                                         for a in ll.values()])

    def lib_fwd_bwd():
        y_ = library_block(xg, lb, ll, s, mask, heads)
        torch.autograd.grad(y_, wrt, gy)

    with torch.no_grad():
        lib_fwd = timed(lambda: library_block(xg, lb, ll, s, mask, heads))
    res["bwd_library_ms"] = max(timed(lib_fwd_bwd) - lib_fwd, 0.0)
    res["breakdown"] = launch_breakdown(x, args, bargs, gy)
    log(f"{label}: per-launch device ms {json.dumps(res['breakdown'])}")
    log(f"{label}: fwd {res['fwd_ms']:.3f} ms (plain {res['fwd_plain_ms']:.3f},"
        f" library {res['fwd_library_ms']:.3f}, bound "
        f"{res['fwd_bound_ms']:.4f}); bwd {res['bwd_ms']:.3f} ms (plain "
        f"{res['bwd_plain_ms']:.3f}, library {res['bwd_library_ms']:.3f}, "
        f"bound {res['bwd_bound_ms']:.4f})")
    return res


# ---------------------------------------------------------------------------
# main path and learning gate
# ---------------------------------------------------------------------------

def main_path_phase():
    import numpy as np
    import torch
    from lifelong_clip_tpu_torch import main as cli
    from lifelong_clip_tpu_torch.methods import adapter_clip
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba

    per_pass = {p: {k: 0 for k in fba.LAUNCHES} for p in
                ("train", "eval", "text")}
    losses = []

    def counting(pass_name, fn, on_out=None):
        def wrapped(*a, **kw):
            before = dict(fba.LAUNCHES)
            out = fn(*a, **kw)
            for k in fba.LAUNCHES:
                per_pass[pass_name][k] += fba.LAUNCHES[k] - before[k]
            if on_out is not None:
                on_out(out)
            return out
        return wrapped

    orig = (adapter_clip.make_train_step, adapter_clip.make_eval_step,
            adapter_clip.make_text_feature_fn)
    adapter_clip.make_train_step = lambda *a, **kw: counting(
        "train", orig[0](*a, **kw),
        lambda st: losses.append(float(st["loss"])))
    adapter_clip.make_eval_step = lambda *a, **kw: counting(
        "eval", orig[1](*a, **kw))
    adapter_clip.make_text_feature_fn = lambda *a, **kw: counting(
        "text", orig[2](*a, **kw))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fba.reset_launches()
            t0 = time.perf_counter()
            out = cli.main(["--method", "lora-clip", "--model_name",
                            "ViT-B/16", "--dataset", "synthetic-20",
                            "--n_tasks", "2", "--batchsize", "64",
                            "--online_iter", "1", "--eval_period", "640",
                            "--transforms", "--log_path", tmp,
                            "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(fba.LAUNCHES)
            found = [os.path.join(r, "result.txt")
                     for r, _, fs in os.walk(tmp) if "result.txt" in fs]
            assert found, "main path wrote no result.txt"
    finally:
        (adapter_clip.make_train_step, adapter_clip.make_eval_step,
         adapter_clip.make_text_feature_fn) = orig
    assert losses and np.isfinite(losses).all(), f"losses {losses}"
    tr, ev, tx = per_pass["train"], per_pass["eval"], per_pass["text"]
    assert tr["fused_ln_attention_fwd"] > 0 and \
        tr["fused_ln_attention_bwd"] > 0, f"train pass launches {tr}"
    assert ev["fused_ln_attention_fwd"] > 0, f"eval pass launches {ev}"
    assert tx["fused_ln_attention_fwd"] > 0, f"text pass launches {tx}"
    log(f"main path: {len(losses)} train steps in {wall:.1f} s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, result {out}, launches "
        f"{launches}, per pass {per_pass}")
    return launches


def learning_gate(card):
    import numpy as np
    import torch
    from lifelong_clip_tpu_torch.config import CLIP_PRESETS, PEFTConfig
    from lifelong_clip_tpu_torch.methods.engine import (
        TrainState, make_text_feature_fn, make_train_step)
    from lifelong_clip_tpu_torch.models import build_clip, build_peft
    from lifelong_clip_tpu_torch.models.clip import cast_towers
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer

    dev = torch.device("cuda")
    cfg = CLIP_PRESETS["ViT-B/16"]
    peft_cfg = PEFTConfig(method="lora", encoder="image", lora_r=4)
    params, _ = build_clip("ViT-B/16", gen=torch.Generator().manual_seed(0),
                           device=dev)
    peft = build_peft(torch.Generator().manual_seed(1), cfg, peft_cfg,
                      device=dev)
    frozen = cast_towers(params, torch.bfloat16)
    state = TrainState(trainable=peft, frozen=frozen,
                       make_opt=lambda lv: make_optimizer("adamw", lv, 5e-4),
                       gen=torch.Generator().manual_seed(2))
    mean = (0.48145466, 0.4578275, 0.40821073)
    std = (0.26862954, 0.26130258, 0.27577711)
    step = make_train_step(cfg, peft_cfg, image_size=cfg.image_size,
                           mean=mean, std=std, augment=True)
    n_cls, bs = 64, 64
    rng = np.random.default_rng(0)
    tokens = np.zeros((n_cls, cfg.context_length), np.int64)
    tokens[:, 0] = 49406
    tokens[:, 1:8] = rng.integers(1000, 40000, (n_cls, 7))
    tokens[:, 8] = 49407
    txt = make_text_feature_fn(cfg, peft_cfg)(frozen, peft,
                                              torch.from_numpy(tokens).to(dev))
    batch = {"images": torch.from_numpy(rng.integers(
                 0, 255, (bs, 32, 32, 3), dtype=np.uint8)).to(dev),
             "labels": torch.from_numpy(rng.integers(0, n_cls, (bs,))).to(dev),
             "tokens": txt,
             "mask": torch.zeros(n_cls, device=dev)}
    loss_first = float(step(state, batch)["loss"])
    float(step(state, batch)["loss"])
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        m = step(state, batch)
    loss_last = float(m["loss"])
    dt = time.perf_counter() - t0
    assert loss_last < loss_first - 0.02, (
        f"train steps did not learn: loss {loss_first:.4f} -> "
        f"{loss_last:.4f} after {iters + 2} updates on one batch")
    step_ms = dt / iters * 1e3
    return {"learning_gate": "ok", "loss_first": loss_first,
            "loss_last": loss_last, "step_ms": step_ms,
            "samples_per_s": bs * iters / dt, "batchsize": bs,
            "model": "ViT-B/16 LoRA r=4, no AutoAugment", "card": card,
            "profile": step_profile(lambda: step(state, batch), step_ms)}


PORT_KERNELS = ("gemm_kernel", "attn_fwd_kernel", "attn_bwd_dq_kernel",
                "attn_bwd_dkv_kernel", "ln_fwd_kernel", "ln_bwd_kernel",
                "cast_bf16_kernel", "colsum_kernel", "splitk_reduce_kernel")


def step_profile(run_step, step_ms, steps=3, top=12):
    """torch.profiler over ``steps`` train steps: device ms per step (the
    union of kernel intervals); the device's idle share of the profiled
    window (inflated by the profiler's host overhead) and of ``step_ms``, the
    step time measured without the profiler; the share of the port's own
    kernels in device time; and the ``top`` kernels by time."""
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
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log("train step profile: the profiler saw no device time")
        return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
                "device_busy_ms_per_step": "not measured"}
    busy_us, end, by_name = 0.0, -math.inf, {}
    for e in sorted(kern, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    total = sum(by_name.values()) or 1.0
    port = sum(v for k, v in by_name.items()
               if any(k.startswith(f"void {p}") or k.startswith(p)
                      for p in PORT_KERNELS))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_busy_ms_per_step": busy_us / 1e3 / steps,
           "idle_share_profiled": 1.0 - busy_us / 1e3 / wall_ms,
           "idle_share_of_step": 1.0 - busy_us / 1e3 / steps / step_ms,
           "port_kernel_share": port / total,
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
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: "
        f"{os.path.relpath(path, REPO)} (register report beside it)")

    log(f"kernel checks: beyond one bf16 ulp (2**-7 of the value), y and "
        f"qkv within {kc.REL_FWD} and dx and every grad within {kc.REL_BWD} "
        f"of the max of the term each checks; each term a check must see is "
        f">= {kc.MARGIN} x (tolerance + one typical ulp)")
    cases = [kernel_case("vision", 64, 197, 768, 12, 4, False, False, 0)]
    torch.cuda.synchronize()
    cases.append(kernel_case("text K=20", 20, 77, 512, 8, 0, True, False, 1))
    cases.append(kernel_case("text K=64", 64, 77, 512, 8, 0, True, False, 2))
    cases.append(kernel_case("vision weight_grads", 64, 197, 768, 12, 4,
                             False, True, 3, time_it=False))
    torch.cuda.synchronize()

    launches = main_path_phase()
    torch.cuda.synchronize()
    gate = learning_gate(card)
    torch.cuda.synchronize()

    v = cases[0]
    src = "lifelong_clip_tpu_torch/csrc/fused_block_attn.cu"
    kernels = []
    for name, pre in (("fused_ln_attention_fwd", "fwd"),
                      ("fused_ln_attention_bwd", "bwd")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c[f"{pre}_max_abs_err"] for c in cases),
            "ms": v[f"{pre}_ms"],
            "plain_ms": v[f"{pre}_plain_ms"],
            "bound_ms": v[f"{pre}_bound_ms"],
            "bound_us": v[f"{pre}_bound_ms"] * 1e3,
            "bound_by": v[f"{pre}_bound_by"],
            "library_ms": v[f"{pre}_library_ms"],
            "shape": "vision 64x197x768, 12 heads, LoRA r=4, bf16",
            "cases": [{k: c[k] for k in c if k.startswith(pre) or k in
                       ("label", "shape")} for c in cases]})
    log(json.dumps(gate))
    log(json.dumps({"kernels": kernels, "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
