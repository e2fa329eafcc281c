#!/usr/bin/env python3
"""Time the port's fused LN-attention chains (kernel #1 forward, #2
backward) of one checkout at the ViT-B/16 vision shape (64 x 197 x 768, 12
heads, LoRA r=4, bf16, no mask), its KV-prefix chains (#3, #4) at the
mvp-clip shape (P = 20, 5 slots live), and its flash-attention forward (#5)
at the prompted-LoRA shape (B*H = 768, T = 197, S = 217, bf16), on one GPU,
beside the library calls (LN + ``F.linear`` + SDPA + ``F.linear``; SDPA on
the fp32-upcast q, k, v):

    python3 tools/torch_chain_time.py [--root DIR] [--label NAME]

For the forward: the host ms to enqueue one call, ms per call from CUDA
events, device-busy ms from torch.profiler (host gaps left out), the host
ms inside each call into the kernel library, and every launch of the #1
and #3 chains in order by device ms; for the backward, events and
device-busy ms, with the device ms of each attention-backward kernel. The
backward reads the forward's kept intermediates, as a train step does.
``--root`` is the checkout whose
``lifelong_clip_tpu_torch`` is imported (its kernels are built there at
first use), so two trees are compared by running this once on each in one
run on the card; the timing helpers come from this repo's
``chip_smoke.py``. Prints the card and one JSON line.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose lifelong_clip_tpu_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_chain_time: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # this repo's chip_smoke.py, whichever tree is timed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    assert os.path.abspath(fba.__file__).startswith(root), fba.__file__
    torch.backends.cuda.matmul.allow_tf32 = False

    heads, s = 12, 0.25
    x, blk, lora, gy, mask = kc.make_inputs(64, 197, 768, heads, 4, False, 0)
    fargs = (blk["ln_scale"], blk["ln_bias"], blk["w_qkv"], blk["b_qkv"],
             blk["w_out"], blk["b_out"], heads, s, mask, lora)
    bargs = (blk["ln_scale"], blk["ln_bias"], blk["w_qkv"], blk["b_qkv"],
             blk["w_out"], heads, s, mask, lora, False)
    ll = {f"{k}_t": lora[k].T.contiguous() for k in lora}
    lb = cs.library_weights(blk)

    saved = fba._keep_for_backward(
        fba._cuda_forward(x, *fargs, keep=True)[1], False)

    def fwd():
        return fba._cuda_forward(x, *fargs)

    def bwd():
        return fba._cuda_backward(x, gy, *bargs, saved=saved)

    def lib():
        return cs.library_block(x, lb, ll, s, mask, heads)

    # the prefix chains at the mvp-clip shape
    px, pk, pv, pblk, pgy, pmask = kc.make_prefix_inputs(64, 197, 768, heads,
                                                         20, 5, 4)
    pfargs = (pk, pv, *[pblk[k] for k in kc.BLOCK_KEYS], heads, pmask)
    pbargs = (pk, pv, *[pblk[k] for k in kc.BLOCK_KEYS[:5]], heads, pmask,
              False)
    psaved = fba._keep_for_prefix_backward(
        fba._cuda_prefix_forward(px, *pfargs, keep=True)[1], False)

    def pfwd():
        return fba._cuda_prefix_forward(px, *pfargs)

    def pbwd():
        return fba._cuda_prefix_backward(px, pgy, *pbargs, saved=psaved)

    # the flash forward at the prompted-LoRA shape
    from lifelong_clip_tpu_torch.ops import flash_attention as fa
    fq, fk, fv, _, _ = kc.make_flash_inputs(64, 197, 217, 768, heads, 7)
    fwt = [a.float() for a in (fq, fk, fv)]

    def flash():
        return fa._cuda_forward(fq, fk, fv, heads, None)

    def flash_lib():
        return cs.library_flash(*fwt, heads, None)

    def attn_split(fn):
        names = cs.device_split(fn)[1]
        return {cs.kernel_short(k): v for k, v in names.items()
                if "attn_bwd" in k}

    runs = []
    with torch.no_grad():
        for _ in range(args.reps):
            runs.append({
                "host_ms": cs.host_ms(fwd, iters=20),
                "ms": cs.timed(fwd, iters=20),
                "device_ms": cs.device_ms(fwd, iters=10),
                "library_ms": cs.timed(lib, iters=20),
                "library_device_ms": cs.device_ms(lib, iters=10),
                "bwd_ms": cs.timed(bwd),
                "bwd_device_ms": cs.device_ms(bwd),
                "prefix_device_ms": cs.device_ms(pfwd, iters=10),
                "prefix_bwd_device_ms": cs.device_ms(pbwd),
                "flash_device_ms": cs.device_ms(flash, iters=10),
                "flash_library_device_ms": cs.device_ms(flash_lib, iters=10)})
        host_calls = cs.launch_breakdown(fwd, bwd)["host_fwd"]
        split = {"bwd": attn_split(bwd), "prefix_bwd": attn_split(pbwd)}
        chains = {"fwd": cs.device_sequence(fwd),
                  "prefix_fwd": cs.device_sequence(pfwd)}
    median = {}
    for k in runs[0]:
        vals = [r[k] for r in runs if r[k] is not None]
        median[k] = statistics.median(vals) if vals else None
    print(cs.card_line())
    print(json.dumps({"label": args.label, "root": os.path.relpath(root, HERE),
                      "median": median,
                      "attention_bwd_device_ms": split,
                      "forward_chain_by_launch": chains,
                      "host_ms_per_call": host_calls, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
