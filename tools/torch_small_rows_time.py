#!/usr/bin/env python3
"""Time the port's fused LN-attention chains (kernel #1 forward, #2
backward) at the ER family's small batches on one GPU, beside the library
calls, as ``chip_smoke.py``'s kernel phase does, without the rest of that
script:

    python3 tools/torch_small_rows_time.py [--root DIR] [--label NAME]
        [--gates] [--others] [--prefix] [--products] [--bits FILE]
        [--out FILE]
    python3 tools/torch_small_rows_time.py --compare A B

ViT-B/16's vision block (T = 197, D = 768, 12 heads, bf16, no LoRA, no
mask) at 8, 16, 64, 128 and 256 rows (CLIB's miss recompute), the
backward with and without the weight grads (Finetuning's whole-tower step,
and its 8 rows a rank under ``--mesh 2x1``). For each: the checks against
the plain versions, the forward and backward chains' CUDA-event and
device-busy ms beside the plain version and the library yardstick (LN +
``F.linear`` + SDPA + ``F.linear``, backward by autograd), their bounds
and the attention's own, the attention kernels of both chains, and every
launch of both chains and of the yardstick's forward and backward in order
by device ms. ``--gates`` adds the ER and
Finetuning learning gates of ``chip_smoke.py`` (device ms a step, idle
share, kernel events a step); ``--others`` the rows that share these
kernels without being the small batches' (#1/#2 with LoRA r=4 at 64 rows,
at the 32 rows of a ``--mesh 2x1`` rank and the 16 of a pipeline
microbatch, ViT-L/14 at 64 rows and at a 16-row microbatch, L2P's K1,
ProtoCLIP's K3 text prefix, the text tower's causal K=20 and K=64 class
rows; #3/#4 at the mvp shape and ProtoCLIP's K2), to
hold them against another tree; ``--prefix`` every #3/#4 row (the mvp
shape, K2, mvp-clip's 32 rows a ``--mesh 2x1`` rank, ProtoCLIP's suffix K4
and its main path's shape, the text prompts) without the #1/#2 rows.
``--products`` times each GEMM product of the chains alone (qkv, out,
dctx, dh; the LoRA rows' folded ones; dW_out and dW_qkv with the weight
grads' split-K) beside ``torch.matmul`` on the same operands, and the LN
backward alone beside autograd's ``layer_norm`` backward, each with its
bound (``PRODUCT_ROWS``). ``--bits FILE`` saves every output of the rows run
(the chains' y, ctx16, dx and grads; each product's output; the LN
backward's dx) to FILE (in a directory ``.gitignore`` lists; a few hundred
MB), and ``--compare A B`` gives two such files' bit-equal share and
largest distance in ulps, row by row (``tools/torch_attn_time.py``'s
comparison). ``--root`` is the
checkout whose ``lifelong_clip_tpu_torch`` is timed (its kernels are built
there at first use; the cases and timing helpers come from this repo's
``chip_smoke.py``), so a parent and a change are compared by running this
on each in one run on the card (parent, change, change, parent).
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
         (64, False, 44), (64, True, 45), (128, False, 46), (256, False, 47))
# #1/#2 (label, B, T, D, heads, LoRA r, causal, seed) and #3/#4 (label,
# live slots, seed, shape) cases as chip_smoke.py runs them
OTHERS = (("vision, LoRA r=4", 64, 197, 768, 12, 4, False, 0),
          ("per rank of 2x1: lora-clip, 32 rows", 32, 197, 768, 12, 4,
           False, 27),
          ("pipeline microbatch: ViT-B/16, 16 rows", 16, 197, 768, 12, 4,
           False, 30),
          ("ViT-L/14 vision", 64, 257, 1024, 16, 4, False, 12),
          ("pipeline microbatch: ViT-L/14, 16 rows", 16, 257, 1024, 16, 4,
           False, 31),
          ("L2P prompted, T = 222", 64, 222, 768, 12, 0, False, 19),
          ("ProtoCLIP text prefix, T = 25", 64, 25, 512, 8, 0, True, 20),
          ("text K=20", 20, 77, 512, 8, 0, True, 1),
          ("text K=64", 64, 77, 512, 8, 0, True, 2))
PREFIX_OTHERS = (("mvp prefix, 5 of 20 live", 5, 4, (64, 197, 768, 12, 20)),
                 ("ProtoCLIP image, P = 4, 4 live", 4, 21,
                  (64, 197, 768, 12, 4)))
# every #3/#4 row (--prefix): those, mvp-clip's rank of --mesh 2x1, and
# (in main) ProtoCLIP's suffix K4 and main shape and the text prompts
PREFIX_ALL = PREFIX_OTHERS + (
    ("per rank of 2x1: mvp prefix, 32 rows, 5 of 20 live", 5, 29,
     (32, 197, 768, 12, 20)),)
# --products: (label, B, T, D, LoRA r, weight grads) rows whose products
# and LN backward are timed alone
PRODUCT_ROWS = (("vision, r = 0", 64, 197, 768, 0, True),
                ("L2P prompted, T = 222", 64, 222, 768, 0, False),
                ("eval bs 128", 128, 197, 768, 0, False),
                ("ER / FT, 16 rows", 16, 197, 768, 0, True),
                ("vision, LoRA r=4", 64, 197, 768, 4, False),
                ("ViT-L/14 vision, LoRA r=4", 64, 257, 1024, 4, False))
KEEP = ("label", "fwd_ms", "fwd_device_ms", "fwd_library_ms",
        "fwd_library_device_ms", "fwd_plain_ms", "fwd_bound_ms", "bwd_ms",
        "bwd_device_ms", "bwd_library_ms", "bwd_library_device_ms",
        "bwd_plain_ms", "bwd_bound_ms", "fwd_attention_device_ms",
        "bwd_attention_device_ms", "attn_fwd_bound_ms", "attn_bwd_bound_ms",
        "fwd_max_abs_err", "bwd_max_abs_err", "forward_chain_split",
        "chain_split", "library_forward_by_launch",
        "library_backward_by_launch")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def products(cs, fba, label, b, t, d, r, wg, seed):
    """Each GEMM product of the #1/#2 chains at (B, T, D, LoRA r) and the LN
    backward, alone: {name: timings} and {name: output} (seeded operands,
    the same in every tree)."""
    import torch
    import torch.nn.functional as F
    bf, dev = torch.bfloat16, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, std=1.0, dtype=bf):
        return (std * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    m = b * t
    h, ctx, g16, dqkv = rnd(m, d), rnd(m, d), rnd(m, d), rnd(m, 3 * d)
    w_qkv, w_out = rnd(d, 3 * d, std=d ** -0.5), rnd(d, d, std=d ** -0.5)
    b_qkv, b_out, x = rnd(3 * d, std=0.02), rnd(d, std=0.02), rnd(m, d)
    f32 = dict(dtype=torch.float32, device=dev)
    # name: (kernel, library call, flops, bytes)
    fns = {}
    if r:
        a_in, b_in = rnd(d, r, std=d ** -0.5), rnd(r, 3 * d)
        a_out, b_out_l = rnd(d, r, std=d ** -0.5), rnd(r, d)
        zc, nb = fba._z_cols(m), fba._lora_blocks(m)
        z16, z2 = rnd(r, zc), rnd(r, zc)
        ft = torch.stack([a_in.t(), a_out.t()]).contiguous()
        pb = torch.empty(nb * r * 3 * d, **f32)
        pa = torch.empty(nb * 3 * d * r, **f32)

        def lora(out, a, sa, w, sw, n, k, f, lb, **kw):
            return lambda: fba._gemm_lora(out, a, sa, w, sw, m, n, k, f, r,
                                          zalpha=0.25, lscale=1.0, lb=lb,
                                          **kw)
        fns["qkv"] = lora(torch.empty(m, 3 * d, dtype=bf, device=dev), h,
                          (d, 1), w_qkv, (3 * d, 1), 3 * d, d, ft[0],
                          (b_in, 3 * d, 1), bias=b_qkv,
                          zout=torch.empty(r, zc, dtype=bf, device=dev))
        fns["out"] = lora(torch.empty(m, d, dtype=bf, device=dev), ctx,
                          (d, 1), w_out, (d, 1), d, d, ft[1],
                          (b_out_l, d, 1), bias=b_out, resid=x,
                          zout=torch.empty(r, zc, dtype=bf, device=dev))
        fns["dctx"] = lora(torch.empty(m, d, dtype=bf, device=dev), g16,
                           (d, 1), w_out, (1, d), d, d, b_out_l,
                           (a_out, 1, r), zin=z2, pb=pb, xa=ctx, pa=pa)
        fns["dh"] = lora(torch.empty(m, d, **f32), dqkv, (3 * d, 1), w_qkv,
                         (1, 3 * d), d, 3 * d, b_in, (a_in, 1, r), zin=z16,
                         pb=pb, xa=h, pa=pa)
    else:
        def plain(out, a, sa, w, sw, mm, n, k, **kw):
            return lambda: fba._gemm(out, a, sa, w, sw, mm, n, k, **kw)
        fns["qkv"] = plain(torch.empty(m, 3 * d, dtype=bf, device=dev), h,
                           (d, 1), w_qkv, (3 * d, 1), m, 3 * d, d,
                           bias=b_qkv)
        fns["out"] = plain(torch.empty(m, d, dtype=bf, device=dev), ctx,
                           (d, 1), w_out, (d, 1), m, d, d, bias=b_out,
                           resid=x)
        fns["dctx"] = plain(torch.empty(m, d, dtype=bf, device=dev), g16,
                            (d, 1), w_out, (1, d), m, d, d)
        fns["dh"] = plain(torch.empty(m, d, **f32), dqkv, (3 * d, 1),
                          w_qkv, (1, 3 * d), m, d, 3 * d)
        if wg:
            fns["dW_out"] = plain(torch.empty(d, d, **f32), ctx, (1, d),
                                  g16, (d, 1), d, d, m, splits=-2)
            fns["dW_qkv"] = plain(torch.empty(d, 3 * d, **f32), h, (1, d),
                                  dqkv, (3 * d, 1), d, 3 * d, m, splits=-2)
    lib = {"qkv": lambda: torch.matmul(h, w_qkv),
           "out": lambda: torch.matmul(ctx, w_out),
           "dctx": lambda: torch.matmul(g16, w_out.t()),
           "dh": lambda: torch.matmul(dqkv, w_qkv.t()),
           "dW_out": lambda: torch.matmul(ctx.t(), g16),
           "dW_qkv": lambda: torch.matmul(h.t(), dqkv)}
    # (M, N, K, output bytes an element) of each product
    dims = {"qkv": (m, 3 * d, d, 2), "out": (m, d, d, 2),
            "dctx": (m, d, d, 2), "dh": (m, d, 3 * d, 4),
            "dW_out": (d, d, m, 4), "dW_qkv": (d, 3 * d, m, 4)}
    res, outs = {}, {}
    for name, fn in fns.items():
        mm_, n, k, eo = dims[name]
        flops = 2 * mm_ * n * k
        nbytes = 2 * (mm_ * k + k * n) + eo * mm_ * n
        outs[name] = fn()
        torch.cuda.synchronize()
        res[name] = {"mnk": [mm_, n, k],
                     "device_ms": cs.device_ms(fn, iters=10),
                     "events_ms": cs.timed(fn, iters=20),
                     "matmul_device_ms": cs.device_ms(lib[name], iters=10),
                     "bound_ms": cs.bound_ms(flops, nbytes)[0]}
    # the LN backward alone (dx = g + LN'(x)^T dh; with the weight grads'
    # workspace as Finetuning's chain runs it) beside autograd's layer_norm
    # backward on the same x and gamma
    gamma, beta = 1 + rnd(d, std=0.1), rnd(d, std=0.1)
    dh = torch.randn(m, d, generator=gen, device=dev)
    part = torch.empty(3 * fba._ln_part_chunks(m, d) * d + 2 * m, **f32) \
        if wg else None
    from lifelong_clip_tpu_torch.ops import _kernels

    def ln():   # llc_ln_bwd as the chains call it (the same in every tree)
        dx = torch.empty_like(x)
        _kernels.call("llc_ln_bwd", 1, 1, x.data_ptr(), gamma.data_ptr(),
                      dh.data_ptr(), g16.data_ptr(), dx.data_ptr(),
                      None if part is None else part.data_ptr(), m, d, 1e-5,
                      torch.cuda.current_stream().cuda_stream)
        return dx
    xl = x.detach().clone().requires_grad_(True)
    yl = F.layer_norm(xl, (d,), gamma, beta, 1e-5)
    dh16 = dh.to(bf)
    lib_ln = (lambda: torch.autograd.grad(yl, xl, dh16, retain_graph=True))
    outs["ln_bwd_dx"] = ln()
    torch.cuda.synchronize()
    res["ln_bwd"] = {"weight_grads": wg,
                     "device_ms": cs.device_ms(ln, iters=10),
                     "events_ms": cs.timed(ln, iters=20),
                     "layer_norm_bwd_device_ms": cs.device_ms(lib_ln,
                                                              iters=10),
                     "bound_ms": cs.bound_ms(0, m * d * (2 + 4 + 2 + 2))[0]}
    return res, outs


def chain_bits(kc, fba, rows, wg, seed, others=None, prefix=None):
    """Every output of a chain row, recomputed from the case's seed: #1/#2
    (``kc.block_outputs``) or, with ``prefix`` (live, shape), #3/#4's y, dx
    and grads."""
    import torch
    if prefix is None:
        label, b, t, d, h, r, causal = others or (
            None, rows, 197, 768, 12, 0, False)
        x, blk, lora, gy, mask = kc.make_inputs(b, t, d, h, r, causal, seed)
        return kc.block_outputs(x, blk, lora, 0.25 if r else 0.0, gy, mask,
                                h, weight_grads=wg)
    live, (b, t, d, h, p) = prefix
    x, pk, pv, blk, gy, row = kc.make_prefix_inputs(b, t, d, h, p, live, seed)
    wb = [blk[k] for k in kc.BLOCK_KEYS]
    y, saved = fba._prefix_forward(x, pk, pv, *wb, h, row, keep=wg)
    grads = fba._prefix_backward(x, gy, pk, pv, *wb[:5], h, row, wg,
                                 saved=saved)
    out = {"y": y}
    out.update({f"g{i}": v for i, v in enumerate(grads)
                if isinstance(v, torch.Tensor)})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose lifelong_clip_tpu_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--gates", action="store_true",
                    help="also run the ER and Finetuning learning gates")
    ap.add_argument("--others", action="store_true",
                    help="also time the rows that share the kernels")
    ap.add_argument("--prefix", action="store_true",
                    help="time every #3/#4 row and no #1/#2 row")
    ap.add_argument("--products", action="store_true",
                    help="time each GEMM product and the LN backward alone")
    ap.add_argument("--bits", help="save every output of the rows run here")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --bits files and stop")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    if args.compare:
        return _load(os.path.join(HERE, "tools", "torch_attn_time.py"),
                     "torch_attn_time").compare(*args.compare)
    import torch
    if not torch.cuda.is_available():
        print("torch_small_rows_time: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _load(os.path.join(HERE, "chip_smoke.py"), "chip_smoke")
    from lifelong_clip_tpu_torch.ops import _kernels
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    assert os.path.abspath(_kernels.__file__).startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    cases, gates, prods, bits = [], {}, {}, {}

    def keep_bits(label, fn):
        if args.bits:
            bits[label] = {k: v.detach().cpu() for k, v in fn().items()}
            torch.cuda.synchronize()
    with contextlib.redirect_stdout(io.StringIO()):
        for i, (label, b, t, d, r, wg) in enumerate(
                PRODUCT_ROWS if args.products else ()):
            prods[label], outs = products(cs, fba, label, b, t, d, r, wg,
                                          60 + i)
            keep_bits(f"products: {label}", lambda: outs)
        if args.prefix:
            for label, live, seed, shape in PREFIX_ALL:
                res = cs.prefix_kernel_case(label, live, False, seed,
                                            shape=shape)
                cases.append({k: res.get(k) for k in KEEP})
                torch.cuda.synchronize()
                keep_bits(label, lambda: chain_bits(
                    kc, fba, None, False, seed, prefix=(live, shape)))
            from lifelong_clip_tpu_torch.models.proto_clip import \
                suffix_mask
            more = [cs.prefix_kernel_case(
                "ProtoCLIP suffix, C x S = 64 x 8, lp = 25", 25, False, 23,
                shape=(64, 512, 512, 8, 25), shared=True,
                mask=suffix_mask(64, 8, 25, device="cuda"))]
            more += [r for r in cs.proto_main_suffix_cases()
                     if "fwd_ms" in r]
            more.append(cs.text_prompt_prefix_case())
            cases += [{k: r.get(k) for k in KEEP} for r in more]
            torch.cuda.synchronize()
        for rows, wg, seed in () if args.prefix else CASES:
            label = f"{rows} x 197 x 768, r = 0" + (
                ", weight_grads" if wg else "")
            res = cs.kernel_case(label, rows, 197, 768, 12, 0, False, wg,
                                 seed, library_parts=True)
            cases.append({k: res.get(k) for k in KEEP})
            torch.cuda.synchronize()
            keep_bits(label, lambda: chain_bits(kc, fba, rows, wg, seed))
        for label, b, t, d, h, r, causal, seed in (
                OTHERS if args.others else ()):
            res = cs.kernel_case(label, b, t, d, h, r, causal, False, seed,
                                 library_parts=True)
            cases.append({k: res.get(k) for k in KEEP})
            torch.cuda.synchronize()
            keep_bits(label, lambda: chain_bits(
                kc, fba, None, False, seed,
                others=(label, b, t, d, h, r, causal)))
        for label, live, seed, shape in PREFIX_OTHERS if args.others else ():
            res = cs.prefix_kernel_case(label, live, False, seed, shape=shape)
            cases.append({k: res.get(k) for k in KEEP})
            torch.cuda.synchronize()
            keep_bits(label, lambda: chain_bits(kc, fba, None, False, seed,
                                                prefix=(live, shape)))
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
              f"{c['bwd_bound_ms']:.4f}); attention fwd "
              f"{json.dumps(c['fwd_attention_device_ms'])}, bwd "
              f"{json.dumps(c['bwd_attention_device_ms'])}", flush=True)
    for label, res in prods.items():
        print(f"products, {label}: " + "; ".join(
            f"{k} {cs.fmt(v['device_ms'], 4)} (matmul "
            f"{cs.fmt(v.get('matmul_device_ms', v.get('layer_norm_bwd_device_ms')), 4)}"
            f", bound {v['bound_ms']:.4f})" for k, v in res.items()),
            flush=True)
    if args.bits:
        torch.save(bits, args.bits)
    line = json.dumps({"label": args.label,
                       "root": os.path.relpath(root, HERE), "card": card,
                       "cases": cases, "gates": gates, "products": prods})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
