#!/usr/bin/env python3
"""Time #1/#2's and #3/#4's attention alone, one checkout at a time, and
hold two checkouts' attention outputs bit for bit:

    python3 tools/torch_attn_time.py [--root DIR] [--label NAME] [--out F]
        [--rows all|block|prefix]
    python3 tools/torch_attn_time.py --compare A B

The attention of the fused LN-attention chains (``llc_attn_fwd`` and
``llc_attn_bwd``, no mask, the weight grads' bias partials where a row
takes them) on seeded bf16 qkv16 and dctx16 at the rows #1/#2 run with no
mask (ViT-B/16 at 1, 8, 16, 32, 64, 128 and 256 batch rows, L2P's K1 at
T = 222, ViT-L/14 at 16 and 64 rows, and narrow T off and on a tile, past
256 keys at 300 and 384), on
one GPU: CUDA-event ms a call and every kernel by device ms (torch
profiler), beside the attention's own bound (``chip_smoke.attention_cost``
at 3.35 TB/s and 989 TFLOP/s) and the library's parts, which the port
never calls: ``scaled_dot_product_attention``'s forward and its backward
(autograd over one kept forward) on the same q, k, v, and their kernels.
The KV-prefix rows (``PREFIX_ROWS``) time ``llc_attn_prefix_fwd`` and
``llc_attn_prefix_bwd`` on seeded qkv16, kvp16 (the P prefix rows' K | V)
and dctx16 under a (P + T,) key-mask row with ``live`` of the P slots
live, as #3/#4 run them at mvp-clip's shape (P = 20, 5 live), ProtoCLIP's
K2 (P = 4, 4 and none live), one rank of mvp-clip's ``--mesh 2x1`` (32
rows) and with the weight grads, plus narrow rows on and off an 8-row
atom; SDPA there runs on the concatenated keys and values with the key
row as its float mask. ``--rows`` picks the block rows, the prefix rows or
both.
``--root`` is the checkout whose ``lifelong_clip_tpu_torch`` is imported
(its kernels built there at first use); the inputs come from seeded CPU
generators, so every checkout sees the same ones. ``--out`` keeps ctx16,
dqkv16 (and dkvp16 for a prefix row) and the bias partials of every row (``torch.save``, ~1 GB: give it
a directory ``.gitignore`` lists); ``--compare`` reads two such files and
prints, for each row and output, the share of bit-equal elements and the
largest difference in bf16 ulps (fp32 ulps for the partials). Prints the
card's name and power limit and one JSON line.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, B, T, D, heads, weight_grads, seed)
ROWS = (("vision 64 x 197", 64, 197, 768, 12, False, 0),
        ("eval bs 128", 128, 197, 768, 12, False, 1),
        ("L2P K1, T = 222", 64, 222, 768, 12, False, 2),
        ("ER 16 rows", 16, 197, 768, 12, False, 3),
        ("FT 16 rows, weight_grads", 16, 197, 768, 12, True, 4),
        ("FT 8 rows a rank, weight_grads", 8, 197, 768, 12, True, 5),
        ("CLIB miss recompute, 256 rows", 256, 197, 768, 12, False, 6),
        ("mesh rank, 32 rows", 32, 197, 768, 12, False, 7),
        ("one row", 1, 197, 768, 12, False, 8),
        ("ViT-L/14 64 x 257", 64, 257, 1024, 16, False, 9),
        ("ViT-L/14 microbatch, 16 rows", 16, 257, 1024, 16, False, 10),
        ("T = 64, weight_grads", 8, 64, 256, 4, True, 11),
        ("T = 17", 8, 17, 256, 4, False, 12),
        ("T = 129, weight_grads", 8, 129, 256, 4, True, 13),
        ("T = 300, weight_grads", 8, 300, 256, 4, True, 14),
        ("T = 384", 8, 384, 256, 4, False, 15))
# (label, B, T, D, heads, P, live slots, weight_grads, seed)
PREFIX_ROWS = (
    ("mvp prefix 64 x 197, P = 20, 5 live", 64, 197, 768, 12, 20, 5, False,
     20),
    ("K2 ProtoCLIP image, P = 4, 4 live", 64, 197, 768, 12, 4, 4, False, 21),
    ("K2, P = 4, none live", 64, 197, 768, 12, 4, 0, False, 22),
    ("mvp rank of 2x1, 32 rows, P = 20, 5 live", 32, 197, 768, 12, 20, 5,
     False, 23),
    ("mvp prefix weight_grads, 20 live", 64, 197, 768, 12, 20, 20, True, 24),
    ("S = 256 (P = 56), weight_grads", 8, 200, 256, 4, 56, 56, True, 25),
    ("P = 3, T = 17, weight_grads", 8, 17, 256, 4, 3, 2, True, 26),
    ("P = 8, T = 64", 8, 64, 256, 4, 8, 5, False, 27),
    ("P = 1, T = 127, weight_grads", 8, 127, 256, 4, 1, 1, True, 28))


def row_inputs(b, t, d, seed):
    """qkv16 (B*T, 3D) and dctx16 (B*T, D) on the card, from a seeded CPU
    generator (the same in every checkout)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b * t, 3 * d, generator=g)
    dctx = torch.randn(b * t, d, generator=g) * 0.1
    return (qkv.to("cuda", torch.bfloat16), dctx.to("cuda", torch.bfloat16))


def run_row(cs, b, t, d, heads, wg, seed):
    import torch
    import torch.nn.functional as F
    from lifelong_clip_tpu_torch.ops import _kernels
    qkv, dctx = row_inputs(b, t, d, seed)
    dh, m = d // heads, b * t
    scale = dh ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    ctx = torch.empty(m, d, dtype=torch.bfloat16, device="cuda")
    dqkv = torch.empty(m, 3 * d, dtype=torch.bfloat16, device="cuda")
    # the mma.sync road's row statistics (a road that keeps them in shared
    # memory reads none)
    stats = torch.empty(b * heads * -(-t // 16) * 16 * 4, dtype=torch.float32,
                        device="cuda")
    groups = -(-t // 16)
    bpart = (torch.zeros(b * groups * d + b * groups * 2 * d,
                         dtype=torch.float32, device="cuda") if wg else None)

    def fwd():
        _kernels.call("llc_attn_fwd", qkv.data_ptr(), None, None,
                      ctx.data_ptr(), b, t, d, heads, scale, stream)

    def bwd():
        _kernels.call("llc_attn_bwd", qkv.data_ptr(), dctx.data_ptr(), None,
                      None, dqkv.data_ptr(),
                      None if bpart is None else bpart.data_ptr(),
                      stats.data_ptr(), b, t, d, heads, scale, stream)

    q, k, v = (a.view(b, t, heads, dh).transpose(1, 2)
               for a in qkv.split(d, dim=1))
    g4 = dctx.view(b, t, heads, dh).transpose(1, 2)
    lq, lk, lv = (a.detach().clone().requires_grad_(True) for a in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v)

    def sdpa_bwd():
        torch.autograd.grad(lout, (lq, lk, lv), g4, retain_graph=True)

    fwd()
    bwd()
    torch.cuda.synchronize()
    out = {"ctx16": ctx.cpu(), "dqkv16": dqkv.cpu()}
    if bpart is not None:
        out["bias_partials"] = bpart.cpu()
    res = {"shape": [b, t, d], "heads": heads, "weight_grads": wg}
    return time_row(cs, res, (fwd, bwd, sdpa_fwd, sdpa_bwd), b, t, d,
                    heads), out


def time_row(cs, res, fns, b, t, d, heads, keys=None):
    """CUDA-event and device ms of the attention's forward and backward and
    SDPA's (``fns``), every kernel by device ms, and the attention's bound
    over ``keys`` keys a row (default T), into ``res``."""
    for name, fn in zip(("fwd", "bwd", "sdpa_fwd", "sdpa_bwd"), fns):
        res[f"{name}_ms"] = cs.timed(fn, iters=20, warmup=3)
        busy, names = cs.device_split(fn, iters=10)
        res[f"{name}_device_ms"] = busy
        res[f"{name}_kernels"] = {cs.kernel_short(k): v
                                  for k, v in names.items()}
    for name, backward in (("fwd", False), ("bwd", True)):
        ms, by = cs.bound_ms(*cs.attention_cost(b, t, d, heads, backward,
                                                keys=keys))
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = ms, by
    return res


def run_prefix_row(cs, b, t, d, heads, p, live, wg, seed):
    import torch
    import torch.nn.functional as F
    from lifelong_clip_tpu_torch.ops import _kernels
    qkv, dctx = row_inputs(b, t, d, seed)
    g = torch.Generator().manual_seed(seed + 1000)
    kvp = torch.randn(b * p, 2 * d, generator=g).to("cuda", torch.bfloat16)
    mask = torch.zeros(p + t, device="cuda")
    mask[live:p] = float("-inf")
    dh, m, s = d // heads, b * t, p + t
    scale = dh ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    ctx = torch.empty(m, d, dtype=torch.bfloat16, device="cuda")
    dqkv = torch.empty(m, 3 * d, dtype=torch.bfloat16, device="cuda")
    dkvp = torch.empty(b * p, 2 * d, dtype=torch.bfloat16, device="cuda")
    stats = torch.empty(b * heads * -(-t // 16) * 16 * 4, dtype=torch.float32,
                        device="cuda")
    bpart = (torch.zeros(b * -(-t // 16) * d + b * -(-s // 16) * 2 * d,
                         dtype=torch.float32, device="cuda") if wg else None)

    def fwd():
        _kernels.call("llc_attn_prefix_fwd", qkv.data_ptr(), kvp.data_ptr(),
                      mask.data_ptr(), 0, None, ctx.data_ptr(), b, t, p, d,
                      heads, scale, stream)

    def bwd():
        _kernels.call("llc_attn_prefix_bwd", qkv.data_ptr(), kvp.data_ptr(),
                      dctx.data_ptr(), mask.data_ptr(), 0, None,
                      dqkv.data_ptr(), dkvp.data_ptr(),
                      None if bpart is None else bpart.data_ptr(),
                      stats.data_ptr(), b, t, p, d, heads, scale, stream)

    def heads_of(a, n):
        return a.view(b, n, heads, dh).transpose(1, 2)

    q = heads_of(qkv[:, :d], t)
    k = torch.cat([heads_of(kvp[:, :d], p), heads_of(qkv[:, d:2 * d], t)], 2)
    v = torch.cat([heads_of(kvp[:, d:], p), heads_of(qkv[:, 2 * d:], t)], 2)
    g4 = heads_of(dctx, t)
    am = mask.to(torch.bfloat16).view(1, 1, 1, s)
    lq, lk, lv = (a.detach().clone().requires_grad_(True) for a in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=am)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, attn_mask=am)

    def sdpa_bwd():
        torch.autograd.grad(lout, (lq, lk, lv), g4, retain_graph=True)

    fwd()
    bwd()
    torch.cuda.synchronize()
    out = {"ctx16": ctx.cpu(), "dqkv16": dqkv.cpu(), "dkvp16": dkvp.cpu()}
    if bpart is not None:
        out["bias_partials"] = bpart.cpu()
    res = {"shape": [b, t, d], "heads": heads, "prompts": p, "live": live,
           "weight_grads": wg}
    # the bound counts the live keys' pairs only (dead slots add zeros)
    return time_row(cs, res, (fwd, bwd, sdpa_fwd, sdpa_bwd), b, t, d, heads,
                    keys=live + t), out


def ulps(a, b):
    """Largest difference in units of the last place between two tensors of
    one float dtype (bf16 or fp32), on the integers that order the floats;
    NaN where exactly one of two elements is NaN."""
    import torch
    itype = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    wide = torch.int64

    def ordered(x):
        i = x.view(itype).to(wide)
        top = 1 << (8 * x.element_size() - 1)
        return torch.where(i < 0, -(i + top), i)

    nan = torch.isnan(a) != torch.isnan(b)
    if bool(nan.any()):
        return float("nan")
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def compare(path_a, path_b):
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    report = {}
    for label in a:
        if label not in b:
            continue
        report[label] = {}
        for key, x in a[label].items():
            y = b[label][key]
            same = (x.view(torch.int16 if x.dtype == torch.bfloat16
                           else torch.int32)
                    == y.view(torch.int16 if y.dtype == torch.bfloat16
                              else torch.int32))
            report[label][key] = {
                "bit_equal_share": float(same.float().mean()),
                "differing": int((~same).sum()),
                "max_ulps": ulps(x, y)}
    print(json.dumps({"compare": [path_a, path_b], "rows": report}))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose lifelong_clip_tpu_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="keep every row's outputs here")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --out files and stop")
    ap.add_argument("--rows", choices=("all", "block", "prefix"),
                    default="all", help="the #1/#2 rows, the #3/#4 rows "
                    "or both")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    import torch
    if not torch.cuda.is_available():
        print("torch_attn_time: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # this repo's chip_smoke.py (timing helpers, costs), whichever tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lifelong_clip_tpu_torch.ops import _kernels
    assert os.path.abspath(_kernels.__file__).startswith(root)
    card = cs.card_line()
    print(card, flush=True)
    _kernels.library()
    todo = []
    if args.rows in ("all", "block"):
        todo += [(label, run_row, rest) for label, *rest in ROWS]
    if args.rows in ("all", "prefix"):
        todo += [(label, run_prefix_row, rest) for label, *rest in PREFIX_ROWS]
    rows, outs = {}, {}
    for label, run, rest in todo:
        rows[label], outs[label] = run(cs, *rest)
        r = rows[label]
        print(f"{label}: attention fwd {r['fwd_ms']:.4f} ms (device "
              f"{cs.fmt(r['fwd_device_ms'], 4)}, bound "
              f"{r['fwd_bound_ms']:.4f}, SDPA {r['sdpa_fwd_ms']:.4f}), bwd "
              f"{r['bwd_ms']:.4f} ms (device {cs.fmt(r['bwd_device_ms'], 4)}, "
              f"bound {r['bwd_bound_ms']:.4f}, SDPA {r['sdpa_bwd_ms']:.4f})",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        torch.save(outs, args.out)
    print(json.dumps({"label": args.label,
                      "root": os.path.relpath(root, HERE), "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
