"""The port's CUDA kernels against their plain PyTorch versions, its GEMM
against ``torch.matmul``, and the unfused attention road's fp32 products, on
the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
without one. On the card, without JAX (this file imports torch only):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""

import threading

import pytest
import torch

from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
from lifelong_clip_tpu_torch.ops import kernel_check as kc

pytestmark = pytest.mark.cuda

LORA_KEYS = ("a_in", "b_in", "a_out", "b_out")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _inputs(dev, b, t, d, r, seed=0):
    x, blk, lora, gy, _ = kc.make_inputs(b, t, d, 1, r, False, seed,
                                         device=dev)
    return x, [blk[k] for k in kc.BLOCK_KEYS], lora, gy


# (b, t, d, heads, lora r, causal, weight_grads): head dims 64, 32 and 16;
# T on and off a multiple of 16; the vision block's T = 197; past 256 keys
# (the tiled roads): ViT-L/14's block (T = 257, D = 1024, 16 heads) with and
# without weight_grads, T = 512, causal T = 300, and T = 800, whose queries
# the dk/dv kernel cannot hold at once and streams; the text tower of
# lora-clip with LoRA on both towers at CIFAR-100's 100 class rows (causal,
# r=4, D = 512: the GEMMs' N = 1536 and 512)
CASES = [(2, 13, 128, 2, 4, False, False), (3, 77, 256, 4, 0, True, True),
         (2, 197, 192, 3, 4, False, True), (2, 9, 128, 4, 4, True, False),
         (2, 32, 64, 4, 2, False, True),
         (2, 257, 1024, 16, 4, False, False),
         (2, 257, 1024, 16, 4, False, True),
         (2, 512, 256, 4, 4, False, False), (1, 300, 128, 2, 0, True, True),
         (1, 800, 64, 1, 0, False, False),
         (100, 77, 512, 8, 4, True, False),
         (128, 197, 768, 12, 0, False, False),
         # L2P's prompted pass (T = 1 + 25 + 196, a partial row tile, no
         # LoRA) and ProtoCLIP's text prefix (T = 25, causal), narrowed
         (2, 222, 192, 3, 0, False, False), (4, 25, 128, 2, 0, True, False),
         # the ER family at ViT-B/16's widths: Finetuning's whole-tower step
         # (no LoRA, weight grads), ER's step and CLIB's 256-row recompute
         (16, 197, 768, 12, 0, False, True),
         (16, 197, 768, 12, 0, False, False),
         (256, 197, 768, 12, 0, False, False),
         # Finetuning's 8 rows a rank of --mesh 2x1, and B = 1 and 3, where
         # the attention kernels split each (head, batch row) over blocks
         (8, 197, 768, 12, 0, False, True),
         (1, 197, 768, 12, 0, False, False),
         (3, 197, 768, 12, 0, False, False)]


@pytest.mark.parametrize("b,t,d,heads,r,causal,wg", CASES)
def test_kernels_match_plain_versions(cuda, b, t, d, heads, r, causal, wg):
    """Through the op's autograd Function, each output on the part the
    kernels compute (y - x, the LoRA-in term of qkv, dx - g, every grad),
    with the tolerances stated in ``ops/kernel_check.py``."""
    x, blk, lora, gy, mask = kc.make_inputs(b, t, d, heads, r, causal, 0,
                                            device=cuda)
    kc.check_case(x, blk, lora, gy, mask, heads, 0.25 if r else 0.0, wg)


@pytest.mark.parametrize("b,d,heads,r", [(4, 192, 3, 4), (16, 768, 12, 0)])
def test_backward_is_deterministic(cuda, b, d, heads, r):
    """No float atomics: two backward passes on the same inputs, reading
    the forward's kept intermediates as a train step does, agree bit for
    bit, the row contractions and the bias and LN sums included; also at
    Finetuning's 16 rows, where the attention kernels split each (head,
    batch row) over blocks."""
    x, blk, lora, gy = _inputs(cuda, b, 197, d, r, seed=1)
    s = 0.25 if r else 0.0
    _, saved = fba._cuda_forward(x, *blk, heads, s, None, lora, keep=True)
    bargs = (*blk[:5], heads, s, None, lora, True)
    saved = fba._keep_for_backward(saved, True)
    first = fba._cuda_backward(x, gy, *bargs, saved)
    second = fba._cuda_backward(x, gy, *bargs, saved)
    for one, two in zip(first[0], second[0]):
        assert kc.same_bits(one, two)
    for k in (LORA_KEYS if r else ()):
        assert torch.equal(first[1][k], second[1][k]), k


def test_backward_in_a_fresh_host_thread(cuda):
    """The chain's first launch in a host thread that made no CUDA call
    before (autograd's backward thread at a process's first op, once no
    PyTorch launch leads the chain) encodes new TMA maps: the launcher
    makes the device's context current first. Shapes no other case uses,
    so the maps are new."""
    x, blk, _, gy = _inputs(cuda, 3, 61, 256, 0, seed=4)
    _, saved = fba._cuda_forward(x, *blk, 4, 0.0, None, None, keep=True)
    kept = fba._keep_for_backward(saved, True)
    out = {}

    def run():
        try:
            out["grads"] = fba._cuda_backward(x, gy, *blk[:5], 4, 0.0, None,
                                              None, True, kept)
        except Exception as e:   # noqa: BLE001 - reported below
            out["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert "error" not in out, out.get("error")
    assert all(torch.isfinite(g).all() for g in out["grads"][0])


def test_rows_do_not_depend_on_the_batch(cuda):
    """The rows of a 16-row batch, whose attention kernels split each
    (head, batch row) over blocks, give ctx, y and dx bit for bit equal to
    the same rows inside a 64-row batch, which does not split: each row's
    arithmetic is the same on both roads."""
    x, blk, _, gy, _ = kc.make_inputs(64, 197, 768, 12, 0, False, 9,
                                      device=cuda)
    got = [kc.batch_rows(x[:n], blk, gy[:n], 12) for n in (16, 64)]
    for key in got[0]:
        assert kc.same_bits(got[0][key], got[1][key][:got[0][key].shape[0]]), key


# (b, t, d, heads, lora r, weight_grads) under the causal (T, T) mask: the
# text tower's shape (lora-clip with LoRA on both towers, 100 class rows
# cut to 6), ProtoCLIP's K3 text prefix (T = 25, narrowed), one row block
# (T = 9), the weight grads' bias partials, and past 256 keys (the tiled
# roads)
CAUSAL_CASES = [(6, 77, 512, 8, 4, False), (4, 25, 128, 2, 0, False),
                (2, 9, 128, 4, 4, False), (3, 77, 256, 4, 0, True),
                (1, 300, 128, 2, 0, True)]


@pytest.mark.parametrize("b,t,d,heads,r,wg", CAUSAL_CASES)
def test_causal_tile_map_changes_no_bit(cuda, b, t, d, heads, r, wg):
    """#1/#2 under the causal mask with its tile map (dead 16 x 16 blocks
    skipped, plain blocks' entries from the map's words) and with a null
    map (every block swept, the mask read): ctx, y, dx, the LoRA grads and
    the block grads bit for bit equal."""
    x, blk, lora, gy, mask = kc.make_inputs(b, t, d, heads, r, True, 5,
                                            device=cuda)
    s = 0.25 if r else 0.0
    skip, full = (kc.block_outputs(x, blk, lora, s, gy, mask, heads,
                                   tile_map=m, weight_grads=wg)
                  for m in (True, False))
    assert fba._Prepared(x, *[blk[k] for k in kc.BLOCK_KEYS], mask, lora,
                         s).tmap is not None
    for key in skip:
        assert kc.same_bits(skip[key], full[key]), key


def test_causal_text_rows_do_not_depend_on_the_batch(cuda):
    """The text tower's 20 and 64 class rows (causal, LoRA r=4, under the
    mask's tile map) give ctx, y and dx bit for bit equal to the same rows
    inside its 100."""
    x, blk, lora, gy, mask = kc.make_inputs(100, 77, 512, 8, 4, True, 11,
                                            device=cuda)
    whole = kc.batch_rows(x, blk, gy, 8, lora, 0.25, mask)
    for n in (20, 64):
        part = kc.batch_rows(x[:n], blk, gy[:n], 8, lora, 0.25, mask)
        for key in part:
            assert kc.same_bits(part[key], whole[key][:n]), (n, key)


def test_one_tile_map_a_mask(cuda):
    """The blocks of a tower pass share one mask tensor: its tile map is
    built once for all their forwards and backwards, and anew for another
    mask tensor or after an in-place write to it."""
    from lifelong_clip_tpu_torch.ops.attention import causal_mask
    x, blk, lora, gy = _inputs(cuda, 2, 37, 128, 4, seed=6)
    mask = causal_mask(37, device=cuda)
    fba.reset_launches()
    for _ in range(3):
        xl = x.detach().clone().requires_grad_(True)
        fba.fused_ln_attention_block(xl, *blk, 2, 0.25, mask, lora,
                                     False).backward(gy)
    assert fba.LAUNCHES["block_tile_map"] == 1
    assert fba.LAUNCHES["fused_ln_attention_bwd"] == 3
    mask[0, 1] = 0.0   # a write: the map is stale
    fba.fused_ln_attention_block(x, *blk, 2, 0.25, mask, lora)
    fba.fused_ln_attention_block(x, *blk, 2, 0.25, causal_mask(37,
                                 device=cuda), lora)
    assert fba.LAUNCHES["block_tile_map"] == 3


def test_op_launches_kernels_and_counts_them(cuda):
    x, blk, lora, gy = _inputs(cuda, 2, 13, 128, 4, seed=2)
    lora = {k: v.requires_grad_() for k, v in lora.items()}
    fba.reset_launches()
    y = fba.fused_ln_attention_block(x, *blk, 2, 0.25, None, lora, False)
    y.backward(gy)
    assert fba.LAUNCHES == {"fused_ln_attention_fwd": 1,
                            "fused_ln_attention_bwd": 1,
                            "fused_prefix_attention_fwd": 0,
                            "fused_prefix_attention_bwd": 0,
                            "prefix_tile_map": 0,
                            "block_tile_map": 0}
    for k in LORA_KEYS:   # bf16 primals get bf16 grads
        assert lora[k].grad.dtype == torch.bfloat16, k


def test_unsupported_shape_raises_on_the_card(cuda):
    """A CUDA tensor the kernels cannot take raises; no plain fallback."""
    x, blk, _, _ = _inputs(cuda, 1, 9, 96, 0)
    with pytest.raises(ValueError):
        fba.fused_ln_attention_block(x, *blk, 2)   # head dim 48


# KV-prefix block: (b, t, d, heads, P, live slots, weight_grads). Head dims
# 64, 32 and 16; T and P on and off a multiple of 16; the mvp-clip block's
# T = 197 with P = 20 (5 live, as its g-prompt layers); no live slot;
# S = P + T = 256, the register roads' widest; S = 257 (20 of 60 slots live)
# and S = 512 on the tiled roads
PREFIX_CASES = [(2, 13, 128, 2, 5, 2, False), (2, 197, 192, 3, 20, 5, True),
                (3, 77, 256, 4, 20, 0, False), (2, 9, 64, 4, 3, 3, True),
                (2, 200, 128, 2, 56, 56, False),
                (2, 197, 192, 3, 60, 20, False),
                (2, 197, 192, 3, 315, 40, True)]


@pytest.mark.parametrize("b,t,d,heads,p,live,wg", PREFIX_CASES)
def test_prefix_kernels_match_plain_versions(cuda, b, t, d, heads, p, live,
                                             wg):
    """y on y - x, dx on dx - g, dpk, dpv and the block grads, with the
    tolerances stated in ``ops/kernel_check.py``; dead slots' grads are
    exactly zero."""
    x, pk, pv, blk, gy, mask = kc.make_prefix_inputs(b, t, d, heads, p, live,
                                                     0, device=cuda)
    kc.check_prefix_case(x, pk, pv, blk, gy, mask, heads, wg)


def test_prefix_kernels_take_a_full_mask(cuda):
    """A (T, P + T) mask (the text tower's causal mask with a prefix, plus
    dead slots) goes to the kernels as a matrix, not as one key-mask row."""
    from lifelong_clip_tpu_torch.ops.attention import causal_mask
    x, pk, pv, blk, gy, mask = kc.make_prefix_inputs(3, 77, 256, 4, 8, 5, 3,
                                                     device=cuda)
    full = causal_mask(77, prefix=8, device=cuda) + mask[None, :]
    assert fba._prefix_mask_arg(full, 77, 85, cuda)[1] == 85
    assert fba._prefix_mask_arg(mask, 77, 85, cuda)[1] == 0
    kc.check_prefix_case(x, pk, pv, blk, gy, full, 4, True)


def _suffix(c, s, lp, dead_row=None, prefix_dead_row=None):
    """ProtoCLIP's (C * S, lp + C * S) suffix mask on the CPU; optionally
    one row with no live key at all, or one row whose prefix keys are dead
    (its only live keys are then its own class's)."""
    from lifelong_clip_tpu_torch.models.proto_clip import suffix_mask
    m = suffix_mask(c, s, lp)
    if dead_row is not None:
        m[dead_row] = float("-inf")
    if prefix_dead_row is not None:
        m[prefix_dead_row, :lp] = float("-inf")
    return m


def _random_blocks(t, p, block, seed, values=False):
    """Seeded 0 / -inf entries, about a third dead, with whole ``block`` x
    ``block`` squares dead; every prefix key live for the first row. With
    ``values``, the live entries of every other row are N(0, 1) draws, so
    their blocks are read from the mask, not from the map's words."""
    g = torch.Generator().manual_seed(seed)
    m = torch.where(torch.rand(t, p + t, generator=g) < 0.3,
                    float("-inf"), 0.0)
    for r in range(0, t, block):
        for c in range(0, p + t, block):
            if float(torch.rand((), generator=g)) < 0.6:
                m[r:r + block, c:c + block] = float("-inf")
    m[0, :p] = 0.0
    if values:
        m[::2] += torch.randn(m[::2].shape, generator=g)
    return m


def _corner(t, p):
    """The causal mask with one 16 x 16 block of keys dead for its rows but
    for one entry of -1e30 in its last corner."""
    from lifelong_clip_tpu_torch.ops.attention import causal_mask
    m = causal_mask(t, prefix=p)
    m[32:48, 16:32] = float("-inf")
    m[47, 31] = -1e30
    return m


# (P, T, mask on the CPU): ProtoCLIP's suffix mask on the register road (T
# = 64) and the tiled one (T = 320); the text tower's causal mask with a
# prefix as a 2-D mask on both roads; seeded masks with whole 16 x 16 and 64
# x 64 blocks dead (and, on the tiled road, finite values other than 0,
# read from the mask); a dead block but for one -1e30 entry; a row whose only
# live keys are its class's suffix keys in the last 64-key tile; a row with
# no live key at all
TILE_MAP_CASES = {
    "suffix register road": (7, 64, lambda: _suffix(8, 8, 7)),
    "suffix tiled road": (25, 320, lambda: _suffix(40, 8, 25)),
    "causal register road": (8, 77, None),
    "causal tiled road": (20, 300, None),
    "random 16-blocks": (53, 150, lambda: _random_blocks(150, 53, 16, 0)),
    "random 64-blocks": (25, 320, lambda: _random_blocks(320, 25, 64, 1)),
    "random values, tiled road": (
        25, 320, lambda: _random_blocks(320, 25, 16, 2, values=True)),
    "corner -1e30": (20, 70, lambda: _corner(70, 20)),
    "live only in the last tile": (
        25, 320, lambda: _suffix(40, 8, 25, prefix_dead_row=317)),
    "a row with no live key": (25, 320, lambda: _suffix(40, 8, 25,
                                                        dead_row=37)),
}


@pytest.mark.parametrize("case", list(TILE_MAP_CASES))
def test_prefix_kernels_take_the_suffix_block_diagonal_mask(cuda, case):
    """2-D masks on the KV-prefix kernels, ProtoCLIP's block-diagonal
    suffix mask first (C classes x S tokens as one row, one prompt tensor
    as pk and pv): the map kernel gives ``mask_tile_map_reference``'s bytes
    and ``mask_tile_words_reference``'s words;
    every output and dpk + dpv within ``ops/kernel_check.py``'s tolerances
    of the plain version (a row with no live key: NaN where the plain
    version has NaN, the rest within them); and ctx, dqkv and dkvp bit for
    bit those of the same kernels with a null map (every block swept; NaN
    equal to NaN)."""
    from lifelong_clip_tpu_torch.ops.attention import causal_mask
    p, t, make = TILE_MAP_CASES[case]
    mask = (make() if make else causal_mask(t, prefix=p)).to(cuda)
    assert fba._prefix_mask_arg(mask, t, p + t, cuda)[1] == p + t
    tmap, words = fba.unpack_tile_map(fba.mask_tile_map(mask), t, p + t)
    assert torch.equal(tmap, fba.mask_tile_map_reference(mask))
    assert torch.equal(words, fba.mask_tile_words_reference(mask))
    x, pk, pv, blk, gy, _ = kc.make_prefix_inputs(
        2, t, 128, 2, p, p, 9, device=cuda, shared=True)
    if not bool(torch.isneginf(mask).all(1).any()):
        kc.check_prefix_case(x, pk, pv, blk, gy, mask, 2, False)
    else:
        _check_nan_rows(x, pk, blk, gy, mask)
    skip, full = (kc.prefix_attention_outputs(x, pk, pv, blk, gy, mask, 2,
                                              tile_map=m)
                  for m in (True, False))
    for key in skip:
        assert kc.same_bits(skip[key], full[key]), key


def _check_nan_rows(x, pk, blk, gy, mask):
    """A mask with a row that sees no key: the op's y is NaN on that row as
    the plain version's is, within the tolerances elsewhere, and each grad
    NaN exactly where the plain version's is."""
    xl, pkl = (a.detach().clone().requires_grad_(True) for a in (x, pk))
    ref_args = [blk[k] for k in kc.BLOCK_KEYS]
    y = fba.fused_prefix_attention_block(xl, pkl, pkl, *ref_args, 2, mask,
                                         False)
    y.backward(gy)
    y = y.detach()
    with torch.no_grad():
        y_ref = fba.fused_prefix_attention_block_reference(
            x, pk, pk, *ref_args, 2, mask)
        grads = fba.fused_prefix_attention_block_reference_bwd(
            x, gy, pk, pk, *ref_args[:5], 2, mask, False)
    nan_rows = torch.isnan(y_ref).any(-1)
    assert bool(nan_rows.any()) and torch.equal(torch.isnan(y),
                                                torch.isnan(y_ref))
    ok = ~nan_rows
    kc._held({}, "y", y[ok], y_ref[ok], y_ref[ok].float() - x[ok].float(),
             kc.REL_FWD)
    assert torch.equal(torch.isnan(xl.grad), torch.isnan(grads[0]))
    assert torch.equal(torch.isnan(pkl.grad),
                       torch.isnan(grads[1].float() + grads[2].float()))


@pytest.mark.parametrize("shared,d", [(True, 256), (True, 192),
                                      (False, 256), (False, 192)])
def test_prefix_projections_take_one_launch(cuda, monkeypatch, shared, d):
    """The prefix rows' K and V projections are one GEMM launch: N = 2D for
    one prompt tensor as pk and pv (mvp-clip), a grouped launch for two
    (D = 192: a group's columns end inside a 128-column tile, so the grouped
    launch stores from the accumulators); the forward chain launches three
    GEMMs, and the op holds to its plain version."""
    from lifelong_clip_tpu_torch.ops import _kernels
    x, pk, pv, blk, gy, mask = kc.make_prefix_inputs(2, 77, d, d // 64, 20,
                                                     7, 3, device=cuda,
                                                     shared=shared)
    calls = []
    orig = _kernels.call

    def counting(name, *a):
        calls.append(name)
        return orig(name, *a)

    monkeypatch.setattr(_kernels, "call", counting)
    fba._cuda_prefix_forward(x, pk, pv, *[blk[k] for k in kc.BLOCK_KEYS],
                             d // 64, mask)
    assert calls.count("llc_gemm") == 3, calls
    kc.check_prefix_case(x, pk, pv, blk, gy, mask, d // 64, True)


def test_prefix_backward_is_deterministic(cuda):
    x, pk, pv, blk, _, mask = kc.make_prefix_inputs(4, 197, 192, 3, 20, 5,
                                                    1, device=cuda)
    gy = torch.randn_like(x)
    _, saved = fba._cuda_prefix_forward(
        x, pk, pv, *[blk[k] for k in kc.BLOCK_KEYS], 3, mask, keep=True)
    args = (pk, pv, *[blk[k] for k in kc.BLOCK_KEYS[:5]], 3, mask, True,
            fba._keep_for_prefix_backward(saved, True))
    first = fba._cuda_prefix_backward(x, gy, *args)
    second = fba._cuda_prefix_backward(x, gy, *args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_prefix_op_launches_kernels_and_counts_them(cuda):
    """One tensor as pk and pv (mvp-clip): both grads reach it."""
    x, pk, _, blk, gy, mask = kc.make_prefix_inputs(2, 13, 128, 2, 5, 2, 2,
                                                    device=cuda)
    pk = pk.requires_grad_()
    fba.reset_launches()
    y = fba.fused_prefix_attention_block(
        x, pk, pk, *[blk[k] for k in kc.BLOCK_KEYS], 2, mask, False)
    y.backward(gy)
    assert fba.LAUNCHES["fused_prefix_attention_fwd"] == 1
    assert fba.LAUNCHES["fused_prefix_attention_bwd"] == 1
    assert pk.grad.dtype == torch.bfloat16
    assert float(pk.grad[:, :2].abs().max()) > 0
    assert float(pk.grad[:, 2:].abs().max()) == 0.0


def test_unfused_road_keeps_fp32_on_the_card(cuda):
    """The unfused road's products stay fp32 on the card, as on the CPU and
    in JAX, even with TF32 turned on globally: bf16 operands are upcast,
    whose products are exact in fp32, and TF32 is off for the product."""
    from lifelong_clip_tpu_torch.ops import attention as att
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    q = torch.randn(2, 4, 77, 64, generator=g).to(bf)
    k = torch.randn(2, 4, 97, 64, generator=g).to(bf)
    x = torch.randn(2, 77, 256, generator=g).to(bf)
    params = {"w_qkv": (0.06 * torch.randn(256, 768, generator=g)).to(bf),
              "b_qkv": (0.1 * torch.randn(768, generator=g)).to(bf),
              "w_out": (0.06 * torch.randn(256, 256, generator=g)).to(bf),
              "b_out": (0.1 * torch.randn(256, generator=g)).to(bf)}
    x_kv = torch.cat([torch.randn(2, 20, 256, generator=g).to(bf), x], 1)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        s_card = att.mm32(q.to(cuda), k.to(cuda).transpose(-1, -2)).cpu()
        y_card = att.multi_head_attention(
            x.to(cuda), {n: a.to(cuda) for n, a in params.items()}, 4,
            x_kv=x_kv.to(cuda)).cpu()
        assert torch.backends.cuda.matmul.allow_tf32   # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    s_cpu = att.mm32(q, k.transpose(-1, -2))
    y_cpu = att.multi_head_attention(x, params, 4, x_kv=x_kv)
    assert s_card.dtype == torch.float32
    # fp32 scores: summation order only (64-term sums of exact products)
    torch.testing.assert_close(s_card, s_cpu, rtol=1e-5,
                               atol=1e-5 * float(s_cpu.abs().max()))
    # bf16 output rounded once from fp32: what differs is a flipped rounding
    # of the bf16 q/k/v, p or ctx, whose size follows the terms summed, not
    # the output element; one bf16 ulp at the output's scale
    scale = float(y_cpu.float().abs().max())
    torch.testing.assert_close(y_card.float(), y_cpu.float(), rtol=0,
                               atol=2.0 ** -7 * scale)


# flash attention: (b, t, s, d, heads, mask, dtype). T and S on and off a
# multiple of 64, T != S, S > 256 (no key limit; the bf16 forward's tiled
# road), causal with a prefix, a key-mask row, fp32 and bf16
FLASH_CASES = [(2, 13, 20, 128, 2, None, "bf16"),
               (2, 197, 217, 128, 2, 5, "bf16"),
               (3, 77, 77, 256, 4, "causal", "bf16"),
               (2, 257, 257, 128, 2, None, "bf16"),
               (2, 77, 700, 128, 2, "causal", "bf16"),
               (2, 70, 300, 128, 2, 9, "bf16"),
               (2, 70, 300, 64, 1, 9, "f32"),
               (1, 64, 64, 128, 2, "causal", "f32")]


@pytest.mark.parametrize("b,t,s,d,heads,mask,dtype", FLASH_CASES)
def test_flash_kernels_match_plain_versions(cuda, b, t, s, d, heads, mask,
                                            dtype):
    """o, dq, dk, dv through the op's autograd Function, with the tolerance
    stated in ``ops/kernel_check.py``; dead keys' dk and dv exactly 0."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    kc.check_flash_case(*kc.make_flash_inputs(b, t, s, d, heads, 0, mask,
                                              dt, device=cuda), heads)


def test_flash_backward_is_deterministic(cuda):
    """No atomics: two backward passes agree bit for bit."""
    from lifelong_clip_tpu_torch.ops import flash_attention as fa
    q, k, v, gy, mask = kc.make_flash_inputs(4, 197, 217, 768, 12, 1, 5,
                                             device=cuda)
    first = fa._cuda_backward(q, k, v, gy, 12, mask)
    second = fa._cuda_backward(q, k, v, gy, 12, mask)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_op_launches_kernels_and_raises(cuda):
    """Each op call on the card launches its kernel once; a head dim other
    than 64 and mixed dtypes raise, with no plain fallback."""
    from lifelong_clip_tpu_torch.ops import flash_attention as fa
    q, k, v, gy, _ = kc.make_flash_inputs(2, 13, 20, 128, 2, 2, device=cuda)
    q = q.requires_grad_()
    fa.reset_launches()
    fa.flash_attention(q, k, v, 2).backward(gy)
    assert fa.LAUNCHES == {"flash_attention_fwd": 1,
                           "flash_attention_bwd": 1}
    with pytest.raises(ValueError, match="head dim 64"):
        fa.flash_attention(q, k, v, 4)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.float(), v, 2)


def test_flash_prompted_lora_width_dead_keys(cuda):
    """The prompted-LoRA block's widths (12 heads of 64, T = 197, S = 217)
    with a key row of 5 live prompt slots: o, dq, dk, dv within the flash
    tolerance, and the 15 dead keys' dk and dv exactly 0."""
    kc.check_flash_case(*kc.make_flash_inputs(3, 197, 217, 768, 12, 2, 5,
                                              device=cuda), 12)


# the port's GEMM (``llc_gemm`` through ``ops/fused_block_attn.py:_gemm``):
# (layout, out dtype, M, N, K, epilogue terms, splits). NN with
# N-contiguous B (the qkv and out projections), NT with K-contiguous B
# (dctx, dh), TN with M-contiguous A (the weight grads, split over K);
# M = 12608 (ViT-B/16 at bs 64) and ragged M, N and K; bf16 output takes
# the 128 x 128 wgmma tile with the epilogue staged in shared memory, fp32
# output 128 x 256 at N = 2304 and 128 x 128 below.
GEMM_CASES = [
    ("NN", "bf16", 12608, 2304, 768, "bias,lora", 1),
    ("NN", "bf16", 12608, 2304, 768, "bias", 1),
    ("NN", "bf16", 12608, 768, 768, "bias,lora,resid", 1),
    ("NT", "f32", 12608, 768, 2304, "lora", 1),
    ("NT", "bf16", 1000, 768, 768, "lora,resid", 1),
    ("TN", "f32", 768, 768, 12608, "", -1),
    ("TN", "f32", 760, 2304, 1000, "resid", 1),
    ("NN", "f32", 1000, 328, 520, "alpha", 1),
    # 16 batch rows (M = 3152, 150 tiles of 128 x 128): the out and dctx
    # products, and dh, which takes 128 x 64 tiles (fp32 out, K = 2304)
    ("NN", "bf16", 3152, 768, 768, "bias,resid", 1),
    ("NT", "bf16", 3152, 768, 768, "lora", 1),
    ("NT", "f32", 3152, 768, 2304, "lora", 1),
]


@pytest.mark.parametrize("layout,out_dt,m,n,k,terms,splits", GEMM_CASES)
def test_gemm_matches_fp32_matmul(cuda, layout, out_dt, m, n, k, terms,
                                  splits):
    """out = alpha * A @ B + bias + s * z @ L, then + residual, rounded once,
    against an fp32 ``torch.matmul`` of the same bf16 operands: within 1e-2
    of the output's max beyond one bf16 ulp (fp32 sums in another order).
    Each epilogue term is drawn at the product's scale (sqrt(K)) and
    asserted to be >= ``kc.MARGIN`` x (tolerance + one typical ulp), so a
    wrong or missing term fails the check."""
    bf = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    scale = k ** 0.5   # the std of an element of A @ B

    def rnd(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=g, device=cuda)).to(bf)

    a, b = rnd(m, k), rnd(k, n)
    # the layouts as the callers store them: (storage, (stride m|k, stride k|n))
    a_arg = (a.t().contiguous(), (1, m)) if layout == "TN" else (a, (k, 1))
    b_arg = (b.t().contiguous(), (1, k)) if layout == "NT" else (b, (n, 1))
    odt = bf if out_dt == "bf16" else torch.float32
    kw = {"splits": splits}
    want = a.float() @ b.float()
    parts = {}
    if "alpha" in terms:
        kw["alpha"] = 0.5
        want = 0.5 * want
    if "bias" in terms:
        kw["bias"] = scale * torch.randn(n, generator=g, device=cuda)
        parts["bias"] = kw["bias"]
    if "lora" in terms:
        z, lb = rnd(m, 4), rnd(4, n)
        # rank 4: z @ L has std 2, so lscale = scale / 2 gives it std scale
        kw.update(lz=(z, 4, 1), lb=(lb, n, 1), lscale=scale / 2)
        parts["lora"] = scale / 2 * (z.float() @ lb.float())
    if "resid" in terms:
        kw["resid"] = rnd(m, n, std=scale).to(odt)
        parts["resid"] = kw["resid"].float()
    for term in parts.values():
        want = want + term
    out = torch.empty(m, n, dtype=odt, device=cuda)
    fba._gemm(out, *a_arg, *b_arg, m, n, k, **kw)
    torch.cuda.synchronize()
    got = out.float()
    tol = 1e-2 * float(want.abs().max())
    floor = kc.MARGIN * (tol + kc.ULP * float(want.square().mean().sqrt()))
    for name, term in parts.items():
        assert float(term.abs().max()) >= floor, (name, floor)
    excess = ((got - want).abs()
              - kc.ULP * torch.maximum(got.abs(), want.abs())).clamp(min=0)
    assert float(excess.max()) <= tol, (float(excess.max()), tol)


def test_gemm_refuses_strides_tma_cannot_read(cuda):
    """K = 100 puts the rows of A 200 bytes apart, which TMA cannot read:
    the launcher raises (no caller has such strides) rather than falling
    back to another tile; the rank-r shapes (N <= 16) still take them."""
    bf = torch.bfloat16
    a = torch.randn(1000, 100, device=cuda).to(bf)
    b = torch.randn(100, 256, device=cuda).to(bf)
    out = torch.empty(1000, 256, dtype=bf, device=cuda)
    with pytest.raises(RuntimeError, match="llc_gemm failed"):
        fba._gemm(out, a, (100, 1), b, (256, 1), 1000, 256, 100)
    small = torch.empty(1000, 4, dtype=torch.float32, device=cuda)
    fba._gemm(small, a, (100, 1), b, (256, 1), 1000, 4, 100)
    torch.cuda.synchronize()
    want = a.float() @ b[:, :4].float()
    torch.testing.assert_close(small, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_gemm_split_k_is_deterministic(cuda):
    """A contraction over all rows split over K: fp32 partials summed in a
    fixed order, so two runs agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(12608, 768, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(12608, 2304, generator=g, device=cuda).to(torch.bfloat16)
    outs = [fba._gemm(torch.empty(768, 2304, device=cuda), a, (1, 768), b,
                      (2304, 1), 768, 2304, 12608, splits=-1)
            for _ in range(2)]
    assert torch.equal(*outs)
