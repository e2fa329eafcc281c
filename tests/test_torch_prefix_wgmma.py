"""The KV-prefix attention of #3/#4 on warpgroup MMA
(``csrc/attn_wgmma.cu``'s ``PRE`` instances): which chains take it
(``ops/fused_block_attn.py:prefix_wgmma_road``), and a model of the key
buffer those kernels fill.

The kernels read key j from row j of their K and V buffers, as the mma.sync
kernels' ``load_kv`` puts it: rows 0..P-1 the prefix keys, then the tokens.
A TMA box must start on the 128B swizzle's 8-row atom, and token 0 sits at
row P, so the threads copy the first R0 = 8 ceil(P/8) rows themselves (the
prefix keys and the first R0 - P tokens), TMA brings the whole 64-token
boxes that fit the buffers from token R0 - P onto row R0, and the threads
copy the rest (the last tokens, then zeros to the buffers' end). The
buffers are the road's with no prefix, 64 ceil(2 wa_win(S) / 64) rows. The
model below repeats that layout and checks, for every P in 1..40 and
every T up to 256 - P, that each row is written once, each key lands in
its row, in order, and the two half-row windows (``wa_win(S)`` keys from
rows 0 and 16 h0) cover the halves the mma.sync kernels sum, h0 = ceil(n
/ 2) of the n = ceil(S / 16) 16-key blocks. The kernels themselves run
only on the card (``tests/test_torch_cuda_kernels.py -k prefix_wgmma``).
No JAX here: the layout has no counterpart in the JAX package.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
from lifelong_clip_tpu_torch.ops import kernel_check as kc

TILE = 64                    # rows of a TMA box and of a wgmma tile
BOX = TILE * 64 * 2          # one box of 64 bf16 columns: 8 KB
SMEM_MAX = 227 * 1024        # the H100's shared memory a block may opt into


def wa_win(s):
    """Keys a half row's window spans (``attn_wgmma.cu:wa_win``)."""
    return 64 if s <= 128 else (112 if s <= 224 else 128)


def wa_tiles(win):
    """64-row tiles the windows span (``attn_wgmma.cu:wa_tiles``)."""
    return (2 * win + TILE - 1) // TILE


def smem_bytes(win, pre):
    """``wa_fwd_smem`` and ``wa_bwd_smem``: the forward's query tile, K and
    V; the backward's Q, K, V, dctx, statistics, exchange, dq partials;
    barriers; with a prefix the key row."""
    nt = wa_tiles(win)
    row = 256 * 4 if pre else 0
    fwd = BOX * (1 + 2 * nt) + 2 * 8 + row + 1024
    bwd = (4 * nt * BOX + nt * TILE * 16 + 3 * 2 * TILE * 4 + 32 * 128 * 4
           + (1 + nt) * 8 + row + 1024)
    return fwd, bwd


def key_buffer(p, t):
    """The K (or V) buffer of the prefix kernels for P prefix keys and T
    tokens: for each row the key it holds (0..S-1, -1 for zeros) and how
    many writers touched it (the threads or a TMA box)."""
    s = p + t
    rows = TILE * wa_tiles(wa_win(s))
    key = np.full(rows, -2)
    writes = np.zeros(rows, int)
    r0 = (p + 7) // 8 * 8
    tok0 = r0 - p
    # TMA (wa_boxes): box b of 64 tokens from token tok0 + 64 b onto row R0
    # + 64 b, on the 8-row atom, as many as end inside the buffer; tokens
    # past T read as zeros
    boxes = min(-(-(t - tok0) // TILE) if t > tok0 else 0,
                (rows - r0) // TILE)
    for b in range(boxes):
        start = r0 + TILE * b
        assert start % 8 == 0 and start + TILE <= rows, (p, t, b)
        tok = tok0 + TILE * b + np.arange(TILE)
        key[start:start + TILE] = np.where(tok < t, p + tok, -1)
        writes[start:start + TILE] += 1
    # the threads (wa_prefix_rows): rows [0, R0) and [TB, end), each the
    # prefix key, the token or zero its row holds
    tb = r0 + TILE * boxes
    own = np.concatenate([np.arange(r0), np.arange(tb, rows)])
    key[own] = np.where(own < s, own, -1)
    writes[own] += 1
    return key, writes


@pytest.mark.parametrize("p", range(1, 41))
def test_every_key_lands_once_in_its_row(p):
    for t in range(1, 257 - p):
        s = p + t
        key, writes = key_buffer(p, t)
        assert (writes == 1).all(), (p, t)
        # key j in row j (load_kv's row), zeros past S
        assert (key[:s] == np.arange(s)).all(), (p, t)
        assert (key[s:] == -1).all(), (p, t)
        # the halves: the mma.sync kernels' warps take the first h0 of the
        # n 16-key blocks and the rest; the wgmma windows start at rows 0
        # and 16 h0 (on the atom), span wa_win(S) keys and cover them
        n = -(-s // 16)
        h0 = (n + 1) // 2
        kb1, win = 16 * h0, wa_win(s)
        assert kb1 % 8 == 0
        assert 16 * h0 <= win and 16 * n - kb1 <= win, (p, t)
        assert kb1 + win <= len(key), (p, t)
        assert fba.prefix_wgmma_road(p, t, 64, "row")


@pytest.mark.parametrize("win", [64, 112, 128])
def test_buffers_fit_the_card(win):
    """Both kernels' shared memory, with and without a prefix, within what
    a block may take; the forward keeps its three blocks an SM with a
    prefix (228 KB an SM, 1 KB of it reserved a block)."""
    for pre in (False, True):
        fwd, bwd = smem_bytes(win, pre)
        assert bwd <= SMEM_MAX and 3 * (fwd + 1024) <= 228 * 1024, (win, pre)


# (P, T, head dim, mask kind, takes the warpgroup-MMA kernels): mvp-clip's
# and DualPrompt's / MVP's prompted block (P = 20), ProtoCLIP's K2 (P = 4),
# the widest S = 256 and one key past it, S = 512 (P = 315), head dims 32
# and 16, a 2-D mask (ProtoCLIP's suffix K4 and its main shape, the text
# prompts' causal-prefix mask), and no mask
ROAD = [(20, 197, 64, "row", True), (4, 197, 64, "row", True),
        (56, 200, 64, "row", True), (1, 1, 64, "row", True),
        (57, 200, 64, "row", False), (315, 197, 64, "row", False),
        (20, 197, 32, "row", False), (20, 197, 16, "row", False),
        (25, 512, 64, "matrix", False), (25, 160, 64, "matrix", False),
        (20, 77, 64, "matrix", False), (20, 197, 64, None, False)]


@pytest.mark.parametrize("p,t,dh,kind,takes", ROAD)
def test_road(p, t, dh, kind, takes):
    assert fba.prefix_wgmma_road(p, t, dh, kind) is takes
    # the op reads the kind off its prepared mask: a row (stride 0), a
    # (T, P + T) matrix (stride P + T), or none
    heads = 4
    mask = {None: None, "row": torch.zeros(p + t),
            "matrix": torch.zeros(t, p + t)}[kind]
    m, rs = fba._prefix_mask_arg(mask, t, p + t, "cpu")
    pp = SimpleNamespace(p=p, t=t, d=dh * heads, mask=m, mask_rs=rs)
    assert fba._prefix_road(pp, heads) is takes


def test_the_cpu_launches_no_kernel():
    """On the CPU the op runs its plain version: no launch is counted."""
    x, pk, pv, blk, gy, mask = kc.make_prefix_inputs(2, 13, 128, 2, 5, 2, 0,
                                                     device="cpu")
    fba.reset_launches()
    y = fba.fused_prefix_attention_block(
        x, pk, pv, *[blk[k] for k in kc.BLOCK_KEYS], 2, mask, False)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert fba.LAUNCHES["attn_prefix_fwd_wgmma"] == 0
    assert fba.LAUNCHES["attn_prefix_bwd_wgmma"] == 0
