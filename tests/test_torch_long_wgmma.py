"""The long road of #1/#2's warpgroup-MMA attention (``csrc/attn_wgmma.cu``'s
``attn_fwd_wgmma_long_kernel`` and ``attn_bwd_wgmma_long_kernel``): which
rows take it (``ops/fused_block_attn.py:attention_road``, the source's
``attn_wgmma_long_road``), a model of the kernels' shared memory, the width
of the last key tile's products, and the attention's own bound at
ViT-L/14's shape.

With no mask at head dim 64 the block's attention takes the half-row
kernels up to 256 keys, the long kernels past them up to
``WGMMA_LONG_TMAX`` (ViT-L/14's 257 tokens), and the mma.sync tiled
kernels past that; a mask, a KV prefix and head dims 16, 32 and 128 keep
the mma.sync kernels. The long backward holds Q, K, V and dctx whole in
shared memory, which sets ``WGMMA_LONG_TMAX``. The kernels run only on the
card (``tests/test_torch_cuda_kernels.py -k long_wgmma``). No JAX here.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import importlib.util
import os
import re

import pytest

from lifelong_clip_tpu_torch.ops import fused_block_attn as fba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lifelong_clip_tpu_torch", "csrc")
TILE = 64                    # rows of a TMA box and of a wgmma tile
BOX = TILE * 64 * 2          # one box of 64 bf16 columns: 8 KB
SMEM_MAX = 227 * 1024        # the H100's shared memory a block may opt into
SM_SMEM = 228 * 1024         # an SM's shared memory, 1 KB of it per block kept
TMAX = fba.WGMMA_LONG_TMAX


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _smem(fn, nt):
    """The byte count ``attn_wgmma.cu``'s ``fn`` returns for ``nt`` tiles,
    its expression evaluated with the source's constants."""
    body = re.search(r"static size_t %s\(int nt\) \{\s*return (.*?);" % fn,
                     _source("attn_wgmma.cu"), re.S).group(1)
    expr = (body.replace("(size_t)", "").replace("sizeof(float4)", "16")
            .replace("WA_BOX", str(BOX)).replace("WA_TILE", str(TILE)))
    return eval(" ".join(expr.split()), {"nt": nt})   # noqa: S307


def _tiles(t):
    return -(-t // TILE)


def _lastn(t):
    """``attn_wgmma.cu:wl_lastn``: the live keys of the last 64-key tile,
    rounded up to 16."""
    return -(-(t - (t - 1) // TILE * TILE) // 16) * 16


ROADS = [(256, 64, None, "wgmma"), (257, 64, None, "wgmma_long"),
         (TMAX, 64, None, "wgmma_long"), (TMAX + 1, 64, None, "mma_sync"),
         (512, 64, None, "mma_sync"), (1, 64, None, "wgmma"),
         (257, 64, "matrix", "mma_sync"), (256, 64, "matrix", "mma_sync")]
ROADS += [(t, dh, kind, "mma_sync") for dh in (16, 32, 128)
          for t in (256, 257, TMAX, TMAX + 1) for kind in (None, "matrix")]


@pytest.mark.parametrize("t,dh,kind,road", ROADS)
def test_road_predicate(t, dh, kind, road):
    """The kernels a (T, head dim, mask) row takes, by
    ``attention_road``."""
    assert fba.attention_road(t, dh, kind) == road


def test_predicate_matches_the_source():
    """The Python bound is the source's ``ATTN_WGMMA_LONG_TMAX``, and the
    long road starts where ``attn_wgmma_road`` stops (256 keys)."""
    src = _source("hopper.cuh")
    tmax = int(re.search(r"constexpr int ATTN_WGMMA_LONG_TMAX = (\d+);",
                         src).group(1))
    assert tmax == TMAX
    assert "S <= 256" in src and "T > 256 && T <= ATTN_WGMMA_LONG_TMAX" in src
    assert fba.WGMMA_TMAX == 256


@pytest.mark.parametrize("p,t", [(1, 256), (20, 237), (20, 257), (56, 257)])
def test_prefix_rows_past_256_keys_keep_the_mma_sync_kernels(p, t):
    """The long road has no prefix instance: a KV prefix past 256 keys
    under a key row keeps the mma.sync kernels; up to 256 the prefix
    road."""
    assert fba.prefix_wgmma_road(p, t, 64, "row") is (p + t <= 256)


def test_shared_memory_fits_every_long_row():
    """For every T on the road the backward (Q, K, V, dctx whole, the row
    statistics, 1 + 2 ceil(T/64) barriers) fits the 227 KB a block may
    hold, and the forward (two query tiles, K and V whole) too: two blocks
    an SM up to 320 keys (five tiles), one from 321 (six); one more tile
    would not fit the backward, so ``WGMMA_LONG_TMAX`` is 384."""
    per_sm = {}
    for t in range(257, TMAX + 1):
        nt = _tiles(t)
        fwd, bwd = _smem("wl_fwd_smem", nt), _smem("wl_bwd_smem", nt)
        assert bwd <= SMEM_MAX and fwd <= SMEM_MAX, (t, fwd, bwd)
        per_sm[t] = SM_SMEM // (fwd + 1024)
    assert {t: n for t, n in per_sm.items() if t <= 320} == \
        {t: 2 for t in range(257, 321)}
    assert set(n for t, n in per_sm.items() if t > 320) == {1}
    assert _smem("wl_bwd_smem", _tiles(TMAX) + 1) > SMEM_MAX
    assert _smem("wl_bwd_smem", 6) == 4 * 6 * BOX + 6 * 64 * 16 + 13 * 8 + 1024


@pytest.mark.parametrize("t,lastn", [(257, 16), (271, 16), (272, 16),
                                     (273, 32), (300, 48), (319, 64),
                                     (320, 64), (321, 16), (384, 64)])
def test_last_tile_width(t, lastn):
    """The last key tile's products cover its live keys in whole 16-key
    chunks, as the tiled road skips the chunks at or past S - k0: at T =
    257 one chunk (an m64n16 product)."""
    assert _lastn(t) == lastn
    live = t - (_tiles(t) - 1) * TILE
    assert lastn - 16 < live <= lastn <= TILE


def test_attention_bound_at_vit_l14():
    """``chip_smoke.attention_cost`` at ViT-L/14's vision block (64 x 257 x
    1024, 16 heads of 64), by hand: the forward reads q, k, v and writes
    ctx (4 x 16448 rows x 1024 x 2 B, 135 MB, 0.0402 ms at 3.35 TB/s), the
    backward reads q, k, v and dctx and writes dq, dk and dv (7 x ...,
    236 MB, 0.0704 ms); both bound by bytes (2 and 5 products, 4.3 and
    10.8 GFLOP)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    b, t, d, heads = 64, 257, 1024, 16
    rows = b * t
    fl, by = cs.attention_cost(b, t, d, heads, False)
    assert fl == 2 * 2 * b * heads * t * t * 64
    assert by == 4 * rows * d * 2 == 134_742_016
    ms, bound = cs.bound_ms(fl, by)
    assert bound == "bytes" and round(ms, 4) == 0.0402
    fl, by = cs.attention_cost(b, t, d, heads, True)
    assert fl == 5 * 2 * b * heads * t * t * 64
    assert by == 7 * rows * d * 2 == 235_798_528
    ms, bound = cs.bound_ms(fl, by)
    assert bound == "bytes" and round(ms, 4) == 0.0704
