"""The tile map of a 2-D attention mask (``ops/fused_block_attn.py:
mask_tile_map_reference`` and ``mask_tile_words_reference``, the plain
versions of the card's ``mask_tile_map_kernel``) against a numpy brute
force over every block.

The KV-prefix kernels skip the 16 x 16 blocks the map marks dead, so a block
must be dead only where every entry is -inf (any finite entry, however
negative, keeps it) and none of its rows is a row with no live key at all;
they take a live block's entries from its bit words only where every entry
is +0.0 or -inf. No JAX here: the map has no counterpart in the JAX
package.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import numpy as np
import pytest
import torch

from lifelong_clip_tpu_torch.models.proto_clip import suffix_mask
from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
from lifelong_clip_tpu_torch.ops.attention import causal_mask


def brute_force(mask: np.ndarray, tq: int = 16, tk: int = 16) -> np.ndarray:
    """Block (r, c) is live if any entry of it is not -inf, or if any of its
    rows has no entry that is not -inf; a live block is 2 where each entry
    is -inf or +0.0, else 1."""
    t, s = mask.shape
    live = ~np.isneginf(mask)
    no_key = ~live.any(1)
    out = np.zeros((-(-t // tq), -(-s // tk)), np.uint8)
    for r in range(out.shape[0]):
        rows = slice(r * tq, min((r + 1) * tq, t))
        for c in range(out.shape[1]):
            cols = slice(c * tk, min((c + 1) * tk, s))
            if live[rows, cols].any() or no_key[rows].any():
                blk = mask[rows, cols]
                plain = np.isneginf(blk) | ((blk == 0) & ~np.signbit(blk))
                out[r, c] = 2 if plain.all() else 1
    return out


def brute_words(mask: np.ndarray) -> np.ndarray:
    """Word w of block (r, c): bit i of its low half is key 16c + i of row
    16r + w not -inf, its high half the same of row 16r + w + 8; rows past T
    all ones, keys past S zero."""
    t, s = mask.shape
    nr, nc = -(-t // 16), -(-s // 16)
    bits = np.zeros((nr * 16, nc * 16), np.uint64)
    bits[:t, :s] = ~np.isneginf(mask)
    bits[t:] = 1
    out = np.zeros((nr, nc, 8), np.uint64)
    for w in range(8):
        for half, row in ((0, w), (1, w + 8)):
            rows = bits[row::16]                 # row 16r + row of block r
            for i in range(16):                  # key 16c + i of block c
                out[:, :, w] |= rows[:, i::16] << np.uint64(16 * half + i)
    return out.astype(np.uint32).view(np.int32)


def random_mask(t, s, seed, block, dead_share=0.6):
    """Seeded 0 / -inf entries with whole ``block`` x ``block`` squares
    dead."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((t, s)) < 0.3, -np.inf, 0.0)
    for r in range(0, t, block):
        for c in range(0, s, block):
            if rng.random() < dead_share:
                m[r:r + block, c:c + block] = -np.inf
    return m.astype(np.float32)


def corner_mask(t, s):
    """One 16 x 16 block dead but for one finite entry of -1e30 in its last
    corner; the rest of its rows live elsewhere."""
    m = np.full((t, s), -np.inf, np.float32)
    m[:, :8] = 0.0
    m[16:32, 16:32] = -np.inf
    m[31, 31] = -1e30
    return m


def masks():
    yield "suffix 8 x 8, lp 7", suffix_mask(8, 8, 7).numpy()
    yield "suffix 40 x 8, lp 25", suffix_mask(40, 8, 25).numpy()
    yield "suffix 64 x 8, lp 25", suffix_mask(64, 8, 25).numpy()
    yield "causal 77, prefix 8", causal_mask(77, prefix=8).numpy()
    yield "causal 300, prefix 20", causal_mask(300, prefix=20).numpy()
    yield "random 16-blocks", random_mask(150, 203, 0, 16)
    yield "random 64-blocks", random_mask(320, 345, 1, 64)
    yield "corner -1e30", corner_mask(70, 90)
    m = random_mask(100, 120, 2, 16)
    m[20:40, 30:50] = np.where(np.isneginf(m[20:40, 30:50]), -np.inf, -0.5)
    m[60, 3] = -0.0                # -0.0: not +0.0, so read from the mask
    yield "finite values and -0.0", m
    m = suffix_mask(40, 8, 25).numpy()
    m[37] = -np.inf                # a row with no live key at all
    yield "suffix with a dead row", m
    m = suffix_mask(40, 8, 25).numpy()
    m[5, :25] = -np.inf            # row 5 sees its own class's keys only
    yield "a row live only in its last tile", m


CASES = list(masks())


@pytest.mark.parametrize("name,mask", CASES, ids=[c[0] for c in CASES])
def test_tile_map_reference_matches_brute_force(name, mask):
    m = torch.from_numpy(mask)
    got = fba.mask_tile_map_reference(m)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), brute_force(mask), err_msg=name)
    words = fba.mask_tile_words_reference(m)
    np.testing.assert_array_equal(words.numpy(), brute_words(mask),
                                  err_msg=name)
    # the CPU wrapper packs the plain versions as the kernel's buffer
    tmap, wbuf = fba.unpack_tile_map(fba.mask_tile_map(m), *mask.shape)
    assert torch.equal(tmap, got) and torch.equal(wbuf, words)
    assert fba.LAUNCHES["prefix_tile_map"] == 0


def test_finite_entry_keeps_its_block_and_dead_row_keeps_its_row():
    tm = fba.mask_tile_map_reference(torch.from_numpy(corner_mask(70, 90)))
    assert tm[1, 1] == 1          # the -1e30 corner entry: read the mask
    assert tm[2, 1] == 0          # the same keys, rows 32-47: dead
    assert tm[1, 0] == 2          # +0.0 and -inf only: from the words
    m = suffix_mask(40, 8, 25).numpy()
    dead = fba.mask_tile_map_reference(torch.from_numpy(m))
    m[37] = -np.inf
    tm = fba.mask_tile_map_reference(torch.from_numpy(m))
    assert bool((tm[2] > 0).all()) and not bool((dead[2] > 0).all())
    assert torch.equal(tm[:2], dead[:2]) and torch.equal(tm[3:], dead[3:])


def test_suffix_mask_tiles_are_mostly_dead():
    """ProtoCLIP's suffix mask at 64 class slots: each 64-query tile has at
    most 3 of the 9 64-key tiles live, each 16-row block 4 of 34 16-key
    blocks (3 for the first)."""
    tm = fba.mask_tile_map_reference(suffix_mask(64, 8, 25))
    assert tuple(tm.shape) == (32, 34)
    assert (tm > 0).sum(1).tolist() == [3] + [4] * 31
    assert set(tm.unique().tolist()) == {0, 2}   # every live block plain
    for q in range(8):
        tiles = tm[4 * q:4 * q + 4].view(4, -1)
        live = [k for k in range(9) if bool(tiles[:, 4 * k:4 * k + 4].any())]
        assert len(live) <= 3 and live[0] == 0, (q, live)
