"""The port's AutoAugment, RandAugment, Cutout, CutMix and train pipeline
against the JAX package's on the same numpy inputs, fed the draws JAX makes
from its key; and the port's own draws by their distribution.

Tolerances: ops whose arithmetic is integer or a select (invert, posterize,
solarize, equalize, identity, brightness, integer translations) agree
exactly; the rest within 1e-5 (fp32 sums in another order: the warps' taps,
the gray dot products, the smoothing adds). Composed augmentations are held
stage by stage from the same input; end to end, a quantizing op (posterize,
equalize, solarize) after a warp or a colour op can round one level the
other way where the two fp32 values straddle a rounding boundary, so there
a bounded share of elements may differ by at most a few levels.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_clip_tpu.ops import autoaugment as ja
from lifelong_clip_tpu.ops import preprocess as jpre
from lifelong_clip_tpu_torch.ops import autoaugment as ta
from lifelong_clip_tpu_torch.ops import preprocess as tpre

SIZES = (32, 72)          # both sides of JAX's 64 px warp / equalize guards
EXACT = {"Invert", "Posterize", "Solarize", "Equalize", "Identity",
         "Brightness", "AutoContrast"}
LEVEL = 1.0 / 255.0
B = 8     # one batch size throughout: JAX compiles each shape once


def _images(b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s, s, 3)) / 255.0).astype(np.float32)


def _mags(name):
    """Two magnitudes an op runs at, signs applied."""
    kind = ja._OPS[name][2]
    if kind is True:
        return (0.23, -0.3) if name != "Rotate" else (17.0, -29.0)
    if kind == "enh":
        return (1.7, 0.4)
    return {"Posterize": (4.0, 6.0), "Solarize": (0.4, 0.75)}.get(name,
                                                                 (0.0,))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("name", ja._OP_NAMES)
def test_op_matches_jax(name, s):
    """Each op of the table at fixed magnitudes against JAX's single-image
    op, vmapped over the batch."""
    x = _images(B, s, 0)
    for mag in _mags(name):
        want = np.asarray(jax.vmap(lambda im: ja._OPS[name][0](
            im, jnp.float32(mag)))(jnp.asarray(x)))
        got = ta._OPS[name][0](torch.tensor(x), mag).numpy()
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("s", SIZES)
def test_batched_warp_and_equalize_match_jax(s):
    """The port's one warp and one equalize against JAX's batched road on
    each side of its guard (hat-tensor einsums and one-hot histograms at
    32 px, gathers and per-sample equalize at 72 px); integer translations
    and equalize exactly."""
    x = _images(B, s, 1)
    mats = ta._affine_mats(["ShearX", "ShearY", "Rotate", "TranslateX",
                            "TranslateY"] * 2, [0.3, -0.25, 17.0, 0.25, -0.2,
                                                -0.3, 0.25, -29.0, -0.1, 0.4],
                           s, s)[:B]
    want = np.asarray(ja._batched_warp(jnp.asarray(x), jnp.asarray(mats)))
    got = ta.warp(torch.tensor(x), mats).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # whole-pixel shifts: every tap weight is 0 or 1
    ints = ta._center_mats(np.ones(2), np.zeros(2), np.zeros(2), np.ones(2),
                           [3.0, -5.0], [-2.0, 4.0], s, s)
    np.testing.assert_array_equal(
        ta.warp(torch.tensor(x[:2]), ints).numpy(),
        np.asarray(ja._batched_warp(jnp.asarray(x[:2]), jnp.asarray(ints))))
    np.testing.assert_array_equal(
        ta.equalize(torch.tensor(x)).numpy(),
        np.asarray(ja._batched_equalize(jnp.asarray(x))))


def _jax_aa_draws(key, b, policy):
    """The draws ``auto_augment_batch_fast`` makes from ``key``."""
    _, prob, _ = ja._policy_arrays(policy)
    k_pick, k_g1, k_g2, k_s1, k_s2 = jax.random.split(key, 5)
    pick = jax.random.randint(k_pick, (b,), 0, prob.shape[0])
    gates = [jax.random.bernoulli(kg, jnp.asarray(prob)[pick, j])
             for j, kg in enumerate((k_g1, k_g2))]
    signs = [jnp.where(jax.random.bernoulli(ks, 0.5, (b,)), 1.0, -1.0)
             for ks in (k_s1, k_s2)]
    return (np.asarray(pick), np.stack([np.asarray(g) for g in gates]),
            np.stack([np.asarray(v) for v in signs]))


def _jax_mag(oi, mag, sign):
    """JAX ``auto_augment_batch_fast``'s signed magnitudes."""
    signed = jnp.asarray([ja._OP_NAMES.index(n) for n in ta._AFFINE])
    enh = jnp.asarray([ja._OP_NAMES.index(n) for n in
                       ("Brightness", "Color", "Contrast", "Sharpness")])
    mg = jnp.where(jnp.isin(oi, signed), mag * sign, mag)
    return jnp.where(jnp.isin(oi, enh), 1.0 + (mag - 1.0) * sign, mg)


def _assert_close_end_to_end(got, want, share, levels):
    """Within 1e-5 except where a level rounded the other way upstream of a
    quantizing op: at most ``share`` of the elements, each within
    ``levels`` levels (see the module docstring)."""
    diff = np.abs(got - want)
    off = diff > 1e-5
    assert off.mean() <= share, off.mean()
    assert diff.max() <= levels * LEVEL + 1e-5, diff.max()


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("policy", sorted(ta.POLICIES))
def test_auto_augment_matches_jax_on_its_draws(policy, s):
    """``auto_augment_fast`` at the draws JAX makes from its key: each of
    the two ``_apply_stage_batched`` stages against JAX's on the same input
    within 1e-5; the whole policy against ``auto_augment_batch_fast``; the
    per-sample plain version against the batched road."""
    b = B
    x = _images(b, s, 2)
    key = jax.random.PRNGKey(3)
    pick, gates, signs = _jax_aa_draws(key, b, policy)
    op_idx, _, mag = ja._policy_arrays(policy)
    used = frozenset(n for st in ja.POLICIES[policy] for n, _, _ in st)
    stage_in = x
    for j in range(2):
        oi = jnp.asarray(op_idx)[pick, j]
        mg = _jax_mag(oi, jnp.asarray(mag)[pick, j], jnp.asarray(signs[j]))
        want = np.asarray(ja._apply_stage_batched(
            jnp.asarray(stage_in), oi, mg, jnp.asarray(gates[j]),
            used_ops=used))
        got = ta._apply_stage_batched(torch.tensor(stage_in), np.asarray(oi),
                                      np.asarray(mg), gates[j]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=f"stage {j}")
        stage_in = want
    want = np.asarray(ja.auto_augment_batch_fast(key, jnp.asarray(x), policy))
    got = ta.auto_augment_fast(torch.tensor(x), policy, pick, gates, signs)
    _assert_close_end_to_end(got.numpy(), want, share=0.01, levels=16)
    plain = ta.auto_augment_per_sample(torch.tensor(x), policy, pick, gates,
                                       signs)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=0,
                               atol=1e-6)


def _jax_ra_draws(key, b, num_ops=2):
    keys = jax.random.split(key, 2 * num_ops)
    picks = [jax.random.randint(keys[2 * i], (b,), 0, len(ja._RA_OPS))
             for i in range(num_ops)]
    signs = [jnp.where(jax.random.bernoulli(keys[2 * i + 1], 0.5, (b,)),
                       1.0, -1.0) for i in range(num_ops)]
    return (np.stack([np.asarray(p) for p in picks]),
            np.stack([np.asarray(v) for v in signs]))


@pytest.mark.parametrize("s", SIZES)
def test_rand_augment_matches_jax_on_its_draws(s):
    """``rand_augment`` at JAX's draws: each stage from the same input
    within 1e-5, the whole against ``rand_augment_batch``."""
    b = B
    x = _images(b, s, 4)
    key = jax.random.PRNGKey(5)
    picks, signs = _jax_ra_draws(key, b)
    ra_idx = np.array([ja._OP_NAMES.index(n) for n in ja._RA_OPS])
    mags = np.array([float(ja._OPS[n][1](9.0)) for n in ja._RA_OPS],
                    np.float32)
    stage_in = x
    for i in range(2):
        oi = jnp.asarray(ra_idx[picks[i]])
        mg = _jax_mag(oi, jnp.asarray(mags[picks[i]]), jnp.asarray(signs[i]))
        want = np.asarray(ja._apply_stage_batched(
            jnp.asarray(stage_in), oi, mg, jnp.ones((b,), bool),
            used_ops=frozenset(ja._RA_OPS)))
        got = ta._apply_stage_batched(torch.tensor(stage_in), np.asarray(oi),
                                      np.asarray(mg),
                                      np.ones(b, bool)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        stage_in = want
    want = np.asarray(ja.rand_augment_batch(key, jnp.asarray(x)))
    got = ta.rand_augment(torch.tensor(x), picks, signs).numpy()
    _assert_close_end_to_end(got, want, share=0.01, levels=16)


def test_cutout_and_cutmix_match_jax():
    """At the draws JAX makes from its keys: cutout exactly; cutmix's
    images, mixed labels and label weight exactly."""
    b, s = B, 32
    x = _images(b, s, 6)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    cy = np.asarray(jax.random.randint(k1, (b, 1, 1), 0, s)).reshape(-1)
    cx = np.asarray(jax.random.randint(k2, (b, 1, 1), 0, s)).reshape(-1)
    want = np.asarray(jpre.cutout(key, jnp.asarray(x), size=16))
    got = tpre.cutout(torch.tensor(x), torch.tensor(cy), torch.tensor(cx),
                      size=16).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).mean() > 0.05

    y = np.eye(b, dtype=np.float32)[np.arange(b) % 4]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    perm = np.asarray(jax.random.permutation(k1, b))
    lam = float(jax.random.beta(k2, 1.0, 1.0))
    cy = int(jax.random.randint(k3, (), 0, s))
    cx = int(jax.random.randint(k4, (), 0, s))
    wx, wy, wl = jpre.cutmix(key, jnp.asarray(x), jnp.asarray(y))
    gx, gy, gl = tpre.cutmix(torch.tensor(x), torch.tensor(y),
                             torch.tensor(perm), lam, cy, cx)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    assert gl == float(wl) and 0.0 < gl < 1.0
    # the random wrapper: a mixed batch and labels that still sum to 1
    mx, my, ml = tpre.random_cutmix(torch.Generator().manual_seed(0),
                                    torch.tensor(x), torch.tensor(y))
    assert mx.shape == x.shape and 0.0 <= ml <= 1.0
    np.testing.assert_allclose(my.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_train_pipeline_matches_jax_on_its_draws():
    """``make_train_pipeline`` with AutoAugment (cifar10), Cutout and
    RandAugment, in JAX's order, fed the draws JAX's pipeline makes from
    its key (fp32 out): normalized values within 1e-4 except where a
    quantizing op rounded a level the other way (at most 3% of the
    elements, each within 16 levels over the smallest std)."""
    b, s, size = B, 32, 40
    mean, std = (0.5, 0.45, 0.4), (0.25, 0.26, 0.27)
    u8 = np.random.default_rng(8).integers(0, 256, (b, s, s, 3),
                                           dtype=np.uint8)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jpre.make_train_pipeline(
        size, mean, std, use_autoaug=True, autoaug_policy="cifar10",
        use_cutout=True, use_randaug=True, out_dtype=jnp.float32)(
            key, jnp.asarray(u8)))
    ks = jax.random.split(key, 4)
    k1, k2 = jax.random.split(jax.random.fold_in(key, 17))
    c1, c2 = jax.random.split(ks[0])
    draws = {
        "autoaug": _jax_aa_draws(ks[3], b, "cifar10"),
        "cutout": (np.asarray(jax.random.randint(k1, (b, 1, 1), 0, s))
                   .reshape(-1), np.asarray(jax.random.randint(
                       k2, (b, 1, 1), 0, s)).reshape(-1)),
        "randaug": _jax_ra_draws(jax.random.fold_in(key, 19), b),
        "crop": (torch.tensor(np.asarray(jax.random.randint(c1, (b,), 0, 9))),
                 torch.tensor(np.asarray(jax.random.randint(c2, (b,), 0, 9)))),
        "flip": torch.tensor(np.asarray(
            jax.random.bernoulli(ks[1], 0.5, (b,)))),
    }
    pipe = tpre.make_train_pipeline(size, mean, std, use_autoaug=True,
                                    autoaug_policy="cifar10", use_cutout=True,
                                    use_randaug=True, out_dtype=torch.float32)
    got = pipe.apply(torch.tensor(u8), draws).numpy()
    assert got.shape == (b, size, size, 3)
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() <= 0.03, (diff > 1e-4).mean()
    assert diff.max() <= 16 * LEVEL / min(std) + 1e-4, diff.max()
    # the generator road: same shape and dtype, finite
    out = pipe(torch.Generator().manual_seed(0), torch.tensor(u8))
    assert out.shape == (b, size, size, 3) and torch.isfinite(out).all()


def test_pipeline_without_augmentation_draws_as_before():
    """Without AutoAugment, Cutout or RandAugment the pipeline draws the
    crop offsets and then the flip flags, as it did before they existed, so
    a run without them keeps its random stream."""
    u8 = torch.randint(0, 256, (4, 24, 24, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1))
    mean, std = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
    got = tpre.make_train_pipeline(32, mean, std, out_dtype=torch.float32)(
        torch.Generator().manual_seed(3), u8)
    g = torch.Generator().manual_seed(3)
    oy = torch.randint(0, 9, (4,), generator=g)
    ox = torch.randint(0, 9, (4,), generator=g)
    flip = torch.rand(4, generator=g) < 0.5
    want = tpre.normalize(tpre.hflip(tpre.resize_pad_crop(
        u8.float() / 255.0, 32, oy, ox), flip), mean, std)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_draws_follow_their_distribution():
    """The port's own draws over 20000 samples, each within 5 sigma of its
    law: the sub-policy pick uniform over the table, each stage's gate on at
    its op's prob, signs +1 at 1/2; RandAugment's picks uniform over its 14
    ops."""
    n = 20000
    for policy in sorted(ta.POLICIES):
        _, prob, _ = ta._policy_arrays(policy)
        pick, gates, signs = ta.draw_auto_augment(
            torch.Generator().manual_seed(11), n, policy)
        pick, gates, signs = pick.numpy(), gates.numpy(), signs.numpy()
        k = prob.shape[0]
        counts = np.bincount(pick, minlength=k)
        sd = np.sqrt(n * (1 / k) * (1 - 1 / k))
        assert np.abs(counts - n / k).max() < 5 * sd, (policy, counts)
        for j in range(2):
            p = prob[pick, j]
            on = gates[j]
            for v in np.unique(p):
                sel = p == v
                sd = np.sqrt(v * (1 - v) / sel.sum()) if 0 < v < 1 else 0
                assert abs(on[sel].mean() - v) <= 5 * sd + 1e-12, (policy, v)
            assert set(np.unique(signs[j])) == {-1.0, 1.0}
            assert abs((signs[j] > 0).mean() - 0.5) < 5 * np.sqrt(0.25 / n)
    picks, signs = ta.draw_rand_augment(torch.Generator().manual_seed(12), n)
    for row, srow in zip(picks.numpy(), signs.numpy()):
        counts = np.bincount(row, minlength=len(ta._RA_OPS))
        k = len(ta._RA_OPS)
        assert np.abs(counts - n / k).max() < 5 * np.sqrt(n / k * (1 - 1 / k))
        assert abs((srow > 0).mean() - 0.5) < 5 * np.sqrt(0.25 / n)


def test_wrappers_apply_the_draws_they_make():
    """``auto_augment_batch_fast`` and ``rand_augment_batch`` are their
    cores at the draws ``draw_auto_augment`` / ``draw_rand_augment`` make
    from the same generator."""
    x = torch.tensor(_images(B, 32, 10))
    for policy in sorted(ta.POLICIES):
        got = ta.auto_augment_batch_fast(torch.Generator().manual_seed(4), x,
                                         policy)
        draws = ta.draw_auto_augment(torch.Generator().manual_seed(4), B,
                                     policy)
        assert torch.equal(got, ta.auto_augment_fast(x, policy, *draws))
    got = ta.rand_augment_batch(torch.Generator().manual_seed(5), x)
    draws = ta.draw_rand_augment(torch.Generator().manual_seed(5), B)
    assert torch.equal(got, ta.rand_augment(x, *draws))
