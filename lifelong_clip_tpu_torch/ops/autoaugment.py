"""AutoAugment / RandAugment as batched PyTorch ops on the device.

Counterpart of ``lifelong_clip_tpu/ops/autoaugment.py``: the published
policy tables (ImageNet / CIFAR10 / SVHN, two (op, prob, level) stages a
sub-policy), the op table with its magnitude rules, and the ops themselves
on float images in [0, 1]. Every op works on a batch (B, H, W, C) with one
magnitude or a (B,) tensor of them, so the single-image functions of the
JAX package are these on a batch of one.

The random draws (sub-policy pick, the stages' gates and signs, RandAugment's
op picks and signs) are made on the host from a ``torch.Generator``
(``draw_auto_augment``, ``draw_rand_augment``); each batched entry point is
a core that takes them as arguments (``auto_augment_fast``,
``rand_augment``) and a wrapper that draws them (``auto_augment_batch_fast``,
``rand_augment_batch``). ``auto_augment_per_sample`` applies the same draws
one sample and one op at a time (JAX's per-sample ``auto_augment_batch``):
the plain version the batched road is held against. Since the draws are on
the host, a stage knows
which sample runs which op without asking the device: it runs each op once
on the samples that drew it (``_apply_stage_batched``), and one warp for
all the affine ops of the stage.

One road for every size, where JAX picks by size for the TPU: warps are
4-tap bilinear gathers (JAX's ``_affine_warp``; JAX contracts hat tensors up
to 64 px), equalize a ``scatter_add_`` histogram and an integer LUT (JAX's
per-sample ``equalize``; JAX's one-hot matmul up to 64 x 64 computes the
same integers). Out-of-range coverage blends to a fill of 0, the live
torchvision convention the JAX package follows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_GRAY = (0.299, 0.587, 0.114)


def _per_sample(m, x):
    """A magnitude as ``x`` broadcasts it: a float, or a (B,) tensor or
    array as (B, 1, 1, 1) on ``x``'s device."""
    if isinstance(m, (int, float)):
        return float(m)
    m = torch.as_tensor(m, dtype=x.dtype).to(x.device, non_blocking=True)
    return m.reshape(-1, 1, 1, 1) if m.dim() else m


# --------------------------------------------------------------------------
# geometry: bilinear affine warp
# --------------------------------------------------------------------------

@functools.lru_cache()
def _taps(h: int, w: int, device: torch.device):
    """Output pixel coordinates (1, 1, H, W) and the four taps' (dy, dx)
    offsets (1, 4, 1, 1), made once per shape and device."""
    xs = torch.arange(w, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    dy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=device)
    dx = torch.tensor([0.0, 1.0, 0.0, 1.0], device=device)
    return (xs.reshape(1, 1, 1, w), ys.reshape(1, 1, h, 1),
            dy.reshape(1, 4, 1, 1), dx.reshape(1, 4, 1, 1))


def warp(x, mats):
    """One bilinear warp a sample (JAX ``_affine_warp``, batched).

    x (B, H, W, C) float; mats (B, 2, 3) mapping OUTPUT pixel coordinates
    to INPUT ones (PIL convention). Each output pixel reads its four
    neighbouring input pixels (one gather for the four taps); taps outside
    the image read 0, which is the fill of 0 blended by lost coverage."""
    b, h, w, c = x.shape
    xs, ys, dy, dx = _taps(h, w, x.device)
    m = torch.as_tensor(mats, dtype=torch.float32).to(
        x.device, non_blocking=True).reshape(b, 6, 1, 1, 1).unbind(1)
    xin = m[0] * xs + m[1] * ys + m[2]                        # (B, 1, H, W)
    yin = m[3] * xs + m[4] * ys + m[5]
    x0 = torch.floor(xin)
    y0 = torch.floor(yin)
    wx = xin - x0
    wy = yin - y0
    xc = x0 + dx                                               # (B, 4, H, W)
    yc = y0 + dy
    valid = (xc >= 0) & (xc < w) & (yc >= 0) & (yc < h)
    # tap (dy, dx) weighs (1 - wx or wx) * (1 - wy or wy), as JAX's w00..w11
    wt = (torch.where(dx > 0, wx, 1 - wx) * torch.where(dy > 0, wy, 1 - wy))
    idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
    vals = x.reshape(b, h * w, c).gather(
        1, idx.reshape(b, 4 * h * w, 1).expand(b, 4 * h * w, c))
    vals = torch.where(valid.reshape(b, 4 * h * w, 1), vals, 0.0)
    out = (wt.reshape(b, 4, h, w, 1) * vals.reshape(b, 4, h, w, c)).sum(1)
    return out.to(x.dtype)


def _center_mats(a, b_, c_, d, tx0, ty0, h: int, w: int):
    """(B, 2, 3) float32 matrices on the host: the linear part
    [[a, b], [c, d]] about the image centre, then the translation (JAX
    ``_center_mat``)."""
    f = np.float32
    a, b_, c_, d, tx0, ty0 = (np.broadcast_to(np.asarray(v, f), np.shape(a))
                              for v in (a, b_, c_, d, tx0, ty0))
    cx, cy = f((w - 1) / 2.0), f((h - 1) / 2.0)
    tx = cx - a * cx - b_ * cy + tx0
    ty = cy - c_ * cx - d * cy + ty0
    return np.stack([np.stack([a, b_, tx], -1), np.stack([c_, d, ty], -1)],
                    -2).astype(f)


def _affine_mats(names, mag, h: int, w: int):
    """Per-sample centred matrices for the affine ops ``names`` (one a
    sample) at magnitudes ``mag`` (signs applied), on the host (JAX
    ``_affine_params`` + ``_center_mat``)."""
    f = np.float32
    names = np.asarray(names, dtype=object).reshape(-1)
    mag = np.asarray(mag, f).reshape(-1)
    unknown = set(names) - set(_AFFINE)
    if unknown:
        raise ValueError(f"{sorted(unknown)} are not affine ops")
    rot = names == "Rotate"
    rad = mag * f(np.pi) / f(180.0)
    cos, sin = np.cos(rad), np.sin(rad)
    one, zero = np.ones_like(mag), np.zeros_like(mag)
    return _center_mats(
        np.where(rot, cos, one),
        np.where(names == "ShearX", mag, np.where(rot, sin, zero)),
        np.where(names == "ShearY", mag, np.where(rot, -sin, zero)),
        np.where(rot, cos, one),
        np.where(names == "TranslateX", mag * f(w), zero),
        np.where(names == "TranslateY", mag * f(h), zero), h, w)


def _affine(name):
    def op(x, mag):
        b, h, w, _ = x.shape
        mag = np.broadcast_to(np.asarray(mag, np.float32), (b,))
        return warp(x, _affine_mats([name] * b, mag, h, w))
    op.__name__ = name.lower()
    return op


shear_x = _affine("ShearX")
shear_y = _affine("ShearY")
translate_x = _affine("TranslateX")
translate_y = _affine("TranslateY")
rotate = _affine("Rotate")


# --------------------------------------------------------------------------
# colour ops (PIL ImageEnhance / ImageOps semantics on [0, 1] floats)
# --------------------------------------------------------------------------

@functools.lru_cache()
def _gray_weights(device: torch.device):
    return torch.tensor(_GRAY, dtype=torch.float32, device=device)


def _gray(x):
    return x @ _gray_weights(x.device)                            # (B, H, W)


def _blend(a, b, factor):
    return (b + factor * (a - b)).clamp(0.0, 1.0)


def invert(x, _=None):
    return 1.0 - x


def brightness(x, factor):
    # blend toward 0: b + f * (a - b) with b = 0 is f * a, bit for bit
    return (_per_sample(factor, x) * x).clamp(0.0, 1.0)


def color(x, factor):
    return _blend(x, _gray(x)[..., None], _per_sample(factor, x))


def contrast(x, factor):
    gray = torch.round(_gray(x) * 255.0) / 255.0
    mean = gray.mean(dim=(1, 2), keepdim=True)[..., None]
    return _blend(x, mean, _per_sample(factor, x))


def _smooth(x):
    """PIL SMOOTH ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13), border kept, as
    eight shifted adds in JAX ``_batched_smooth``'s order."""
    b, h, w, c = x.shape
    if h < 3 or w < 3:
        return x
    acc = 5.0 * x[:, 1:-1, 1:-1]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                acc = acc + x[:, 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
    out = x.clone()
    out[:, 1:-1, 1:-1] = acc / 13.0
    return out


def sharpness(x, factor):
    return _blend(x, _smooth(x), _per_sample(factor, x))


@functools.lru_cache()
def _level_values(device: torch.device):
    """l / 255 for the 256 levels, divided on the host. On the card a
    division by a Python scalar multiplies by its reciprocal, one ulp off
    the quotient for some levels; a table keeps the quantizing ops exact
    and equal across devices and to JAX's division."""
    table = np.arange(256, dtype=np.float32) / np.float32(255.0)
    return torch.from_numpy(table).to(device)


def _from_levels(levels):
    return _level_values(levels.device)[levels.long()]


def posterize(x, bits):
    levels = torch.round(x * 255.0).to(torch.int32)
    bits = _per_sample(bits, x)
    if isinstance(bits, float):
        shift = min(max(int(8 - bits), 0), 8)
    else:   # samples of other ops carry other magnitudes: keep in range
        shift = (8 - bits).to(torch.int32).clamp(0, 8)
    return _from_levels((levels >> shift) << shift)


def solarize(x, threshold):
    return torch.where(x >= _per_sample(threshold, x), 1.0 - x, x)


def autocontrast(x, _=None):
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), 1.0)
    return ((x - lo) * scale).clamp(0.0, 1.0)


def equalize(x, _=None):
    """Per-sample, per-channel histogram equalization (PIL
    ``ImageOps.equalize``) in integer arithmetic: a ``scatter_add_``
    histogram of the 256 levels, PIL's step, and the LUT gathered."""
    b, h, w, c = x.shape
    levels = torch.round(x * 255.0).to(torch.int64)
    lv = levels.permute(0, 3, 1, 2).reshape(b, c, h * w)
    hist = torch.zeros(b, c, 256, dtype=torch.int64, device=x.device)
    hist.scatter_add_(2, lv, torch.ones_like(lv))
    bins = torch.arange(256, device=x.device)
    last_nz = torch.where(hist > 0, bins, -1).amax(-1, keepdim=True)
    last_count = hist.gather(2, last_nz.clamp(min=0))
    step = (hist.sum(-1, keepdim=True) - last_count) // 255       # (B, C, 1)
    lut = (hist.cumsum(-1) - hist + step // 2) // step.clamp(min=1)
    lut = lut.clamp(0, 255)
    out = torch.where(step == 0, lv, lut.gather(2, lv))
    return _from_levels(out.reshape(b, c, h, w).permute(0, 2, 3, 1))


def identity(x, _=None):
    return x


# --------------------------------------------------------------------------
# policy machinery
# --------------------------------------------------------------------------

def _lvl(lo, hi):
    return lambda m: lo + (hi - lo) * (m / 9.0)


# op name -> (fn, magnitude for a level 0-9, signed: True / "enh" / False)
_OPS = {
    "ShearX": (shear_x, _lvl(0.0, 0.3), True),
    "ShearY": (shear_y, _lvl(0.0, 0.3), True),
    "TranslateX": (translate_x, _lvl(0.0, 150.0 / 331.0), True),
    "TranslateY": (translate_y, _lvl(0.0, 150.0 / 331.0), True),
    "Rotate": (rotate, _lvl(0.0, 30.0), True),
    "Brightness": (brightness, lambda m: 1.0 + _lvl(0.0, 0.9)(m), "enh"),
    "Color": (color, lambda m: 1.0 + _lvl(0.0, 0.9)(m), "enh"),
    "Contrast": (contrast, lambda m: 1.0 + _lvl(0.0, 0.9)(m), "enh"),
    "Sharpness": (sharpness, lambda m: 1.0 + _lvl(0.0, 0.9)(m), "enh"),
    "Posterize": (posterize, lambda m: 8.0 - round(_lvl(0.0, 4.0)(m)),
                  False),
    "Solarize": (solarize, _lvl(1.0, 0.0), False),
    "AutoContrast": (autocontrast, lambda m: 0.0, False),
    "Equalize": (equalize, lambda m: 0.0, False),
    "Invert": (invert, lambda m: 0.0, False),
    "Identity": (identity, lambda m: 0.0, False),
}

_OP_NAMES = list(_OPS)
_AFFINE = ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")
_IS_AFFINE = np.array([n in _AFFINE for n in _OP_NAMES])
_SIGNED = np.array([_OPS[n][2] is True for n in _OP_NAMES])
_ENH = np.array([_OPS[n][2] == "enh" for n in _OP_NAMES])


def _signed_mag(op_idx, mag, sign):
    """The magnitude each sample's op runs at (host float32): affine ops
    take ``mag * sign``, enhancements ``1 + (mag - 1) * sign``, the rest
    ``mag`` (JAX ``_apply_op`` and the batched roads)."""
    f = np.float32
    op_idx = np.asarray(op_idx).reshape(-1)
    mag = np.asarray(mag, f).reshape(-1)
    sign = np.broadcast_to(np.asarray(sign, f), mag.shape)
    signed, enh = _SIGNED[op_idx], _ENH[op_idx]
    out = np.where(signed, mag * sign, mag)
    return np.where(enh, f(1.0) + (mag - f(1.0)) * sign, out).astype(f)


def _apply_op(img, op_idx: int, mag, sign):
    """One op on one image (H, W, C) (JAX ``_apply_op``): ``sign`` in
    {-1, +1} flips signed magnitudes."""
    name = _OP_NAMES[int(op_idx)]
    m = float(_signed_mag([op_idx], [mag], [sign])[0])
    return _OPS[name][0](img[None], m)[0]


# published AutoAugment policies (op, prob, level 0-9)
POLICIES = {
    "imagenet": [
        (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
        (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 0)),
        (("Equalize", 0.8, 0), ("Equalize", 0.6, 0)),
        (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
        (("Equalize", 0.4, 0), ("Solarize", 0.2, 4)),
        (("Equalize", 0.4, 0), ("Rotate", 0.8, 8)),
        (("Solarize", 0.6, 3), ("Equalize", 0.6, 0)),
        (("Posterize", 0.8, 5), ("Equalize", 1.0, 0)),
        (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
        (("Equalize", 0.6, 0), ("Posterize", 0.4, 6)),
        (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
        (("Rotate", 0.4, 9), ("Equalize", 0.6, 0)),
        (("Equalize", 0.0, 0), ("Equalize", 0.8, 0)),
        (("Invert", 0.6, 0), ("Equalize", 1.0, 0)),
        (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
        (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
        (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
        (("Sharpness", 0.4, 7), ("Invert", 0.6, 0)),
        (("ShearX", 0.6, 5), ("Equalize", 1.0, 0)),
        (("Color", 0.4, 0), ("Equalize", 0.6, 0)),
        (("Equalize", 0.4, 0), ("Solarize", 0.2, 4)),
        (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 0)),
        (("Invert", 0.6, 0), ("Equalize", 1.0, 0)),
        (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
        (("Equalize", 0.8, 0), ("Equalize", 0.6, 0)),
    ],
    "cifar10": [
        (("Invert", 0.1, 0), ("Contrast", 0.2, 6)),
        (("Rotate", 0.7, 2), ("TranslateX", 0.3, 9)),
        (("Sharpness", 0.8, 1), ("Sharpness", 0.9, 3)),
        (("ShearY", 0.5, 8), ("TranslateY", 0.7, 9)),
        (("AutoContrast", 0.5, 0), ("Equalize", 0.9, 0)),
        (("ShearY", 0.2, 7), ("Posterize", 0.3, 7)),
        (("Color", 0.4, 3), ("Brightness", 0.6, 7)),
        (("Sharpness", 0.3, 9), ("Brightness", 0.7, 9)),
        (("Equalize", 0.6, 0), ("Equalize", 0.5, 0)),
        (("Contrast", 0.6, 7), ("Sharpness", 0.6, 5)),
        (("Color", 0.7, 7), ("TranslateX", 0.5, 8)),
        (("Equalize", 0.3, 0), ("AutoContrast", 0.4, 0)),
        (("TranslateY", 0.4, 3), ("Sharpness", 0.2, 6)),
        (("Brightness", 0.9, 6), ("Color", 0.2, 8)),
        (("Solarize", 0.5, 2), ("Invert", 0.0, 0)),
        (("Equalize", 0.2, 0), ("AutoContrast", 0.6, 0)),
        (("Equalize", 0.2, 0), ("Equalize", 0.6, 0)),
        (("Color", 0.9, 9), ("Equalize", 0.6, 0)),
        (("AutoContrast", 0.8, 0), ("Solarize", 0.2, 8)),
        (("Brightness", 0.1, 3), ("Color", 0.7, 0)),
        (("Solarize", 0.4, 5), ("AutoContrast", 0.9, 0)),
        (("TranslateY", 0.9, 9), ("TranslateY", 0.7, 9)),
        (("AutoContrast", 0.9, 0), ("Solarize", 0.8, 3)),
        (("Equalize", 0.8, 0), ("Invert", 0.1, 0)),
        (("TranslateY", 0.7, 9), ("AutoContrast", 0.9, 0)),
    ],
    "svhn": [
        (("ShearX", 0.9, 4), ("Invert", 0.2, 3)),
        (("ShearY", 0.9, 8), ("Invert", 0.7, 5)),
        (("Equalize", 0.6, 5), ("Solarize", 0.6, 6)),
        (("Invert", 0.9, 3), ("Equalize", 0.6, 3)),
        (("Equalize", 0.6, 1), ("Rotate", 0.9, 3)),
        (("ShearX", 0.9, 4), ("AutoContrast", 0.8, 3)),
        (("ShearY", 0.9, 8), ("Invert", 0.4, 5)),
        (("ShearY", 0.9, 5), ("Solarize", 0.2, 6)),
        (("Invert", 0.9, 6), ("AutoContrast", 0.8, 1)),
        (("Equalize", 0.6, 3), ("Rotate", 0.9, 3)),
        (("ShearX", 0.9, 4), ("Solarize", 0.3, 3)),
        (("ShearY", 0.8, 8), ("Invert", 0.7, 4)),
        (("Equalize", 0.9, 5), ("TranslateY", 0.6, 6)),
        (("ShearX", 0.9, 4), ("AutoContrast", 0.8, 3)),
        (("ShearY", 0.8, 8), ("Solarize", 0.7, 4)),
        (("Invert", 0.6, 4), ("Rotate", 0.8, 4)),
        (("ShearY", 0.3, 7), ("TranslateX", 0.9, 3)),
        (("ShearX", 0.1, 6), ("Invert", 0.6, 5)),
        (("Solarize", 0.7, 2), ("TranslateY", 0.6, 7)),
        (("ShearY", 0.8, 4), ("Invert", 0.8, 8)),
        (("ShearX", 0.7, 9), ("TranslateY", 0.8, 3)),
        (("ShearY", 0.8, 5), ("AutoContrast", 0.7, 3)),
        (("ShearX", 0.7, 2), ("Invert", 0.1, 5)),
        (("Solarize", 0.5, 0), ("TranslateY", 0.2, 1)),
        (("AutoContrast", 0.9, 5), ("Solarize", 0.5, 3)),
    ],
}


@functools.lru_cache()
def _policy_arrays(policy: str):
    """A policy table as (op_idx, prob, mag) numpy arrays, each (P, 2)."""
    table = POLICIES[policy]
    op_idx = np.zeros((len(table), 2), np.int32)
    prob = np.zeros((len(table), 2), np.float32)
    mag = np.zeros((len(table), 2), np.float32)
    for i, stages in enumerate(table):
        for j, (name, p, lvl) in enumerate(stages):
            op_idx[i, j] = _OP_NAMES.index(name)
            prob[i, j] = p
            mag[i, j] = float(_OPS[name][1](float(lvl)))
    return op_idx, prob, mag


def _host(a, dtype=None):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a if dtype is None else a.astype(dtype)


def _apply_stage_batched(x, op_idx, mag, gate):
    """One policy stage over the batch.

    x (B, H, W, C) float32 on its device; op_idx, mag (signs applied) and
    gate: (B,) on the host. Samples whose gate is off, or that drew
    Identity, keep their image; the others run their op, each op once on
    the samples that drew it and one warp for all affine ops, with one
    host-to-device copy of the indices, magnitudes and warp matrices."""
    b, h, w, _ = x.shape
    op_idx = _host(op_idx, np.int64)
    mag = _host(mag, np.float32)
    gate = _host(gate, bool)
    groups = []
    affine = np.flatnonzero(gate & _IS_AFFINE[op_idx])
    if len(affine):
        groups.append(("warp", affine))
    for i, name in enumerate(_OP_NAMES):
        sel = np.flatnonzero(gate & (op_idx == i))
        if len(sel) and name not in _AFFINE and name != "Identity":
            groups.append((name, sel))
    if not groups:
        return x
    order = np.concatenate([idx for _, idx in groups])
    mats = _affine_mats(np.asarray(_OP_NAMES, object)[op_idx[affine]],
                        mag[affine], h, w)
    host = torch.from_numpy(np.concatenate(
        [order.astype(np.float32), mag[order], mats.reshape(-1)]))
    dev = host.to(x.device, non_blocking=True)
    n = len(order)
    idx_all, mag_all = dev[:n].long(), dev[n:2 * n]
    out = x.clone()
    lo = 0
    for name, idx in groups:
        sl = slice(lo, lo + len(idx))
        lo += len(idx)
        sub = x.index_select(0, idx_all[sl])
        if name == "warp":
            y = warp(sub, dev[2 * n:].reshape(-1, 2, 3))
        else:
            y = _OPS[name][0](sub, mag_all[sl])
        out.index_copy_(0, idx_all[sl], y)
    return out


def draw_auto_augment(gen: torch.Generator, b: int,
                      policy: str = "imagenet"):
    """AutoAugment's draws for a batch of ``b`` on the host: the sub-policy
    ``pick`` (B,), uniform over the table; each stage's ``gates`` (2, B),
    on at its op's prob; each stage's ``signs`` (2, B), +-1 at 1/2."""
    _, prob, _ = _policy_arrays(policy)
    pick = torch.randint(0, prob.shape[0], (b,), generator=gen)
    p = torch.from_numpy(prob)[pick]                              # (B, 2)
    gates = torch.stack([torch.rand(b, generator=gen) < p[:, j]
                         for j in range(2)])
    signs = torch.stack([torch.where(torch.rand(b, generator=gen) < 0.5,
                                     1.0, -1.0) for _ in range(2)])
    return pick, gates, signs


def auto_augment_fast(images, policy: str, pick, gates, signs):
    """Batched AutoAugment at given draws (``draw_auto_augment``): the two
    stages of each sample's sub-policy, then a clip to [0, 1] (JAX
    ``auto_augment_batch_fast``)."""
    op_idx, _, mag = _policy_arrays(policy)
    pick = _host(pick, np.int64)
    gates, signs = _host(gates, bool), _host(signs, np.float32)
    x = images
    for j in range(2):
        oi = op_idx[pick, j]
        x = _apply_stage_batched(
            x, oi, _signed_mag(oi, mag[pick, j], signs[j]), gates[j])
    return x.clamp(0.0, 1.0)


def auto_augment_batch_fast(gen: torch.Generator, images,
                            policy: str = "imagenet"):
    """(B, H, W, C) float in [0, 1] -> augmented, one sub-policy a sample
    drawn from ``gen``."""
    return auto_augment_fast(images, policy,
                             *draw_auto_augment(gen, images.shape[0], policy))


def auto_augment_per_sample(images, policy: str, pick, gates, signs):
    """The same draws applied one sample and one op at a time (JAX
    ``auto_augment_batch`` / ``_augment_one``): the plain version the
    batched road is held against."""
    op_idx, _, mag = _policy_arrays(policy)
    pick = _host(pick, np.int64)
    gates, signs = _host(gates, bool), _host(signs, np.float32)
    out = []
    for i in range(images.shape[0]):
        img = images[i]
        for j in range(2):
            if gates[j, i]:
                img = _apply_op(img, op_idx[pick[i], j], mag[pick[i], j],
                                signs[j, i])
        out.append(img)
    return torch.stack(out)


_RA_OPS = ["Identity", "ShearX", "ShearY", "TranslateX", "TranslateY",
           "Rotate", "Brightness", "Color", "Contrast", "Sharpness",
           "Posterize", "Solarize", "AutoContrast", "Equalize"]
_RA_NUM_OPS, _RA_MAGNITUDE = 2, 9     # JAX's rand_augment_batch defaults


def draw_rand_augment(gen: torch.Generator, b: int):
    """RandAugment's draws on the host: each stage's op ``picks`` (N, B),
    uniform over ``_RA_OPS``, and ``signs`` (N, B), +-1 at 1/2."""
    picks = torch.stack([torch.randint(0, len(_RA_OPS), (b,), generator=gen)
                         for _ in range(_RA_NUM_OPS)])
    signs = torch.stack([torch.where(torch.rand(b, generator=gen) < 0.5,
                                     1.0, -1.0) for _ in range(_RA_NUM_OPS)])
    return picks, signs


def rand_augment(images, picks, signs):
    """RandAugment at given draws (``draw_rand_augment``): one op a stage a
    sample at the fixed magnitude, then a clip (JAX
    ``rand_augment_batch``)."""
    ra_idx = np.array([_OP_NAMES.index(n) for n in _RA_OPS], np.int64)
    mags = np.array([float(_OPS[n][1](float(_RA_MAGNITUDE)))
                     for n in _RA_OPS], np.float32)
    picks, signs = _host(picks, np.int64), _host(signs, np.float32)
    x = images
    for i in range(picks.shape[0]):
        oi = ra_idx[picks[i]]
        x = _apply_stage_batched(x, oi, _signed_mag(oi, mags[picks[i]],
                                                    signs[i]),
                                 np.ones(len(oi), bool))
    return x.clamp(0.0, 1.0)


def rand_augment_batch(gen: torch.Generator, images):
    return rand_augment(images, *draw_rand_augment(gen, images.shape[0]))

