"""Batched on-device image preprocessing in plain PyTorch.

Counterpart of ``lifelong_clip_tpu/ops/preprocess.py``. Train pipeline, in
JAX's order: [AutoAugment] -> [Cutout] -> [RandAugment] -> Resize(S, S) ->
RandomCrop(S, pad=4) -> RandomHorizontalFlip -> Normalize, the resize, pad
and crop fused as per-sample matrix contractions (uint8 in, normalized
compute-dtype out). Test: Resize -> Normalize. CutMix (``cutmix``) mixes a
batch and its labels; the ER family's step applies it. The random
draws come from a ``torch.Generator`` on the host; the deterministic cores
(``resize_pad_crop``, ``hflip``, ``cutout``, ``cutmix``,
``TrainPipeline.apply``) take them explicitly, so tests can feed them the
JAX pipeline's draws.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import autoaugment

CROP_PAD = 4     # RandomCrop's zero padding in the train pipeline


@functools.lru_cache()
def _resize_matrix(n_in: int, n_out: int):
    """Bilinear interpolation as an (n_out, n_in) matrix (half-pixel
    centers, matching jax.image.resize / torchvision bilinear)."""
    scale = n_in / n_out
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(centers).astype(np.int64)
    frac = centers - lo
    m = np.zeros((n_out, n_in), np.float32)
    lo0 = np.clip(lo, 0, n_in - 1)
    lo1 = np.clip(lo + 1, 0, n_in - 1)
    m[np.arange(n_out), lo0] += 1.0 - frac
    m[np.arange(n_out), lo1] += frac
    return m


@functools.lru_cache()
def _resize_tensor(n_in: int, n_out: int, pad: int, device: torch.device):
    """``_resize_matrix`` zero-padded by ``pad`` rows each side, on
    ``device``; made once per shape, so a step copies nothing to the card
    (a blocking host-to-device copy would also stall the host on the
    device's queue)."""
    m = np.pad(_resize_matrix(n_in, n_out), ((pad, pad), (0, 0)))
    return torch.from_numpy(m).to(device)


@functools.lru_cache()
def _channel_stats(mean: Tuple[float, ...], std: Tuple[float, ...], dtype,
                   device: torch.device):
    return (torch.tensor(mean, dtype=dtype, device=device),
            torch.tensor(std, dtype=dtype, device=device))


def resize_bilinear(x, size: int):
    """(B, H, W, C) -> (B, size, size, C) fp32, bilinear, as two separable
    matrix contractions."""
    b, h, w, c = x.shape
    if h == size and w == size:
        return x
    rh = _resize_tensor(h, size, 0, x.device)
    rw = _resize_tensor(w, size, 0, x.device)
    x = torch.einsum("oh,bhwc->bowc", rh, x.float())
    return torch.einsum("ow,bhwc->bhoc", rw, x)


def normalize(x, mean: Tuple[float, ...], std: Tuple[float, ...]):
    """Channel-wise normalization; input in [0, 1]."""
    mean, std = _channel_stats(tuple(mean), tuple(std), x.dtype, x.device)
    return (x - mean) / std


def resize_pad_crop(x, size: int, oy, ox, pad: int = 4):
    """Resize to (size, size), zero-pad by ``pad``, crop back at per-sample
    offsets ``oy``/``ox`` (ints in [0, 2*pad]). The per-sample resize matrix
    is the shared bilinear matrix zero-padded and shifted by the offset."""
    b, h, w, c = x.shape
    dev = x.device
    rh = _resize_tensor(h, size, pad, dev)
    rw = _resize_tensor(w, size, pad, dev)
    rows = torch.arange(size, device=dev)
    # the offsets are drawn on the host: copy them without waiting on the
    # device's queue
    oy = oy.to(dev, non_blocking=True)
    ox = ox.to(dev, non_blocking=True)
    mh = rh[oy[:, None] + rows[None, :]]     # (B, size, H)
    mw = rw[ox[:, None] + rows[None, :]]     # (B, size, W)
    x = torch.einsum("boi,bihc->bohc", mh, x.float())
    return torch.einsum("boj,bhjc->bhoc", mw, x)


def hflip(x, flags):
    """Flip the samples whose flag is set along W."""
    flags = flags.to(x.device, non_blocking=True)
    return torch.where(flags[:, None, None, None], x.flip(2), x)


def cutout(x, cy, cx, size: int = 16, fill: float = 0.0):
    """Per-sample square cutout centred at (``cy``, ``cx``), (B,) ints
    (reference ``utils/augment.py:268-321``)."""
    b, h, w, _ = x.shape
    cy = torch.as_tensor(cy).to(x.device, non_blocking=True).reshape(b, 1, 1)
    cx = torch.as_tensor(cx).to(x.device, non_blocking=True).reshape(b, 1, 1)
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    mask = ((ys - cy).abs() < size // 2) & ((xs - cx).abs() < size // 2)
    return torch.where(mask[..., None], fill, x)


def cutmix(x, y_onehot, perm, lam: float, cy: int, cx: int):
    """Batch CutMix (reference ``utils/augment.py:344-380``): paste the box
    of side ``sqrt(1 - lam)`` of the image's centred at (``cy``, ``cx``)
    from partner ``perm[i]`` into image i; labels mix by the pasted area.
    Returns (mixed images, mixed labels, the label weight ``lam_adj``)."""
    b, h, w, _ = x.shape
    rh = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(h) * rh)
    cut_w = int(np.float32(w) * rh)
    y1, y2 = (min(max(v, 0), h) for v in (cy - cut_h // 2, cy + cut_h // 2))
    x1, x2 = (min(max(v, 0), w) for v in (cx - cut_w // 2, cx + cut_w // 2))
    perm = torch.as_tensor(perm).to(x.device, non_blocking=True)
    mixed = x.clone()
    mixed[:, y1:y2, x1:x2] = x[perm][:, y1:y2, x1:x2]
    lam_adj = float(np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1))
                    / np.float32(h * w))
    y_mixed = lam_adj * y_onehot + (1.0 - lam_adj) * y_onehot[perm]
    return mixed, y_mixed, lam_adj


def random_cutmix(gen: torch.Generator, x, y_onehot, alpha: float = 1.0):
    """``cutmix`` at a random partner permutation, ``lam`` ~ Beta(alpha,
    alpha) and a centre uniform over the image, all drawn from ``gen``."""
    b, h, w, _ = x.shape
    perm = torch.randperm(b, generator=gen)
    # torch's Beta sampler takes no generator: a numpy one seeded from gen
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    cy = int(torch.randint(0, h, (1,), generator=gen))
    cx = int(torch.randint(0, w, (1,), generator=gen))
    return cutmix(x, y_onehot, perm, lam, cy, cx)


class TrainPipeline:
    """The train pipeline: ``pipeline(gen, uint8 images (B, H, W, C) on the
    device) -> normalized batch``. ``draw`` makes its random draws on the
    host, ``apply`` runs it at given draws (a dict: ``autoaug`` (pick,
    gates, signs), ``cutout`` (cy, cx), ``randaug`` (picks, signs),
    ``crop`` (oy, ox), ``flip`` flags). Without the optional stages it
    draws exactly what it drew before they existed: the crop offsets, then
    the flip flags."""

    def __init__(self, img_size: int, mean: Tuple[float, ...],
                 std: Tuple[float, ...], *, use_autoaug: bool = False,
                 autoaug_policy: str = "imagenet", use_cutout: bool = False,
                 use_randaug: bool = False, out_dtype=torch.bfloat16):
        if use_autoaug and autoaug_policy not in autoaugment.POLICIES:
            raise ValueError(f"unknown AutoAugment policy {autoaug_policy!r}"
                             f"; one of {sorted(autoaugment.POLICIES)}")
        self.img_size, self.mean, self.std = img_size, mean, std
        self.use_autoaug, self.autoaug_policy = use_autoaug, autoaug_policy
        self.use_cutout, self.use_randaug = use_cutout, use_randaug
        self.out_dtype = out_dtype

    def draw(self, gen: torch.Generator, b: int, h: int, w: int):
        d = {}
        if self.use_autoaug:
            d["autoaug"] = autoaugment.draw_auto_augment(gen, b,
                                                         self.autoaug_policy)
        if self.use_cutout:
            d["cutout"] = (torch.randint(0, h, (b,), generator=gen),
                           torch.randint(0, w, (b,), generator=gen))
        if self.use_randaug:
            d["randaug"] = autoaugment.draw_rand_augment(gen, b)
        n = 2 * CROP_PAD + 1
        d["crop"] = (torch.randint(0, n, (b,), generator=gen),
                     torch.randint(0, n, (b,), generator=gen))
        d["flip"] = torch.rand(b, generator=gen) < 0.5
        return d

    def apply(self, images_u8, draws):
        x = images_u8.float() / 255.0
        if self.use_autoaug:
            x = autoaugment.auto_augment_fast(x, self.autoaug_policy,
                                              *draws["autoaug"])
        if self.use_cutout:
            x = cutout(x, *draws["cutout"], size=16)
        if self.use_randaug:
            x = autoaugment.rand_augment(x, *draws["randaug"])
        x = resize_pad_crop(x, self.img_size, *draws["crop"], pad=CROP_PAD)
        x = hflip(x, draws["flip"])
        return normalize(x, self.mean, self.std).to(self.out_dtype)

    def __call__(self, gen: torch.Generator, images_u8):
        return self.apply(images_u8, self.draw(gen, *images_u8.shape[:3]))


def make_train_pipeline(img_size: int, mean: Tuple[float, ...],
                        std: Tuple[float, ...], *, use_autoaug: bool = False,
                        autoaug_policy: str = "imagenet",
                        use_cutout: bool = False, use_randaug: bool = False,
                        out_dtype=torch.bfloat16) -> TrainPipeline:
    """fn(gen, uint8 images (B,H,W,C) on the device) -> normalized batch."""
    return TrainPipeline(img_size, mean, std, use_autoaug=use_autoaug,
                         autoaug_policy=autoaug_policy, use_cutout=use_cutout,
                         use_randaug=use_randaug, out_dtype=out_dtype)


def make_eval_pipeline(img_size: int, mean: Tuple[float, ...],
                       std: Tuple[float, ...], out_dtype=torch.bfloat16):
    def pipeline(images_u8):
        x = images_u8.float() / 255.0
        x = resize_bilinear(x, img_size)
        return normalize(x, mean, std).to(out_dtype)

    return pipeline
