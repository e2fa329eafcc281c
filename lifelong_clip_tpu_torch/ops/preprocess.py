"""Batched on-device image preprocessing in plain PyTorch.

Counterpart of ``lifelong_clip_tpu/ops/preprocess.py``. Train pipeline:
Resize(S, S) -> RandomCrop(S, pad=4) -> RandomHorizontalFlip -> Normalize,
fused as per-sample matrix contractions (uint8 in, normalized compute-dtype
out). Test: Resize -> Normalize. The random draws come from a
``torch.Generator``; the deterministic cores (``resize_pad_crop``,
``hflip``) take the offsets and flags explicitly, so tests can feed them the
JAX pipeline's draws. AutoAugment (``ops/autoaugment.py``) is not ported
yet (ROADMAP.md, queue A, first item).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


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


def resize_pad_random_crop(gen: torch.Generator, x, size: int, pad: int = 4):
    """``resize_pad_crop`` at offsets drawn uniformly from [0, 2*pad]."""
    b = x.shape[0]
    oy = torch.randint(0, 2 * pad + 1, (b,), generator=gen)
    ox = torch.randint(0, 2 * pad + 1, (b,), generator=gen)
    return resize_pad_crop(x, size, oy, ox, pad)


def hflip(x, flags):
    """Flip the samples whose flag is set along W."""
    flags = flags.to(x.device, non_blocking=True)
    return torch.where(flags[:, None, None, None], x.flip(2), x)


def random_hflip(gen: torch.Generator, x, p: float = 0.5):
    return hflip(x, torch.rand(x.shape[0], generator=gen) < p)


def make_train_pipeline(img_size: int, mean: Tuple[float, ...],
                        std: Tuple[float, ...], *, use_autoaug: bool = False,
                        out_dtype=torch.bfloat16):
    """fn(gen, uint8 images (B,H,W,C) on the device) -> normalized batch."""
    if use_autoaug:
        raise NotImplementedError(
            "AutoAugment (ops/autoaugment.py) is not ported yet; run without "
            "'autoaug' in --transforms (ROADMAP.md, queue A, first item)")

    def pipeline(gen, images_u8):
        x = images_u8.float() / 255.0
        x = resize_pad_random_crop(gen, x, img_size, pad=4)
        x = random_hflip(gen, x)
        return normalize(x, mean, std).to(out_dtype)

    return pipeline


def make_eval_pipeline(img_size: int, mean: Tuple[float, ...],
                       std: Tuple[float, ...], out_dtype=torch.bfloat16):
    def pipeline(images_u8):
        x = images_u8.float() / 255.0
        x = resize_bilinear(x, img_size)
        return normalize(x, mean, std).to(out_dtype)

    return pipeline
