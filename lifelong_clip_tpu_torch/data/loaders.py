"""Native dataset file parsers (no torchvision dependency).

The reference leans on torchvision dataset classes
(``datasets/CIFAR.py`` etc.); this environment ships no torchvision, so
the standard on-disk formats are parsed directly:

  * CIFAR-10/100 — python pickled batches (``cifar-10-batches-py/``,
    ``cifar-100-python/``)
  * MNIST / FashionMNIST — idx ubyte files (optionally gzipped)
  * SVHN — ``{train,test}_32x32.mat`` via scipy.io
  * generic image folders — ``<root>/<name>/<train|test|val>/<class>/*``
    decoded with PIL when available

All loaders return (uint8 images NHWC, int64 targets, class names).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import List, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, List[str]]


def _missing(what: str, path: str):
    return FileNotFoundError(
        f"{what} not found under {path!r}. This environment has no network "
        f"egress — place the dataset files there, or pass "
        f"--synthetic_fallback for a synthetic stand-in.")


def load_cifar(data_dir: str, key: str, train: bool) -> Arrays:
    if key == "cifar10":
        base = os.path.join(data_dir, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train \
            else ["test_batch"]
        meta_file, names_key, label_key = "batches.meta", b"label_names", \
            b"labels"
    else:
        base = os.path.join(data_dir, "cifar-100-python")
        files = ["train"] if train else ["test"]
        meta_file, names_key, label_key = "meta", b"fine_label_names", \
            b"fine_labels"
    if not os.path.isdir(base):
        raise _missing(key, base)

    imgs, targets = [], []
    for f in files:
        with open(os.path.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        imgs.append(d[b"data"])
        targets.extend(d[label_key])
    data = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    with open(os.path.join(base, meta_file), "rb") as fh:
        meta = pickle.load(fh, encoding="bytes")
    names = [n.decode() for n in meta[names_key]]
    return (np.ascontiguousarray(data, np.uint8),
            np.asarray(targets, np.int64), names)


_FASHION_NAMES = ["T-shirt/top", "Trouser", "Pullover", "Dress", "Coat",
                  "Sandal", "Shirt", "Sneaker", "Bag", "Ankle boot"]


def _read_idx(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_mnist_idx(data_dir: str, key: str, train: bool) -> Arrays:
    sub = "MNIST" if key == "mnist" else "FashionMNIST"
    split = "train" if train else "t10k"
    candidates = [os.path.join(data_dir, sub, "raw"),
                  os.path.join(data_dir, sub), data_dir]
    base = next((c for c in candidates
                 if os.path.exists(os.path.join(
                     c, f"{split}-images-idx3-ubyte")) or
                 os.path.exists(os.path.join(
                     c, f"{split}-images-idx3-ubyte.gz"))), None)
    if base is None:
        raise _missing(key, os.path.join(data_dir, sub))

    def find(stem):
        for ext in ("", ".gz"):
            p = os.path.join(base, stem + ext)
            if os.path.exists(p):
                return p
        raise _missing(stem, base)

    imgs = _read_idx(find(f"{split}-images-idx3-ubyte"))
    labels = _read_idx(find(f"{split}-labels-idx1-ubyte"))
    imgs = np.repeat(imgs[..., None], 3, axis=-1)  # grayscale -> 3ch
    names = ([str(i) for i in range(10)] if key == "mnist"
             else _FASHION_NAMES)
    return imgs, labels.astype(np.int64), names


def load_svhn(data_dir: str, train: bool) -> Arrays:
    from scipy.io import loadmat
    fname = ("train" if train else "test") + "_32x32.mat"
    for base in (os.path.join(data_dir, "svhn"), data_dir):
        p = os.path.join(base, fname)
        if os.path.exists(p):
            mat = loadmat(p)
            imgs = mat["X"].transpose(3, 0, 1, 2)
            labels = mat["y"].ravel().astype(np.int64) % 10  # '10' -> 0
            return (np.ascontiguousarray(imgs, np.uint8), labels,
                    [str(i) for i in range(10)])
    raise _missing("svhn", data_dir)


def load_image_folder(data_dir: str, key: str, train: bool,
                      image_size: int = 224) -> Arrays:
    """Generic <root>/<key>/<split>/<class>/*.{jpg,png} layout."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise _missing(f"{key} (needs PIL for folder decode)",
                       data_dir) from e
    for split in (("train",) if train else ("test", "val")):
        base = os.path.join(data_dir, key, split)
        if os.path.isdir(base):
            break
    else:
        raise _missing(key, os.path.join(data_dir, key))
    classes = sorted(d for d in os.listdir(base)
                     if os.path.isdir(os.path.join(base, d)))
    imgs, targets = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(base, cname)
        for f in sorted(os.listdir(cdir)):
            if not f.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            with Image.open(os.path.join(cdir, f)) as im:
                im = im.convert("RGB").resize((image_size, image_size))
                imgs.append(np.asarray(im, np.uint8))
            targets.append(ci)
    if not imgs:
        raise _missing(key, base)
    return (np.stack(imgs), np.asarray(targets, np.int64),
            [c.replace("_", " ") for c in classes])


def load_imagenet_r(data_dir: str, train: bool,
                    image_size: int = 224) -> Arrays:
    """ImageNet-R with the reference's deterministic 80/20 split
    (``datasets/Imagenet_R.py:52-77``: seed-0 torch randperm over samples,
    sorted index lists) and its 200-class wordnet name table (shipped as
    ``assets/imagenet_r_classes.json``). Expects the extracted
    ``imagenet-r/<wnid>/*.jpg`` layout."""
    import json
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise _missing("imagenet-r (needs PIL)", data_dir) from e
    base = os.path.join(data_dir, "imagenet-r")
    if not os.path.isdir(base):
        raise _missing("imagenet-r", base)
    names_path = os.path.join(os.path.dirname(__file__), "..", "assets",
                              "imagenet_r_classes.json")
    class_names = [n.replace("_", " ")
                   for n in json.load(open(names_path))]

    wnids = sorted(d for d in os.listdir(base)
                   if os.path.isdir(os.path.join(base, d)))
    samples = []
    for ci, wnid in enumerate(wnids):
        cdir = os.path.join(base, wnid)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                samples.append((os.path.join(cdir, f), ci))

    # protocol split: torch randperm(seed 0), 80% train, sorted
    import torch
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(len(samples), generator=gen)
    len_train = int(len(samples) * 0.8)
    keep = sorted(perm[:len_train].tolist()) if train else \
        sorted(perm[len_train:].tolist())

    imgs, targets = [], []
    for i in keep:
        path, ci = samples[i]
        with Image.open(path) as im:
            im = im.convert("RGB").resize((image_size, image_size))
            imgs.append(np.asarray(im, np.uint8))
        targets.append(ci)
    return (np.stack(imgs), np.asarray(targets, np.int64), class_names)


def load_tinyimagenet(data_dir: str, train: bool) -> Arrays:
    """TinyImageNet (reference datasets/TinyImageNet.py layout):
    train/<wnid>/images/*.JPEG, val/images + val_annotations.txt."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise _missing("tinyimagenet (needs PIL)", data_dir) from e
    base = os.path.join(data_dir, "tiny-imagenet-200")
    if not os.path.isdir(base):
        raise _missing("tinyimagenet", base)
    wnids = sorted(open(os.path.join(base, "wnids.txt"))
                   .read().split())
    wnid_to_idx = {w: i for i, w in enumerate(wnids)}
    names = {}
    words = os.path.join(base, "words.txt")
    if os.path.exists(words):
        for line in open(words):
            parts = line.strip().split("\t")
            if len(parts) == 2:
                names[parts[0]] = parts[1].split(",")[0]
    class_names = [names.get(w, w) for w in wnids]

    imgs, targets = [], []
    if train:
        for w in wnids:
            d = os.path.join(base, "train", w, "images")
            for f in sorted(os.listdir(d)):
                with Image.open(os.path.join(d, f)) as im:
                    imgs.append(np.asarray(im.convert("RGB"), np.uint8))
                targets.append(wnid_to_idx[w])
    else:
        ann = os.path.join(base, "val", "val_annotations.txt")
        for line in open(ann):
            parts = line.strip().split("\t")
            fname, w = parts[0], parts[1]
            p = os.path.join(base, "val", "images", fname)
            with Image.open(p) as im:
                imgs.append(np.asarray(im.convert("RGB"), np.uint8))
            targets.append(wnid_to_idx[w])
    return (np.stack(imgs), np.asarray(targets, np.int64), class_names)
