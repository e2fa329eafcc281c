"""Dataset registry: name -> (loader, mean, std, n_classes, class names).

Counterpart of reference ``datasets/__init__.py:35-58`` (15 datasets).
Datasets parse from their standard on-disk formats via native loaders
(``data/loaders.py`` — no torchvision in this environment, no downloads);
a deterministic ``synthetic`` dataset family exists for tests/benchmarks
and as a stand-in when real data is absent.

Datasets are materialized as uint8 numpy arrays (images HWC) + int64
targets: the online stream addresses samples by index, and the fused
device pipeline (ops/preprocess.py) consumes raw uint8 — so there is no
per-sample Python transform stack like the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# torchvision statistics used by the reference (datasets/__init__.py)
_STATS = {
    "mnist": ((0.1307,) * 3, (0.3081,) * 3, 10),
    "fashionmnist": ((0.286,) * 3, (0.3205,) * 3, 10),
    "svhn": ((0.4377, 0.4438, 0.4728), (0.1980, 0.2010, 0.1970), 10),
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2615), 10),
    "cifar100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762), 100),
    "tinyimagenet": ((0.4802, 0.4481, 0.3975), (0.2770, 0.2691, 0.2821),
                     200),
    "imagenet-r": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 200),
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 1000),
    "eurosat": ((0.3444, 0.3803, 0.4078), (0.2037, 0.1366, 0.1148), 10),
    "food101": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 101),
    "flowers102": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 102),
    "caltech101": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 101),
    "oxford_pet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 37),
    "stanfordcars": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 196),
    "cub200": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 200),
    "notmnist": ((0.4254,) * 3, (0.4586,) * 3, 10),
}


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: uint8 images (N, H, W, C) + int targets."""
    images: np.ndarray
    targets: np.ndarray
    class_names: List[str]
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    name: str = ""

    def __len__(self):
        return len(self.targets)

    @property
    def n_classes(self) -> int:
        return len(self.class_names)

    def gather(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.images[indices], self.targets[indices]


def dataset_stats(name: str):
    key = name.lower()
    if key.startswith("synthetic"):
        n_cls, _ = _parse_synthetic_spec(key)
        return (0.5, 0.5, 0.5), (0.25, 0.25, 0.25), n_cls
    if key not in _STATS:
        raise KeyError(f"unknown dataset {name!r}; known: {list(_STATS)}")
    return _STATS[key]


def _parse_synthetic_spec(key: str):
    """``synthetic[-C[xP]]`` -> (n_classes, per_class or None).

    ``synthetic-20`` = 20 classes at the default per-class count;
    ``synthetic-10x8`` = 10 classes, 8 samples each (tiny smoke runs).
    """
    if "-" not in key:
        return 20, None
    spec = key.split("-", 1)[1]
    if "x" in spec:
        c, p = spec.split("x", 1)
        return int(c), int(p)
    return int(spec), None


def make_synthetic(n_classes: int = 20,
                   per_class: int = 50,
                   image_size: int = 32,
                   seed: int = 0,
                   train: bool = True,
                   name: str = "synthetic") -> ArrayDataset:
    """Deterministic class-structured random images.

    Each class has a distinct mean color + frequency pattern so a model can
    actually fit it — useful for end-to-end smoke runs mirroring the
    reference's --debug mode (methods/_trainer.py:343-344).
    """
    rng = np.random.default_rng(seed + (0 if train else 10_000))
    n = n_classes * per_class
    targets = np.repeat(np.arange(n_classes), per_class)
    yy, xx = np.mgrid[0:image_size, 0:image_size] / image_size
    imgs = np.empty((n, image_size, image_size, 3), np.uint8)
    for c in range(n_classes):
        base = np.stack([
            np.sin(2 * np.pi * ((c % 7) + 1) * xx),
            np.cos(2 * np.pi * ((c % 5) + 1) * yy),
            np.sin(2 * np.pi * ((c % 3) + 1) * (xx + yy)),
        ], axis=-1)
        base = (base * 0.4 + 0.5) * 255
        lo, hi = c * per_class, (c + 1) * per_class
        noise = rng.normal(0, 25, (per_class, image_size, image_size, 3))
        imgs[lo:hi] = np.clip(base[None] + noise, 0, 255).astype(np.uint8)
    perm = rng.permutation(n)
    return ArrayDataset(images=imgs[perm], targets=targets[perm],
                        class_names=[f"pattern {i}" for i in
                                     range(n_classes)],
                        mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25),
                        name=name)


def _load_native(name: str, data_dir: str, train: bool) -> ArrayDataset:
    """Native file-format parsers (this environment has no torchvision):
    CIFAR pickled batches, MNIST-family idx files, SVHN .mat, and a
    generic image-folder layout for the larger datasets. Files must already
    exist on disk (zero-egress: no downloads)."""
    mean, std, _ = dataset_stats(name)
    key = name.lower()
    from . import loaders
    if key in ("cifar10", "cifar100"):
        imgs, targets, names = loaders.load_cifar(data_dir, key, train)
    elif key in ("mnist", "fashionmnist"):
        imgs, targets, names = loaders.load_mnist_idx(data_dir, key, train)
    elif key == "svhn":
        imgs, targets, names = loaders.load_svhn(data_dir, train)
    elif key == "imagenet-r":
        imgs, targets, names = loaders.load_imagenet_r(data_dir, train)
    elif key == "tinyimagenet":
        imgs, targets, names = loaders.load_tinyimagenet(data_dir, train)
    else:
        imgs, targets, names = loaders.load_image_folder(data_dir, key,
                                                         train)
    return ArrayDataset(images=imgs, targets=targets,
                        class_names=names, mean=mean, std=std, name=key)


def get_dataset(name: str,
                data_dir: str = "./data",
                train: bool = True,
                synthetic_fallback: bool = False) -> ArrayDataset:
    """Load a dataset by registry name.

    ``synthetic_fallback=True`` substitutes a synthetic dataset with the
    same class count when real data is unavailable (keeps smoke runs and
    benchmarks executable in this zero-egress environment).
    """
    key = name.lower()
    if key.startswith("multi:"):
        return get_multi_dataset(key, data_dir, train=train,
                                 synthetic_fallback=synthetic_fallback)
    if key.startswith("synthetic"):
        n_cls, per_class = _parse_synthetic_spec(key)
        kw = {} if per_class is None else {"per_class": per_class}
        return make_synthetic(n_classes=n_cls, train=train, name=key, **kw)
    try:
        return _load_native(key, data_dir, train)
    except Exception:
        if not synthetic_fallback:
            raise
        mean, std, n_cls = dataset_stats(key)
        ds = make_synthetic(n_classes=n_cls, train=train,
                            name=f"synthetic:{key}")
        return dataclasses.replace(ds, mean=mean, std=std)


def _resize_nearest(imgs: np.ndarray, size: int) -> np.ndarray:
    """Host-side nearest-neighbor resize for dataset materialization."""
    n, h, w, c = imgs.shape
    if h == size and w == size:
        return imgs
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return imgs[:, ys][:, :, xs]


def combine_datasets(datasets, image_size: int = None,
                     name: str = "multi") -> ArrayDataset:
    """Concatenate datasets with label offsetting — the cross-domain
    multiDatasets stream (reference datasets/multiDatasets.py:9-51)."""
    image_size = image_size or max(d.images.shape[1] for d in datasets)
    images, targets, names = [], [], []
    offset = 0
    for d in datasets:
        images.append(_resize_nearest(d.images, image_size))
        targets.append(d.targets + offset)
        names.extend(f"{d.name}:{c}" if d.name else str(c)
                     for c in d.class_names)
        offset += d.n_classes
    return ArrayDataset(images=np.concatenate(images),
                        targets=np.concatenate(targets),
                        class_names=names,
                        mean=datasets[0].mean, std=datasets[0].std,
                        name=name)


def get_multi_dataset(spec: str, data_dir: str = "./data",
                      train: bool = True,
                      synthetic_fallback: bool = False) -> ArrayDataset:
    """'multi:cub200+stanfordcars+food101' -> combined offset-label stream."""
    parts = spec.split(":", 1)[1].split("+")
    ds = [get_dataset(p, data_dir, train=train,
                      synthetic_fallback=synthetic_fallback)
          for p in parts]
    return combine_datasets(ds, name=spec)
