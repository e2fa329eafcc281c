"""Si-Blurry online task stream construction.

Pure-function reimplementation of the protocol defined by the reference's
``OnlineSampler`` (``utils/online_sampler.py:9-249``): classes split into
N% disjoint / (100-N)% blurry, M% of blurry-class samples shuffled across
task boundaries, per-task index order shuffled. ``varing_NM`` draws random
per-task class/blur boundaries (``:114-203``).

Protocol-parity note (SURVEY §7 hard-part 7): the reference consumes a
``torch.Generator`` (Philox) stream for every randperm/randint. We use the
same torch CPU generator for these host-side index draws — torch here is a
seeded-RNG library only, nothing touches the compute path — so a given
``rnd_seed`` produces the *identical* sample stream as the reference.
Everything downstream (batching, device upload) is numpy/torch.

Unlike the reference, the result is an immutable ``TaskStream`` value
(per-task numpy index arrays + class metadata) rather than a stateful
Sampler bound to a DataLoader.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskStream:
    """The full pre-drawn online stream: one index array per task."""
    task_indices: List[np.ndarray]        # sample indices into the dataset
    disjoint_classes: List[List[int]]     # per-task disjoint class ids
    blurry_classes: List[List[int]]       # per-task blurry class ids
    n_classes: int

    @property
    def n_tasks(self) -> int:
        return len(self.task_indices)

    def samples_in_task(self, t: int) -> int:
        return len(self.task_indices[t])


def _torch_gen(seed: int):
    import torch
    return torch, torch.Generator().manual_seed(seed)


def si_blurry_stream(targets: Sequence[int],
                     n_classes: int,
                     n_tasks: int,
                     n: int,
                     m: int,
                     rnd_seed: int,
                     varing_NM: bool = False) -> TaskStream:
    """Draw the Si-Blurry stream for a dataset's targets.

    Parity with reference ``OnlineSampler.__init__``: fixed split keeps
    class order sequential (``online_sampler.py:58`` — the reference
    comments out the randperm), varing_NM permutes classes and draws
    randint split boundaries.
    """
    torch, gen = _torch_gen(rnd_seed)
    targets = np.asarray(targets)

    disjoint_num = (n_classes * n // 100) // n_tasks * n_tasks
    blurry_num = (n_classes - disjoint_num) // n_tasks * n_tasks

    if not varing_NM:
        class_order = np.arange(n_classes)
        disjoint_classes = class_order[:disjoint_num].reshape(
            n_tasks, -1).tolist() if disjoint_num else \
            [[] for _ in range(n_tasks)]
        blurry_classes = class_order[
            disjoint_num:disjoint_num + blurry_num].reshape(
                n_tasks, -1).tolist() if blurry_num else \
            [[] for _ in range(n_tasks)]
    else:
        class_order = torch.randperm(n_classes, generator=gen).numpy()
        if disjoint_num > 0:
            cuts = ([0] + sorted(torch.randint(
                0, disjoint_num, (n_tasks - 1,),
                generator=gen).tolist()) + [disjoint_num])
            disjoint_classes = [
                class_order[cuts[i]:cuts[i + 1]].tolist()
                for i in range(n_tasks)]
        else:
            disjoint_classes = [[] for _ in range(n_tasks)]
        if blurry_num > 0:
            cuts = ([0] + sorted(torch.randint(
                0, blurry_num, (n_tasks - 1,),
                generator=gen).tolist()) + [blurry_num])
            blurry_classes = [
                class_order[disjoint_num + cuts[i]:
                            disjoint_num + cuts[i + 1]].tolist()
                for i in range(n_tasks)]
        else:
            blurry_classes = [[] for _ in range(n_tasks)]

    # assign each sample index to its task bucket (first matching task)
    disjoint_sets = [set(c) for c in disjoint_classes]
    blurry_sets = [set(c) for c in blurry_classes]
    disjoint_indices: List[List[int]] = [[] for _ in range(n_tasks)]
    blurry_indices: List[List[int]] = [[] for _ in range(n_tasks)]
    total_blurred = 0
    for i, y in enumerate(targets):
        for j in range(n_tasks):
            if y in disjoint_sets[j]:
                disjoint_indices[j].append(i)
                break
            if y in blurry_sets[j]:
                blurry_indices[j].append(i)
                total_blurred += 1
                break

    # move M% of blurry samples across tasks
    blurred: List[int] = []
    if not varing_NM:
        for j in range(n_tasks):
            cut = len(blurry_indices[j]) * m // 100
            blurred += blurry_indices[j][:cut]
            blurry_indices[j] = blurry_indices[j][cut:]
        if blurred:
            perm = torch.randperm(len(blurred), generator=gen).numpy()
            blurred = [blurred[p] for p in perm]
        per_task = len(blurred) // n_tasks
        for j in range(n_tasks):
            blurry_indices[j] += blurred[:per_task]
            blurred = blurred[per_task:]
    else:
        num_blurred = total_blurred * m // 100
        if num_blurred > 0:
            cuts = ([0] + sorted(torch.randint(
                0, num_blurred, (n_tasks - 1,),
                generator=gen).tolist()) + [num_blurred])
            for j in range(n_tasks):
                take = cuts[j + 1] - cuts[j]
                blurred += blurry_indices[j][:take]
                blurry_indices[j] = blurry_indices[j][take:]
            perm = torch.randperm(len(blurred), generator=gen).numpy()
            blurred = [blurred[p] for p in perm]
            for j in range(n_tasks):
                take = cuts[j + 1] - cuts[j]
                blurry_indices[j] += blurred[:take]
                blurred = blurred[take:]

    task_indices = []
    for j in range(n_tasks):
        idx = np.asarray(disjoint_indices[j] + blurry_indices[j],
                         dtype=np.int64)
        perm = torch.randperm(len(idx), generator=gen).numpy()
        task_indices.append(idx[perm])

    return TaskStream(task_indices=task_indices,
                      disjoint_classes=[list(map(int, c))
                                        for c in disjoint_classes],
                      blurry_classes=[list(map(int, c))
                                      for c in blurry_classes],
                      n_classes=n_classes)


def iter_batches(indices: np.ndarray,
                 batch_size: int,
                 *,
                 drop_last: bool = False):
    """Yield consecutive batches of dataset indices from a task stream."""
    n = len(indices)
    end = (n // batch_size) * batch_size if drop_last else n
    for lo in range(0, end, batch_size):
        yield indices[lo:lo + batch_size]


def exposed_test_indices(targets: Sequence[int],
                             exposed: Sequence[int]) -> np.ndarray:
    """Test-set filter to exposed classes (reference OnlineTestSampler,
    utils/online_sampler.py:482-535)."""
    targets = np.asarray(targets)
    mask = np.isin(targets, np.asarray(list(exposed)))
    return np.nonzero(mask)[0]


def stream_class_histogram(stream: TaskStream,
                           targets: Sequence[int]) -> np.ndarray:
    """(n_tasks, n_classes) sample counts per task — the reference's
    train_data_config dump (methods/_trainer.py:576-633)."""
    targets = np.asarray(targets)
    out = np.zeros((stream.n_tasks, stream.n_classes), np.int64)
    for t, idx in enumerate(stream.task_indices):
        out[t] = np.bincount(targets[idx], minlength=stream.n_classes)
    return out
