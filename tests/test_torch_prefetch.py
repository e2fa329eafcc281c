"""The port's batch prefetcher (``data/prefetch.py``): stream order and
content, error propagation and lookahead bound on the CPU (as
``tests/test_checkpoint_obs.py`` holds the JAX one), the padding of batches
it leaves on the device, and its upload through pinned memory on the card
(marker ``cuda``)."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import threading
import time

import numpy as np
import pytest
import torch

from lifelong_clip_tpu_torch.data.prefetch import BatchPrefetcher, DeviceUpload
from lifelong_clip_tpu_torch.data.registry import make_synthetic
from lifelong_clip_tpu_torch.methods.base import pad_batch
from lifelong_clip_tpu_torch.utils.stream import iter_batches


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_classes=4, per_class=8, image_size=8, seed=0)


def test_batch_prefetcher_order_and_content(data):
    idx = np.arange(20)
    seen = list(BatchPrefetcher(iter_batches(idx, 8), data.gather, depth=2))
    assert [len(b[0]) for b in seen] == [8, 8, 4]
    np.testing.assert_array_equal(np.concatenate([b[0] for b in seen]), idx)
    for bidx, images, labels in seen:
        np.testing.assert_array_equal(labels, data.targets[bidx])
        np.testing.assert_array_equal(images, data.images[bidx])


def test_batch_prefetcher_propagates_errors():
    def bad_gather(idx):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(BatchPrefetcher([np.arange(4)], bad_gather))

    def late_error(idx):
        if idx[0] >= 8:
            raise ValueError("late")
        return idx, idx

    got = []
    with pytest.raises(ValueError, match="late"):
        for b in BatchPrefetcher(iter_batches(np.arange(16), 4), late_error):
            got.append(b[0])
    assert len(got) == 2      # the batches before the failing one arrive


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_batch_prefetcher_runs_at_most_depth_ahead(depth):
    """While the consumer holds batch k, at most k + ``depth`` batches have
    been gathered, and the worker does reach that bound (it looks ahead)."""
    lock = threading.Lock()
    gathered = [0]

    def gather(idx):
        with lock:
            gathered[0] += 1
        return idx, idx

    reached = False
    deadline = time.monotonic() + 30
    for k, _ in enumerate(BatchPrefetcher(iter_batches(np.arange(40), 4),
                                          gather, depth=depth), start=1):
        # give the worker time to run as far ahead as it may
        while gathered[0] < min(k + depth, 10) and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.01)
        with lock:
            assert gathered[0] <= k + depth, (k, gathered[0])
            reached |= gathered[0] == k + depth
    assert reached


def test_consumer_leaving_early_stops_the_worker():
    pf = BatchPrefetcher(iter_batches(np.arange(400), 4),
                         lambda i: (i, i), depth=2)
    for _ in pf:
        break
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


def test_pad_batch_pads_device_tensors_like_host_arrays(data):
    images, labels = data.gather(np.arange(5))
    want, want_labels, n = pad_batch(images, labels, 8)
    got, got_labels, m = pad_batch(torch.from_numpy(images), labels, 8)
    assert isinstance(got, torch.Tensor) and n == m == 5
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_labels, want_labels)


@pytest.mark.cuda
def test_device_upload_lands_each_batch_on_the_card(data):
    """Through pinned buffers and a side stream: every batch arrives whole
    and in order, with more batches than buffers (the ring is reused)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    place = DeviceUpload(dev)
    seen = list(BatchPrefetcher(iter_batches(np.arange(32), 4), data.gather,
                                place=place, depth=1))
    assert len(seen) == 8
    for bidx, images, labels in seen:
        assert images.device.type == "cuda"
        torch.testing.assert_close(images.cpu(),
                                   torch.from_numpy(data.images[bidx]))


@pytest.mark.cuda
def test_device_upload_of_a_ranks_rows(data):
    """Under a data-parallel mesh the batch goes up whole, as without one,
    and the step takes a view of the rank's rows on the card; a short tail
    batch goes up whole too, to be padded there before it is cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from lifelong_clip_tpu_torch.parallel.mesh import Mesh, local_rows
    dp = Mesh.__new__(Mesh)     # rank 1 of a data axis of 2, no group
    dp.shape, dp.data_rank = {"data": 2, "model": 1}, 1
    place = DeviceUpload(torch.device("cuda"))
    seen = list(BatchPrefetcher(iter_batches(np.arange(10), 4), data.gather,
                                place=place, depth=1))
    for bidx, images, _ in seen[:2]:
        rows = local_rows(images, dp)
        assert rows.device.type == "cuda" and len(rows) == 2
        assert rows.data_ptr() == images[2:].data_ptr()
        torch.testing.assert_close(rows.cpu(),
                                   torch.from_numpy(data.images[bidx[2:]]))
    tail = seen[2][1]
    assert tail.device.type == "cuda" and len(tail) == 2
