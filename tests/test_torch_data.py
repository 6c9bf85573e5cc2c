"""The port's datasets against the JAX package's: byte-equal arrays from
the same seeds, the same splits and the same batch order."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from distributed_machine_learning_tpu.data import (  # noqa: E402
    Dataset as JaxDataset,
    dummy_regression_data as jax_dummy,
    glucose_like_data as jax_glucose,
    split_into_intervals as jax_split_into_intervals,
    train_val_split as jax_train_val_split,
)
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    Dataset,
    dummy_regression_data,
    glucose_like_data,
    split_into_intervals,
    train_val_split,
)


def _assert_same(port_pair, jax_pair):
    for ours, theirs in zip(port_pair, jax_pair):
        for a, b in ((ours.x, theirs.x), (ours.y, theirs.y)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(num_samples=80, seq_len=24,
                                             num_features=16, seed=3)])
def test_dummy_regression_data_is_byte_equal(kw):
    _assert_same(dummy_regression_data(**kw), jax_dummy(**kw))


def test_glucose_like_data_is_byte_equal():
    kw = dict(num_steps=3000, num_features=6, interval=48, stride=24)
    _assert_same(glucose_like_data(**kw), jax_glucose(**kw))


@pytest.mark.parametrize("shuffle", [True, False])
def test_train_val_split_is_byte_equal(shuffle):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 5, 3)).astype(np.float32)
    y = rng.normal(size=(37, 1)).astype(np.float32)
    _assert_same(train_val_split(x, y, 0.3, seed=5, shuffle=shuffle),
                 jax_train_val_split(x, y, 0.3, seed=5, shuffle=shuffle))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_split_into_intervals_matches(dtype):
    a = np.arange(60, dtype=dtype).reshape(20, 3)
    for interval, stride in ((4, 4), (5, 2), (20, 1), (21, 1)):
        got = split_into_intervals(a, interval, stride)
        want = jax_split_into_intervals(a, interval, stride)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,batch,with_mask,drop", [
    (23, 5, False, True), (23, 5, True, False), (3, 8, False, True)])
def test_dataset_batches_match(n, batch, with_mask, drop):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    kw = dict(seed_parts=(7, "epoch", 2), with_mask=with_mask,
              drop_remainder=drop)
    ours = list(Dataset(x, y).batches(batch, **kw))
    theirs = list(JaxDataset(x, y).batches(batch, **kw))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert u.tobytes() == v.tobytes()
    assert (Dataset(x, y).num_batches(batch, drop)
            == JaxDataset(x, y).num_batches(batch, drop))
