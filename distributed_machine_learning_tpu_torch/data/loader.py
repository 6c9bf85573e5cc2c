"""Data pipeline: .npy DataFrame loading, windowing, splits, batches.

Port of ``distributed_machine_learning_tpu/data/loader.py``:

* ``load_dataframe_from_npy``: a pickled ``{"columns": ..., "data": ...}``
  dict in a ``.npy`` file -> DataFrame (the reference project's
  ``ray-tune-hpo-regression.py:414-418``);
* ``split_into_intervals``: strided sliding windows, through the native
  C++ kernel for float32 (``data/native.py``), numpy strides otherwise;
* ``make_regression_dataset`` / ``get_dataset``: the reference's
  ``get_data_loaders`` pipeline (``:423-459``): feature selection with
  schema auto-detection, column dedup, label extraction, windowing
  (interval 96, stride 96), a deterministic 70/30 split;
* ``Dataset``: an ndarray pair with seeded batches (the native splitmix64
  Fisher-Yates shuffle and gather, the JAX package's batch order), staged
  onto a device by ``as_torch`` (with the budget check the JAX ``as_jax``
  makes under ``enforce_budget=True``);
* the windowed-array disk cache (``$DML_DATASET_CACHE_DIR``): the
  windowed ``.npy`` payloads published as content-store blobs under
  ``<cache_dir>/.cas`` behind a ``dataset-win-<key>`` ref (the JAX
  package's store variant; ``DML_STORE_CKPT=0`` turns it off), else flat
  ``win_<key>_{x,y}.npy`` files, reopened with ``mmap_mode="r"`` either
  way and counted in :func:`dataset_cache_counters` (the ``host_input``
  counters of ``data/pipeline.py``).

Every array equals the JAX package's byte for byte on the same inputs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from distributed_machine_learning_tpu_torch.data import features as F
from distributed_machine_learning_tpu_torch.data import native
from distributed_machine_learning_tpu_torch.utils.seeding import (
    fold_seed,
    rng_from,
)

def load_dataframe_from_npy(path: str):
    """Load a DataFrame stored as a pickled {columns, data} dict in .npy."""
    import pandas as pd

    payload = np.load(path, allow_pickle=True).item()
    return pd.DataFrame(payload["data"], columns=payload["columns"])


def split_into_intervals(
    array: np.ndarray, interval: int, stride: int
) -> np.ndarray:
    """[T, F] -> [num_intervals, interval, F] with the given stride: the
    native kernel for float32, numpy strides for other dtypes."""
    if array.ndim == 1:
        array = array[:, None]
    T = array.shape[0]
    if T < interval:
        return np.empty((0, interval, array.shape[1]), dtype=array.dtype)
    if array.dtype == np.float32:
        return native.window(array, interval, stride)
    windows = np.lib.stride_tricks.sliding_window_view(array, interval, axis=0)
    # sliding_window_view gives [T-interval+1, F, interval]; stride + reorder.
    return np.ascontiguousarray(np.transpose(windows[::stride], (0, 2, 1)))


@dataclass
class Dataset:
    """A fully materialized (x, y) array pair with seeded batch iteration."""

    x: np.ndarray
    y: np.ndarray

    def __post_init__(self):
        if len(self.x) != len(self.y):
            raise ValueError(f"x/y length mismatch: {len(self.x)} vs {len(self.y)}")

    def __len__(self) -> int:
        return len(self.x)

    @property
    def num_features(self) -> int:
        return int(self.x.shape[-1])

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed_parts: Sequence = (0,),
        drop_remainder: bool = True,
        with_mask: bool = False,
    ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield (x, y) batches of a static shape, in the order of the
        native splitmix64 shuffle of ``fold_seed(*seed_parts)``.

        A dataset smaller than ``batch_size`` yields ONE batch zero-padded
        to ``batch_size``.  ``with_mask=True`` yields ``(x, y, mask)``
        (``mask`` float32, 1.0 for real rows) and also pads the final
        ragged batch under ``drop_remainder=False``.
        """
        n = len(self)
        idx = (native.shuffled_indices(n, fold_seed(*seed_parts)) if shuffle
               else np.arange(n))
        end = (n // batch_size) * batch_size if drop_remainder else n
        if end == 0:
            end = n  # tiny dataset: one batch, PADDED to batch_size below
        if self.x.dtype == np.float32 and self.y.dtype == np.float32:
            take = native.gather
        else:
            take = lambda a, sel: a[sel]  # noqa: E731
        for start in range(0, end, batch_size):
            sel = idx[start : start + batch_size]
            bx, by = take(self.x, sel), take(self.y, sel)
            short = batch_size - len(sel)
            if short > 0 and (start == 0 or with_mask):
                bx = np.concatenate(
                    [bx, np.zeros((short, *bx.shape[1:]), bx.dtype)]
                )
                by = np.concatenate(
                    [by, np.zeros((short, *by.shape[1:]), by.dtype)]
                )
            if with_mask:
                mask = np.ones(len(bx), np.float32)
                if short > 0:
                    mask[len(sel):] = 0.0
                yield bx, by, mask
            else:
                yield bx, by

    def num_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        n = len(self)
        return max(n // batch_size if drop_remainder else -(-n // batch_size), 1)

    def as_torch(self, device=None, enforce_budget: bool = False):
        """Both arrays staged onto ``device`` (the current card when None)
        once, as tensors: the counterpart of the JAX ``as_jax``.

        ``enforce_budget=True`` first checks their bytes against the
        device's budget (``data/pipeline.py::device_budget_bytes``, the
        virtual ``DML_CPU_DEVICE_BUDGET_BYTES`` one on the CPU) and raises
        ``ResidentOverBudgetError`` before anything is allocated; the
        out-of-core alternative is ``input_mode="streaming"``."""
        import torch

        from distributed_machine_learning_tpu_torch.utils.device import (
            resolve_device,
        )

        device = resolve_device("cuda" if device is None else device)
        if enforce_budget:
            from distributed_machine_learning_tpu_torch.data.pipeline import (
                check_resident_budget,
            )

            check_resident_budget(
                int(self.x.nbytes) + int(self.y.nbytes), device,
                what="Dataset.as_torch",
            )
        return (torch.as_tensor(np.asarray(self.x)).to(device),
                torch.as_tensor(np.asarray(self.y)).to(device))


def train_val_split(
    x: np.ndarray,
    y: np.ndarray,
    val_fraction: float = 0.3,
    seed: int = 42,
    shuffle: bool = True,
) -> Tuple[Dataset, Dataset]:
    """Deterministic split: the first ``round(n * val_fraction)`` rows of a
    seeded shuffle are validation."""
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        rng_from("split", seed).shuffle(idx)
    n_val = int(round(n * val_fraction))
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    return Dataset(x[train_idx], y[train_idx]), Dataset(x[val_idx], y[val_idx])


# ---------------------------------------------------------------------------
# The windowed-array disk cache, shared by trial processes on one host
# ---------------------------------------------------------------------------

CACHE_DIR_ENV_VAR = "DML_DATASET_CACHE_DIR"
_CACHE_COUNTERS = ("dataset_cache_hits", "dataset_cache_misses",
                   "dataset_cache_bytes")


def dataset_cache_counters() -> Dict[str, int]:
    """The window cache's counters in this process: hits, misses and the
    bytes served from the cache, kept in the ``host_input`` registry of
    ``data/pipeline.py`` as in the JAX package."""
    from distributed_machine_learning_tpu_torch.data.pipeline import (
        get_host_input_counters,
    )

    counters = get_host_input_counters()
    return {name: int(counters.get(name)) for name in _CACHE_COUNTERS}


def _count(name: str, value: int = 1) -> None:
    from distributed_machine_learning_tpu_torch.data.pipeline import (
        get_host_input_counters,
    )

    get_host_input_counters().add(name, int(value))


def dataset_cache_dir(explicit: Optional[str] = None) -> Optional[str]:
    """The windowed-array cache directory: ``explicit``, else
    ``$DML_DATASET_CACHE_DIR``, else None (no cache)."""
    raw = explicit or os.environ.get(CACHE_DIR_ENV_VAR)
    return os.path.expanduser(raw) if raw else None


def _window_cache_key(
    x: np.ndarray, y: np.ndarray, interval: int, stride: int,
    standardize: bool, nan_policy: str,
) -> str:
    """Content key of one windowed build: sha256 over the source bytes
    (after feature selection, before windowing) and every parameter that
    shapes the product; the JAX package's key."""
    import hashlib

    h = hashlib.sha256()
    for arr in (np.ascontiguousarray(x), np.ascontiguousarray(y)):
        h.update(str((arr.shape, arr.dtype.str)).encode())
        h.update(arr.tobytes())
    h.update(
        f"interval={interval}/stride={stride}/standardize={standardize}"
        f"/nan={nan_policy}/v1".encode()
    )
    return h.hexdigest()[:32]


def _atomic_np_save(path: str, arr: np.ndarray) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)  # readers see whole files or nothing


def _windowed_via_store(cache_dir, key, build):
    """Content-store variant of the window cache: the ``.npy`` payloads
    are published as blobs under ``<cache_dir>/.cas`` behind a
    ``dataset-win-<key>`` ref, so identical window products dedup against
    each other (and against anything else in a shared ``$DML_STORE_ROOT``)
    and unreferenced products are swept by the same reachability GC as
    checkpoints.  Readers still mmap the blob file directly.

    Returns ``(xw, yw)``, or None when the store path is unavailable
    (store disabled, or a non-mmappable remote scheme) — the caller then
    falls back to the flat-file cache.
    """
    from distributed_machine_learning_tpu_torch import store as store_lib

    if not store_lib.store_enabled():
        return None
    cas = store_lib.get_store(
        store_lib.store_root_for(os.path.join(cache_dir, "win"))
    )
    if "://" in cas.root and not cas.root.startswith("file://"):
        return None  # mmap consumers need a real local file
    ref_name = f"dataset-win-{key}"

    def _open(mapping):
        arrays = []
        for part in ("x", "y"):
            digest = mapping.get(part)
            path = cas.local_blob_path(digest) if digest else None
            if path is None:
                return None
            try:
                arrays.append(np.load(path, mmap_mode="r"))
            except (OSError, ValueError):
                return None
        return tuple(arrays)

    doc = cas.read_ref(ref_name)
    if doc:
        manifest = cas.read_manifest(doc.get("manifest")) or {}
        got = _open(manifest.get("files") or {})
        if got is not None:
            _count("dataset_cache_hits")
            _count("dataset_cache_bytes",
                   int(got[0].nbytes) + int(got[1].nbytes))
            return got
    _count("dataset_cache_misses")
    xw, yw = build()
    try:
        import io

        with cas.pin() as pin:
            mapping = {}
            for part, arr in (("x", xw), ("y", yw)):
                buf = io.BytesIO()
                np.save(buf, np.ascontiguousarray(arr))
                digest = cas.put_blob(buf.getvalue())
                pin.add(digest)
                mapping[part] = digest
            manifest_digest = cas.put_manifest({
                "kind": "dataset-window",
                "key": key,
                "files": mapping,
                store_lib.MANIFEST_CHUNKS_KEY: sorted(set(mapping.values())),
            })
            pin.add(manifest_digest)
            cas.set_ref(ref_name, manifest_digest, meta={"key": key})
        got = _open(mapping)
        if got is not None:
            return got
    except (OSError, ValueError):
        pass  # a cache write failure must never fail a build
    return xw, yw


def _windowed_arrays(
    x: np.ndarray,
    y: np.ndarray,
    interval: int,
    stride: int,
    standardize: bool,
    nan_policy: str,
    cache_dir: Optional[str],
) -> Tuple[np.ndarray, np.ndarray]:
    """Standardize and window (the per-trial rebuild), through the disk
    cache when there is a directory: the product is stored once per
    (source sha256, interval, stride, standardize, nan_policy) — as
    content-store blobs (:func:`_windowed_via_store`), else as
    ``win_<key>_{x,y}.npy`` — and reopened with ``mmap_mode="r"``, so
    trial processes on one host share the page cache instead of
    re-windowing."""

    def build() -> Tuple[np.ndarray, np.ndarray]:
        xs = x
        if standardize:
            xs, _, _ = native.standardize(xs)
        xw = split_into_intervals(xs, interval, stride)
        yw = split_into_intervals(y, interval, stride)[:, -1, 0:1]
        return xw, yw

    if not cache_dir:
        return build()
    key = _window_cache_key(x, y, interval, stride, standardize, nan_policy)
    via_store = _windowed_via_store(cache_dir, key, build)
    if via_store is not None:
        return via_store
    os.makedirs(cache_dir, exist_ok=True)
    fx = os.path.join(cache_dir, f"win_{key}_x.npy")
    fy = os.path.join(cache_dir, f"win_{key}_y.npy")
    try:
        xw = np.load(fx, mmap_mode="r")
        yw = np.load(fy, mmap_mode="r")
        _count("dataset_cache_hits")
        _count("dataset_cache_bytes", int(xw.nbytes) + int(yw.nbytes))
        return xw, yw
    except (OSError, ValueError):
        pass  # a miss (or a torn file): rebuild and publish
    _count("dataset_cache_misses")
    xw, yw = build()
    try:
        _atomic_np_save(fx, xw)
        _atomic_np_save(fy, yw)
        return np.load(fx, mmap_mode="r"), np.load(fy, mmap_mode="r")
    except OSError:
        return xw, yw  # a failed cache write never fails a build


def make_regression_dataset(
    features_df,
    labels_df,
    feature_columns: Optional[Sequence[str]] = None,
    label_column: str = F.LABEL_COLUMN,
    interval: int = 96,
    stride: int = 96,
    val_fraction: float = 0.3,
    seed: int = 42,
    standardize: bool = False,
    nan_policy: str = "zero",
    cache_dir: Optional[str] = None,
) -> Tuple[Dataset, Dataset]:
    """The reference's ``get_data_loaders`` pipeline, DataFrame -> Datasets.

    Selects the feature columns (deduplicated), extracts the label,
    windows both with (interval, stride), labels each window with its
    last step's value and splits 70/30.  ``standardize=True`` z-scores the
    feature columns first (the native Welford kernel).  ``nan_policy``
    "zero" (default) replaces non-finite feature values with 0, "keep"
    passes them through; windows whose label is non-finite are dropped
    under either.  ``cache_dir`` (or ``$DML_DATASET_CACHE_DIR``) turns on
    the windowed-array disk cache."""
    if nan_policy not in ("zero", "keep"):
        raise ValueError(f"unknown nan_policy {nan_policy!r}")
    if feature_columns is not None:
        cols = [c for c in dict.fromkeys(feature_columns)
                if c in features_df.columns]
        features_df = features_df[cols]
    features_df = features_df.loc[:, ~features_df.columns.duplicated()]

    x = features_df.to_numpy(dtype=np.float32)
    y = labels_df[label_column].to_numpy(dtype=np.float32)
    if nan_policy == "zero":
        x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    xw, yw = _windowed_arrays(
        x, y, interval, stride, standardize, nan_policy,
        dataset_cache_dir(cache_dir),
    )
    finite = np.isfinite(yw[:, 0])
    if not finite.all():
        xw, yw = xw[finite], yw[finite]
    # The split's fancy indexing materializes in-memory arrays from a
    # cache hit's mmap views.
    return train_val_split(xw, yw, val_fraction=val_fraction, seed=seed)


def get_dataset(
    patient_id: str,
    data_dir: str,
    feature_columns: Optional[Sequence[str]] = None,
    **kwargs,
) -> Tuple[Dataset, Dataset]:
    """Load ``{data_dir}/{id}_features.npy`` and ``{id}_labels.npy`` and
    build the datasets.  Without ``feature_columns`` the schema is
    detected: a file with the reference's column names selects its
    81-column list (and a file missing any of them raises ``KeyError``),
    any other the canonical list."""
    fdf = load_dataframe_from_npy(
        os.path.join(data_dir, f"{patient_id}_features.npy"))
    ldf = load_dataframe_from_npy(
        os.path.join(data_dir, f"{patient_id}_labels.npy"))
    if feature_columns is None:
        if F.is_reference_format(fdf.columns):
            feature_columns = F.reference_features
            missing = [c for c in feature_columns if c not in fdf.columns]
            if missing:
                raise KeyError(
                    f"reference-format file for {patient_id!r} is missing "
                    f"{len(missing)}/81 expected columns (first: "
                    f"{missing[:4]}); pass feature_columns= explicitly to "
                    f"train on a subset"
                )
        else:
            feature_columns = F.features
    return make_regression_dataset(fdf, ldf, feature_columns=feature_columns,
                                   **kwargs)
