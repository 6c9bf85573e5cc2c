"""The port's pickle-free checkpoints (``tune/checkpoint.py``).

Round trips are bit-exact for every dtype ``train_regressor`` reports
(f32 and bf16 parameters, the nested optimizer state, the generator
state) and a few more; a damaged newest checkpoint falls back to the one
before it; retention keeps the newest k; and no module on the
checkpoint path uses pickle, ``torch.save`` or ``torch.load``.
"""

from __future__ import annotations

import ast
import json
import os

import numpy as np
import pytest

from _torch_tune_common import restore_global_state  # noqa: F401

torch = pytest.importorskip("torch")

import distributed_machine_learning_tpu_torch.tune as port_tune  # noqa: E402
from distributed_machine_learning_tpu.ckpt import manager as jax_manager  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    checkpoint as ckpt_lib,
)
from distributed_machine_learning_tpu_torch.tune.storage import (  # noqa: E402
    MemoryStorage,
)

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
          torch.int64, torch.int32, torch.uint8, torch.bool]


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 1e3).to(dtype)
    return torch.randint(0, 200, shape, generator=g).to(dtype)


def _assert_same(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.device.type == "cpu"
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.detach().cpu().reshape(-1).view(torch.uint8))
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", [(), (1,), (3, 5), (2, 0, 4), (7, 3, 2)])
def test_tensors_round_trip_bit_exactly(dtype, shape, tmp_path):
    t = _tensor(dtype, shape, seed=len(shape))
    if dtype.is_floating_point and t.numel():
        t.reshape(-1)[0] = float("nan")
    path = ckpt_lib.checkpoint_path(str(tmp_path), 1)
    ckpt_lib.save_checkpoint(path, {"t": t, "view": t.transpose(0, -1)
                                    if t.dim() > 1 else t})
    back = ckpt_lib.load_checkpoint(path)
    _assert_same(back["t"], t)
    _assert_same(back["view"], t.transpose(0, -1) if t.dim() > 1 else t)


def _trainer_checkpoint(compute_dtype=None):
    """What train_regressor reports: one epoch of a tiny flash model."""
    train, val = dummy_regression_data(num_samples=40, seq_len=8,
                                       num_features=3)
    config = {"model": "transformer", "d_model": 8, "num_heads": 2,
              "num_layers": 1, "attention_type": "flash",
              "learning_rate": 1e-3, "num_epochs": 1, "batch_size": 16}
    if compute_dtype:
        config["compute_dtype"] = compute_dtype
    seen = []
    with port_tune.session.standalone(devices=[torch.device("cpu")],
                                      report_fn=lambda m, c: seen.append(c)):
        port_tune.train_regressor(config, train_data=train, val_data=val)
    return seen[-1]


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_trainer_checkpoint_round_trips_bit_exactly(compute_dtype, tmp_path):
    tree = _trainer_checkpoint(compute_dtype)
    assert tree["generator"].dtype == torch.uint8
    assert isinstance(tree["opt_state"]["count"], int)
    # bf16 parameters too, as a bf16 trainer would hold them.
    tree["params_bf16"] = {k: v.to(torch.bfloat16)
                           for k, v in tree["params"].items()}
    tree["nested"] = {"list": [1, 2.5, None, "s", True],
                      "tuple": (torch.arange(3), {"x": -0.0}),
                      "inf": float("inf")}
    path = ckpt_lib.checkpoint_path(str(tmp_path), 12)
    assert ckpt_lib.save_checkpoint(path, tree) == path
    back = ckpt_lib.load_checkpoint(path)
    _assert_same(back, tree)
    g = torch.Generator()
    g.set_state(back["generator"])
    h = torch.Generator()
    h.set_state(tree["generator"])
    assert torch.equal(torch.rand(8, generator=g), torch.rand(8, generator=h))


def test_file_layout_and_index(tmp_path):
    tree = {"params": {"w": torch.ones(4, 4, dtype=torch.bfloat16)},
            "epoch": 3}
    path = ckpt_lib.checkpoint_path(str(tmp_path), 7)
    ckpt_lib.save_checkpoint(path, tree)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000007.json",
                                            "ckpt_000007.tensors"]
    meta = json.loads(open(path).read())
    assert meta["format"] == ckpt_lib.FORMAT
    entry = meta["tree"]["dict"]["params"]["dict"]["w"]["tensor"]
    assert entry == {"dtype": "bfloat16", "shape": [4, 4], "offset": 0,
                     "nbytes": 32}
    assert meta["bytes"] == os.path.getsize(tmp_path / "ckpt_000007.tensors")
    assert ckpt_lib.step_of_path(path) == 7
    # No JAX reader sees a checkpoint of its own format here.
    assert jax_manager.list_generations(str(tmp_path)) == []


def _write_steps(directory, steps):
    paths = []
    for step in steps:
        p = ckpt_lib.checkpoint_path(directory, step)
        ckpt_lib.save_checkpoint(p, {"w": torch.full((3,), float(step)),
                                     "epoch": step})
        paths.append(p)
    return paths


@pytest.mark.parametrize("damage", ["truncate_tensors", "flip_byte",
                                    "truncate_index", "drop_tensors"])
def test_damaged_newest_checkpoint_falls_back(damage, tmp_path):
    d = str(tmp_path)
    paths = _write_steps(d, [1, 2, 3])
    newest = paths[-1]
    tensors = ckpt_lib.tensors_path_for(newest)
    if damage == "truncate_tensors":
        data = open(tensors, "rb").read()
        open(tensors, "wb").write(data[: len(data) // 2])
    elif damage == "flip_byte":
        data = bytearray(open(tensors, "rb").read())
        data[3] ^= 0x40
        open(tensors, "wb").write(bytes(data))
    elif damage == "truncate_index":
        text = open(newest).read()
        open(newest, "w").write(text[: len(text) // 2])
    else:
        os.unlink(tensors)
    with pytest.raises(ckpt_lib.CheckpointCorruptionError):
        ckpt_lib.load_checkpoint(newest)
    logs = []
    tree, used, step = ckpt_lib.load_checkpoint_with_fallback(
        newest, d, log=logs.append)
    assert (used, step) == (paths[1], 2) and tree["epoch"] == 2
    assert torch.equal(tree["w"], torch.full((3,), 2.0))
    assert ckpt_lib.find_latest_checkpoint(d) == (newest, 3)
    assert logs


def test_fallback_without_anything_valid_restarts(tmp_path):
    d = str(tmp_path)
    (only,) = _write_steps(d, [4])
    os.unlink(ckpt_lib.tensors_path_for(only))
    assert ckpt_lib.load_checkpoint_with_fallback(
        only, d, log=lambda m: None) == (None, None, 0)
    assert ckpt_lib.load_checkpoint_with_fallback(None, d) == (None, None, 0)
    assert ckpt_lib.load_checkpoint(
        ckpt_lib.checkpoint_path(d, 99)) is None


def test_prune_keeps_the_newest_and_protected(tmp_path):
    d = str(tmp_path)
    paths = _write_steps(d, [1, 2, 3, 4, 5])
    assert ckpt_lib.prune_checkpoints(d, 2, protect=paths[0]) == 2
    assert [p for _, p in ckpt_lib.list_checkpoints(d)] == [
        paths[0], paths[3], paths[4]]
    assert not os.path.exists(ckpt_lib.tensors_path_for(paths[1]))
    assert ckpt_lib.prune_checkpoints(d, 0) == 0


def test_run_keeps_checkpoints_num(tmp_path):
    def trainable(config):
        for it in range(1, 6):
            port_tune.report({"loss": 1.0 / it},
                             checkpoint={"w": torch.full((2,), float(it))})

    analysis = port_tune.run(trainable, {"x": port_tune.choice([1, 2])},
                             metric="loss", num_samples=2,
                             keep_checkpoints_num=2,
                             devices=[torch.device("cpu")], verbose=0,
                             storage_path=str(tmp_path))
    for t in analysis.trials:
        kept = ckpt_lib.list_checkpoints(
            os.path.join(analysis.root, t.trial_id, "checkpoints"))
        assert [s for s, _ in kept] == [4, 5]
        w = ckpt_lib.load_checkpoint(t.latest_checkpoint)["w"]
        assert torch.equal(w, torch.full((2,), 5.0))


def test_memory_storage_round_trip():
    MemoryStorage.clear()
    try:
        path = ckpt_lib.checkpoint_path("mem://ckpt/trial_0", 2)
        tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
        ckpt_lib.save_checkpoint(path, tree)
        _assert_same(ckpt_lib.load_checkpoint(path), tree)
        assert ckpt_lib.find_latest_checkpoint("mem://ckpt/trial_0") == (
            path, 2)
    finally:
        MemoryStorage.clear()


def test_unsupported_leaves_and_schemes_raise(tmp_path):
    path = ckpt_lib.checkpoint_path(str(tmp_path), 1)
    with pytest.raises(TypeError):
        ckpt_lib.save_checkpoint(path, {"a": np.zeros(3)})
    with pytest.raises(TypeError):
        ckpt_lib.save_checkpoint(path, {1: torch.zeros(3)})
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3f"):
        ckpt_lib.save_checkpoint("gs://bucket/ckpt_000001.json",
                                 {"a": torch.zeros(1)})


PICKLE_FREE = ("tune/checkpoint.py", "tune/experiment.py", "tune/storage.py")


@pytest.mark.parametrize("relpath", PICKLE_FREE)
def test_checkpoint_path_modules_use_no_pickle(relpath):
    root = os.path.dirname(port_tune.__file__)
    tree = ast.parse(open(os.path.join(root, os.path.relpath(
        relpath, "tune"))).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] + [a.name for a in node.names]
        else:
            names = []
        assert not [n for n in names if "pickle" in n or n in ("save", "load")
                    and isinstance(node, ast.ImportFrom)
                    and node.module == "torch"], (relpath, names)
        if isinstance(node, ast.Attribute) and node.attr in ("save", "load"):
            assert not (isinstance(node.value, ast.Name)
                        and node.value.id == "torch"), (relpath, node.attr)
        if isinstance(node, ast.Name):
            assert "pickle" not in node.id, (relpath, node.id)
