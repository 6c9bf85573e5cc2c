"""The port's ``quant/`` against the JAX package's.

A small transformer (GQA, so the q/k/v ``DenseGeneral`` kernels are 3-d
``(d_model, heads, head_dim)``) and an mlp, initialized by flax.  Held
bit for bit: the int8 codes, scales and bf16 payload bits (the msgpack
bytes a bundle stores) and the manifest statistics; the bf16 dequantized
trees; the fake-quant round trips (single model and population); the
quality delta.  Within tolerance: the activation ranges (same keys, flax
module paths) and the quantized forward, through ``predict_quantized``
and through the serving engine on an int8 bundle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from flax import serialization  # noqa: E402

from distributed_machine_learning_tpu import quant as jax_quant  # noqa: E402
from distributed_machine_learning_tpu.models import build_model as jax_build  # noqa: E402
from distributed_machine_learning_tpu.serve import export as jax_export  # noqa: E402
from distributed_machine_learning_tpu_torch import quant, serve  # noqa: E402
from distributed_machine_learning_tpu_torch.models import build_model  # noqa: E402
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    input_features_of,
)
from distributed_machine_learning_tpu_torch.serve import _msgpack  # noqa: E402

CONFIGS = {
    "transformer_gqa": dict(model="transformer", d_model=16, num_heads=4,
                            num_kv_heads=2, num_layers=2, dim_feedforward=32,
                            dropout=0.0, attention_type="flash",
                            max_seq_length=16),
    "mlp": dict(model="mlp", hidden_sizes=[32, 16]),
}
SEQ, FEATURES = 12, 5
# The served-answer gate of a bf16 forward: a share of the largest entry.
QUANT_TOL = 3e-2


def _rows(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, SEQ, FEATURES)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def family(request):
    config = CONFIGS[request.param]
    model = jax_build(config)
    variables = model.init(jax.random.key(0), jnp.asarray(_rows(1, 0)))
    variables = {"params": jax.tree.map(np.asarray, variables["params"])}
    port_model = build_model(config, input_features_of(variables["params"]))
    return config, model, variables, port_model.eval()


def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_quantize_variables_is_byte_equal_with_the_same_stats(family,
                                                              precision):
    _, _, variables, _ = family
    jq, jstats = jax_quant.quantize_variables(variables, precision)
    pq, pstats = quant.quantize_variables(variables, precision)
    assert pstats == jstats
    assert _msgpack.packb(pq) == serialization.to_bytes(jq)
    assert quant.tree_precision(pq) == jax_quant.tree_precision(jq) == \
        precision
    if precision == "int8":
        # A 3-d q/k/v kernel gets one scale per flax output channel
        # (head_dim), shared across heads.
        scales = pq["quant_scales"]
        layer = scales.get("layer_0")
        if layer is not None:
            assert layer["attention"]["key"]["kernel"].shape == (1, 1, 4)
    # Round trip through the bundle codec keeps the dtypes.
    back = _msgpack.unpackb(_msgpack.packb(pq))
    assert quant.tree_precision(back) == precision


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_dequantize_variables_is_bit_equal(family, precision):
    _, _, variables, _ = family
    jq, _ = jax_quant.quantize_variables(variables, precision)
    pq, _ = quant.quantize_variables(variables, precision)
    want = jax_quant.dequantize_variables(jq, precision)
    got = quant.dequantize_variables(pq, precision)
    assert sorted(got) == sorted(want)
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        if precision == "f32":
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            continue
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy(),
            np.asarray(b).view(np.int16))


def test_fake_quant_tree_and_population_are_equal(family):
    _, _, variables, _ = family
    params = variables["params"]
    for a, b in zip(_leaves(quant.fake_quant_tree(params)),
                    _leaves(jax_quant.fake_quant_tree(params))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    stacked = jax.tree.map(
        lambda p: np.stack([p * np.float32(s) for s in (1.0, -0.5, 2.0)])
        + rng.normal(size=(3, *p.shape)).astype(np.float32) * 1e-3, params)
    for a, b in zip(_leaves(quant.fake_quant_population(stacked)),
                    _leaves(jax_quant.fake_quant_population(stacked))):
        np.testing.assert_array_equal(a, b)


def test_quality_delta_is_equal():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(17, 1)).astype(np.float32)
    q = f + rng.normal(size=(17, 1)).astype(np.float32) * 1e-2
    assert quant.quality_delta(f, q) == jax_quant.quality_delta(f, q)
    with pytest.raises(ValueError, match="prediction shapes diverge"):
        quant.quality_delta(f, q[:3])


def test_activation_ranges_have_the_same_keys_and_values(family):
    _, model, variables, port_model = family
    x = _rows(6, 2)
    want = jax_quant.activation_ranges(model, variables, x)
    got = quant.activation_ranges(port_model, variables, x)
    assert list(got) == list(want) and want
    top = max(want.values())
    assert max(abs(got[k] - want[k]) for k in want) <= 1e-5 * top
    # Best-effort: a forward that fails yields an empty table.
    assert quant.activation_ranges(port_model, variables,
                                   np.zeros((2, 3), np.float32)) == {}


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_quantized_forward_matches_the_jax_predict_quantized(
        family, precision, tmp_path):
    config, model, variables, port_model = family
    jq, stats = jax_quant.quantize_variables(variables, precision)
    x = _rows(5, 4)
    want = jax_quant.predict_quantized(model, jq, x, precision)
    top = np.abs(want).max()
    pq = _msgpack.unpackb(serialization.to_bytes(jq))
    got = quant.predict_quantized(port_model, pq, x, precision)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= QUANT_TOL * top
    # The serving engine on the JAX-written bundle of the same tree: its
    # weights stay int8/bf16, its answers those of the same forward.
    jax_export.write_bundle(
        str(tmp_path), {"bundle_version": 1, "config": config,
                        "precision": precision}, jq)
    bundle = serve.load_bundle(str(tmp_path))
    engine = serve.InferenceEngine(bundle, max_bucket=8, device="cpu")
    kept = {t.dtype for t in jax.tree.leaves(engine._variables)}
    assert (torch.int8 in kept) == (precision == "int8")
    assert torch.float32 not in kept or precision == "int8"
    served = engine.predict(x)
    np.testing.assert_array_equal(served, got)
    assert engine.program_stats()["precision"] == precision
    assert engine.resident_bytes() == stats["bytes_quant"]


def test_calibration_block_and_refusals(family, tmp_path):
    config, model, variables, port_model = family
    x = _rows(4, 5)
    want = jax_quant.build_quant_block(model, variables, "int8", x)
    got = quant.build_quant_block(port_model, variables, "int8", x)
    jv, pv = want.pop("_variables"), got.pop("_variables")
    assert _msgpack.packb(pv) == serialization.to_bytes(jv)
    jc, pc = want.pop("calibration"), got.pop("calibration")
    want.pop("quality_delta_mape"), got.pop("quality_delta_mape")
    assert got == want
    assert sorted(pc) == sorted(jc)
    assert pc["batch_shape"] == jc["batch_shape"]
    if config["model"] == "mlp":
        # Its bf16 forward rounds alike in both frameworks.
        for k in ("quality_delta_mape", "quality_delta_mae", "max_abs_err"):
            assert abs(pc[k] - jc[k]) <= 1e-4 * abs(jc[k]), k
    else:
        # The transformer's bf16 attention and layer norms round apart:
        # each quantized answer may move by QUANT_TOL of the largest f32
        # answer, which bounds how far each measured error can move.
        f = jax_quant.predict_f32(model, variables, x)
        moved = QUANT_TOL * np.abs(f).max()
        assert abs(pc["quality_delta_mae"] - jc["quality_delta_mae"]) <= moved
        assert abs(pc["max_abs_err"] - jc["max_abs_err"]) <= moved
        assert abs(pc["quality_delta_mape"] - jc["quality_delta_mape"]) <= \
            moved * np.mean(1.0 / (np.abs(f) + 1e-8))
    with pytest.raises(ValueError, match="requires a calibration_batch"):
        quant.build_quant_block(port_model, variables, "int8", None)
    with pytest.raises(ValueError, match="precision must be one of"):
        quant.check_precision("fp8")
    f32_dir = str(tmp_path / "f32")
    jax_export.write_bundle(f32_dir, {"bundle_version": 1, "config": config,
                                      "precision": "f32"}, variables)
    q_dir = quant.quantize_bundle(f32_dir, str(tmp_path / "q"), "int8", x,
                                  device="cpu")
    with pytest.raises(ValueError, match="already int8"):
        quant.quantize_bundle(q_dir, str(tmp_path / "qq"), "int8", x,
                              device="cpu")
    with pytest.raises(ValueError, match="targets bf16/int8"):
        quant.quantize_bundle(f32_dir, str(tmp_path / "qq"), "f32", x)
    # The JAX package quantizes the same bundle to the same bytes.
    j_dir = jax_quant.quantize_bundle(f32_dir, str(tmp_path / "j"), "int8", x)
    with open(f"{q_dir}/params.msgpack", "rb") as a, \
            open(f"{j_dir}/params.msgpack", "rb") as b:
        assert a.read() == b.read()
    assert serve.load_bundle(q_dir).manifest["source"]["parent_bundle"] \
        == f32_dir
