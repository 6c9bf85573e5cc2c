"""The port's transformer regressors against the JAX package's flax models.

Weights are initialized by flax, carried over with ``from_flax_params``,
and both models see the same numpy batch in eval mode."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from distributed_machine_learning_tpu.models import build_model as jax_build  # noqa: E402
from distributed_machine_learning_tpu_torch.models import (  # noqa: E402
    build_model,
    compute_dtype_of,
)
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    from_flax_params,
    input_features_of,
    to_flax_params,
)

FEATURES = 5
BASE = dict(model="transformer", d_model=16, num_heads=4, num_layers=2,
            dim_feedforward=32, dropout=0.0, max_seq_length=32)

VARIANTS = {
    "scaled_dot_product": dict(),
    "multi_head_attention_causal_free": dict(
        attention_type="multi_head_attention", key_dim_scaling=0.4),
    "linear_attention": dict(attention_type="linear_attention"),
    "blockwise": dict(attention_type="blockwise", block_size=4),
    "flash": dict(attention_type="flash", key_dim_scaling=0.3),
    "flash_gqa_rope": dict(attention_type="flash", num_kv_heads=2,
                           position_encoding="rope"),
    "mqa_no_position": dict(num_kv_heads=1, position_encoding="none"),
    "depthwise_shared_weights": dict(depthwise_separable_conv=True,
                                     shared_weights=True),
    "depthwise_kernel4_stochastic_depth": dict(
        feedforward_type="depthwise_separable", attn_kernel_size=4,
        stochastic_depth_rate=0.2),
    "simple_transformer": dict(model="simple_transformer"),
}


def _flax(config, x, seed=0):
    model = jax_build(config)
    variables = model.init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(1)},
        jnp.asarray(x),
    )
    params = jax.tree.map(np.asarray, variables["params"])
    out = np.asarray(
        model.apply(variables, jnp.asarray(x), deterministic=True), np.float32
    )
    return params, out


def _port(config, params, x):
    model = build_model(config, input_features_of(params))
    model.load_state_dict(from_flax_params(params))
    model.eval()
    with torch.no_grad():
        return model, model(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_transformer_matches_flax(name):
    config = dict(BASE, **VARIANTS[name])
    x = np.random.default_rng(0).normal(size=(3, 16, FEATURES)).astype(np.float32)
    params, ref = _flax(config, x)
    model, out = _port(config, params, x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # The carried weights go back to the identical flax tree.
    back = to_flax_params(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_flagship_config_bf16_at_cut_depth():
    config = {"model": "transformer", "d_model": 512, "num_heads": 8,
              "num_layers": 2, "dim_feedforward": 2048, "dropout": 0.0,
              "attention_type": "flash", "compute_dtype": "bfloat16",
              "max_seq_length": 64}
    x = np.random.default_rng(1).normal(size=(2, 64, 16)).astype(np.float32)
    params, ref = _flax(config, x)
    model, out = _port(config, params, x)
    with torch.no_grad():
        raw = model(torch.from_numpy(x))
    assert raw.dtype == torch.bfloat16  # the head runs in the compute dtype
    np.testing.assert_allclose(out, ref, atol=3e-2)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="moe"):
        build_model(dict(BASE, feedforward_type="moe"), FEATURES)
    with pytest.raises(NotImplementedError, match="seq_axis"):
        build_model(dict(BASE, seq_axis="sp"), FEATURES)
    with pytest.raises(ValueError, match="attention_type"):
        build_model(dict(BASE, attention_type="nope"), FEATURES)
    with pytest.raises(ValueError, match="num_kv_heads"):
        build_model(dict(BASE, num_kv_heads=3), FEATURES)
    with pytest.raises(ValueError, match="compute_dtype"):
        compute_dtype_of({"compute_dtype": "int4"})
    with pytest.raises(KeyError, match="Unknown model"):
        build_model(dict(BASE, model="resnet18"), FEATURES)
