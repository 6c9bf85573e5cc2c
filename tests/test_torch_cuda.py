"""Tests of the port that need an NVIDIA card (marker ``cuda``).

They skip on a machine without one.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

``chip_smoke.py`` drives the same kernel over a larger grid and the whole
serving path at full width.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from distributed_machine_learning_tpu_torch.ops import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv,D,S", [(8, 8, 64, 2048), (8, 4, 16, 96),
                                       (8, 1, 128, 200), (4, 2, 256, 70)])
def test_kernel_matches_plain_version(card, dtype, atol, causal, H, Hkv, D, S):
    gen = torch.Generator().manual_seed(S + D)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(2, S, h, D, generator=gen).to(card, dt)
               for h in (H, Hkv, Hkv))
    before = fa.launches.count
    out, lse = fa.flash_forward(q, k, v, 0.3, causal, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, 0.3, causal)
    torch.cuda.synchronize()
    assert fa.launches.count == before + 1
    assert out.dtype == dt and lse.shape == (2 * H, 1, S)
    assert (out.float() - ref_out.float()).abs().max().item() <= atol
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_kernel_reads_strided_inputs(card):
    """q/k/v as views of a fused [B, S, 3, H, D] projection: no copies."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 100, 3, 4, 32, generator=gen).to(card)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = fa.flash_forward(q, k, v)
    ref, _ = fa.flash_attention_reference(q, k, v, 32 ** -0.5, False)
    assert (out - ref).abs().max().item() <= 2e-4


def test_engine_serves_on_the_card(card, tmp_path):
    from distributed_machine_learning_tpu_torch.models import build_model
    from distributed_machine_learning_tpu_torch.models.convert import (
        to_flax_params,
    )
    from distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
        load_bundle,
        write_bundle,
    )

    config = {"model": "transformer", "d_model": 64, "num_heads": 4,
              "num_layers": 2, "attention_type": "flash", "dropout": 0.0,
              "compute_dtype": "bfloat16", "max_seq_length": 128}
    torch.manual_seed(0)
    model = build_model(config, 16)
    write_bundle(str(tmp_path), {"bundle_version": 1, "config": config},
                 {"params": to_flax_params(model.state_dict())})
    engine = InferenceEngine(load_bundle(str(tmp_path)), max_bucket=4,
                             device=card)
    x = np.random.default_rng(0).normal(size=(3, 128, 16)).astype(np.float32)
    before = fa.launches.count
    out = engine.predict(x)
    assert fa.launches.count - before == config["num_layers"]
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(x)).float().numpy()  # CPU, plain
    np.testing.assert_allclose(out, ref, atol=3e-2)
