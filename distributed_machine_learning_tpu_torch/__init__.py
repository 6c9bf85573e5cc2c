"""PyTorch + CUDA port of ``distributed_machine_learning_tpu``.

A second package beside the JAX one, ported slice by slice (ROADMAP.md).
It imports ``torch`` and never ``jax``, ``flax`` or the JAX package.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far: the serving path for the transformer family — bundle ->
engine -> batcher -> replicas -> HTTP — with the flash-attention forward
as a hand-written CUDA kernel (``csrc/flash_fwd.cu``); and one trial's
training, ``tune.train_regressor``, with the attention backward as two
more (``csrc/flash_bwd.cu``); and the sweep around it, ``tune.run`` with
BayesOpt, ASHA and the thread executor, so the JAX package's README
quickstart runs here with only the package name changed.
"""

__version__ = "0.1.0"
