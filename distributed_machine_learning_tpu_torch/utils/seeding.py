"""Deterministic seeding helpers shared by data generators and trials.

``rng_from`` and ``fold_seed`` are copies of the JAX package's
``utils/seeding.py`` (numpy and hashlib only), so the port derives the
same integers from the same seed parts.  ``init_generators_for`` takes the
place of ``init_rngs_for``: explicit ``torch.Generator``s seeded from the
same two derivations instead of ``jax.random`` keys.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch


def rng_from(*parts) -> np.random.Generator:
    """Build a numpy Generator from an arbitrary tuple of seed parts.

    Hashing makes (experiment_seed, trial_index) style derivations stable
    across processes and platforms, unlike Python's salted ``hash``.
    """
    h = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def fold_seed(*parts) -> int:
    """A stable 31-bit integer seed derived from the parts."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def init_generators_for(seed, device="cpu") -> Dict[str, torch.Generator]:
    """A trial's two streams: ``params`` (on the CPU, so a seed gives the
    same initial weights on every device) from ``fold_seed(seed, "init")``
    and ``dropout`` (on ``device``, where the masks are drawn) from
    ``fold_seed(seed, "init_dropout")``."""
    params = torch.Generator().manual_seed(fold_seed(seed, "init"))
    dropout = torch.Generator(device=torch.device(device)).manual_seed(
        fold_seed(seed, "init_dropout")
    )
    return {"params": params, "dropout": dropout}
