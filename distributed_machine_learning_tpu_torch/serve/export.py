"""Servable bundles: the same on-disk layout as the JAX package.

Port of ``distributed_machine_learning_tpu/serve/export.py`` (local
directories only)::

    <bundle>/bundle.json                  manifest: bundle_version, config,
                                          features, provenance
    <bundle>/params.msgpack               flax msgpack tree {"params": ..}
    <bundle>/params.msgpack.manifest.json sha256 + byte count of the above

A bundle written by the JAX package's ``write_bundle``/``export_bundle``
serves unchanged here, and one written here loads there.  Not yet ported:
ref-copied ``params.cas`` bundles and ``export_bundle`` (which needs the
trainer).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from distributed_machine_learning_tpu_torch.serve import _msgpack

BUNDLE_VERSION = 1
MANIFEST_NAME = "bundle.json"
PARAMS_NAME = "params.msgpack"
PARAMS_MANIFEST_SUFFIX = ".manifest.json"


class BundleCorruptionError(ValueError):
    """The params file does not match its recorded checksum or decode."""


@dataclass
class ServableBundle:
    """A loaded bundle: everything the engine needs to answer."""

    config: Dict[str, Any]
    variables: Dict[str, Any]  # {"params": nested dict of numpy arrays}
    manifest: Dict[str, Any] = field(default_factory=dict)
    path: Optional[str] = None
    checkpoint_load_s: float = 0.0

    @property
    def model_family(self) -> str:
        return self.config.get("model", "transformer")

    @property
    def precision(self) -> str:
        return str(self.manifest.get("precision", "f32"))

    @property
    def input_features(self) -> int:
        from distributed_machine_learning_tpu_torch.models.convert import (
            input_features_of,
        )

        return input_features_of(self.variables["params"])

    def build_model(self):
        """The model with this bundle's weights, on the CPU, in eval mode."""
        from distributed_machine_learning_tpu_torch.models import build_model
        from distributed_machine_learning_tpu_torch.models.convert import (
            from_flax_params,
        )

        model = build_model(self.config, self.input_features)
        model.load_state_dict(from_flax_params(self.variables["params"]))
        return model.eval()


def write_bundle(
    out_dir: str, manifest: Dict[str, Any], variables: Dict[str, Any]
) -> str:
    """Write a manifest + params pair (the bundle layout) to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    payload = _msgpack.packb(variables)
    params_path = os.path.join(out_dir, PARAMS_NAME)
    with open(params_path, "wb") as f:
        f.write(payload)
    # The sidecar lands after the payload, as the JAX package writes it.
    with open(params_path + PARAMS_MANIFEST_SUFFIX, "w") as f:
        json.dump({
            "sha256": hashlib.sha256(payload).hexdigest(),
            "bytes": len(payload),
            "format": "flax-msgpack",
        }, f)
    return out_dir


def _read_params(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        data = f.read()
    sidecar = path + PARAMS_MANIFEST_SUFFIX
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            expected = json.load(f).get("sha256")
        if expected is not None and hashlib.sha256(data).hexdigest() != expected:
            raise BundleCorruptionError(
                f"checksum mismatch for {path} ({len(data)} bytes)"
            )
    try:
        return _msgpack.unpackb(data)
    except (ValueError, TypeError, KeyError, UnicodeDecodeError) as exc:
        raise BundleCorruptionError(
            f"undecodable params at {path}: {exc!r}"
        ) from exc


def load_bundle(bundle_dir: str) -> ServableBundle:
    """Read a bundle directory back into a :class:`ServableBundle`."""
    manifest_path = os.path.join(bundle_dir, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(
            f"no {MANIFEST_NAME} under {bundle_dir!r} — not a bundle directory"
        )
    with open(manifest_path) as f:
        manifest = json.load(f)
    version = manifest.get("bundle_version")
    if version != BUNDLE_VERSION:
        raise ValueError(
            f"bundle at {bundle_dir!r} has version {version!r}; this "
            f"build reads version {BUNDLE_VERSION}"
        )
    params_file = str(manifest.get("params_file") or PARAMS_NAME)
    if params_file != PARAMS_NAME:
        raise NotImplementedError(
            f"bundle params {params_file!r}: ref-copied bundles are not "
            f"ported yet (ROADMAP.md queue A)"
        )
    params_path = os.path.join(bundle_dir, params_file)
    if not os.path.exists(params_path):
        raise FileNotFoundError(f"bundle at {bundle_dir!r} is missing {params_file}")
    t0 = time.monotonic()
    variables = _read_params(params_path)
    load_s = time.monotonic() - t0
    if not isinstance(variables, dict) or "params" not in variables:
        raise BundleCorruptionError(f"{params_path} holds no params tree")
    return ServableBundle(
        config=dict(manifest.get("config", {})),
        variables=variables,
        manifest=manifest,
        path=bundle_dir,
        checkpoint_load_s=round(load_s, 4),
    )
