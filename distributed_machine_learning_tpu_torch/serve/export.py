"""Servable bundles: the same on-disk layout as the JAX package.

Port of ``distributed_machine_learning_tpu/serve/export.py`` (local
directories only)::

    <bundle>/bundle.json                  manifest: bundle_version, config,
                                          precision, features, provenance
    <bundle>/params.msgpack               flax msgpack tree {"params": ..,
                                          ["quant_scales": ..]}
    <bundle>/params.msgpack.manifest.json sha256 + byte count of the above

:func:`export_bundle` freezes a sweep's best trial (its newest checkpoint,
the port's own or a JAX-written one) into a bundle, in f32, bf16 or int8
(``quant/``).  The params tree is in the flax layout either way, so a
bundle written by the JAX package serves unchanged here, and one written
here loads there: an f32 or quantized bundle of the same weights is the
same bytes from either package.  Not yet ported: ref-copied
``params.cas`` bundles (ROADMAP.md A8) and exports from sharded
``gen_NNNNNN`` checkpoints (A7).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from distributed_machine_learning_tpu_torch.serve import _msgpack
from distributed_machine_learning_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

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
    def quality_delta_mape(self) -> Optional[float]:
        """Calibration-measured MAPE of quantized predictions vs the f32
        parent (None for unquantized bundles)."""
        quant = self.manifest.get("quant") or {}
        delta = quant.get("quality_delta_mape")
        return None if delta is None else float(delta)

    @property
    def feature_names(self) -> List[str]:
        return list((self.manifest.get("features") or {}).get("names", []))

    @property
    def source_topology(self) -> Dict[str, Any]:
        """The training topology the bundle was exported from: ``{"mesh_
        shape": {axis: size}, "process_count": n, "rules_fingerprint":
        "pr_..."}``; manifests without one read as one device and one
        process."""
        topo = (self.manifest.get("source") or {}).get("topology") or {}
        return {
            "mesh_shape": dict(topo.get("mesh_shape") or {}),
            "process_count": int(topo.get("process_count", 1)),
            "rules_fingerprint": topo.get("rules_fingerprint"),
        }

    @property
    def input_features(self) -> int:
        from distributed_machine_learning_tpu_torch.models.convert import (
            input_features_of,
        )

        return input_features_of(self.variables["params"])

    def build_model(self, load_weights: bool = True):
        """The model with this bundle's weights, on the CPU, in eval mode.
        A quantized bundle's weights are int8 codes: with ``load_weights``
        off the model keeps its initial weights and serves only as the
        structure ``quant.apply_variables`` runs the tree through."""
        from distributed_machine_learning_tpu_torch.models import build_model
        from distributed_machine_learning_tpu_torch.models.convert import (
            from_flax_params,
        )

        model = build_model(self.config, self.input_features)
        if load_weights:
            model.load_state_dict(from_flax_params(self.variables["params"]))
        return model.eval()


# The JSON form of the partition-rule tables of the families the port
# builds (``models/partition_rules.py`` of the JAX package, rendered as
# ``parallel/partition.py::rules_fingerprint`` renders them): a manifest's
# ``rules_fingerprint`` is the JAX value.  Applying the rules waits for
# ROADMAP.md A9.
_TRANSFORMER_RULES = [
    [["s", "attention/(query|key|value)/kernel$"], [None, "tp", None]],
    [["s", "attention/(query|key|value)/bias$"], ["tp", None]],
    [["s", "attention/out/kernel$"], ["tp", None, None]],
    [["s", "attention/out/bias$"], []],
    [["s", "ff/Dense_0/kernel$"], [None, "tp"]],
    [["s", "ff/Dense_0/bias$"], ["tp"]],
    [["s", "ff/Dense_1/kernel$"], ["tp", None]],
    [["s", "ff/Dense_1/bias$"], []],
    [["s", "ff/pointwise/kernel$"], [None, None, "tp"]],
    [["s", "ff/pointwise/bias$"], ["tp"]],
    [["s", "ff/out_proj/kernel$"], ["tp", None]],
    [["s", "ff/out_proj/bias$"], []],
    [["s", "ff/w_in$"], ["ep", None, "tp"]],
    [["s", "ff/b_in$"], ["ep", "tp"]],
    [["s", "ff/w_out$"], ["ep", "tp", None]],
    [["s", "ff/b_out$"], ["ep", None]],
    [["s", "ff/router/"], []],
    [["s", "head/Dense_0/kernel$"], ["tp", None]],
    [["s", "head/Dense_[1-9]\\d*/(kernel|bias)$"], []],
    [["s", "input_projection/kernel$"], [None, "tp"]],
    [["s", ".*"], []],
]
RULE_TABLES: Dict[str, list] = {
    "transformer": _TRANSFORMER_RULES,
    "simple_transformer": _TRANSFORMER_RULES,
    "mlp": [
        [["t", "Dense_0", "kernel"], [None, "tp"]],
        [["t", "Dense_1", "kernel"], ["tp", None]],
        [["t", "Dense_\\d+", "bias"], []],
        [["s", ".*"], []],
    ],
}
_DEFAULT_RULES = [[["s", ".*"], []]]


def rules_fingerprint_for(config: Dict[str, Any]) -> str:
    """The sha256 id of the rule table a config's family shards under: the
    JAX ``rules_fingerprint_for`` (a config's own ``partition_rules``
    override is not read: the port runs no sharded trial, ROADMAP.md
    A9)."""
    payload = RULE_TABLES.get(str(config.get("model", "transformer")),
                              _DEFAULT_RULES)
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return "pr_" + hashlib.sha256(blob.encode()).hexdigest()[:16]


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
    """The params tree at ``path``, checked against its sidecar's sha256
    and decoded as the JAX package's checkpoints are (the same format)."""
    from distributed_machine_learning_tpu_torch.tune import checkpoint as ck

    try:
        return ck.load_checkpoint(path)
    except ck.CheckpointCorruptionError as exc:
        raise BundleCorruptionError(str(exc)) from exc


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
            f"ported yet (ROADMAP.md A8)"
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


# -- export ------------------------------------------------------------------


def _feature_block(schema: str) -> Dict[str, Any]:
    """The input-column contract, from ``data/features.py``: a serving
    client can validate and order its feature vector from it."""
    from distributed_machine_learning_tpu_torch.data import features as F

    names = F.features if schema == "canonical" else F.reference_features
    return {"schema": schema, "names": list(names), "label": F.LABEL_COLUMN}


def _servable_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Strip training-only entries (a live mesh handle cannot ride in a
    manifest)."""
    return {k: v for k, v in config.items() if k != "mesh"}


def _read_state(root: str) -> Dict[str, Any]:
    path = os.path.join(root, "experiment_state.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _source_topology(config: Dict[str, Any]) -> Dict[str, Any]:
    """The training topology of a checkpoint the port reads: one gathered
    host (a JAX msgpack checkpoint or the port's own), so no mesh and one
    process; the rule fingerprint comes from the config."""
    return {
        "mesh_shape": {},
        "process_count": 1,
        "rules_fingerprint": rules_fingerprint_for(config),
    }


def _refuse_sharded(ckpt_path: Optional[str], ckpt_dir: Optional[str]):
    """A sharded ``gen_NNNNNN`` checkpoint newer than any the port reads
    is refused by name rather than passed over for an older one."""
    from distributed_machine_learning_tpu_torch.tune import checkpoint as ck

    gens = ck.sharded_generations(ckpt_dir) if ckpt_dir else []
    newest = max((ck.GEN_RE.match(os.path.basename(g)).group(1)
                  for g in gens), key=int, default=None)
    named = ckpt_path and ck.GEN_RE.match(
        os.path.basename(str(ckpt_path).rstrip("/")))
    if named or (newest is not None and (
            ckpt_path is None or int(newest) > ck.step_of_path(ckpt_path))):
        raise NotImplementedError(
            f"the newest checkpoint under {ckpt_dir or ckpt_path!r} is a "
            f"sharded generation (gen_NNNNNN); reading it is not ported "
            f"yet (ROADMAP.md A7)"
        )


def export_bundle(
    source,
    out_dir: str,
    metric: Optional[str] = None,
    mode: Optional[str] = None,
    trial_id: Optional[str] = None,
    feature_schema: str = "canonical",
    precision: str = "f32",
    calibration_batch=None,
    device: DeviceLike = "cuda",
) -> str:
    """Resolve the best trial of ``source`` and write a servable bundle.

    ``source`` is a live :class:`ExperimentAnalysis` (what ``tune.run``
    returns) or an experiment directory (``<storage_path>/<name>``, of
    either package), whose ``metric``/``mode`` default to the objective
    recorded in ``experiment_state.json``.  ``trial_id`` overrides the
    best-trial selection.  ``precision`` selects the stored weight dtype
    (``"f32"``, ``"bf16"``, ``"int8"``); a quantized export needs a
    ``calibration_batch`` (an ``(n, features...)`` array) and records the
    measured quality delta vs the f32 weights in the manifest's ``quant``
    block; its calibration forwards run on ``device`` (an f32 export runs
    none).  Returns ``out_dir``."""
    from distributed_machine_learning_tpu_torch.models import (
        build_model,
        models,
    )
    from distributed_machine_learning_tpu_torch.models.convert import (
        input_features_of,
        to_flax_params,
    )
    from distributed_machine_learning_tpu_torch.quant import (
        build_quant_block,
        check_precision,
    )
    from distributed_machine_learning_tpu_torch.quant.api import (
        require_calibration,
    )
    from distributed_machine_learning_tpu_torch.tune import checkpoint as ck
    from distributed_machine_learning_tpu_torch.tune.experiment import (
        ExperimentAnalysis,
        _jsonable,
    )

    check_precision(precision)
    if isinstance(source, ExperimentAnalysis):
        analysis = source
    else:
        root = str(source)
        state = _read_state(root)
        metric = metric or state.get("metric")
        mode = mode or state.get("mode") or "min"
        if not metric:
            raise ValueError(
                f"experiment at {root!r} predates metric recording — "
                f"pass metric= explicitly"
            )
        analysis = ExperimentAnalysis.from_directory(root, metric, mode)

    if trial_id is not None:
        matches = [t for t in analysis.trials if t.trial_id == trial_id]
        if not matches:
            raise ValueError(
                f"no trial {trial_id!r} in experiment {analysis.root!r}"
            )
        trial = matches[0]
    else:
        trial = analysis.best_trial

    family = str(trial.config.get("model", "transformer"))
    if family not in models:
        # Its bundle could not be served here, and its rule fingerprint is
        # one the port does not carry.
        raise NotImplementedError(
            f"model family {family!r} is not ported yet (ROADMAP.md A4)"
        )
    ckpt_path = trial.latest_checkpoint
    ckpt_dir = (os.path.join(analysis.root, trial.trial_id, "checkpoints")
                if analysis.root else None)
    if ckpt_path is None and ckpt_dir:
        # A rehydrated analysis carries no live checkpoint pointers; the
        # on-disk layout does (<root>/<trial_id>/checkpoints/).
        ckpt_path, _ = ck.find_latest_checkpoint(ckpt_dir)
    _refuse_sharded(ckpt_path, ckpt_dir)
    t_load = time.time()
    ckpt = ck.load_checkpoint(ckpt_path) if ckpt_path else None
    if ckpt is None or "params" not in ckpt:
        raise ValueError(
            f"trial {trial.trial_id} has no restorable checkpoint "
            f"(path={ckpt_path!r}); run with checkpointing enabled"
        )
    if ck.is_flax_checkpoint(ckpt_path):
        variables = {"params": ckpt["params"]}
        if ckpt.get("batch_stats"):
            variables["batch_stats"] = ckpt["batch_stats"]
    else:
        variables = {"params": to_flax_params(ckpt["params"])}
    ckpt_load_s = time.time() - t_load

    config = _servable_config(trial.config)
    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "created_at": time.time(),
        "model_family": trial.config.get("model", "transformer"),
        "config": _jsonable(config),
        "metric": analysis.metric,
        "mode": analysis.mode,
        "best_score": analysis._score(trial),
        "precision": precision,
        "features": _feature_block(feature_schema),
        "source": {
            "experiment": analysis.root,
            "trial_id": trial.trial_id,
            "checkpoint": ckpt_path,
            # The manifest's vocabulary: "sharded" for a generation,
            # "msgpack" for a checkpoint one host wrote whole (the JAX
            # blob, or the port's tensor file and index).
            "checkpoint_format": "msgpack",
            "checkpoint_load_s": round(ckpt_load_s, 4),
            "topology": _source_topology(trial.config),
        },
    }
    if precision != "f32":
        require_calibration(precision, calibration_batch)
        model = build_model(config, input_features_of(variables["params"]))
        quant_block = build_quant_block(
            model.to(resolve_device(device)).eval(), variables, precision,
            calibration_batch)
        variables = quant_block.pop("_variables")
        manifest["quant"] = quant_block
    write_bundle(out_dir, manifest, variables)
    return out_dir
