"""Vectorized HPO: K trials trained as one batched program with
``torch.func``.

Port of ``distributed_machine_learning_tpu/tune/vectorized.py``.  Trials
whose configs differ only in ``learning_rate``, ``weight_decay`` and
``seed`` (:data:`VECTOR_KEYS`) share a static signature and train as one
population: their parameters are stacked on a leading axis, a step is
``vmap(grad(loss))`` over (each row's parameters, its batch, its dropout
seed), and the population optimizer updates every row with its own lr and
wd (``ops/optimizers.py::PopulationOptimizer``).  Everything else in a
config shapes the program, so configs are grouped by
:func:`_static_signature` and each group runs as its own population.
With ``attention_type="flash"`` the hand-written kernels run once per
step for the whole population, on its batch folded into theirs
(``ops/flash_attention.py``).

Trials are suggested and trained chunk by chunk (``max_batch_trials`` per
chunk), so adaptive searchers see every earlier chunk's results.  Each
epoch's records go trial by trial through the scheduler, as in
``tune.run``; when the survivors fit in half the rows, the population is
compacted: the stopped rows are cut out of every stacked tensor
(parameters, moments, lr/wd, dropout seeds, shuffle seeds) and the rest
continue as a smaller population.  Every row draws its shuffles and its
dropout masks from streams of its own seed (``tune/trainable.py::
epoch_permutation``, ``ops/rng.py``), so a surviving trial's trajectory
does not depend on who else is still in the population.

Decisions that the JAX runner takes against its compile cost take none
here, since the port runs eagerly and compiles nothing:

* ``compaction="auto"`` compacts at every halving boundary (the JAX cost
  model with a compile cost of 0; ``"always"`` is the same, ``"never"``
  keeps the rows);
* ``epochs_per_dispatch`` changes nothing without PBT: the port
  dispatches epoch by epoch, and stops and compaction act per epoch, so
  the reported results are the same for any value.  Under PBT it sizes
  the dispatch as in the JAX runner (whole generations when compiled, at
  most one interval on the boundary path);
* populations are not padded to a size multiple (the TPU's sublane rule).

``input_mode="streaming"`` falls back to resident staging, counted as
``host_input.mode_fallbacks`` in ``experiment_state.json``, as in the JAX
runner.  Each trial's parameters at its end (its last epoch, or the
epoch its stop came) are written as one checkpoint in the port's format,
so ``ExperimentAnalysis.best_model()`` works on a vectorized experiment.

With a ``PopulationBasedTraining`` or ``PB2`` scheduler the population
IS the PBT population: exploit is a row gather of every stacked
parameter and optimizer leaf, explore rewrites the rows' lr/wd, and a
lagger keeps its own dropout and shuffle seeds.  ``pbt_mode="compiled"``
(what ``"auto"`` picks when it can) enqueues whole generations on the
device, ranking and draws included, and reads their stacked outputs back
once per chunk; ``"boundary"`` reads back once per perturbation interval
and decides on the host.  Both take their decisions from the same
deterministic step on the same draws (``schedulers/pbt.py``), so they
decide the same bit for bit.  PB2, list/quantized/callable specs and
``stop=`` rules need host decisions every generation and run on the
boundary path.

``checkpoint_every_epochs=N`` writes the population (parameters,
optimizer state with each row's lr/wd, dropout-stream and shuffle seeds,
the row mapping, the live flags, the trials' ids and PBT's pending donor
notes) to ``<experiment>/population.json`` at the start of each chunk and
every N epochs, after PBT and compaction, through
``checkpoint.save_replacing``: a kill leaves the old file or the new one.
``resume=True`` (with ``name``) reopens the experiment: finished chunks
replay from their records as TERMINATED, trials that never started run
as their own chunk, and the interrupted population continues from the
file.  Records past it are dropped (memory and ``result.jsonl``), the
searcher is fast-forwarded, ASHA's rungs and stateful stop rules are
warmed by replay, and PBT/PB2 re-baseline each trial on its last record.
The dropout stream is counted from the step and the shuffles from the
epoch, so the resumed sweep gives the uninterrupted sweep's records bit
for bit.  A compiled-PBT resume off a generation boundary runs on the
boundary path (``pbt.mode_fallbacks``).  The JAX package's msgpack
``population.ckpt`` is not read.

Refused by name, each with the ROADMAP.md item that will lift it:
``checkpoint_format="sharded"`` (A7), more than one device (A9),
``progress_deadline_s``/``progress_grace_s`` (A10), a
``compile_cache_dir`` path and PBT's ``objective="quality_after_quant"``
(A8, ``quant/``).
"""

from __future__ import annotations

import json
import os
import time
import uuid
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.data.loader import Dataset
from distributed_machine_learning_tpu_torch.models import (
    build_model,
    compute_dtype_of,
    init_parameters,
)
from distributed_machine_learning_tpu_torch.ops import flash_attention
from distributed_machine_learning_tpu_torch.ops.losses import get_loss
from distributed_machine_learning_tpu_torch.ops.optimizers import (
    check_supported,
    PopulationOptimizer,
    set_injected_hyperparams,
    state_to,
    take_rows,
)
from distributed_machine_learning_tpu_torch.ops.rng import (
    resolve_rng_impl,
    stream_seed,
)
from distributed_machine_learning_tpu_torch.ops.schedules import get_schedule
from distributed_machine_learning_tpu_torch.tune import checkpoint as ckpt_lib
from distributed_machine_learning_tpu_torch.tune._regression_program import (
    eval_metrics_from_sums,
    make_pbt_generation_fn,
    make_population_epoch_fn,
    make_population_eval_fn,
    make_score_fn,
    stage_data,
)
from distributed_machine_learning_tpu_torch.tune.callbacks import (
    dispatch_safely,
    experiment_counters,
    with_default_reporter,
)
from distributed_machine_learning_tpu_torch.tune.experiment import (
    ExperimentAnalysis,
    ExperimentStore,
)
from distributed_machine_learning_tpu_torch.tune.runner import DEFAULT_STORAGE
from distributed_machine_learning_tpu_torch.tune.schedulers.base import (
    CONTINUE,
    REQUEUE,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)
from distributed_machine_learning_tpu_torch.tune.schedulers.pbt import (
    PopulationBasedTraining,
    generation_draw_count,
    generation_draws,
    reference_generation_step,
)
from distributed_machine_learning_tpu_torch.tune.search.base import (
    RandomSearch,
    Searcher,
    maybe_warm_start,
)
from distributed_machine_learning_tpu_torch.tune.search_space import SearchSpace
from distributed_machine_learning_tpu_torch.tune.stoppers import (
    resolve_stop,
    stop_hit,
)
from distributed_machine_learning_tpu_torch.tune.trainable import (
    _refuse_unported as _refuse_unported_config,
    epoch_permutation,
)
from distributed_machine_learning_tpu_torch.tune.trial import Trial, TrialStatus
from distributed_machine_learning_tpu_torch.utils.device import resolve_device
from distributed_machine_learning_tpu_torch.utils.seeding import (
    init_generators_for,
    rng_from,
)

# Hyperparameters that vary across trials *within* one population.
VECTOR_KEYS = ("learning_rate", "weight_decay", "seed")

INPUT_MODES = ("auto", "resident", "streaming")

# The population checkpoint's index under the experiment root.
POPULATION_CHECKPOINT = "population.json"


def _static_signature(config: Dict[str, Any]) -> Tuple:
    """Hashable signature of everything that shapes the program."""
    items = []
    for k in sorted(config):
        if k in VECTOR_KEYS:
            continue
        v = config[k]
        items.append((k, tuple(v) if isinstance(v, list) else v))
    return tuple(items)


def _refuse_population_knobs(cfg: Dict[str, Any]) -> None:
    """The trainable knobs a population does not take, refused by name
    (a non-injectable optimizer raises the JAX runner's own ValueError,
    from ``PopulationOptimizer``)."""
    if max(int(cfg.get("accumulate_grad_batches", 1)), 1) > 1:
        raise NotImplementedError(
            "run_vectorized takes one optimizer step per batch: the JAX "
            "run_vectorized never reads accumulate_grad_batches and steps "
            "every batch, so the port refuses it rather than ignore it; "
            "use tune.run (see ROADMAP.md C)"
        )
    if cfg.get("remat"):
        raise NotImplementedError(
            "run_vectorized(remat=True): torch.utils.checkpoint does not run "
            "under torch.func's vmap(grad(...)); see ROADMAP.md A1e"
        )


@dataclass
class PopulationState:
    """One population on the device: ``params`` ``{name: [K, ...]}``, the
    population optimizer's state, the rows' dropout-stream seeds ``[K]``
    and the rows' config seeds (their shuffles)."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    stream_seeds: torch.Tensor
    seeds: List[int]


class _GroupProgram:
    """The population init/train/eval programs for one static-signature
    group, with both splits staged on ``device``."""

    def __init__(self, static_cfg: Dict[str, Any], train_data: Dataset,
                 val_data: Dataset, device: torch.device):
        cfg = static_cfg
        self._static_cfg = dict(static_cfg)
        resolve_rng_impl(cfg)
        _refuse_unported_config(cfg)
        _refuse_population_knobs(cfg)
        opt_name = check_supported(cfg.get("optimizer", "adam"))
        self.device = device
        self.loss_name = str(cfg.get("loss_function", "mse"))
        self.num_epochs = int(cfg.get("num_epochs", 20))
        self.compute_dtype = compute_dtype_of(cfg) or torch.float32
        self.num_features = train_data.num_features
        self.data = data = stage_data(
            train_data, val_data, int(cfg.get("batch_size", 32)),
            self.compute_dtype, device)
        self._n_val = len(val_data)
        self._data_sums = _data_checksums(train_data, val_data)
        self.steps_per_epoch = data.num_batches
        total_steps = int(
            cfg.get("total_steps", self.num_epochs * data.num_batches))
        self.total_steps = max(total_steps, 1)
        # Shape-only schedule (peak 1.0); per-row lr scales it.
        self.shape_schedule = get_schedule(
            str(cfg.get("lr_schedule", "warmup_linear_decay")),
            learning_rate=1.0,
            warmup_steps=int(cfg.get("warmup_steps", 0)),
            total_steps=self.total_steps,
        )
        self.tx = PopulationOptimizer(
            opt_name, self.shape_schedule,
            float(cfg.get("momentum", 0.0)),
            float(cfg.get("gradient_clipping", 0.0)),
        )
        # The template lends functional_call its structure and buffers;
        # its own parameters are never trained.
        self.model = build_model(cfg, self.num_features).to(device)
        self._epoch = make_population_epoch_fn(
            self.model, self.tx, get_loss(self.loss_name), data.n_train,
            data.num_batches, data.batch_size)
        self._eval = make_population_eval_fn(
            self.model, data.n_val_blocks, data.eval_bs)
        if device.type == "cuda" and cfg.get("attention_type") == "flash":
            # Build the kernels now, so no epoch's time holds an nvcc build.
            flash_attention.build_kernels()
        # Measured dispatches ({"chunk", "rows", "exec_s"}): the step time
        # PBT's latency objective prices a population by.
        self.dispatch_obs: List[Dict[str, float]] = []

    def init_population(self, seeds: List[int], lrs, wds) -> PopulationState:
        """Each row initialized as ``train_regressor`` initializes a trial
        of that seed, then stacked (``torch.func.stack_module_state``)."""
        from torch.func import stack_module_state

        models = [
            init_parameters(build_model(self._static_cfg, self.num_features),
                            init_generators_for(s)["params"])
            for s in seeds
        ]
        stacked, _ = stack_module_state(models)
        params = {k: v.detach().to(self.device) for k, v in stacked.items()}
        opt_state = set_injected_hyperparams(
            self.tx.init(params), np.asarray(lrs, np.float32),
            np.asarray(wds, np.float32))
        return PopulationState(
            params=params, opt_state=opt_state,
            stream_seeds=torch.tensor([stream_seed(s) for s in seeds],
                                      dtype=torch.int64, device=self.device),
            seeds=[int(s) for s in seeds],
        )

    def permutations(self, state: PopulationState, epoch: int
                     ) -> torch.Tensor:
        """``[K, n_train]``: each row's shuffle for ``epoch``."""
        return self.chunk_permutations(state, epoch, 1)[0]

    def chunk_permutations(self, state: PopulationState, epoch0: int,
                           n: int) -> torch.Tensor:
        """``[n, K, n_train]``: every row's shuffle of epochs ``epoch0`` to
        ``epoch0 + n - 1``, staged with one upload."""
        return torch.stack([
            torch.stack([epoch_permutation(s, e, self.data.n_train)
                         for s in state.seeds])
            for e in range(epoch0, epoch0 + n)]).to(self.device)

    def train_epoch(self, state: PopulationState, epoch: int,
                    perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Train every row one epoch; ``[K]`` mean losses on the device."""
        d = self.data
        if perms is None:
            perms = self.permutations(state, epoch)
        return self._epoch(state.params, state.opt_state, d.x_train,
                           d.y_train, perms, state.stream_seeds,
                           epoch * self.steps_per_epoch)

    def eval_sums(self, state: PopulationState) -> torch.Tensor:
        d = self.data
        return self._eval(state.params, d.x_val, d.y_val, d.val_mask)

    def run_epochs(self, state: PopulationState, epoch0: int, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n`` epochs of training and evaluation for every row, left on
        the device: train losses ``[K, n]`` and eval sums ``[K, n, 4]``."""
        perms = self.chunk_permutations(state, epoch0, n)
        losses, sums = [], []
        for e in range(n):
            losses.append(self.train_epoch(state, epoch0 + e, perms[e]))
            sums.append(self.eval_sums(state))
        return torch.stack(losses, 1), torch.stack(sums, 1)

    def read_epochs(self, losses: torch.Tensor, sums: torch.Tensor
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """ONE read back of :meth:`run_epochs`' outputs: ``(train_losses
        [K, n] float32, {metric: [K, n]})``."""
        host = torch.cat([losses[..., None].float(), sums], dim=-1)
        return self.host_metrics(host.cpu().numpy())

    def host_metrics(self, host: np.ndarray
                     ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """``host`` ``[K, n, 5]`` (train loss, then the eval sums) as
        ``(train_losses [K, n], {metric: [K, n]})``."""
        k, n = host.shape[:2]
        rows = [eval_metrics_from_sums(self.loss_name, *row[1:], self._n_val)
                for row in host.reshape(k * n, 5).astype(np.float64)]
        metrics = {key: np.asarray([r[key] for r in rows]).reshape(k, n)
                   for key in rows[0]}
        return host[..., 0].astype(np.float32), metrics

    def gather_rows(self, state: PopulationState, src, lr, wd
                    ) -> PopulationState:
        """PBT's exploit: row i takes row ``src[i]``'s parameters and
        optimizer state, then the rows' lr/wd are set to ``lr``/``wd``
        (explore).  The dropout-stream and shuffle seeds stay with their
        rows: a lagger keeps its own identity."""
        idx = torch.as_tensor(np.asarray(src), dtype=torch.long,
                              device=self.device)
        opt_state = take_rows(state.opt_state, idx)
        set_injected_hyperparams(opt_state, np.asarray(lr, np.float32),
                                 np.asarray(wd, np.float32))
        return PopulationState(
            params={k: v[idx] for k, v in state.params.items()},
            opt_state=opt_state, stream_seeds=state.stream_seeds,
            seeds=state.seeds)

    def param_count(self) -> int:
        """One row's parameter count (the ``params`` term of PBT's
        multi-objective scalarization)."""
        return sum(int(p.numel()) for p in self.model.parameters())

    def pbt_generation_program(self, spec: Dict[str, Any], *, interval: int,
                               valid, metric: str) -> Any:
        """``make_pbt_generation_fn`` over this group's epoch and eval.
        Returns ``run(state, lr, wd, perms, draws, gen0, obj_scale) ->
        (state, outputs)``."""
        run = make_pbt_generation_fn(
            self._epoch, self._eval,
            make_score_fn(metric, self.loss_name, self._n_val), spec,
            interval=interval, num_epochs_total=self.num_epochs,
            steps_per_epoch=self.steps_per_epoch, valid=valid,
            device=self.device)

        def run_state(state, lr, wd, perms, draws, gen0, obj_scale):
            d = self.data
            params, opt_state, lr, wd, outputs = run(
                state.params, state.opt_state, state.stream_seeds, lr, wd,
                d.x_train, d.y_train, d.x_val, d.y_val, d.val_mask, perms,
                draws, gen0, obj_scale)
            return PopulationState(params, opt_state, state.stream_seeds,
                                   state.seeds), outputs

        return run_state

    def select_rows(self, state: PopulationState, keep: List[int]
                    ) -> PopulationState:
        """The population cut to the rows ``keep``: every stacked leaf."""
        idx = torch.as_tensor(keep, dtype=torch.long, device=self.device)
        return PopulationState(
            params={k: v[idx] for k, v in state.params.items()},
            opt_state=take_rows(state.opt_state, idx),
            stream_seeds=state.stream_seeds[idx],
            seeds=[state.seeds[i] for i in keep],
        )

    def population_tree(self, state: PopulationState) -> Dict[str, Any]:
        """The population as a checkpoint tree (tensors, ints and lists)."""
        return {"params": state.params, "opt_state": state.opt_state,
                "stream_seeds": state.stream_seeds,
                "seeds": [int(s) for s in state.seeds]}

    def restore_population(self, tree: Dict[str, Any]) -> PopulationState:
        """:meth:`population_tree`'s inverse, on this program's device."""
        return PopulationState(
            params={k: v.to(self.device) for k, v in tree["params"].items()},
            opt_state=state_to(tree["opt_state"], self.device),
            stream_seeds=tree["stream_seeds"].to(self.device),
            seeds=[int(s) for s in tree["seeds"]])

    def row_params(self, state: PopulationState, i: int
                   ) -> Dict[str, torch.Tensor]:
        """Row ``i``'s parameters as a state dict on the CPU."""
        return {k: v[i].detach().cpu() for k, v in state.params.items()}

    def rebind_data(self, train_data: Dataset, val_data: Dataset,
                    force: bool = False) -> None:
        """Point this (cache-reused) program at fresh data: re-stage unless
        the content fingerprint matches and ``force`` is off."""
        sums = _data_checksums(train_data, val_data)
        if sums == self._data_sums and not force:
            return
        self.data = stage_data(
            train_data, val_data, int(self._static_cfg.get("batch_size", 32)),
            self.compute_dtype, self.device)
        self._n_val = len(val_data)
        self._data_sums = sums

    def staged_nbytes(self) -> int:
        d = self.data
        return sum(int(t.numel() * t.element_size())
                   for t in (d.x_train, d.y_train, d.x_val, d.y_val))


# Cross-call program cache: repeated ``run_vectorized`` calls with the same
# static config and data shapes (a FIFO then an ASHA sweep, or warm
# repeats) reuse the staged data and the built programs.  Entries pin
# their staged splits in device memory; eviction is LRU by count AND total
# staged bytes, and ``clear_program_cache`` frees it all.
_PROGRAM_CACHE: Dict[Tuple, "_GroupProgram"] = {}
_PROGRAM_CACHE_MAX = 4
_PROGRAM_CACHE_MAX_BYTES = 256 * 1024 * 1024


def clear_program_cache() -> None:
    """Drop every cached group program (frees their staged device data)."""
    _PROGRAM_CACHE.clear()


def _data_fingerprint(train_data: Dataset, val_data: Dataset) -> Tuple:
    return tuple(
        (tuple(a.shape), str(a.dtype))
        for a in (train_data.x, train_data.y, val_data.x, val_data.y)
    )


# Arrays at or below this byte size get an EXACT full-buffer fingerprint;
# larger ones a strided sample.
_FULL_HASH_BYTES = 64 * 1024 * 1024


def _data_checksums(train_data: Dataset, val_data: Dataset) -> Tuple:
    """Content fingerprint for staged-data reuse: crc32 of the whole
    buffer up to ``_FULL_HASH_BYTES``, else of a strided sample (~64k
    elements) plus its float64 sum, which can miss an edit confined to
    unsampled indices (pass ``force_restage=True`` then)."""
    sums = []
    for a in (train_data.x, train_data.y, val_data.x, val_data.y):
        flat = np.ascontiguousarray(np.ravel(a))
        if flat.nbytes <= _FULL_HASH_BYTES:
            sums.append((flat.size, "full", zlib.crc32(flat.view(np.uint8))))
        else:
            stride = max(1, flat.size // 65536)
            sample = np.ascontiguousarray(flat[::stride])
            sums.append((
                flat.size, "sampled", zlib.crc32(sample.view(np.uint8)),
                float(np.sum(sample, dtype=np.float64)),
            ))
    return tuple(sums)


def _group_program_for(sig: Tuple, static_cfg: Dict[str, Any],
                       train_data: Dataset, val_data: Dataset, device,
                       log, force_restage: bool = False) -> "_GroupProgram":
    key = (sig, _data_fingerprint(train_data, val_data), str(device))
    prog = _PROGRAM_CACHE.pop(key, None)
    if prog is not None:
        prog.rebind_data(train_data, val_data, force=force_restage)
        log("program cache hit: reusing the group program"
            + (" (forced re-stage)" if force_restage else ""))
    else:
        prog = _GroupProgram(static_cfg, train_data, val_data, device)
    _PROGRAM_CACHE[key] = prog  # re-insert = LRU touch (dicts are ordered)
    while len(_PROGRAM_CACHE) > 1 and (
        len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX
        or sum(p.staged_nbytes() for p in _PROGRAM_CACHE.values())
        > _PROGRAM_CACHE_MAX_BYTES
    ):
        _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
    return prog


def _stopper_epoch_fraction(sched, num_epochs: int) -> float:
    """Idealized fraction of trial-epochs a rung-based stopper computes.

    Successive-halving geometry from the scheduler's own knobs (ASHA /
    HyperBand expose ``grace_period`` and ``eta``): survivors thin by
    1/eta at each rung, so expected epochs per trial are
    sum_i survivors_i * rung_increment_i.  Schedulers without those
    knobs (median etc.) get a 0.5 prior.
    """
    g = getattr(sched, "grace_period", None)
    rf = getattr(sched, "eta", None) or getattr(sched, "reduction_factor", None)
    if not g or not rf or rf <= 1 or num_epochs <= 0:
        return 0.5
    frac_num, prev, surv, e = 0.0, 0, 1.0, float(g)
    while prev < num_epochs:
        nxt = min(e, float(num_epochs))
        frac_num += surv * (nxt - prev)
        prev, e, surv = nxt, e * rf, surv / rf
    return min(max(frac_num / num_epochs, g / num_epochs), 1.0)


def _refuse_unported(*, devices, pbt_mode: str,
                     checkpoint_every_epochs: int, checkpoint_format: str,
                     progress_deadline_s, progress_grace_s,
                     compile_cache_dir) -> None:
    if pbt_mode not in ("auto", "compiled", "boundary"):
        raise ValueError(
            f"pbt_mode must be 'auto', 'compiled' or 'boundary', "
            f"got {pbt_mode!r}"
        )
    if checkpoint_format not in ("msgpack", "sharded"):
        raise ValueError(
            f"checkpoint_format must be 'msgpack' or 'sharded', "
            f"got {checkpoint_format!r}"
        )
    if not (isinstance(checkpoint_every_epochs, int)
            and checkpoint_every_epochs >= 0):
        raise ValueError(
            f"checkpoint_every_epochs must be an int >= 0, got "
            f"{checkpoint_every_epochs!r}")
    refused = {
        "checkpoint_format": (checkpoint_format != "msgpack", "A7"),
        "devices": (bool(devices) and len(devices) > 1, "A9"),
        "progress_deadline_s": (progress_deadline_s is not None, "A10"),
        "progress_grace_s": (progress_grace_s is not None, "A10"),
        "compile_cache_dir": (compile_cache_dir not in (None, "auto"), "A8"),
    }
    for knob, (is_set, item) in refused.items():
        if is_set:
            raise NotImplementedError(
                f"run_vectorized({knob}=...) is not ported yet; see "
                f"ROADMAP.md {item}"
            )


def run_vectorized(
    param_space: Union[Dict[str, Any], SearchSpace],
    *,
    train_data: Dataset,
    val_data: Dataset,
    metric: str,
    mode: str = "min",
    num_samples: int = 10,
    max_batch_trials: int = 16,
    scheduler: Optional[TrialScheduler] = None,
    search_alg: Optional[Searcher] = None,
    storage_path: str = DEFAULT_STORAGE,
    name: Optional[str] = None,
    seed: int = 0,
    device=None,
    devices: Optional[List] = None,
    verbose: int = 1,
    compile_cache_dir: Optional[str] = "auto",
    compaction: str = "auto",
    epochs_per_dispatch="auto",
    pbt_mode: str = "auto",
    input_mode: str = "auto",
    checkpoint_every_epochs: int = 0,
    checkpoint_format: str = "msgpack",
    resume: bool = False,
    callbacks: Optional[List] = None,
    points_to_evaluate: Optional[List[Dict[str, Any]]] = None,
    stop=None,
    force_restage: bool = False,
    progress_deadline_s: Optional[float] = None,
    progress_grace_s: Optional[float] = None,
) -> ExperimentAnalysis:
    """Run an HPO sweep with trials batched into populations.

    Same observable contract as ``tune.run`` (per-epoch results with
    ``training_iteration``/``time_total_s``, the experiment store on disk,
    an ``ExperimentAnalysis`` with ``best_config``), executed as one
    population per static-signature group per chunk.

    ``device``: where the populations train; ``None`` is the current card
    (the run raises without one), ``"cpu"`` runs on the CPU.  ``devices``
    with one entry is the same as ``device``.  ``force_restage``:
    re-stage the data even when a cached program's fingerprint matches.
    ``compile_cache_dir``: ``"auto"`` and ``None`` are accepted; there is
    nothing to compile.  ``pbt_mode`` (with a ``PopulationBasedTraining``
    or ``PB2`` scheduler): ``"auto"`` takes the compiled path where the
    scheduler allows it, ``"compiled"`` demands it (raises where PB2,
    list/quantized/callable specs or ``stop=`` need host decisions),
    ``"boundary"`` reads back once per interval; the ``pbt`` block of
    ``experiment_state.json`` (mode, generations, exploits, explores,
    host_dispatches) records which path ran.  ``checkpoint_every_epochs``
    and ``resume`` (which needs ``name``): see the module docstring, which
    also lists the knobs that are refused and the JAX runner's decisions
    that take no effect here.
    """
    if resume and not name:
        raise ValueError("resume=True requires name= of the prior run")
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    if input_mode not in INPUT_MODES:
        raise ValueError(
            f"input_mode must be one of {INPUT_MODES}, got {input_mode!r}")
    if compaction not in ("auto", "always", "never"):
        raise ValueError(
            f"compaction must be 'auto', 'always' or 'never', got {compaction!r}"
        )
    if epochs_per_dispatch != "auto" and not (
            isinstance(epochs_per_dispatch, int) and epochs_per_dispatch >= 1):
        raise ValueError(
            f"epochs_per_dispatch must be 'auto' or an int >= 1, got "
            f"{epochs_per_dispatch!r}")
    if device is not None and devices:
        raise ValueError("pass either device or devices, not both")
    _refuse_unported(
        devices=devices, pbt_mode=pbt_mode,
        checkpoint_every_epochs=checkpoint_every_epochs,
        checkpoint_format=checkpoint_format,
        progress_deadline_s=progress_deadline_s,
        progress_grace_s=progress_grace_s,
        compile_cache_dir=compile_cache_dir,
    )
    device = resolve_device(devices[0] if devices else (device or "cuda"))
    mode_fallbacks = 0
    if input_mode == "streaming":
        # Every row's batches are gathered from the shared staged splits
        # on the device; a host-side chunk gather would multiply host work
        # (and slab bytes) by the population size.
        mode_fallbacks += 1
    space = (
        param_space if isinstance(param_space, SearchSpace)
        else SearchSpace(param_space)
    )
    stop = resolve_stop(stop)  # validate dict/callable/Stopper up front
    searcher = maybe_warm_start(search_alg or RandomSearch(), points_to_evaluate)
    searcher.set_search_space(space, seed)
    sched = scheduler or FIFOScheduler()
    pbt: Optional[PopulationBasedTraining] = None
    if isinstance(sched, PopulationBasedTraining):
        # The population is the PBT population: only hyperparameters that
        # are optimizer state can mutate in it; the others change the
        # program and need tune.run's respawn PBT.
        bad = set(sched.mutations) - {"learning_rate", "weight_decay"}
        if bad:
            raise ValueError(
                f"vectorized PBT can only mutate learning_rate/weight_decay "
                f"(optimizer-state hyperparams); {sorted(bad)} change the "
                f"compiled program — use tune.run for those"
            )
        pbt = sched
    sched.set_experiment(metric, mode)
    pbt_compiled, pbt_spec, pbt_counters = _resolve_pbt_mode(
        pbt, pbt_mode, mode, stop)

    name = name or f"vexp_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"
    trials: List[Trial] = []
    next_index = 0
    resume_state = None
    unstarted: List[Trial] = []
    if resume:
        # The checkpoint names its population's trials, so a multi-chunk
        # sweep resumes too: finished chunks replay from disk, the
        # in-flight chunk restores its population, and sampling continues
        # toward num_samples afterwards.  Raises before anything is made
        # when there is no checkpoint.
        resume_state, finished, live, unstarted = _load_resume_state(
            ExperimentStore.root_for(storage_path, name), metric, mode, sched,
            searcher, pbt, stop_rules=stop)
        trials = sorted(finished + live + unstarted, key=lambda t: t.trial_id)
        next_index = len(trials)
        searcher.fast_forward(next_index)
    store = ExperimentStore(storage_path, name)
    store.set_context(metric, mode)
    ckpt_path = (os.path.join(store.root, POPULATION_CHECKPOINT)
                 if checkpoint_every_epochs else None)
    start_time = time.time()

    def log(msg: str):
        if verbose:
            print(f"[tune.vectorized] {msg}", flush=True)

    if mode_fallbacks:
        log("input_mode='streaming' falls back to resident staging here: "
            "populations gather per-row permutations from the shared "
            "staged splits (counted as host_input.mode_fallbacks; use "
            "tune.run for out-of-core datasets)")

    callbacks = with_default_reporter(callbacks, verbose)

    def safe_cb(hook: str, *cb_args):
        dispatch_safely(callbacks, hook, *cb_args, log=log)

    programs: Dict[Tuple, _GroupProgram] = {}
    exhausted = False
    row_epochs = 0  # trial-epochs actually computed (compaction shrinks this)
    exec_total_s = 0.0  # dispatch-to-sync seconds across all populations
    compactions = 0

    def _teardown():
        """Always runs (exceptions, Ctrl-C): persist state, close the
        store, and let callbacks see the experiment end."""
        wall = time.time() - start_time
        # The JAX runner's duty cycle: seconds from an epoch's dispatch to
        # its synchronizing read back, over wall seconds.
        utilization = (
            round(min(exec_total_s / wall, 1.0), 4) if wall > 0 else 0.0
        )
        extra = {
            "wall_clock_s": wall,
            "device_utilization": utilization,
            "device_exec_s": round(exec_total_s, 3),
            "vectorized": True,
            "row_epochs_computed": row_epochs,
            "population_compactions": compactions,
            "compile_time_total_s": 0.0,
        }
        if mode_fallbacks or input_mode != "auto":
            extra["host_input"] = {"mode_fallbacks": mode_fallbacks,
                                   "input_mode_requested": input_mode}
        if pbt is not None:
            # Which path ran is a property of the artifact: a population
            # that fell back to the boundary path overrides ``mode``.
            extra["pbt"] = {
                "mode": "compiled" if pbt_compiled else "boundary",
                "objective": pbt.objective,
                "interval": int(pbt.interval),
                **pbt_counters,
                **pbt.debug_state(),
            }
        try:
            store.write_state(trials, extra=extra)
            store.close()
        except Exception as exc:  # noqa: BLE001 - callbacks still tear down
            log(f"experiment store teardown failed: {exc!r}")
        counters = experiment_counters(extra)
        if counters:
            safe_cb("on_experiment_counters", counters)
        safe_cb("on_experiment_end", trials, wall)
        return wall, utilization

    try:
        for cb in callbacks:
            cb.setup(store.root, metric, mode)
        # Chunked suggest->train loop: adaptive searchers observe all
        # results from earlier chunks before proposing the next one.
        while ((next_index < num_samples and not exhausted)
               or resume_state is not None or unstarted):
            if resume_state is not None:
                chunk = list(resume_state["batch"])
            elif unstarted:
                # Trials made but never started before the interruption
                # (between their params.json and their chunk's first
                # checkpoint): they run as a chunk of their own.
                chunk, unstarted = list(unstarted), []
            else:
                chunk = []
                while (len(chunk) < max_batch_trials
                       and next_index < num_samples):
                    config = searcher.suggest(next_index)
                    if config is None:
                        exhausted = True
                        break
                    trial = Trial(trial_id=f"trial_{next_index:05d}",
                                  config=config)
                    next_index += 1
                    trials.append(trial)
                    chunk.append(trial)
                    sched.on_trial_add(trial)
                    store.write_params(trial)
            if not chunk:
                break

            groups: Dict[Tuple, List[Trial]] = {}
            for t in chunk:
                groups.setdefault(_static_signature(t.config), []).append(t)
            log(
                f"chunk of {len(chunk)} trials in {len(groups)} static "
                f"group(s) [{len(trials)}/{num_samples} suggested]"
            )
            group_ckpt_path = ckpt_path
            if ckpt_path and len(groups) > 1:
                log("population checkpointing needs a single static group; "
                    f"this chunk has {len(groups)}: checkpoints disabled")
                group_ckpt_path = None
            for sig, members in groups.items():
                program = programs.get(sig)
                if program is None:
                    program = programs[sig] = _group_program_for(
                        sig, dict(members[0].config), train_data, val_data,
                        device, log, force_restage=force_restage,
                    )
                pop_rows, pop_exec_s, pop_compactions = _run_population(
                    program, members, sched, searcher, store, metric, mode,
                    log, compaction, safe_cb, stop_rules=stop, pbt=pbt,
                    pbt_compiled=pbt_compiled, pbt_spec=pbt_spec,
                    pbt_counters=pbt_counters,
                    epochs_per_dispatch=epochs_per_dispatch,
                    checkpoint_every_epochs=checkpoint_every_epochs,
                    ckpt_path=group_ckpt_path, resume_state=resume_state,
                )
                resume_state = None  # consumed by the first (only) group
                row_epochs += pop_rows
                exec_total_s += pop_exec_s
                compactions += pop_compactions
    finally:
        wall, utilization = _teardown()

    analysis = ExperimentAnalysis(
        trials, metric=metric, mode=mode, root=store.root, wall_clock_s=wall,
        device_utilization=utilization,
    )
    log(
        f"experiment {name}: {analysis.num_terminated()}/{len(trials)} trials in "
        f"{wall:.1f}s ({analysis.trials_per_hour():.1f} trials/hour, "
        f"{100 * utilization:.0f}% dispatch-to-sync share, vectorized)"
    )
    return analysis


def _load_resume_state(root: str, metric: str, mode: str,
                       sched: TrialScheduler, searcher: Searcher, pbt,
                       stop_rules=None
                       ) -> Tuple[Dict[str, Any], List[Trial], List[Trial],
                                  List[Trial]]:
    """Rehydrate an interrupted sweep: load the population checkpoint,
    rebuild the trials from the experiment directory, and replay their
    records through the scheduler and searcher so that their state is
    what it was when the checkpoint was written.

    The checkpoint's ``trial_ids`` name the in-flight chunk; the other
    trials with records belong to chunks that finished and replay as
    TERMINATED; those without records were made but never started and run
    again.  Returns ``(resume_state, finished, live_batch, unstarted)``."""
    ck = ckpt_lib.load_checkpoint(os.path.join(root, POPULATION_CHECKPOINT))
    if ck is None:
        raise ValueError(
            f"resume=True but no population checkpoint under {root} (no "
            f"{POPULATION_CHECKPOINT}; was the run started with "
            f"checkpoint_every_epochs > 0?)")
    prior = ExperimentAnalysis.from_directory(root, metric, mode)
    by_id = {t.trial_id: t for t in prior.trials}
    ck_ids = [str(i) for i in ck["trial_ids"]]
    missing = [i for i in ck_ids if i not in by_id]
    if missing:
        raise ValueError(f"population checkpoint names trials missing from "
                         f"{root}: {missing}")
    batch = [by_id[i] for i in ck_ids]
    others = [t for t in sorted(by_id.values(), key=lambda t: t.trial_id)
              if t.trial_id not in set(ck_ids)]
    finished = [t for t in others if t.results]
    unstarted = [t for t in others if not t.results]
    for trial in unstarted:
        sched.on_trial_add(trial)
    active = [bool(a) for a in ck["active"]]
    if len(batch) != len(active):
        raise ValueError(
            f"checkpoint population size ({len(active)}) does not match its "
            f"{len(batch)} trials under {root}")
    lrs = ck["lrs"].numpy().astype(np.float32)
    wds = ck["wds"].numpy().astype(np.float32)
    epoch0 = int(ck["epoch0"])
    now = time.time()

    # Chunks that finished before the interruption: whole replay, terminal.
    for trial in finished:
        sched.on_trial_add(trial)
        runtime = float(trial.results[-1].get("time_total_s", 0.0))
        trial.started_at = now - runtime
        trial.finished_at = now
        trial.reports_since_restart = len(trial.results)
        trial.status = TrialStatus.TERMINATED
    _replay_records(finished, sched, searcher, pbt, metric, mode, stop_rules)
    for trial in finished:
        sched.on_trial_complete(trial)
        searcher.on_trial_complete(trial.trial_id, trial.config,
                                   trial.last_result, metric, mode)
    for idx, trial in enumerate(batch):
        # The crash may have come after the checkpoint: those epochs run
        # again, so their records go (memory and file) or they would count
        # twice.  The file is written anew (a killed process may have cut
        # its last line).
        kept = [r for r in trial.results
                if int(r.get("training_iteration", 0)) <= epoch0]
        trial.results = kept
        with open(os.path.join(root, trial.trial_id, "result.jsonl"),
                  "w") as f:
            for r in kept:
                f.write(json.dumps(r) + "\n")
        # PBT may have changed lr/wd since params.json was written; a value
        # it left alone keeps the bits params.json holds (the population
        # carries them rounded to float32).
        trial.config = dict(trial.config)
        for key, value in (("learning_rate", lrs[idx]),
                           ("weight_decay", wds[idx])):
            if key in trial.config and np.float32(trial.config[key]) != value:
                trial.config[key] = float(value)
        sched.on_trial_add(trial)
        # time_total_s goes on from the last record across the gap.
        runtime = float(kept[-1]["time_total_s"]) if kept else 0.0
        trial.started_at = now - runtime
        trial.restore_base = 0
        trial.reports_since_restart = len(kept)
        if active[idx]:
            trial.status = TrialStatus.RUNNING
            trial.finished_at = None
        else:
            # A stopped trial's clock stays at its recorded runtime.
            trial.status = TrialStatus.TERMINATED
            trial.finished_at = now
    _replay_records(batch, sched, searcher, pbt, metric, mode, stop_rules)
    for idx, trial in enumerate(batch):
        if not active[idx]:
            sched.on_trial_complete(trial)
            searcher.on_trial_complete(trial.trial_id, trial.config,
                                       trial.last_result, metric, mode)
    resume_state = {
        "state": ck["state"],
        "rows": [int(r) for r in ck["rows"]],
        "active": active,
        "lrs": lrs,
        "wds": wds,
        "epoch0": epoch0,
        "pbt_notes": {int(r): d for r, d in ck["pbt_notes"].items()},
        "batch": batch,
    }
    return resume_state, finished, batch, unstarted


def _replay_records(trial_list, sched, searcher, pbt, metric, mode,
                    stop_rules=None) -> None:
    """Route stored records back through the scheduler and searcher in
    epoch-major order, the order the live loop produced them, and warm
    stateful stop rules (their decisions ignored).  Under PBT the
    scheduler is skipped (the population carries its decisions) and
    re-baselined on each trial's last record only: a full history would
    credit every old change to the trial's final config."""
    for e in range(max((len(t.results) for t in trial_list), default=0)):
        for trial in trial_list:
            if e < len(trial.results):
                record = trial.results[e]
                if pbt is None:
                    sched.on_trial_result(trial, record)
                searcher.on_trial_result(trial.trial_id, dict(trial.config),
                                         record, metric, mode)
                if callable(stop_rules):
                    stop_hit(stop_rules, trial.trial_id, record)
    if pbt is not None:
        for trial in trial_list:
            if trial.results:
                pbt.observe_result(trial, trial.results[-1])


def _resolve_pbt_mode(pbt, pbt_mode: str, mode: str, stop
                      ) -> Tuple[bool, Optional[Dict[str, Any]],
                                 Dict[str, Any]]:
    """``(compiled, device_spec, counters)`` of a PBT sweep, as the JAX
    runner resolves them: PB2, list/quantized/callable specs and ``stop=``
    rules force the boundary path, and ``pbt_mode="compiled"`` raises
    where it is forced."""
    if pbt is None:
        return False, None, {}
    if pbt.quant_aware:
        raise NotImplementedError(
            "PopulationBasedTraining(objective='quality_after_quant') needs "
            "the int8 re-scoring of quant/, which is not ported yet; see "
            "ROADMAP.md A8"
        )
    if pbt.objective_weights != (0.0, 0.0) and mode != "min":
        raise ValueError(
            "PopulationBasedTraining(objective=...) scalarizes "
            "quality x latency x params as a COST product — it is only "
            "defined for mode='min' metrics"
        )
    spec = pbt.device_mutation_spec()
    reasons = []
    if spec is None:
        reasons.append("the scheduler/mutation specs need per-generation "
                       "host decisions (PB2, list/quantized/callable specs)")
    if stop is not None:
        reasons.append("stop= rules decide per epoch on host")
    if pbt_mode == "compiled" and reasons:
        raise ValueError("pbt_mode='compiled' is impossible here: "
                         + "; ".join(reasons))
    counters = {"generations": 0, "exploits": 0, "explores": 0,
                "host_dispatches": 0}
    return pbt_mode != "boundary" and not reasons, spec, counters


def _emit_epoch_records(
    batch, rows, active, lrs, epoch, step_count, shape_val, now,
    train_losses, metrics_np, sched, searcher, store, metric, mode,
    safe_cb=lambda *a: None, stop_rules=None, pbt_notes=None, pbt=None,
):
    """Append one epoch's records for every live trial and route them
    through the scheduler/searcher (the vectorized analogue of
    ``session.report``).  Under PBT a record right after an exploit notes
    its donor (``pbt_exploited_from``), and the scheduler only observes
    (PB2's model learns; the row gather replaces its decisions).  The port
    pads no population, so it has no pad rows to skip."""
    for i, r in enumerate(rows):
        trial = batch[r]
        if not active[r]:
            continue
        record = {
            "epoch": epoch,
            "training_iteration": epoch + 1,
            "train_loss": float(train_losses[i]),
            "steps": step_count,
            "lr": float(lrs[r]) * shape_val,
            "trial_id": trial.trial_id,
            "timestamp": now,
            "time_total_s": now - trial.started_at,
            "population_size": len(rows),
            **{key: float(v[i]) for key, v in metrics_np.items()},
        }
        note = pbt_notes.pop(r, None) if pbt_notes is not None else None
        if note is not None:
            record["pbt_exploited_from"] = note
        trial.results.append(record)
        # Keep Trial.training_iteration live (== epochs completed), the
        # same contract the threaded executor maintains via report().
        trial.reports_since_restart += 1
        store.append_result(trial, record)
        safe_cb("on_trial_result", trial, record)
        if pbt is not None:
            pbt.observe_result(trial, record)
            decision = CONTINUE
        else:
            decision = sched.on_trial_result(trial, record)
        searcher.on_trial_result(
            trial.trial_id, dict(trial.config), record, metric, mode
        )
        if decision == REQUEUE:
            raise ValueError(
                "requeue schedulers are not supported in vectorized mode; "
                "use tune.run"
            )
        if decision == CONTINUE and stop_rules is not None:
            # Same stop surface as tune.run (stoppers.stop_hit).
            if stop_hit(stop_rules, trial.trial_id, record):
                decision = STOP
        if decision == STOP:
            active[r] = False
            trial.status = TrialStatus.TERMINATED
            trial.finished_at = time.time()
            sched.on_trial_complete(trial)
            searcher.on_trial_complete(
                trial.trial_id, trial.config, trial.last_result, metric, mode
            )
            safe_cb("on_trial_complete", trial)


def _compaction_keep(rows: List[int], active: List[bool], remaining: int,
                     compaction: str) -> Optional[List[int]]:
    """The population rows to keep, or None to keep them all: once the
    survivors fit in half the rows (and epochs remain), EXACTLY half,
    padded with already-stopped rows if the survivors undershoot, so
    sizes walk the ladder K, K/2, K/4, ... as in the JAX runner."""
    pos = [i for i, r in enumerate(rows) if active[r]]
    target = len(rows) // 2
    if compaction == "never" or remaining <= 0 or not 0 < len(pos) <= target:
        return None
    live = set(pos)
    pad = [i for i in range(len(rows)) if i not in live]
    return sorted(pos + pad[: target - len(pos)])


def _save_final(program, store, state, trial: Trial, i: int) -> None:
    """Row ``i``'s parameters as the trial's one checkpoint, at its
    training iteration."""
    path = ckpt_lib.checkpoint_path(store.checkpoint_dir(trial),
                                    trial.training_iteration)
    ckpt_lib.save_checkpoint(path, {"params": program.row_params(state, i),
                                    "epoch": trial.training_iteration - 1})
    trial.latest_checkpoint = path
    trial.latest_checkpoint_iteration = trial.training_iteration


def _pbt_objective_scale(pbt, program) -> float:
    """The constant scalarization factor of the multi-objective score:
    ``step_latency_s ** lat_w * param_millions ** param_w``.

    Latency is the population's measured step time (the newest dispatch
    in ``program.dispatch_obs``, which rides the cross-call program cache,
    so a warm sweep prices itself from the prior sweep; 1.0 before any
    measurement) and params the group's per-row parameter count; both are
    constant across the rows, so in-population ranking is unchanged.
    Frozen per population: re-reading the latency between generations
    would break the compiled-vs-boundary decision parity."""
    lat_w, par_w = pbt.objective_weights
    if lat_w == 0.0 and par_w == 0.0:
        return 1.0
    scale = 1.0
    if lat_w:
        obs = [o for o in getattr(program, "dispatch_obs", [])
               if o.get("exec_s") and o.get("chunk")]
        if obs:
            o = obs[-1]
            step_s = o["exec_s"] / max(o["chunk"] * program.steps_per_epoch,
                                       1)
            scale *= step_s ** lat_w
    if par_w:
        scale *= (program.param_count() / 1e6) ** par_w
    # float32: the device multiplies scores by this as an f32 scalar and
    # the host reference must see the same bits.
    return float(np.float32(scale))


def _inject_objective(pbt, obj_scale, train_losses, metrics_np):
    """Attach the scalarized objective as a per-epoch record metric
    (``pbt_objective``) when multi-objective ranking is on."""
    if pbt is None or pbt.objective_weights == (0.0, 0.0):
        return metrics_np
    col = (train_losses if pbt.metric == "train_loss"
           else metrics_np.get(pbt.metric))
    if col is None:
        return metrics_np
    out = dict(metrics_np)
    out["pbt_objective"] = np.asarray(col, np.float32) * np.float32(obj_scale)
    return out


def _apply_reference_exploits(batch, rows, lrs, wds, pbt, pbt_notes,
                              src, new_lr, new_wd, exploited, mut_keys):
    """Mirror one generation's exploit decisions into the host
    bookkeeping: a lagger's config becomes the donor's with the perturbed
    hyperparams (it keeps its own seed), its improvement chain resets, and
    the donor note annotates its next record.  Returns the (lagger, donor)
    trial-id pairs."""
    pairs = []
    for i in np.flatnonzero(np.asarray(exploited)):
        i = int(i)
        r = rows[i]
        lagger, donor = batch[r], batch[rows[int(src[i])]]
        new_cfg = dict(donor.config)
        new_cfg["learning_rate"] = float(new_lr[i])
        if "weight_decay" in new_cfg or "weight_decay" in mut_keys:
            new_cfg["weight_decay"] = float(new_wd[i])
        new_cfg["seed"] = lagger.config.get("seed", 0)
        lagger.config = new_cfg
        pbt.reset_improvement_chain(lagger.trial_id)
        lrs[r] = float(new_lr[i])
        wds[r] = float(new_wd[i])
        pbt_notes[r] = donor.trial_id
        pairs.append((lagger.trial_id, donor.trial_id))
        pbt._num_perturbations += 1
    return pairs


def _fall_back_to_boundary(counters, log, why: str) -> None:
    log(f"PBT falling back to boundary mode: {why}")
    counters["mode"] = "boundary"
    counters["mode_fallbacks"] = counters.get("mode_fallbacks", 0) + 1


def _pbt_dispatch(program, pbt, compiled: bool, epochs_per_dispatch,
                  stop_rules, counters, log, ckpt_every: int = 0
                  ) -> Tuple[int, int, bool]:
    """``(epochs per dispatch, generations per compiled dispatch,
    compiled)`` of a PBT population, by the JAX runner's rules: the
    compiled path dispatches whole generations (all of them under
    ``"auto"``, at most ``ckpt_every`` epochs when checkpointing), the
    boundary path at most one interval, rounded down to a divisor of
    ``num_epochs``.  A compiled dispatch below one interval falls back to
    the boundary path, counted in ``mode_fallbacks``."""
    iv = max(int(pbt.interval), 1)
    num_epochs = program.num_epochs
    if epochs_per_dispatch == "auto":
        dispatch = num_epochs if compiled else iv
        if stop_rules is not None:
            dispatch = 1  # stop rules act at dispatch boundaries
        if ckpt_every:
            # Population checkpoints land at dispatch boundaries.
            dispatch = min(dispatch, ckpt_every)
    else:
        dispatch = max(int(epochs_per_dispatch), 1)
    chunk_gens = 0
    if compiled:
        chunk_gens = dispatch // iv
        if chunk_gens < 1:
            _fall_back_to_boundary(counters, log, f"dispatch chunk {dispatch} "
                                   f"< perturbation interval {iv}")
            compiled = False
        elif chunk_gens * iv != dispatch:
            log(f"epochs_per_dispatch rounded {dispatch} -> "
                f"{chunk_gens * iv} (whole generations of {iv} epochs)")
            dispatch = chunk_gens * iv
    if not compiled and dispatch > iv:
        # One gather per dispatch boundary: a larger chunk would drop
        # perturbations, not delay them.
        log(f"epochs_per_dispatch clamped {dispatch} -> {iv} to match the "
            f"PBT perturbation interval (boundary mode)")
        dispatch = iv
    if dispatch > 1 and not compiled and num_epochs % dispatch:
        d = dispatch
        while num_epochs % d:
            d -= 1
        log(f"epochs_per_dispatch rounded {dispatch} -> {d} (largest "
            f"divisor of num_epochs={num_epochs})")
        dispatch = d
    return dispatch, chunk_gens, compiled


def _read_generations(outputs, program) -> List[Dict[str, np.ndarray]]:
    """The stacked outputs of a compiled chunk, read back ONCE (every
    tensor packed into one float64 vector; float32 values, row indices
    and flags are exact in it)."""
    parts = [torch.cat([t.double().reshape(-1) for t in gen])
             for gen in outputs]
    host = torch.cat(parts).cpu().numpy()
    out, pos = [], 0
    for (tl, sums, *_), part in zip(outputs, parts):
        k, iv = tl.shape
        flat = host[pos:pos + part.numel()]
        pos += part.numel()
        a, b = k * iv, k * iv * 5
        train_losses, metrics = program.host_metrics(np.concatenate(
            [flat[:a].reshape(k, iv, 1), flat[a:b].reshape(k, iv, 4)], -1))
        scores, src, new_lr, new_wd, exploited = flat[b:].reshape(5, k)
        out.append({
            "train_losses": train_losses, "metrics": metrics,
            "scores": scores.astype(np.float32),
            "src": src.astype(np.int64),
            "new_lr": new_lr.astype(np.float32),
            "new_wd": new_wd.astype(np.float32),
            "exploited": exploited.astype(bool),
        })
    return out


def _note_dispatch(program, chunk: int, rows: int, exec_s: float) -> None:
    obs = getattr(program, "dispatch_obs", None)
    if obs is not None:
        obs.append({"chunk": chunk, "rows": rows, "exec_s": exec_s})
        del obs[:-32]


def _run_population(
    program: _GroupProgram,
    batch: List[Trial],
    sched: TrialScheduler,
    searcher: Searcher,
    store: ExperimentStore,
    metric: str,
    mode: str,
    log,
    compaction: str = "auto",
    safe_cb=lambda *a: None,
    stop_rules=None,
    *,
    pbt=None,
    pbt_compiled: bool = False,
    pbt_spec=None,
    pbt_counters=None,
    epochs_per_dispatch="auto",
    checkpoint_every_epochs: int = 0,
    ckpt_path: Optional[str] = None,
    resume_state: Optional[Dict[str, Any]] = None,
) -> Tuple[int, float, int]:
    """Train one population of K same-shape trials to completion, or, with
    ``resume_state`` (from :func:`_load_resume_state`), continue one from
    its checkpoint.

    Returns ``(row_epochs, exec_seconds, compactions)``: trial-epochs
    actually computed (rows x epochs, the honest cost under compaction),
    dispatch-to-sync seconds, and how many times the population was
    compacted.  Without PBT a dispatch is one epoch; under PBT see
    :func:`_pbt_dispatch`.  With ``ckpt_path`` the population is saved
    at the start and every ``checkpoint_every_epochs`` epochs."""
    ckpt_every = int(checkpoint_every_epochs or 0) if ckpt_path else 0
    epoch_start = 0
    pbt_notes: Dict[int, str] = {}  # trial index -> donor id, for the record
    if resume_state is not None:
        # The population at the checkpointed row count (compaction may
        # have cut it), filled from the file: nothing to initialize.
        lrs = np.asarray(resume_state["lrs"], np.float32)
        wds = np.asarray(resume_state["wds"], np.float32)
        rows = list(resume_state["rows"])
        active = list(resume_state["active"])
        epoch_start = int(resume_state["epoch0"])
        state = program.restore_population(resume_state["state"])
        pbt_notes.update(resume_state["pbt_notes"])
        log(f"resumed population of {len(rows)} rows at epoch "
            f"{epoch_start}")
    else:
        now = time.time()
        for t in batch:
            t.status = TrialStatus.RUNNING
            t.started_at = now
            safe_cb("on_trial_start", t)
        seeds = [int(t.config.get("seed", 0)) for t in batch]
        lrs = np.asarray([float(t.config["learning_rate"]) for t in batch],
                         np.float32)
        wds = np.asarray([float(t.config.get("weight_decay", 0.0))
                          for t in batch], np.float32)
        state = program.init_population(seeds, lrs, wds)
        active = [True] * len(batch)
        # ``rows[i]`` = index into ``batch`` of the trial living at
        # population row i.  Compaction cuts stopped rows out and shrinks
        # this mapping.
        rows = list(range(len(batch)))

    def save_population(at_epoch: int) -> None:
        # The trial ids tell a resume the in-flight chunk from the chunks
        # that finished (each chunk overwrites this file).
        ckpt_lib.save_replacing(ckpt_path, {
            "state": program.population_tree(state),
            "rows": [int(r) for r in rows],
            "active": [bool(a) for a in active],
            "lrs": torch.from_numpy(np.array(lrs, np.float32)),
            "wds": torch.from_numpy(np.array(wds, np.float32)),
            "epoch0": int(at_epoch),
            "trial_ids": [t.trial_id for t in batch],
            "pbt_notes": {str(r): d for r, d in pbt_notes.items()},
        })
        log(f"population checkpoint at epoch {at_epoch}")

    if ckpt_every and resume_state is None:
        # From here on the file names the chunk that is running: a crash
        # before its first periodic save must not resume the previous one.
        save_population(0)

    row_epochs, exec_total_s, compactions = 0, 0.0, 0
    num_epochs = program.num_epochs
    counters = pbt_counters if pbt_counters is not None else {}
    dispatch, chunk_gens, iv = 1, 0, 1
    realign = False
    if pbt is not None:
        iv = max(int(pbt.interval), 1)
        if pbt_compiled and epoch_start % iv:
            # The generation program cannot start mid-generation; the
            # boundary path takes the same decisions (the shared step).
            _fall_back_to_boundary(
                counters, log, f"resume epoch {epoch_start} is not a "
                f"multiple of the perturbation interval {iv}")
            pbt_compiled, realign = False, True
        dispatch, chunk_gens, pbt_compiled = _pbt_dispatch(
            program, pbt, pbt_compiled, epochs_per_dispatch, stop_rules,
            counters, log, ckpt_every)
    # The deterministic step's state: each row's lr/wd as the decision
    # step last produced them (the float32 bits the optimizer carries),
    # and the frozen objective scale.
    mut_keys: Tuple[str, ...] = ()
    row_lr = row_wd = None
    obj_scale = 1.0
    if pbt is not None and pbt_spec is not None:
        mut_keys = tuple(pbt_spec["keys"])
        row_lr, row_wd = lrs[rows], wds[rows]
        obj_scale = _pbt_objective_scale(pbt, program)
        if obj_scale != 1.0:
            log(f"PBT multi-objective ranking: scores scaled by "
                f"{obj_scale:.3g} ({pbt.objective})")

    def emit(epoch, train_losses, metrics_np, now):
        step_count = (epoch + 1) * program.steps_per_epoch
        shape_val = float(
            program.shape_schedule(min(step_count, program.total_steps)))
        metrics_np = _inject_objective(pbt, obj_scale, train_losses,
                                       metrics_np)
        _emit_epoch_records(
            batch, rows, active, lrs, epoch, step_count, shape_val, now,
            train_losses, metrics_np, sched, searcher, store, metric, mode,
            safe_cb, stop_rules, pbt_notes, pbt,
        )

    epoch0 = epoch_start
    while epoch0 < num_epochs:
        if (pbt_compiled and epoch0 % iv == 0
                and num_epochs - epoch0 >= iv):
            # ---- compiled PBT: g generations enqueued, one read back ----
            g = min(chunk_gens, (num_epochs - epoch0) // iv)
            gen0 = epoch0 // iv
            valid = np.asarray([active[r] for r in rows])
            run = program.pbt_generation_program(
                pbt_spec, interval=iv, valid=valid, metric=pbt.metric)
            t0 = time.time()
            n_draws = generation_draw_count(pbt_spec)
            draws = np.stack([generation_draws(pbt.seed, len(rows), gen,
                                               n_draws)
                              for gen in range(gen0, gen0 + g)])
            dev = program.device
            state, outputs = run(
                state, torch.as_tensor(row_lr, device=dev),
                torch.as_tensor(row_wd, device=dev),
                program.chunk_permutations(state, epoch0, g * iv),
                torch.as_tensor(draws, device=dev), gen0,
                torch.as_tensor(np.float32(obj_scale), device=dev))
            gens = _read_generations(outputs, program)
            exec_s = time.time() - t0
            exec_total_s += exec_s
            row_epochs += len(rows) * g * iv
            _note_dispatch(program, g * iv, len(rows), exec_s)
            counters["host_dispatches"] += 1
            counters["generations"] += g
            t_end = time.time()
            for gi, out in enumerate(gens):
                gen = gen0 + gi
                for e_off in range(iv):
                    n_done = gi * iv + e_off + 1
                    emit(gen * iv + e_off, out["train_losses"][:, e_off],
                         {m: v[:, e_off] for m, v in out["metrics"].items()},
                         t0 + n_done * (t_end - t0) / (g * iv))
                # Notes annotate the NEXT generation's first record, as on
                # the boundary path.
                pbt._generation_log.append({
                    "gen": gen, "fire": bool((gen + 1) * iv < num_epochs),
                    "scores": out["scores"], "row_lr": row_lr.copy(),
                    "row_wd": row_wd.copy(), "valid": valid,
                    "src": out["src"], "new_lr": out["new_lr"],
                    "new_wd": out["new_wd"], "exploited": out["exploited"],
                })
                pairs = _apply_reference_exploits(
                    batch, rows, lrs, wds, pbt, pbt_notes, out["src"],
                    out["new_lr"], out["new_wd"], out["exploited"], mut_keys)
                counters["exploits"] += len(pairs)
                counters["explores"] += len(pairs) * len(mut_keys)
                if pairs:
                    log(f"PBT epoch {(gen + 1) * iv - 1} (on the device): "
                        + ", ".join(f"{a}<-{b}" for a, b in pairs))
                row_lr, row_wd = out["new_lr"].copy(), out["new_wd"].copy()
            safe_cb("on_heartbeat")
            epoch0 += g * iv
            if (ckpt_every and epoch0 < num_epochs
                    and epoch0 // ckpt_every > (epoch0 - g * iv) // ckpt_every):
                save_population(epoch0)
            continue

        chunk = min(dispatch, num_epochs - epoch0)
        if realign:
            # Off a boundary, the boundary path's first dispatch ends on the
            # next one, so generations fire where the interrupted run's did.
            chunk, realign = min(chunk, iv - epoch0 % iv), False
        t0 = time.time()
        tl_chunk, metrics_chunk = program.read_epochs(
            *program.run_epochs(state, epoch0, chunk))
        if pbt is not None:
            counters["host_dispatches"] += 1
        exec_s = time.time() - t0
        exec_total_s += exec_s
        row_epochs += len(rows) * chunk
        _note_dispatch(program, chunk, len(rows), exec_s)
        t_end = time.time()
        was_active = list(active)
        for e_off in range(chunk):
            emit(epoch0 + e_off, tl_chunk[:, e_off],
                 {m: v[:, e_off] for m, v in metrics_chunk.items()},
                 time.time() if chunk == 1
                 else t0 + (e_off + 1) * (t_end - t0) / chunk)
        for i, r in enumerate(rows):
            if was_active[r] and not active[r]:
                _save_final(program, store, state, batch[r], i)
        epoch0 += chunk
        epoch = epoch0 - 1  # last completed epoch (PBT/compaction below)
        safe_cb("on_heartbeat")

        # ---- boundary PBT: the host decides, the device gathers ---------
        if (pbt is not None and not pbt_compiled
                and epoch0 // iv > (epoch0 - chunk) // iv
                and epoch0 < num_epochs):
            if pbt.metric in metrics_chunk:
                scores = metrics_chunk[pbt.metric][:, -1]
            elif pbt.metric == "train_loss":
                scores = tl_chunk[:, -1]
            else:
                raise ValueError(
                    f"PBT metric {pbt.metric!r} is not produced by this "
                    f"trainable (have: train_loss, "
                    f"{', '.join(sorted(metrics_chunk))})"
                )
            counters["generations"] += 1
            if pbt_spec is not None:
                state, row_lr, row_wd = _boundary_generation(
                    program, state, batch, rows, active, lrs, wds, pbt,
                    pbt_spec, pbt_notes, scores, obj_scale, row_lr, row_wd,
                    (epoch0 - 1) // iv, epoch, mut_keys, counters, log)
            else:
                state = _boundary_host_mutations(
                    program, state, batch, rows, active, lrs, wds, pbt,
                    pbt_notes, scores, epoch, counters, log)

        if not any(active[r] for r in rows):
            log(f"population fully early-stopped at epoch {epoch}")
            break
        keep = _compaction_keep(rows, active, num_epochs - epoch - 1,
                                compaction)
        if keep is not None:
            live = sum(1 for r in rows if active[r])
            state = program.select_rows(state, keep)
            rows = [rows[i] for i in keep]
            if row_lr is not None:
                row_lr, row_wd = row_lr[keep], row_wd[keep]
            compactions += 1
            log(f"compacted population -> {len(rows)} rows ({live} live) "
                f"at epoch {epoch}")

        # After PBT and compaction, so the rows on disk match the mapping.
        if (ckpt_every and epoch0 < num_epochs
                and epoch0 // ckpt_every > (epoch0 - chunk) // ckpt_every):
            save_population(epoch0)

    now = time.time()
    for i, r in enumerate(rows):
        if active[r]:
            _save_final(program, store, state, batch[r], i)
    for i, trial in enumerate(batch):
        if active[i]:
            trial.status = TrialStatus.TERMINATED
            trial.finished_at = now
            sched.on_trial_complete(trial)
            searcher.on_trial_complete(
                trial.trial_id, trial.config, trial.last_result, metric, mode
            )
            safe_cb("on_trial_complete", trial)
    return row_epochs, exec_total_s, compactions


def _boundary_generation(program, state, batch, rows, active, lrs, wds, pbt,
                         spec, pbt_notes, scores, obj_scale, row_lr, row_wd,
                         gen, epoch, mut_keys, counters, log):
    """One generation on the boundary path through the host reference
    step, on the draws the compiled path uses, so both paths decide the
    same bit for bit.  Returns ``(state, row_lr, row_wd)``."""
    valid = np.asarray([active[r] for r in rows])
    draws = generation_draws(pbt.seed, len(rows), gen,
                             generation_draw_count(spec))
    scores_f = np.asarray(scores, np.float32) * np.float32(obj_scale)
    src, new_lr, new_wd, exploited = reference_generation_step(
        spec, scores_f, row_lr, row_wd, valid, draws, True)
    pbt._generation_log.append({
        "gen": gen, "fire": True, "scores": scores_f.copy(),
        "row_lr": row_lr.copy(), "row_wd": row_wd.copy(), "valid": valid,
        "src": src.copy(), "new_lr": new_lr.copy(), "new_wd": new_wd.copy(),
        "exploited": exploited.copy(),
    })
    pairs = _apply_reference_exploits(batch, rows, lrs, wds, pbt, pbt_notes,
                                      src, new_lr, new_wd, exploited,
                                      mut_keys)
    counters["exploits"] += len(pairs)
    counters["explores"] += len(pairs) * len(mut_keys)
    if pairs:
        # Exploit: laggers adopt donors' weights AND optimizer state in one
        # gather on the device; explore lands in their lr/wd.
        state = program.gather_rows(state, src, new_lr, new_wd)
        log(f"PBT epoch {epoch}: " + ", ".join(f"{a}<-{b}" for a, b in pairs))
    return state, new_lr.copy(), new_wd.copy()


def _boundary_host_mutations(program, state, batch, rows, active, lrs, wds,
                             pbt, pbt_notes, scores, epoch, counters, log):
    """One generation for PB2 and the specs the device step cannot take
    (list, quantized, callable): the quantile split on the host, each
    lagger's donor and mutation from ``rng_from("vpbt", ...)`` and the
    scheduler's ``_mutate`` (PB2's GP-UCB), then the gather."""
    sign = 1.0 if pbt.mode == "min" else -1.0

    def rank_key(value: float) -> float:
        # Non-finite rows never donate and are first in line for rescue.
        v = sign * value
        return v if np.isfinite(v) else np.inf

    # A row a stopper terminated neither donates nor is rescued.
    live = sorted((rank_key(float(scores[i])), i, r)
                  for i, r in enumerate(rows) if active[r])
    if len(live) < 4 or not np.isfinite(live[0][0]):
        return state
    q = max(1, int(len(live) * pbt.quantile))
    # Donors must be finite (a smaller pool, never an inf-ranked one).
    top = [t for t in live[:q] if np.isfinite(t[0])]
    src = np.arange(len(rows))
    exploited = []
    for _, i, r in live[-q:]:
        rng = rng_from("vpbt", pbt.seed, batch[r].trial_id, epoch + 1)
        _, di, dr = top[int(rng.integers(len(top)))]
        src[i] = di
        donor, lagger = batch[dr], batch[r]
        # Explore: mutate the donor's hyperparams; the lagger keeps its own
        # identity and seed.
        new_cfg = pbt._mutate(dict(donor.config), rng)
        new_cfg["seed"] = lagger.config.get("seed", 0)
        lagger.config = new_cfg
        pbt.reset_improvement_chain(lagger.trial_id)
        lrs[r] = float(new_cfg["learning_rate"])
        wds[r] = float(new_cfg.get("weight_decay", 0.0))
        pbt_notes[r] = donor.trial_id
        exploited.append((lagger.trial_id, donor.trial_id))
        pbt._num_perturbations += 1
    counters["exploits"] += len(exploited)
    counters["explores"] += len(exploited) * len(pbt.mutations)
    if exploited:
        state = program.gather_rows(state, src, [lrs[r] for r in rows],
                                    [wds[r] for r in rows])
        log(f"PBT epoch {epoch}: "
            + ", ".join(f"{a}<-{b}" for a, b in exploited))
    return state
