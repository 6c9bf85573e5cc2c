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
* ``epochs_per_dispatch`` is accepted and changes nothing: the port
  dispatches epoch by epoch, and stops and compaction act per epoch, so
  the reported results are the same for any value;
* populations are not padded to a size multiple (the TPU's sublane rule).

``input_mode="streaming"`` falls back to resident staging, counted as
``host_input.mode_fallbacks`` in ``experiment_state.json``, as in the JAX
runner.  Each trial's parameters at its end (its last epoch, or the
epoch its stop came) are written as one checkpoint in the port's format,
so ``ExperimentAnalysis.best_model()`` works on a vectorized experiment.

Refused by name, each with the ROADMAP.md item that will lift it: PBT/PB2
and ``pbt_mode`` (A1 slice c), ``resume``, ``checkpoint_every_epochs`` and
``checkpoint_format="sharded"`` (A1 slice d, A7), more than one device
(A9), ``progress_deadline_s``/``progress_grace_s`` (A10) and a
``compile_cache_dir`` path (A8).
"""

from __future__ import annotations

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
    make_population_epoch_fn,
    make_population_eval_fn,
    stage_data,
)
from distributed_machine_learning_tpu_torch.tune.callbacks import (
    dispatch_safely,
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
)

# Hyperparameters that vary across trials *within* one population.
VECTOR_KEYS = ("learning_rate", "weight_decay", "seed")

INPUT_MODES = ("auto", "resident", "streaming")


def _static_signature(config: Dict[str, Any]) -> Tuple:
    """Hashable signature of everything that shapes the program."""
    items = []
    for k in sorted(config):
        if k in VECTOR_KEYS:
            continue
        v = config[k]
        items.append((k, tuple(v) if isinstance(v, list) else v))
    return tuple(items)


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
        opt_name = check_supported(
            cfg.get("optimizer", "adam"),
            int(cfg.get("accumulate_grad_batches", 1)))
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
        return torch.stack([
            epoch_permutation(s, epoch, self.data.n_train)
            for s in state.seeds]).to(self.device)

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

    def run_epoch(self, state: PopulationState, epoch: int
                  ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """One epoch of training and evaluation for every row, with ONE
        read back at its end: ``(train_losses [K], {metric: [K]})``."""
        losses = self.train_epoch(state, epoch)
        sums = self.eval_sums(state)
        host = torch.cat([losses[:, None].float(), sums], dim=1).cpu().numpy()
        rows = [eval_metrics_from_sums(self.loss_name, *row[1:], self._n_val)
                for row in host.astype(np.float64)]
        metrics = {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
        return host[:, 0], metrics

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


def _refuse_unported(scheduler, *, devices, pbt_mode: str, resume,
                     checkpoint_every_epochs: int, checkpoint_format: str,
                     progress_deadline_s, progress_grace_s,
                     compile_cache_dir) -> None:
    if type(scheduler).__name__ in ("PopulationBasedTraining", "PB2"):
        raise NotImplementedError(
            f"run_vectorized with the {type(scheduler).__name__} scheduler "
            f"(vectorized PBT) is not ported yet; see ROADMAP.md A1 slice c"
        )
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
    refused = {
        "pbt_mode": (pbt_mode != "auto", "A1 slice c"),
        "resume": (bool(resume), "A1 slice d"),
        "checkpoint_every_epochs": (bool(checkpoint_every_epochs),
                                    "A1 slice d"),
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
    nothing to compile.  The module docstring lists the knobs that are
    refused and the JAX runner's decisions that take no effect here.
    """
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
        scheduler, devices=devices, pbt_mode=pbt_mode, resume=resume,
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
    sched.set_experiment(metric, mode)

    name = name or f"vexp_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"
    store = ExperimentStore(storage_path, name)
    store.set_context(metric, mode)
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

    trials: List[Trial] = []
    programs: Dict[Tuple, _GroupProgram] = {}
    next_index = 0
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
        try:
            store.write_state(trials, extra=extra)
            store.close()
        except Exception as exc:  # noqa: BLE001 - callbacks still tear down
            log(f"experiment store teardown failed: {exc!r}")
        safe_cb("on_experiment_end", trials, wall)
        return wall, utilization

    try:
        for cb in callbacks:
            cb.setup(store.root, metric, mode)
        # Chunked suggest->train loop: adaptive searchers observe all
        # results from earlier chunks before proposing the next one.
        while next_index < num_samples and not exhausted:
            chunk = []
            while len(chunk) < max_batch_trials and next_index < num_samples:
                config = searcher.suggest(next_index)
                if config is None:
                    exhausted = True
                    break
                trial = Trial(trial_id=f"trial_{next_index:05d}", config=config)
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
            for sig, members in groups.items():
                program = programs.get(sig)
                if program is None:
                    program = programs[sig] = _group_program_for(
                        sig, dict(members[0].config), train_data, val_data,
                        device, log, force_restage=force_restage,
                    )
                pop_rows, pop_exec_s, pop_compactions = _run_population(
                    program, members, sched, searcher, store, metric, mode,
                    log, compaction, safe_cb, stop_rules=stop,
                )
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


def _emit_epoch_records(
    batch, rows, active, lrs, epoch, step_count, shape_val, now,
    train_losses, metrics_np, sched, searcher, store, metric, mode,
    safe_cb=lambda *a: None, stop_rules=None,
):
    """Append one epoch's records for every live trial and route them
    through the scheduler/searcher (the vectorized analogue of
    ``session.report``).  The JAX helper's PBT notes and pad rows are left
    out: the port runs no vectorized PBT and pads no population."""
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
        trial.results.append(record)
        # Keep Trial.training_iteration live (== epochs completed), the
        # same contract the threaded executor maintains via report().
        trial.reports_since_restart += 1
        store.append_result(trial, record)
        safe_cb("on_trial_result", trial, record)
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
) -> Tuple[int, float, int]:
    """Train one population of K same-shape trials to completion.

    Returns ``(row_epochs, exec_seconds, compactions)``: trial-epochs
    actually computed (rows x epochs, the honest cost under compaction),
    dispatch-to-sync seconds, and how many times the population was
    compacted."""
    k = len(batch)
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
    active = [True] * k
    # ``rows[i]`` = index into ``batch`` of the trial living at population
    # row i.  Compaction cuts stopped rows out and shrinks this mapping.
    rows = list(range(k))
    row_epochs, exec_total_s, compactions = 0, 0.0, 0
    for epoch in range(program.num_epochs):
        t0 = time.time()
        train_losses, metrics_np = program.run_epoch(state, epoch)
        exec_s = time.time() - t0
        exec_total_s += exec_s
        row_epochs += len(rows)
        step_count = (epoch + 1) * program.steps_per_epoch
        shape_val = float(
            program.shape_schedule(min(step_count, program.total_steps)))
        was_active = list(active)
        _emit_epoch_records(
            batch, rows, active, lrs, epoch, step_count, shape_val,
            time.time(), train_losses, metrics_np, sched, searcher, store,
            metric, mode, safe_cb, stop_rules,
        )
        for i, r in enumerate(rows):
            if was_active[r] and not active[r]:
                _save_final(program, store, state, batch[r], i)
        safe_cb("on_heartbeat")
        if not any(active[r] for r in rows):
            log(f"population fully early-stopped at epoch {epoch}")
            break
        keep = _compaction_keep(rows, active, program.num_epochs - epoch - 1,
                                compaction)
        if keep is not None:
            live = sum(1 for r in rows if active[r])
            state = program.select_rows(state, keep)
            rows = [rows[i] for i in keep]
            compactions += 1
            log(f"compacted population -> {len(rows)} rows ({live} live) "
                f"at epoch {epoch}")

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
