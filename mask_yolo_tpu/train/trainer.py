"""Jitted training/eval steps and the epoch loop.

The reference trains through Keras fit_generator on one device
(/root/reference/myolo/model.py:1047-1059). Here a single
`train_step = jit(grad(training_loss))` is compiled once per config and runs
with the batch sharded over the mesh's 'data' axis — XLA inserts the gradient
all-reduce across the devices automatically (SURVEY.md §2.3). The
warm-up counter the reference kept as a mutable tf.Variable inside the loss
(model.py:99) is `state.step`, threaded explicitly.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp

from .. import pipelines
from .state import TrainState


def _make_step_body(net, config, tx, mode: str = "training"):
    """The un-jitted (state, batch) -> (state, metrics) update — shared by the
    per-dispatch step and the scan-superbatch step below."""
    loss_fn = pipelines.training_loss if mode == "training" else pipelines.yolo_only_loss

    def train_step(state: TrainState, batch):
        def compute(params):
            variables = {"params": params, "batch_stats": state.batch_stats}
            return loss_fn(net, variables, batch, config,
                           seen=state.step.astype(jnp.float32),
                           train=True, mutable_stats=True)

        (loss, (metrics, updates)), grads = jax.value_and_grad(
            compute, has_aux=True)(state.params)
        new_params_updates, new_opt_state = tx.update(
            grads, state.opt_state, state.params)
        import optax
        new_params = optax.apply_updates(state.params, new_params_updates)
        new_stats = updates.get("batch_stats", state.batch_stats) if updates else state.batch_stats
        new_state = TrainState(params=new_params, batch_stats=new_stats,
                               opt_state=new_opt_state, step=state.step + 1)
        return new_state, metrics

    return train_step


def make_train_step(net, config, tx, mode: str = "training"):
    """Build the jitted train step: (state, batch) -> (state, metrics)."""
    return functools.partial(jax.jit, donate_argnums=(0,))(
        _make_step_body(net, config, tx, mode))


def make_scan_train_step(net, config, tx, mode: str = "training"):
    """S steps per dispatch: (state, batches) -> (state, last_metrics), where
    every `batches` leaf carries a leading scan axis of length S.

    The math is the per-step body `lax.scan`ned S times — identical update
    sequence to S calls of make_train_step's function (tests/test_train.py
    asserts parameter equality). What changes is the host↔device traffic:
    ONE upload + ONE dispatch per S steps instead of S of each, which
    amortizes per-transfer latency S-fold where it dominates the step.
    Enabled by config.TRAIN_SCAN_STEPS."""
    body = _make_step_body(net, config, tx, mode)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def scan_step(state: TrainState, batches):
        state, metrics = jax.lax.scan(body, state, batches)
        return state, jax.tree.map(lambda x: x[-1], metrics)

    return scan_step


def make_eval_step(net, config, mode: str = "training"):
    loss_fn = pipelines.training_loss if mode == "training" else pipelines.yolo_only_loss

    @jax.jit
    def eval_step(state: TrainState, batch):
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        _, (metrics, _) = loss_fn(net, variables, batch, config,
                                  seen=1e9, train=False, mutable_stats=False)
        return metrics

    return eval_step


class _LimitedSource:
    """Length-capped view of a batch source (STEPS_PER_EPOCH semantics)."""

    def __init__(self, source, max_steps: int):
        self.source = source
        self.max_steps = max_steps

    def __len__(self):
        return min(len(self.source), self.max_steps)

    def __getitem__(self, i):
        return self.source[i]


class _ChunkedSource:
    """Groups a batch source into stacked chunks of `s` consecutive batches
    (leading scan axis) for make_scan_train_step. Only FULL chunks — the
    ≤ s−1 remainder batches run through the per-step path so the scan step
    compiles for exactly one shape."""

    def __init__(self, source, s: int):
        self.source = source
        self.s = s

    def __len__(self):
        return len(self.source) // self.s

    def __getitem__(self, i):
        import numpy as np

        items = [self.source[i * self.s + j] for j in range(self.s)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


def run_epoch(train_step, state, generator, mesh=None, log_every: int = 10,
              verbose: bool = True, profile_dir=None, profile_steps=(2, 5),
              prefetch: int = 2, max_steps: int = 0, scan_step=None,
              scan_steps: int = 0):
    """One pass over the generator. Returns (state, last_metrics).

    profile_dir: if set, capture a jax.profiler trace (viewable in
    TensorBoard/XProf) covering steps [profile_steps[0], profile_steps[1]) —
    the observability hook the reference only approximates with a TensorBoard
    graph callback (model.py:1024-1027; SURVEY.md §5 tracing row).
    prefetch: stage this many batches ahead on device from a background
    thread (0 disables) so host batch prep + transfer overlap compute.
    max_steps: positive = cap the epoch at this many steps (the
    STEPS_PER_EPOCH knob, reference config.py:62); 0 = full generator.
    scan_step/scan_steps: when given (make_scan_train_step, S>1), run the
    bulk of the epoch as stacked S-step superbatches — one upload + one
    dispatch each — and only the ≤ S−1 remainder through `train_step`.
    Update-sequence-identical to the per-step path; a wall-clock lever on
    dispatch-latency-bound links (config.TRAIN_SCAN_STEPS).
    """
    from ..data.prefetch import DevicePrefetcher
    from ..parallel.mesh import batch_sharding, scan_batch_sharding, shard_batch

    if max_steps and max_steps > 0:
        generator = _LimitedSource(generator, int(max_steps))
    n_total = len(generator)
    s = int(scan_steps or 0)
    use_scan = scan_step is not None and s > 1 and n_total >= s
    metrics = {}
    t0 = time.perf_counter()
    tracing = False
    if use_scan:
        source = _ChunkedSource(generator, s)
        sharding = scan_batch_sharding(mesh) if mesh is not None else None
    else:
        source = generator
        sharding = batch_sharding(mesh) if mesh is not None else None
    if prefetch:
        batches = iter(DevicePrefetcher(source, sharding, size=prefetch))
    else:
        batches = (shard_batch(source[i], mesh) if mesh is not None
                   else source[i] for i in range(len(source)))

    def log(done):
        m = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        print(f"  step {done}/{n_total}  "
              f"loss={m.get('loss', 0):.4f}  "
              f"recall={m.get('recall', 0):.3f}  "
              f"({dt / done:.3f}s/step)")

    done = 0
    for i, batch in enumerate(batches):
        if profile_dir is not None:
            if i == profile_steps[0]:
                jax.profiler.start_trace(profile_dir)
                tracing = True
            elif i == profile_steps[1] and tracing:
                jax.tree.map(
                    lambda x: x.block_until_ready(),
                    metrics)
                jax.profiler.stop_trace()
                tracing = False
        if use_scan:
            state, metrics = scan_step(state, batch)
            done += s
        else:
            state, metrics = train_step(state, batch)
            done += 1
        if verbose and (done // log_every) > ((done - (s if use_scan else 1))
                                              // log_every):
            log(done)
    if use_scan:  # remainder batches (< s) through the per-step path
        for i in range(done, n_total):
            batch = (shard_batch(generator[i], mesh) if mesh is not None
                     else generator[i])
            state, metrics = train_step(state, batch)
            done += 1
            if verbose and done % log_every == 0:
                log(done)
    if tracing:
        jax.profiler.stop_trace()
    return state, {k: float(v) for k, v in metrics.items()}
