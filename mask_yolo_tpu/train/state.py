"""Training state, optimizer construction, layer freezing, checkpointing.

Replaces the reference's Keras compile/fit machinery
(/root/reference/myolo/model.py:1062-1118 compile, 1120-1155 set_trainable,
1157-1196 load_weights, ModelCheckpoint at 1026):

 * optimizer — Adam(lr, 0.9, 0.999, eps=1e-8) exactly as the reference
   (model.py:1071-1075), with global-norm clipping from
   config.GRADIENT_CLIP_NORM (the reference defines it at config.py:230 but
   only wires it to the commented-out SGD; we honor it);
 * set_trainable by layer-name regex — reimplemented as an
   optax.multi_transform whose labels are computed by regex-matching the
   slash-joined parameter path, so "all", "yolo.*", "mask.*" etc. work on the
   param pytree;
 * checkpointing — a checkpoint is a directory holding `arrays.npz`
   (params, batch_stats and opt_state leaves keyed by their '/'-joined tree
   paths) and `meta.json` (step, epoch); `load_weights(..., by_name=True,
   exclude=[...])` restores named subtrees only, mirroring the reference's
   h5 by_name loading.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: Any  # int32 scalar — also drives the loss warm-up counter ("seen")


def path_name(path) -> str:
    """Slash-joined name of a pytree path, e.g. 'backbone/block1/conv_dw/kernel'."""
    parts = []
    for p in path:
        key = getattr(p, "key", None)
        if key is None:
            key = getattr(p, "name", str(p))
        parts.append(str(key))
    return "/".join(parts)


def trainable_labels(params, layer_regex: str):
    """Label each param 'train' or 'freeze' by regex on its path.

    Matches the reference's set_trainable semantics (model.py:1120-1155):
    a layer trains iff re.fullmatch(layer_regex, <name>) — here evaluated
    against every prefix segment of the path as well as the whole path, so
    Keras-style layer names ('conv1', 'block3', ...) keep working.
    """
    pattern = re.compile(layer_regex)

    def label(path, _):
        name = path_name(path)
        segments = name.split("/")
        candidates = [name] + segments
        hit = any(pattern.fullmatch(c) for c in candidates)
        return "train" if hit else "freeze"

    return jax.tree_util.tree_map_with_path(label, params)


def zero_nonfinite():
    """Gradient guard: replace non-finite gradient entries with 0.

    One inf/nan gradient (e.g. a pathological batch) would otherwise poison
    Adam's moments permanently — the failure mode that killed a 40-epoch
    Shapes run at epoch 35. Skipping the bad contribution instead lets
    training continue; combined with the loss-side exp clamp this makes the
    reference's notoriously unstable YOLOv2 loss safe to run long.
    """

    def init_fn(params):
        del params
        return optax.EmptyState()

    def update_fn(updates, state, params=None):
        del params
        updates = jax.tree.map(
            lambda g: jnp.where(jnp.isfinite(g), g, jnp.zeros_like(g)),
            updates)
        return updates, state

    return optax.GradientTransformation(init_fn, update_fn)


def make_lr_schedule(learning_rate: float, config, total_steps: int = 0):
    """Resolve config.LR_SCHEDULE into an optax schedule (or a scalar).

    "constant" (default) reproduces the reference's fixed Adam lr
    (model.py:1071-1075); "cosine" decays peak→peak*LR_FINAL_FRACTION over
    `total_steps`, with LR_WARMUP_STEPS of linear warm-up in either mode.
    Returns the bare float when no schedule is active so the optimizer state
    stays identical to previous rounds' checkpoints.
    """
    kind = str(getattr(config, "LR_SCHEDULE", "constant") or "constant")
    warmup = int(getattr(config, "LR_WARMUP_STEPS", 0) or 0)
    if kind == "constant":
        if warmup <= 0:
            return learning_rate
        return optax.linear_schedule(0.0, learning_rate, warmup)
    if kind != "cosine":
        raise ValueError(f"unknown LR_SCHEDULE {kind!r} "
                         "(expected 'constant' or 'cosine')")
    # explicit horizon wins — keeps the decay consistent across the resumed
    # processes of a segmented run, where each call's epochs differ
    total_steps = int(getattr(config, "LR_TOTAL_STEPS", 0) or 0) or total_steps
    if total_steps <= 0:
        raise ValueError("LR_SCHEDULE='cosine' needs total_steps > 0 "
                         "(train() passes epochs * steps_per_epoch)")
    end = learning_rate * float(getattr(config, "LR_FINAL_FRACTION", 0.0))
    warmup = min(warmup, max(total_steps - 1, 0))
    return optax.warmup_cosine_decay_schedule(
        init_value=0.0 if warmup > 0 else learning_rate,
        peak_value=learning_rate,
        warmup_steps=warmup,
        decay_steps=total_steps,
        end_value=end)


def make_optimizer(learning_rate: float, config, params=None,
                   layer_regex: str = ".*", frozen_prefixes: tuple = (),
                   total_steps: int = 0):
    """Adam + clipping + optional freezing.

    frozen_prefixes: top-level module names to freeze regardless of regex —
    used for `yolo_trainable=False` (reference model.py:866-868 freezes the
    whole pretrained YOLO branch).
    total_steps: decay horizon for LR_SCHEDULE='cosine' (see make_lr_schedule).
    """
    clip = float(getattr(config, "GRADIENT_CLIP_NORM", 0) or 0)
    chain = [zero_nonfinite()]
    if clip > 0:
        chain.append(optax.clip_by_global_norm(clip))
    lr = make_lr_schedule(learning_rate, config, total_steps)
    chain.append(optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8))
    adam = optax.chain(*chain)

    if layer_regex == ".*" and not frozen_prefixes:
        return adam

    assert params is not None
    labels = trainable_labels(params, layer_regex)
    if frozen_prefixes:
        def refreeze(path, lbl):
            top = str(getattr(path[0], "key", path[0]))
            return "freeze" if top in frozen_prefixes else lbl
        labels = jax.tree_util.tree_map_with_path(refreeze, labels)
    return optax.multi_transform(
        {"train": adam, "freeze": optax.set_to_zero()}, labels
    )


def create_train_state(params, batch_stats, tx) -> TrainState:
    return TrainState(
        params=params,
        batch_stats=batch_stats,
        opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Checkpointing (.npz + JSON sidecar)
# ---------------------------------------------------------------------------

_ARRAYS, _META = "arrays.npz", "meta.json"
_TREES = ("params", "batch_stats", "opt_state")


def save_checkpoint(path: str, state: TrainState, epoch: int = 0):
    """Save params + batch stats + optimizer moments + step/epoch.

    Including opt_state makes checkpoints truly resumable — the reference
    saves weights only (ModelCheckpoint(save_weights_only=True),
    model.py:1026) and resume was manual (initial_epoch commented out,
    model.py:1050). The directory is written under a temporary name and
    renamed into place, so a crash never leaves a half-written `path`.
    """
    path = os.path.abspath(path)
    arrays = {}
    for tree in _TREES:
        leaves = jax.tree_util.tree_leaves_with_path(
            jax.device_get(getattr(state, tree)))
        for p, leaf in leaves:
            arrays[f"{tree}/{path_name(p)}"] = np.asarray(leaf)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _ARRAYS), **arrays)
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump({"step": int(state.step), "epoch": int(epoch)}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def load_checkpoint(path: str, template=None) -> dict:
    """Restore a checkpoint as {params, batch_stats, opt_state, step, epoch}.

    Without `template` the trees come back as nested dicts of numpy arrays
    (opt_state as its raw path-keyed nesting). With `template` (a dict with
    a freshly-initialized TrainState's trees) every tree is rebuilt into the
    template's structure — optax NamedTuple states included — and a missing
    or mis-shaped leaf raises ValueError."""
    path = os.path.abspath(path)
    with np.load(os.path.join(path, _ARRAYS)) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, _META)) as f:
        out = dict(json.load(f))
    for tree in _TREES:
        prefix = tree + "/"
        flat = {k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith(prefix)}
        if template is None:
            out[tree] = _nest(flat)
            continue

        def pick(p, leaf, flat=flat, tree=tree):
            key = path_name(p)
            if key not in flat or np.shape(flat[key]) != np.shape(leaf):
                raise ValueError(f"checkpoint {path}: {tree}/{key} is missing "
                                 "or has another shape than the template")
            return flat.pop(key)

        out[tree] = jax.tree_util.tree_map_with_path(pick, template[tree])
        if flat:
            raise ValueError(f"checkpoint {path}: {tree} has leaves the "
                             f"template lacks: {sorted(flat)[:5]}")
    return out


def resume_train_state(path: str, fresh_state: TrainState):
    """Rebuild a TrainState (+ start epoch) from a checkpoint written by
    save_checkpoint, restoring optimizer moments into the fresh state's
    structure.

    If the checkpoint's opt_state structure doesn't match the fresh
    optimizer's (e.g. the run resumes under a different LR_SCHEDULE kind —
    constant vs cosine store different optax pytrees), the optimizer state is
    RESET to the fresh one with a warning and params/BN/step/epoch still
    restore — continuing training beats crashing, at the cost of re-warming
    Adam's moments."""
    template = {
        "params": jax.device_get(fresh_state.params),
        "batch_stats": jax.device_get(fresh_state.batch_stats),
        "opt_state": jax.device_get(fresh_state.opt_state),
        "step": 0,
        "epoch": 0,
    }
    try:
        ckpt = load_checkpoint(path, template=template)
        opt_state = ckpt["opt_state"]
    except ValueError:
        import warnings

        raw = load_checkpoint(path)  # structure-free restore
        ckpt = {"params": jax.tree.map(jnp.asarray, raw["params"]),
                "batch_stats": jax.tree.map(jnp.asarray,
                                            raw.get("batch_stats") or {}),
                "step": raw.get("step", 0),
                "epoch": raw.get("epoch", 0)}
        opt_state = fresh_state.opt_state
        warnings.warn(
            f"checkpoint {path}: optimizer state structure does not match "
            "the current optimizer (different LR_SCHEDULE / freezing?) — "
            "optimizer moments RESET, params/BN/epoch restored")
    state = TrainState(
        params=ckpt["params"],
        batch_stats=ckpt["batch_stats"],
        opt_state=opt_state,
        step=jnp.asarray(ckpt["step"], jnp.int32),
    )
    return state, int(ckpt["epoch"])


def merge_params(current, loaded, by_name: bool = False, exclude=None):
    """Merge a loaded params tree into the current one.

    by_name=False: full replacement (shapes must match).
    by_name=True: replace only subtrees whose top-level (module) name exists
    in both; `exclude` lists module names to skip — mirroring the reference's
    h5 by_name/exclude loader (model.py:1157-1196).
    """
    exclude = set(exclude or [])
    if not by_name and not exclude:
        return loaded
    merged = dict(current)
    for name, sub in loaded.items():
        if name in exclude:
            continue
        if name in merged or not by_name:
            merged[name] = sub
    return type(current)(merged) if not isinstance(current, dict) else merged
