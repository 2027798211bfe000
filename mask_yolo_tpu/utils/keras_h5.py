"""Keras-h5 weight interop: load the reference's pretrained weights.

The reference loads pretrained YOLO-branch h5 weights into the image→yolo
sub-model and optionally freezes every layer in that path
(/root/reference/myolo/model.py:854-868), and its ModelCheckpoint writes
whole-model h5 files (model.py:1026). This module converts such Keras-2
`save_weights` h5 files into this framework's (params, batch_stats) pytrees
so reference-trained weights can seed a run here:

    params, stats, report = keras_h5.load_keras_h5(path)
    model.load_weights_from_keras_h5(path)     # by-name merge

Name map (Keras layer → parameter subtree), from the reference graph builders:
  conv1 / conv1_bn                  → backbone/conv1/{conv,bn}       (model.py:42-52)
  conv_dw_{i}[_bn], conv_pw_{i}[_bn], i=1..6  → backbone/block{i}/…  (model.py:55-79)
  …                       i=7..14   → yolo/block{i}/…                (model.py:249-268)
  conv_23                           → yolo/conv_23                   (model.py:271)
  feature_map                       → feature_map                    (model.py:848)
  myolo_mask_conv{i} / myolo_mask_bn{i} → mask/mask_conv{i} / mask_bn{i} (model.py:688-709)
  myolo_mask_deconv / myolo_mask    → mask/mask_deconv / mask_out    (model.py:711-714)

Kernel-layout conversions:
  depthwise  Keras [kh, kw, cin, mult] → grouped conv [kh, kw, 1, cin·mult]
  deconv     Keras [kh, kw, out, in]   → nn.ConvTranspose [kh, kw, in, out],
             spatially flipped (verified numerically against the
             tf.nn.conv2d_transpose formula in tests/test_keras_h5.py)
"""

from __future__ import annotations

import numpy as np


def _bn_entry(weights):
    """Keras BN weight list (gamma, beta, moving_mean, moving_variance) →
    (params {'scale','bias'}, stats {'mean','var'})."""
    gamma, beta, mean, var = weights
    return ({"scale": gamma, "bias": beta}, {"mean": mean, "var": var})


def _depthwise_kernel(k):
    """Keras depthwise [kh, kw, cin, mult] → feature_group_count kernel
    [kh, kw, 1, cin*mult] (output channel g*mult+m corresponds to input
    channel g, matching both frameworks' grouped-channel ordering)."""
    kh, kw, cin, mult = k.shape
    return k.reshape(kh, kw, 1, cin * mult)


def _deconv_kernel(k):
    """Keras Conv2DTranspose [kh, kw, out, in] → nn.ConvTranspose
    [kh, kw, in, out] with a spatial flip."""
    return np.transpose(k, (0, 1, 3, 2))[::-1, ::-1]


def _layer_map(name: str):
    """Keras layer name → (path tuple into our tree, kind).

    kind ∈ {'conv', 'depthwise', 'deconv', 'bn'}. None = unknown layer."""
    if name == "conv1":
        return ("backbone", "conv1", "conv"), "conv"
    if name == "conv1_bn":
        return ("backbone", "conv1", "bn"), "bn"
    for prefix, sub in (("conv_dw_", "conv_dw"), ("conv_pw_", "conv_pw")):
        if name.startswith(prefix):
            rest = name[len(prefix):]
            bn = rest.endswith("_bn")
            idx = int(rest[:-3] if bn else rest)
            top = "backbone" if idx <= 6 else "yolo"
            leaf = sub + ("_bn" if bn else "")
            kind = "bn" if bn else ("depthwise" if sub == "conv_dw" else "conv")
            return (top, f"block{idx}", leaf), kind
    if name == "conv_23":
        return ("yolo", "conv_23"), "conv"
    if name == "feature_map":
        return ("feature_map",), "conv"
    if name.startswith("myolo_mask_conv"):
        return ("mask", f"mask_conv{name[-1]}"), "conv"
    if name.startswith("myolo_mask_bn"):
        return ("mask", f"mask_bn{name[-1]}"), "bn"
    if name == "myolo_mask_deconv":
        return ("mask", "mask_deconv"), "deconv"
    if name == "myolo_mask":
        return ("mask", "mask_out"), "conv"
    return None, None


def _group_layer_weights(group):
    """Resolve every Keras layer stored under a layer group.

    Keras-2 `save_weights` gives each top-level layer a group whose
    `weight_names` attr lists per-variable dataset paths. For a plain layer
    the paths are '<layer>/<var>:0'; for a nested sub-Model layer (the
    reference wraps the YOLO branch in a sub-Model at model.py:854-868, so
    ModelCheckpoint files carry a 'yolo_model' group) the SAME attr lists
    paths of every nested layer ('conv_dw_7/depthwise_kernel:0', ...), with
    the sub-groups themselves carrying no attrs. So the group-level attr is
    the single source of truth: group variables by the first path component
    that `_layer_map` recognizes, preserving the attr's variable order
    (which is Keras's layer.weights order: kernel[, bias] / gamma, beta,
    moving_mean, moving_variance).

    Returns an ordered dict {keras_layer_name: [np.ndarray, ...]}.
    Falls back to recursive dataset discovery when the attr is absent.
    """
    names = [n.decode() if isinstance(n, bytes) else n
             for n in group.attrs.get("weight_names", [])]
    by_layer: dict = {}
    if names:
        for n in names:
            parts = n.split("/")
            layer = next((c for c in parts[:-1] if _layer_map(c)[0] is not None),
                         parts[0])
            by_layer.setdefault(layer, []).append(np.asarray(group[n]))
        return by_layer

    # no weight_names attr anywhere: walk the subtree collecting datasets
    def walk(g, prefix):
        for key in g:
            item = g[key]
            if hasattr(item, "keys"):
                walk(item, prefix + [key])
            else:
                layer = next((c for c in prefix + [key]
                              if _layer_map(c)[0] is not None),
                             (prefix + [key])[0])
                by_layer.setdefault(layer, []).append(np.asarray(item))

    walk(group, [])
    return by_layer


def load_keras_h5(path):
    """Read a Keras-2 save_weights h5 file from the reference codebase.

    Returns (params, batch_stats, report): nested dicts shaped like this
    framework's variable collections (only the subtrees present in the file),
    plus a report dict {'loaded': [...], 'skipped': [...], 'loaded_paths':
    [...]} of layer names / destination path tuples.
    """
    import h5py

    params: dict = {}
    stats: dict = {}
    report = {"loaded": [], "skipped": [], "loaded_paths": []}

    def set_path(tree, pathlist, leafdict):
        node = tree
        for k in pathlist[:-1]:
            node = node.setdefault(k, {})
        node[pathlist[-1]] = leafdict

    with h5py.File(path, "r") as f:
        # Keras save_weights roots the layer groups either at / or at
        # /model_weights (save_model files)
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in root.attrs.get("layer_names", [])]
        if not layer_names:  # fall back to group discovery
            layer_names = [k for k in root.keys()]
        for name in layer_names:
            if name not in root:
                report["skipped"].append(name)
                continue
            by_layer = _group_layer_weights(root[name])
            if not by_layer:
                report["skipped"].append(name)
                continue
            for lname, weights in by_layer.items():
                path_t, kind = _layer_map(lname)
                label = lname if lname == name else f"{name}/{lname}"
                if path_t is None or not weights:
                    report["skipped"].append(label)
                    continue
                _convert(weights, label, path_t, kind,
                         params, stats, set_path, report)
    return params, stats, report


def _convert(weights, name, path_t, kind, params, stats, set_path, report):
    if kind == "bn":
        p, s = _bn_entry(weights)
        set_path(params, list(path_t), p)
        set_path(stats, list(path_t), s)
    elif kind == "depthwise":
        set_path(params, list(path_t), {"kernel": _depthwise_kernel(weights[0])})
    elif kind == "deconv":
        entry = {"kernel": _deconv_kernel(weights[0])}
        if len(weights) > 1:
            entry["bias"] = weights[1]
        set_path(params, list(path_t), entry)
    else:  # conv
        entry = {"kernel": weights[0]}
        if len(weights) > 1:
            entry["bias"] = weights[1]
        set_path(params, list(path_t), entry)
    report["loaded"].append(name)
    report.setdefault("loaded_paths", []).append(tuple(path_t))


def save_keras_h5(path, params, batch_stats=None):
    """Inverse of load_keras_h5: write our pytrees as a Keras-2-layout
    save_weights h5 (round-trip/test utility; also lets reference users pull
    weights trained here back into the Keras codebase)."""
    import h5py

    batch_stats = batch_stats or {}

    def get(tree, pathlist):
        node = tree
        for k in pathlist:
            if node is None or k not in node:
                return None
            node = node[k]
        return node

    names = (["conv1", "conv1_bn"]
             + [f"conv_{t}_{i}{s}" for i in range(1, 15)
                for t in ("dw", "pw") for s in ("", "_bn")]
             + ["conv_23", "feature_map"]
             + [f"myolo_mask_conv{i}" for i in range(1, 5)]
             + [f"myolo_mask_bn{i}" for i in range(1, 5)]
             + ["myolo_mask_deconv", "myolo_mask"])
    with h5py.File(path, "w") as f:
        written = []
        for name in names:
            path_t, kind = _layer_map(name)
            p = get(params, list(path_t))
            if p is None:
                continue
            g = f.create_group(name)
            wnames, arrays = [], []
            if kind == "bn":
                s = get(batch_stats, list(path_t)) or {}
                wnames = [f"{name}/gamma:0", f"{name}/beta:0",
                          f"{name}/moving_mean:0", f"{name}/moving_variance:0"]
                arrays = [p["scale"], p["bias"],
                          s.get("mean", np.zeros_like(p["scale"])),
                          s.get("var", np.ones_like(p["scale"]))]
            elif kind == "depthwise":
                kh, kw, _, cm = np.asarray(p["kernel"]).shape
                # invert _depthwise_kernel (mult inferred as cm // cin is 1
                # for this architecture)
                wnames = [f"{name}/depthwise_kernel:0"]
                arrays = [np.asarray(p["kernel"]).reshape(kh, kw, cm, 1)]
            elif kind == "deconv":
                wnames = [f"{name}/kernel:0"]
                arrays = [np.transpose(np.asarray(p["kernel"])[::-1, ::-1],
                                       (0, 1, 3, 2))]
                if "bias" in p:
                    wnames.append(f"{name}/bias:0")
                    arrays.append(p["bias"])
            else:
                wnames = [f"{name}/kernel:0"]
                arrays = [p["kernel"]]
                if "bias" in p:
                    wnames.append(f"{name}/bias:0")
                    arrays.append(p["bias"])
            for wn, arr in zip(wnames, arrays):
                g.create_dataset(wn, data=np.asarray(arr, dtype=np.float32))
            g.attrs["weight_names"] = np.array([w.encode() for w in wnames])
            written.append(name.encode())
        f.attrs["layer_names"] = np.array(written)
