"""AOT model export: the detect pipeline as a portable StableHLO artifact.

The reference deploys by shipping Python + Keras + an .h5 file and rebuilding
the graph in every process (/root/reference/myolo/model.py:756-803 — even
`detect` re-instantiates the Keras model per call-site script). Here the
deployment story is ahead-of-time export: `jax.export` traces the fully
on-device image→boxes+masks pipeline (pipelines.detect_outputs) ONCE, bakes
the weights in as module constants, and serializes the StableHLO program to
bytes. A serving process then needs only `jax` — no module tree, no
framework model code, no weight files, no re-trace — and the program is
versioned StableHLO bytecode under jax.export's calling convention.

The artifact reproduces the live jitted pipeline exactly on CPU
(tests/test_export.py asserts bit-equality); on a GPU the artifact and a
fresh trace are two separate XLA compilations of the same math, which may
differ in the last bits of a box and flip the odd borderline 0.5-threshold
mask pixel — tools/export_model.py --verify checks with tolerances.

Batch dimension is symbolic by default (`jax.export.symbolic_shape("b")`):
one artifact serves any batch size without recompiling the export. Pass
`batch_size=` to pin it (slightly narrower surface for the XLA compiler to
re-verify at load time). Input dtype is uint8 by default — the serving
contract (serve.py) ships uint8 over the wire and normalizes on device.

File format (single self-contained file):

    magic  b"MYTPUEXP"            8 bytes
    header length                 8 bytes little-endian
    header JSON (utf-8)           model/config metadata (see export_detect)
                                  and, under "program", the Exported's
                                  signature fields
    payload                       the StableHLO bytecode
                                  (Exported.mlir_module_serialized)

jax's own `Exported.serialize()` needs the `flatbuffers` package, which a
GPU serving host need not have; the detect program is single-device and
effect-free, so its signature fits in the JSON header and the loader
rebuilds the `jax.export.Exported` from it.
"""

from __future__ import annotations

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np

from . import pipelines

_MAGIC = b"MYTPUEXP"
_FORMAT_VERSION = 2


def export_detect(net, variables, config, *, batch_size=None,
                  input_dtype="uint8", platforms=None):
    """Trace + lower the module (f32/bf16) detect pipeline to an Exported.

    net/variables/config: as held by MaskYOLO (model.py). The variables are
    closed over, so the weights are embedded in the artifact as constants.
    Returns (exported, header_dict). See export_detect_fn for the knobs.
    """
    fn = jax.jit(lambda images: pipelines.detect_outputs(
        net, variables, images, config))
    return export_detect_fn(fn, config, batch_size=batch_size,
                            input_dtype=input_dtype, platforms=platforms,
                            compute_path=config.COMPUTE_DTYPE)


def export_detect_fn(fn, config, *, batch_size=None, input_dtype="uint8",
                     platforms=None, compute_path="float32"):
    """Trace + lower any jitted images→detect-dict callable to an Exported —
    shared by the module path above and the int8 quantized path
    (quant.QuantizedDetector.detect_fn, whose int8 weights are jit
    constants and therefore bake into the artifact the same way).

    batch_size: int to pin the batch; None (default) exports a symbolic
    batch dimension so one artifact serves any B ≥ 1.
    input_dtype: "uint8" (serving contract; normalized on device) or
    "float32" (caller pre-normalizes to [0, 1]).
    platforms: optional sequence of lowering platforms, e.g.
    ("cuda", "cpu") for an artifact loadable on either; None = the
    default platform of this process.

    Returns (exported, header_dict).
    """
    if input_dtype not in ("uint8", "float32"):
        raise ValueError(f"input_dtype must be uint8/float32, got {input_dtype}")
    h, w, c = config.IMAGE_SHAPE
    if batch_size is None:
        (b,) = jax.export.symbolic_shape("b")
    else:
        b = int(batch_size)
    spec = jax.ShapeDtypeStruct((b, h, w, c), jnp.dtype(input_dtype))

    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    exported = jax.export.export(fn, **kwargs)(spec)

    header = {
        "format_version": _FORMAT_VERSION,
        "model": "mask_yolo_tpu.detect",
        "config_name": getattr(config, "NAME", "?"),
        "num_classes": int(config.NUM_CLASSES),
        "image_shape": [int(h), int(w), int(c)],
        "detection_max_instances": int(config.DETECTION_MAX_INSTANCES),
        "batch_size": None if batch_size is None else int(batch_size),
        "labels": list(getattr(config, "LABELS", []) or []),
        "compute_path": compute_path,
        "input_dtype": input_dtype,
        "platforms": list(exported.platforms),
        "jax_version": jax.__version__,
        "outputs": ["boxes [B,K,4] f32 pixel xyxy", "classes [B,K] i32",
                    "scores [B,K] f32", "masks [B,K,H,W] bool",
                    "valid [B,K] bool"],
    }
    return exported, header


def _aval_json(aval):
    return {"shape": [d if isinstance(d, int) else str(d) for d in aval.shape],
            "dtype": np.dtype(aval.dtype).name}


def save_exported(exported, header, path):
    """Write an Exported + header to the container format above."""
    shardings = exported.in_shardings_hlo + exported.out_shardings_hlo
    if (exported.nr_devices != 1 or exported.ordered_effects
            or exported.unordered_effects
            or any(s is not None for s in shardings)):
        raise ValueError("only single-device, effect-free programs export "
                         "to this format")
    outs = jax.tree_util.tree_unflatten(exported.out_tree,
                                        range(len(exported.out_avals)))
    header = dict(header, program={
        "fun_name": exported.fun_name,
        "in_avals": [_aval_json(a) for a in exported.in_avals],
        "out_keys": sorted(outs, key=outs.get),
        "out_avals": [_aval_json(a) for a in exported.out_avals],
        "platforms": list(exported.platforms),
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": bool(exported.uses_global_constants),
    })
    head = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        f.write(exported.mlir_module_serialized)


def _load_exported(program, payload: bytes):
    """Rebuild the jax.export.Exported that save_exported wrote."""
    scope = jax.export.SymbolicScope()

    def aval(a):
        shape = tuple(d if isinstance(d, int)
                      else jax.export.symbolic_shape(d, scope=scope)[0]
                      for d in a["shape"])
        return jax.core.ShapedArray(shape, np.dtype(a["dtype"]))

    n_in, n_out = len(program["in_avals"]), len(program["out_avals"])
    return jax.export.Exported(
        fun_name=program["fun_name"],
        in_tree=jax.tree_util.tree_structure(((0,) * n_in, {})),
        in_avals=tuple(aval(a) for a in program["in_avals"]),
        out_tree=jax.tree_util.tree_structure(
            dict.fromkeys(program["out_keys"], 0)),
        out_avals=tuple(aval(a) for a in program["out_avals"]),
        _has_named_shardings=False,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        in_shardings_hlo=(None,) * n_in,
        out_shardings_hlo=(None,) * n_out,
        nr_devices=1,
        platforms=tuple(program["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=payload,
        calling_convention_version=program["calling_convention_version"],
        module_kept_var_idx=tuple(program["module_kept_var_idx"]),
        uses_global_constants=program["uses_global_constants"],
        _get_vjp=None)


class ExportedDetector:
    """A serving-ready detector loaded from an export file.

    Exposes the same `detect_batch(images) -> dict` contract as
    MaskYOLO/QuantizedDetector, so it drops straight into
    serve.BatchingExecutor — a deployment process importing only this module
    and jax.
    """

    def __init__(self, exported, header):
        self.exported = exported
        self.header = header
        self._call = jax.jit(exported.call)

    @classmethod
    def load(cls, path):
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a mask_yolo_tpu export "
                                 f"(bad magic {magic!r})")
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen).decode("utf-8"))
            if header.get("format_version") != _FORMAT_VERSION:
                raise ValueError(
                    f"{path}: unsupported format_version "
                    f"{header.get('format_version')}")
            exported = _load_exported(header["program"], f.read())
        return cls(exported, header)

    def serve_config(self, batch_size=None):
        """Minimal config shim (IMAGE_SHAPE / BATCH_SIZE / LABELS from the
        artifact header) satisfying serve.BatchingExecutor — so a deployment
        process serves straight from the artifact with no Config subclass."""
        import types

        fixed = self.header["batch_size"]
        if batch_size is None:
            batch_size = fixed or 8
        elif fixed is not None and batch_size != fixed:
            raise ValueError(f"artifact pins batch_size={fixed}, "
                             f"requested {batch_size}")
        return types.SimpleNamespace(
            IMAGE_SHAPE=list(self.header["image_shape"]),
            BATCH_SIZE=int(batch_size),
            LABELS=list(self.header.get("labels", [])))

    def detect_batch(self, images):
        """[B, H, W, 3] uint8 (or float32 in [0, 1] if exported so) →
        fixed-shape dict (see pipelines.detect_outputs)."""
        images = np.asarray(images)
        want = np.dtype(self.header["input_dtype"])
        if images.dtype != want:
            if want == np.uint8 and np.issubdtype(images.dtype, np.floating):
                # callers holding [0, 1] floats: quantize to the wire dtype
                images = np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)
            elif (want == np.float32
                  and np.issubdtype(images.dtype, np.integer)):
                # float32-exported artifacts expect pre-normalized [0, 1]
                # input (pipelines.images_f32 passes floats through); uint8
                # callers (e.g. the serve wire format) must be normalized
                # here, not bare-cast, or the graph sees 0-255 values.
                images = images.astype(np.float32) / 255.0
            else:
                images = images.astype(want)
        fixed = self.header["batch_size"]
        if fixed is not None and images.shape[0] != fixed:
            raise ValueError(
                f"artifact was exported with batch_size={fixed}, "
                f"got batch {images.shape[0]} (export with batch_size=None "
                f"for a symbolic batch dimension)")
        return self._call(images)
