"""Model deployment (paper §2.2 / Fig. 2): the port of
``repro.core.deploy``.

``save_model`` writes the deployable artifact — ``manifest.json``
(architecture, tensor table, dtype, sha256, and optionally a
``tuned_plan`` knob set) and ``weights.npz`` — in the JAX package's
format: for the same net, weights, ``extra`` and ``tuned`` both packages
write a byte-identical manifest, so an artifact written by either loads
in the other.  ``load_model`` reads it with the same integrity and
geometry checks into tensors on the requested device and verifies the
plan (under the tuned knobs, if any) with the port's plan verifier (shape
flow and every kernel's launch geometry at the serving buckets, on the
device's SMs).  ``load_engine`` rebuilds a ``CNNEngine`` configured to the
tuned plan, on ``cuda`` unless asked for another device.
``params_from_numpy`` carries a JAX parameter tree (as numpy arrays)
across: conv weights stay OIHW and fc weights ``[d_in, d_out]``, so both
packages compute the same thing.

``use_pallas``, ``oh_block`` and ``per_layer_oh_blocks`` are TPU knobs
(the Pallas switch and its row bands) that do not change a result: they
round-trip through the manifest and come back in ``load_tuned_knobs``,
but the port's plan and engine have no such knob and do not apply them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.verifier import DEFAULT_SMS, verify_plan
from repro_torch.core.engine import CNNEngine
from repro_torch.core.methods import Method
from repro_torch.core.netdefs import LayerSpec, NetworkDef
from repro_torch.core.plan import compile_plan, infer_param_shapes
from repro_torch.kernels.common import resolve_device, sm_count

FORMAT_VERSION = 1

#: knob names a tuned plan may pin: the JAX package's list, in its order
#: (it fixes the manifest's bytes); ``fuse`` maps onto ``fuse_pool``
TUNED_KNOBS = ("method", "per_layer_methods", "oh_block",
               "per_layer_oh_blocks", "fuse", "fuse_relu", "per_layer_fuse",
               "per_layer_pool_carry", "per_layer_lrn_oc_block",
               "per_layer_oc_block_final", "use_pallas")
#: the TPU knobs among them, kept in the knob dict but not applied
TPU_ONLY_KNOBS = ("use_pallas", "oh_block", "per_layer_oh_blocks")


def knobs_to_manifest(knobs: dict) -> dict:
    """Serialize a knob set for the manifest: ``Method`` enums become
    their value strings, dict knobs sort canonically.  Unknown knob names
    raise — a typo must not ship as a silently ignored tuning decision."""
    unknown = set(knobs) - set(TUNED_KNOBS)
    if unknown:
        raise ValueError(f"unknown tuned-plan knob(s): {sorted(unknown)}")
    out = {}
    for k in TUNED_KNOBS:
        if k not in knobs:
            continue
        v = knobs[k]
        if isinstance(v, Method):
            v = v.value
        elif isinstance(v, dict):
            v = {n: (m.value if isinstance(m, Method) else m)
                 for n, m in sorted(v.items())}
        out[k] = v
    return out


def knobs_from_manifest(d: dict) -> dict:
    """Inverse of ``knobs_to_manifest``: value strings back to ``Method``
    enums.  Unknown knob names raise, as on the way in."""
    unknown = set(d) - set(TUNED_KNOBS)
    if unknown:
        raise ValueError(f"unknown tuned-plan knob(s): {sorted(unknown)}")
    out = dict(d)
    if "method" in out:
        out["method"] = Method(out["method"])
    if "per_layer_methods" in out:
        out["per_layer_methods"] = {
            n: Method(m) for n, m in out["per_layer_methods"].items()}
    return out


def plan_knobs(knobs: dict) -> dict:
    """A knob dict as ``compile_plan`` takes it: the TPU knobs dropped."""
    return {k: v for k, v in knobs.items() if k not in TPU_ONLY_KNOBS}


def _flatten(params: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A ``{layer: {"w", "b"}}`` tree (tensors on any device, or arrays)
    as ``{"layer/w": array}``."""
    flat = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        elif isinstance(v, torch.Tensor):
            flat[key] = v.detach().cpu().numpy()
        else:
            flat[key] = np.asarray(v)
    return flat


def _digest(flat: Dict[str, np.ndarray]) -> str:
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(flat[k].tobytes())
    return digest.hexdigest()


def save_model(path, net: NetworkDef, params: dict, extra: dict = None,
               tuned: dict = None) -> None:
    """Train-side conversion: write the deployable artifact.  ``tuned``
    (optional) is a knob set (``Method`` enums welcome) kept under
    ``manifest["tuned_plan"]`` and rebuilt by ``load_engine``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = _flatten(params)
    np.savez(path / "weights.npz", **flat)
    manifest = {
        "format_version": FORMAT_VERSION,
        "network": dataclasses.asdict(net),
        "tensors": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in flat.items()},
        "weights_sha256": _digest(flat),
        "extra": extra or {},
    }
    if tuned is not None:
        manifest["tuned_plan"] = knobs_to_manifest(tuned)
    (path / "manifest.json").write_text(
        json.dumps(manifest, indent=2, sort_keys=True))


def params_from_numpy(params: dict, device: Optional[Union[str, torch.device]]
                      = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """A ``{layer: {"w", "b"}}`` tree of arrays (numpy, or anything
    ``np.asarray`` takes, such as JAX arrays) as the port's parameters:
    the same tree of tensors, same layouts, on ``device``."""
    dev = resolve_device(device)
    return {name: {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
                   for k, v in layer.items()}
            for name, layer in params.items()}


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def load_model(path, device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[NetworkDef, dict, dict]:
    """Device-side load: verify integrity and geometry, rebuild the net
    and its params (tensors on ``device``); returns
    ``(net, params, extra)``."""
    dev = resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"format version {manifest['format_version']}")
    with np.load(path / "weights.npz") as data:
        flat = {k: data[k] for k in data.files}
    if _digest(flat) != manifest["weights_sha256"]:
        raise ValueError("weight checksum mismatch — corrupted artifact")
    for k, meta in manifest["tensors"].items():
        if list(flat[k].shape) != meta["shape"]:
            raise ValueError(f"tensor {k} shape mismatch")
        if str(flat[k].dtype) != meta["dtype"]:
            raise ValueError(
                f"tensor {k} dtype mismatch: manifest records "
                f"{meta['dtype']}, weights.npz holds {flat[k].dtype}")
    nd = manifest["network"]
    net = NetworkDef(
        name=nd["name"],
        input_shape=tuple(nd["input_shape"]),
        num_classes=nd["num_classes"],
        layers=tuple(
            LayerSpec(**{**l, "kernel": tuple(l["kernel"]),
                         "stride": tuple(l["stride"]),
                         "padding": tuple(l["padding"])})
            for l in nd["layers"]
        ),
    )
    # the declared architecture must size the shipped tensors
    for name, shp in infer_param_shapes(net).items():
        spec = next(l for l in net.layers if l.name == name)
        b_shape = (shp[0],) if spec.kind == "conv" else (shp[1],)
        for key, want in ((f"{name}/w", tuple(shp)), (f"{name}/b", b_shape)):
            meta = manifest["tensors"].get(key)
            got = None if meta is None else tuple(meta["shape"])
            if got != want:
                raise ValueError(
                    f"manifest geometry mismatch: tensor {key} must be "
                    f"{want} for the declared architecture, manifest "
                    f"records {got}")
    # the plan, under the tuned knobs if there are any, must lower and
    # pass the verifier at the serving buckets on the device's SMs: a
    # tampered tuning or geometry fails the load, not the first batch
    tuned = manifest.get("tuned_plan")
    knobs = plan_knobs(knobs_from_manifest(tuned)) if tuned else {}
    sms = sm_count(dev) if dev.type == "cuda" else DEFAULT_SMS
    errors = [f for f in verify_plan(compile_plan(net, verify=False, **knobs),
                                     sms=sms)
              if f.severity == "error"]
    if errors:
        raise ValueError("plan verification failed: "
                         + "; ".join(map(str, errors)))
    return net, params_from_numpy(_unflatten(flat), dev), manifest["extra"]


def load_tuned_knobs(path) -> Optional[dict]:
    """The ``tuned_plan`` knob set of an artifact (TPU knobs included), or
    None for an untuned manifest.  Reads only the manifest."""
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    tuned = manifest.get("tuned_plan")
    return None if tuned is None else knobs_from_manifest(tuned)


def load_engine(path, device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[CNNEngine, dict, Optional[dict]]:
    """Device-side bring-up in one call: ``(engine, params, knobs)``, the
    ``CNNEngine`` configured to the manifest's tuned plan (the defaults
    when it has none) on ``device`` (``cuda`` unless given).  ``fuse``
    becomes the engine's ``fuse_pool``; the TPU knobs are returned in
    ``knobs`` but not applied."""
    net, params, _extra = load_model(path, device)
    knobs = load_tuned_knobs(path)
    kwargs = plan_knobs(knobs or {})
    if "fuse" in kwargs:
        kwargs["fuse_pool"] = kwargs.pop("fuse")
    return CNNEngine(net, device=device, **kwargs), params, knobs
