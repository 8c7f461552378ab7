"""Model deployment, load side (paper §2.2 / Fig. 2): the port of
``repro.core.deploy``.

``load_model`` reads the artifact the JAX package's ``save_model`` writes
— ``manifest.json`` (architecture, tensor table, dtype, sha256) and
``weights.npz`` — with the same integrity and geometry checks, into
tensors on the requested device.  ``params_from_numpy`` carries a JAX
parameter tree (as numpy arrays) across: conv weights stay OIHW and fc
weights ``[d_in, d_out]``, so both packages compute the same thing.

Not ported yet: ``save_model``, ``load_engine`` and the tuned-plan knobs
of a manifest (a tuned plan is neither compiled nor applied here).
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.netdefs import LayerSpec, NetworkDef
from repro_torch.core.plan import compile_plan, infer_param_shapes
from repro_torch.kernels.common import resolve_device

FORMAT_VERSION = 1


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
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(flat[k].tobytes())
    if digest.hexdigest() != manifest["weights_sha256"]:
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
    compile_plan(net)  # the layer table must lower to a plan
    return net, params_from_numpy(_unflatten(flat), dev), manifest["extra"]
