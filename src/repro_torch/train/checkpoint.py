"""Checkpointing for training — the port of ``repro.train.checkpoint``,
in its on-disk format, so either package loads the other's checkpoint:
``params.npz`` and ``opt.npz`` keyed ``"a/b/c"`` (``core.deploy._flatten``),
bf16 stored as a lossless fp32 upcast with its dtype recorded in
``meta.json``, and an atomic save (a temporary directory, then a rename).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.deploy import _flatten, _unflatten
from repro_torch.kernels.common import resolve_device
from repro_torch.nn.param import DTYPES, tree_map

# npy files cannot store bfloat16; store a lossless float32 upcast plus the
# original dtype for exact restoration
_NPY_UNSAFE = ("bfloat16",)
_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.float16: "float16", torch.int8: "int8",
          torch.int32: "int32", torch.int64: "int64"}


def _encode(tree):
    """({key: numpy array}, {key: dtype name}) of a tree of tensors."""

    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    names = _flatten(tree_map(lambda t: _NAMES[t.dtype], tree))
    return (_flatten(tree_map(host, tree)),
            {k: str(v) for k, v in names.items()})


def _decode(data, dtypes, device):
    out = {}
    for k in data.files:
        t = torch.from_numpy(np.array(data[k]))
        dt = dtypes.get(k)
        if dt in _NPY_UNSAFE:
            t = t.to(DTYPES[dt])
        out[k] = t.to(device)
    return out


def save_checkpoint(path, params, opt_state, step: int, extra: dict = None):
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    p_enc, p_dt = _encode(params)
    o_enc, o_dt = _encode(opt_state)
    np.savez(tmp / "params.npz", **p_enc)
    np.savez(tmp / "opt.npz", **o_enc)
    (tmp / "meta.json").write_text(json.dumps(
        {"step": int(step), "extra": extra or {},
         "param_dtypes": p_dt, "opt_dtypes": o_dt}))
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_checkpoint(path, device=None) -> Tuple[dict, dict, int, dict]:
    """(params, opt_state, step, extra), the trees' tensors on ``device``:
    ``cuda`` unless the caller asks for another (``resolve_device``)."""
    dev = resolve_device(device)
    path = Path(path)
    p = np.load(path / "params.npz")
    o = np.load(path / "opt.npz")
    meta = json.loads((path / "meta.json").read_text())
    params = _unflatten(_decode(p, meta.get("param_dtypes", {}), dev))
    opt = _unflatten(_decode(o, meta.get("opt_dtypes", {}), dev))
    return params, opt, meta["step"], meta["extra"]
