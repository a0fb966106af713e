"""Atomic, manifest-verified checkpoints in the JAX package's format.

The port of ``checkpoint/ckpt.py``, with the same files, so that a
checkpoint written by either package restores in the other:

* **Atomicity** — a checkpoint is written into ``step_<n>.tmp/`` and
  renamed to ``step_<n>/`` once the arrays and the fsync'd manifest are
  there.  A crash mid-save leaves a ``.tmp`` directory that restore ignores
  and the next save removes; the previous complete checkpoint is never
  touched.
* **Integrity** — the manifest records each leaf's shape, numpy dtype name
  and sha256 (of its stored bytes), and a hash of the whole leaf table;
  ``restore`` checks the tree's keys, shapes and dtypes (and the content
  hashes with ``verify=True``) before it returns anything.
* **Resume-exactness** — the optimizer's step count and the data
  pipeline's step live inside the saved tree; with the step-indexed
  pipeline (``data/synthetic.py``) a restart replays the same batches.

Layout::

    <dir>/step_000000420/
        manifest.json        # step, leaf table, tree hash
        arrays.npz           # one entry per leaf, keyed by its escaped path

Leaves are keyed by their path spelled as ``jax.tree_util.keystr`` spells
it (``['opt']['mu']['embed']['q']``, :mod:`repro_torch.tree`).  bfloat16,
which numpy lacks, is stored as its uint16 bit pattern under the dtype name
``bfloat16``, as the reference stores it.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, tree_map

__all__ = ["save", "restore", "latest_step", "all_steps", "CheckpointError"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"

# torch dtype → the numpy dtype name the manifest records
_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.int8: "int8", torch.uint8: "uint8",
          torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
          torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


class CheckpointError(RuntimeError):
    pass


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor → (the numpy array stored, its dtype name)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def _decode(raw: np.ndarray, dtype: str) -> torch.Tensor:
    raw = np.array(raw)                      # a writable contiguous copy, 0-d kept 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _escape(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", key)


def _leaves(tree) -> Dict[str, object]:
    return {path: leaf for path, _, leaf in leaves_with_path(tree)}


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomically write ``tree`` (a dict/list tree of tensors) as
    ``<directory>/step_<step>``.  Returns the final path.  Keeps the newest
    ``keep`` checkpoints and removes older ones and any ``.tmp`` debris."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays, table = {}, {}
    for key, leaf in _leaves(tree).items():
        raw, dtype = _encode(leaf)
        arrays[_escape(key)] = raw
        table[key] = {"shape": list(raw.shape), "dtype": dtype, "sha256": _sha(raw)}
    manifest = {"step": int(step), "leaves": table}
    manifest["tree_hash"] = hashlib.sha256(
        json.dumps(table, sort_keys=True).encode()).hexdigest()[:16]

    np.savez(os.path.join(tmp, _ARRAYS), **arrays)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    steps = all_steps(directory)
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"), ignore_errors=True)
    return final


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, template, *, verify: bool = False):
    """Load ``step`` into the structure of ``template``, a tree of tensors
    that gives each leaf's shape, dtype and device.  A missing or extra
    leaf, or a shape or dtype mismatch, raises :class:`CheckpointError`;
    so does a content hash mismatch with ``verify``.  Returns (tree, step)."""
    path = os.path.join(directory, f"step_{step:09d}")
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointError(f"no complete checkpoint at {path}") from e
    table = manifest["leaves"]
    tpl = _leaves(template)
    if set(tpl) != set(table):
        missing, extra = set(tpl) - set(table), set(table) - set(tpl)
        raise CheckpointError(f"tree mismatch: missing={sorted(missing)[:4]} "
                              f"extra={sorted(extra)[:4]}")
    loaded = {}
    with np.load(os.path.join(path, _ARRAYS)) as data:
        for key, t in tpl.items():
            raw, meta = data[_escape(key)], table[key]
            if verify and _sha(raw) != meta["sha256"]:
                raise CheckpointError(f"{key}: content hash mismatch (corrupt checkpoint)")
            if meta["dtype"] not in _DTYPES:
                raise CheckpointError(f"{key}: unknown dtype {meta['dtype']}")
            if list(raw.shape) != list(t.shape) or _DTYPES[meta["dtype"]] != t.dtype:
                raise CheckpointError(f"{key}: checkpoint {tuple(raw.shape)}/{meta['dtype']} "
                                      f"vs template {tuple(t.shape)}/{t.dtype}")
            loaded[key] = _decode(raw, meta["dtype"]).to(t.device)
    it = iter(loaded[key] for key in tpl)          # the template's leaf order
    return tree_map(lambda _: next(it), template), manifest["step"]
