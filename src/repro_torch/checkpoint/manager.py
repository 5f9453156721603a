"""Checkpoint manager — the port of ``repro.checkpoint.manager``, with the
reference's layout: per-leaf ``.npy`` files + JSON manifest, atomic
rename, keep-k retention, exact resume (params, optimizer state,
data-stream state).

    <dir>/step_000123.tmp/...   (write)
    <dir>/step_000123/          (atomic rename on completion)
        manifest.json           {step, leaf index, tree structure, extra}
        leaf_00000.npy ...

Leaves are numbered in ``jax.tree`` order (:mod:`repro_torch._tree`).  A
bfloat16 leaf is written as the reference writes one (numpy through
``ml_dtypes``): its raw 2-byte values under the descr ``'<V2'``, with
``"dtype": "bfloat16"`` in the manifest.  Restore reads each leaf by the
manifest's dtype (a bfloat16 leaf through an int16 view, since numpy has
no bfloat16 of its own) onto the template leaf's device, so checkpoints
written by the reference, float32 or bfloat16, load into the port.  (The
reference's own restore returns a bfloat16 leaf as raw ``|V2`` bytes.)
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import _tree

__all__ = ["CheckpointManager"]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _write_leaf(path: str, t: torch.Tensor) -> None:
    host = t.detach().cpu().contiguous()
    if host.dtype != torch.bfloat16:
        np.save(path, host.numpy())
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(host.shape)})
        host.view(torch.int16).numpy().tofile(f)


def _read_leaf(path: str, dtype: str, device) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        leaves, skeleton = _tree.flatten(tree)
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = []
        for i, leaf in enumerate(leaves):
            t = torch.as_tensor(leaf)
            fn = f"leaf_{i:05d}.npy"
            _write_leaf(os.path.join(tmp, fn), t)
            index.append({"file": fn, "shape": list(t.shape),
                          "dtype": _dtype_name(t), "host": self.host_id})
        manifest = {"step": step, "leaves": index,
                    "treedef": repr(skeleton), "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):           # re-save of same step: replace
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                ) -> Tuple[Any, int, dict]:
        """Restore into the structure of ``template`` (shapes validated),
        each leaf on its template leaf's device.  Returns (tree, step,
        extra)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        t_leaves, skeleton = _tree.flatten(template)
        if len(t_leaves) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, template "
                f"has {len(t_leaves)} — structure drift")
        leaves = []
        for tmpl, meta in zip(t_leaves, manifest["leaves"]):
            shape = list(getattr(tmpl, "shape", meta["shape"]))
            if shape != meta["shape"]:
                raise ValueError(f"shape mismatch for {meta['file']}: "
                                 f"{meta['shape']} vs {shape}")
            leaves.append(_read_leaf(os.path.join(path, meta["file"]),
                                     meta["dtype"],
                                     getattr(tmpl, "device", "cpu")))
        return _tree.unflatten(skeleton, leaves), step, manifest["extra"]

    # -- retention ------------------------------------------------------------

    def _steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d{8})", d)
            if m and os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def _gc(self):
        steps = self._steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
