"""Fault-tolerant checkpointing: atomic, content-hashed, resumable, async.

The port of ``repro.train.checkpoint``, with its on-disk format, so a
checkpoint written by either package loads in the other:

  root/step_{step:010d}/arrays.npz     leaves ``a0``, ``a1``, ... in the
                                       reference's flatten order (dict keys
                                       sorted, list items by index)
  root/step_{step:010d}/manifest.json  step, extra, the npz's sha256, and
                                       each leaf's key, name, shape, dtype

A bfloat16 leaf is stored as its 2-byte pattern (numpy's ``|V2``, what
``np.savez`` writes for the reference's bf16 arrays; the manifest says
``bfloat16``) and viewed back as the dtype of ``tree_like`` on restore.

Guarantees, as the reference's: atomicity (write to a temp dir, fsync the
manifest, rename), integrity (the sha256 is checked on restore),
retention (``keep_last_n``), resumption (``latest_step``, ``restore``),
and async writes on one background thread (``wait()`` joins it; the
device-to-host copy is taken before ``save`` returns).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.common.tree import flatten, unflatten

_BF16_BYTES = np.dtype("V2")


def _host_copy(leaf):
    """(numpy array, manifest dtype) of one leaf, copied off the device."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(_BF16_BYTES), "bfloat16"
        a = t.cpu().numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _restored(a: np.ndarray, like):
    """A loaded array as ``like`` holds it: a tensor of like's dtype on
    like's device (2-byte patterns viewed, not converted), else numpy."""
    if not isinstance(like, torch.Tensor):
        return a
    if a.dtype == _BF16_BYTES:
        if like.element_size() != 2:
            raise ValueError(f"a 2-byte pattern cannot restore a {like.dtype} leaf")
        t = torch.from_numpy(a.view(np.int16).copy()).view(like.dtype)
    else:
        t = torch.from_numpy(a if a.flags.c_contiguous else a.copy()).to(like.dtype)
    return t.to(like.device)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, root: str, keep_last_n: int = 3, async_write: bool = False):
        self.root = root
        self.keep_last_n = keep_last_n
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -- write ----------------------------------------------------------------

    def save(self, step: int, tree, extra: Optional[dict] = None):
        """Snapshot ``tree`` at ``step``.  The host copy happens here; file
        IO happens inline or on the writer thread."""
        named = flatten(tree)
        copies = [_host_copy(leaf) for _, leaf in named]
        names = [name for name, _ in named]
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, copies, names, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, copies, names, extra)

    def _write(self, step: int, copies, names, extra):
        final_dir = os.path.join(self.root, f"step_{step:010d}")
        tmp_dir = tempfile.mkdtemp(dir=self.root, prefix=".tmp_")
        manifest = {"step": step, "arrays": [], "extra": extra or {}}
        try:
            npz_path = os.path.join(tmp_dir, "arrays.npz")
            np.savez(npz_path, **{f"a{i}": a for i, (a, _) in enumerate(copies)})
            for i, ((a, dtype), n) in enumerate(zip(copies, names)):
                manifest["arrays"].append(
                    {"key": f"a{i}", "name": n, "shape": list(a.shape), "dtype": dtype})
            manifest["sha256"] = _sha256(npz_path)
            with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final_dir):
                shutil.rmtree(final_dir)
            os.replace(tmp_dir, final_dir)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.steps()[: -self.keep_last_n]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:010d}"), ignore_errors=True)

    # -- read -----------------------------------------------------------------

    def steps(self):
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.root, name, "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, tree_like, verify: bool = True):
        """Restore into the structure of ``tree_like`` (shapes must match);
        returns (tree, extra).  Tensor leaves come back as tensors of
        ``tree_like``'s dtype on its device, other leaves as numpy arrays."""
        d = os.path.join(self.root, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        npz_path = os.path.join(d, "arrays.npz")
        if verify and _sha256(npz_path) != manifest["sha256"]:
            raise IOError(f"checkpoint {d} failed integrity check (torn write or corruption)")
        named = flatten(tree_like)
        if len(manifest["arrays"]) != len(named):
            raise ValueError(f"checkpoint has {len(manifest['arrays'])} leaves, "
                             f"expected {len(named)}")
        new_leaves = []
        with np.load(npz_path) as z:
            for meta, (_, like) in zip(manifest["arrays"], named):
                a = z[meta["key"]]
                if list(a.shape) != list(np.shape(like)):
                    raise ValueError(f"leaf {meta['name']}: shape {a.shape} != "
                                     f"{tuple(np.shape(like))}")
                new_leaves.append(_restored(a, like))
        return unflatten(tree_like, new_leaves), manifest["extra"]

    def restore_latest(self, tree_like, verify: bool = True):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, tree_like, verify)
        return step, tree, extra
