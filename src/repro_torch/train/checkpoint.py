"""Checkpointing: manifest + per-leaf raw-bytes shards, async writes,
integrity hashes and resume (the port of ``repro/train/checkpoint.py``,
on the same on-disk format).

Layout:
    <dir>/step_000000123/
        MANIFEST.json     {step, meta?, leaves: {path: {file, shape,
                           dtype, sha256}}}
        0000.bin ...      raw leaf bytes (dtype + shape come from the
                           manifest, not a container format)

A checkpoint directory is atomic: written to ``.tmp`` then renamed, and
a stale ``.tmp`` left by a crashed earlier write is purged first, never
merged.  ``latest_step`` / ``all_steps`` scan complete checkpoints only.
``meta`` is an optional JSON-serializable job-identity blob embedded in
the manifest (the resumable-job layer, :mod:`repro_torch.core.jobs`,
refuses to resume a checkpoint written by a different job).

A tree is nested dicts, lists, tuples and NamedTuples (``None`` holds no
leaf) over leaves that are tensors (any device), numpy arrays or
scalars.  It flattens as the JAX package's ``tree_flatten_with_path``
does: dict keys in sorted order, named ``['key']``; sequence items
``[i]``; NamedTuple fields ``.name`` in field order.  Dtypes are written
under the names the JAX package writes (``"float32"``, ``"bfloat16"``,
...), so both packages write the same manifest and the same bytes for one
tree; a dtype numpy lacks (``bfloat16``, the ``float8`` types) is decoded
with ``torch.frombuffer``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..graph.csr import resolve_device
from ..launch.mesh import check_mesh, mesh_device


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) pairs of a container in flatten order, or None
    for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for part, child in kids:
        out += _leaf_paths(child, prefix + part)
    return out


def _rebuild(like, leaves: Iterator):
    """``like``'s structure over the next leaves (dict keys sorted)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(getattr(like, f), leaves)
                            for f in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(c, leaves) for c in like)
    return next(leaves)


def _map(fn, tree):
    return _rebuild(tree, iter([fn(leaf) for _, leaf in _leaf_paths(tree)]))


def _snapshot(x):
    """A host copy the caller's later writes cannot reach.  A device
    tensor is copied to the host and the copy completes before this
    returns; a host tensor or array is copied, not viewed."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        host = x.clone() if x.device.type == "cpu" else x.to("cpu")
        try:
            return host.numpy()
        except TypeError:       # a dtype numpy lacks (bfloat16, float8)
            return host
    return np.array(x, copy=True)


def _encode(leaf) -> Tuple[bytes, List[int], str]:
    """(raw bytes, shape, JAX dtype name) of a host leaf."""
    if isinstance(leaf, torch.Tensor):
        raw = leaf.contiguous().reshape(-1).view(torch.uint8).numpy() \
            .tobytes()
        return raw, list(leaf.shape), str(leaf.dtype).split(".")[-1]
    arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), arr.dtype.name


def _decode(raw: bytes, dtype: str, shape: List[int]):
    """A host leaf from raw bytes: numpy for numpy's own dtypes, a CPU
    tensor for the rest (whether or not some other library has taught
    numpy the name)."""
    try:
        dt = np.dtype(dtype)
    except TypeError:
        dt = None
    if dt is not None and dt.isbuiltin == 1:
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    tdt = getattr(torch, dtype, None)
    if not isinstance(tdt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r} in the manifest")
    count = int(np.prod(shape, dtype=np.int64))
    if len(raw) != count * tdt.itemsize:
        raise ValueError(f"{len(raw)} bytes for {count} {dtype} values")
    if count == 0:
        return torch.empty(shape, dtype=tdt)
    return torch.frombuffer(bytearray(raw), dtype=tdt).reshape(shape)


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True,
         keep: int = 3, meta: Optional[dict] = None
         ) -> Optional[threading.Thread]:
    """Save a tree.  ``blocking=False`` hands a host *snapshot* to a
    writer thread: the device-to-host copy and a defensive copy of host
    leaves finish before this returns, so the caller may overwrite its
    buffers at once.  ``meta`` (JSON-serializable) is embedded in the
    manifest."""
    host_tree = _map(_snapshot, tree)

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        # a stale .tmp from a crashed earlier write would silently merge
        # its leftover leaf files into this checkpoint: purge, never merge
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        if meta is not None:
            manifest["meta"] = meta
        for i, (path, leaf) in enumerate(_leaf_paths(host_tree)):
            fname = f"{i:04d}.bin"
            raw, shape, dtype = _encode(leaf)
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(raw)
            manifest["leaves"][path] = {
                "file": fname, "shape": shape, "dtype": dtype,
                "sha256": hashlib.sha256(raw).hexdigest()}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, d, "MANIFEST.json")):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """The checkpoint's MANIFEST.json: step, optional ``meta`` job
    identity, and the per-leaf {file, shape, dtype, sha256} table."""
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, like, *, verify: bool = True,
            shardings=None, device=None):
    """Restore into the structure of ``like`` -> (tree, step).

    With ``device=None`` the leaves are host arrays: numpy, or CPU
    tensors for a dtype numpy lacks.  With a ``device`` they are tensors
    on it.  ``shardings=`` is the elastic re-shard: a tree of meshes
    (:class:`torch.distributed.device_mesh.DeviceMesh`) matching
    ``like``, the counterpart of the JAX package's ``NamedSharding(mesh,
    P())``; each leaf is restored, replicated, onto this rank's device of
    its mesh.  A checkpoint written on one mesh restores onto whatever
    mesh is alive now."""
    if shardings is not None and device is not None:
        raise ValueError("restore: pass shardings= or device=, not both")
    dev = resolve_device(device) if device is not None else None
    meshes = None
    if shardings is not None:
        meshes = [m for _, m in _leaf_paths(shardings)]
        if len(meshes) != len(_leaf_paths(like)):
            raise ValueError(f"restore: {len(meshes)} shardings for "
                             f"{len(_leaf_paths(like))} leaves")
        for m in meshes:
            check_mesh(m)
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    manifest = read_manifest(ckpt_dir, step)
    leaves = []
    for path, _ in _leaf_paths(like):
        ent = manifest["leaves"][path]
        with open(os.path.join(d, ent["file"]), "rb") as f:
            raw = f.read()
        if verify:
            digest = hashlib.sha256(raw).hexdigest()
            if digest != ent["sha256"]:
                raise IOError(f"checkpoint corruption in {path}: "
                              f"{digest} != {ent['sha256']}")
        leaf = _decode(raw, ent["dtype"], ent["shape"])
        if meshes is not None:
            leaf = torch.as_tensor(leaf).to(mesh_device(meshes[len(leaves)]))
        elif dev is not None:
            leaf = torch.as_tensor(leaf).to(dev)
        leaves.append(leaf)
    return _rebuild(like, iter(leaves)), manifest["step"]


class CheckpointHook:
    """Async checkpoint writer with single-writer discipline.

    ``__call__`` is the training-loop hook (save every ``interval``
    steps); ``submit`` saves unconditionally (the resumable-job layer
    drives it at chunk boundaries).  At most one writer thread is in
    flight: ``policy="join"`` blocks until the previous write lands,
    ``policy="skip"`` drops the new snapshot instead (counted in
    ``skipped``).  Call ``flush()`` before shutdown so the last write is
    durable.
    """

    def __init__(self, ckpt_dir: str, interval: int = 100, keep: int = 3,
                 policy: str = "join"):
        if policy not in ("join", "skip"):
            raise ValueError(f"policy must be 'join' or 'skip': {policy!r}")
        self.dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        self.policy = policy
        self.written = 0
        self.skipped = 0
        self._pending: Optional[threading.Thread] = None

    @property
    def pending(self) -> Optional[threading.Thread]:
        """The in-flight writer thread (None when idle)."""
        return self._pending

    def submit(self, step: int, tree, *, meta: Optional[dict] = None
               ) -> bool:
        """Start an async save of ``tree`` at ``step``.  Returns False iff
        ``policy="skip"`` dropped it because a write is still in flight."""
        if self._pending is not None:
            if self.policy == "skip" and self._pending.is_alive():
                self.skipped += 1
                return False
            self._pending.join()        # one in-flight write at a time
        self._pending = save(self.dir, step, tree, blocking=False,
                             keep=self.keep, meta=meta)
        self.written += 1
        return True

    def __call__(self, step, params, opt_state, metrics):
        if (step + 1) % self.interval:
            return
        self.submit(step + 1, {"params": params, "opt": opt_state})

    def flush(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
