"""Checkpoint store (port of ``repro/checkpoint/store.py``): the
reference's on-disk format byte for byte, so each package restores the
other's checkpoints.

A checkpoint is a directory:
    manifest.json  — format ``version``, user ``metadata`` and one entry
                     per leaf: its key path, file, shape and dtype name
    leaf_NNNNN.npy — one numpy file per leaf
    COMMIT         — written last; a checkpoint without it is invalid
                     (crash-consistency marker)

Key paths are ``jax.tree_util.keystr``'s strings, built here without
jax: ``['params']['stack']['segments'][0]['pos0']['mixer']['wq']`` —
``[repr(key)]`` for a dict key, ``[index]`` for a list or tuple
position. Leaves are numbered in JAX's flattening order, which walks a
dict's keys SORTED (the port's ``models.param.tree_leaves`` walks them
in insertion order), so two packages saving the same tree write
identical manifests.

numpy's ``.npy`` keeps builtin dtypes only; bfloat16 is stored as its
16-bit pattern (``uint16``) and the float8 types as ``uint8``, with the
logical dtype name in the manifest, exactly as the reference stores them
through ``ml_dtypes`` — here the bits cross through torch's integer
views, so no ``ml_dtypes`` is needed.

Writes go to ``<dir>.tmp-<pid>``, every file is fsync'd, then COMMIT
(fsync'd), then the directory, then ``os.replace`` onto the final name
and an fsync of the parent: a crash at ANY point leaves either the
previous checkpoint or the new one, never a torn mix (a leftover
``.tmp-*`` directory is garbage, ignored by ``is_valid`` and rewritten
on the next save). Leaves are stored device-agnostic; ``load_tree``
puts each on the device of its like-leaf (or ``device``).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

FORMAT_VERSION = 1


class CorruptCheckpointError(RuntimeError):
    """A COMMITted checkpoint whose payload cannot be read anyway (torn
    leaf file, unreadable manifest — partial writes on a filesystem that
    ignored fsync, or bit rot). Distinct from ValueError (structure or
    shape mismatch = caller bug) so CheckpointManager can fall back to
    the last-known-good step."""


# Logical dtype name -> (torch dtype, the same-width integer view that
# carries its bits between torch and numpy, that view's numpy dtype, the
# stored numpy dtype).
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_EXOTIC_BY_TORCH = {v[0]: k for k, v in _EXOTIC.items()}


def _encode(leaf) -> tuple[np.ndarray, str]:
    """A leaf -> (the C-ordered array to store, its logical dtype name).
    A CPU tensor's array may alias it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _EXOTIC_BY_TORCH.get(t.dtype)
        if name is not None:
            _, tview, _, stored = _EXOTIC[name]
            return t.view(tview).numpy().view(stored), name
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(leaf)
    name = str(arr.dtype)
    if name in _EXOTIC:  # an ml_dtypes array, where the caller has one
        return arr.view(_EXOTIC[name][3]), name
    return arr, name


def _decode(raw: np.ndarray, name: str) -> torch.Tensor:
    if name in _EXOTIC:
        tdtype, _, nview, _ = _EXOTIC[name]
        return torch.from_numpy(raw.view(nview)).view(tdtype)
    return torch.from_numpy(raw)


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) pairs in JAX's flattening order: dict keys
    sorted, list and tuple positions in order; None and empty containers
    hold no leaf."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _unflatten(like, prefix: str, values: dict):
    """A tree shaped like ``like`` holding ``values[path]`` at its
    leaves."""
    if isinstance(like, dict):
        return {k: _unflatten(v, f"{prefix}[{k!r}]", values)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, f"{prefix}[{i}]", values)
                          for i, v in enumerate(like))
    if like is None:
        return None
    return values[prefix]


def _fsync_file(fpath: str) -> None:
    fd = os.open(fpath, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(dpath: str) -> None:
    # Directory fsync durably records renames/creates within it; some
    # filesystems refuse O_RDONLY-fsync on directories — best effort.
    try:
        fd = os.open(dpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_tree(path: str, tree, *, metadata: Optional[dict] = None) -> None:
    """Write ``tree`` (nested dicts and lists of tensors or numpy arrays)
    atomically to ``path``."""
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "version": FORMAT_VERSION,
        "metadata": metadata or {},
        "leaves": [],
    }
    for i, (p, leaf) in enumerate(_flatten(tree)):
        stored, dtype_name = _encode(leaf)
        fname = f"leaf_{i:05d}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, stored)
        _fsync_file(fpath)
        manifest["leaves"].append(
            {"path": p, "file": fname, "shape": list(stored.shape),
             "dtype": dtype_name}
        )
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # COMMIT is the crash-consistency barrier: every byte it vouches for
    # is durable before it exists, and it is durable (file + dir fsync)
    # before the tmp dir can replace a previous valid checkpoint.
    cpath = os.path.join(tmp, "COMMIT")
    with open(cpath, "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def is_valid(path: str) -> bool:
    return os.path.exists(os.path.join(path, "COMMIT"))


def leaf_files(path: str) -> list:
    """Absolute paths of the checkpoint's leaf payload files, in
    manifest order. Used by fault-injection harnesses to tear a
    COMMITted checkpoint (corruption is only discoverable at load)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    return [os.path.join(path, e["file"]) for e in manifest["leaves"]]


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["metadata"]


def load_tree(path: str, like: Any, *, device=None, key: Optional[str] = None):
    """Load a checkpoint as a tree of tensors shaped like ``like``.

    ``like`` gives the structure (the manifest stores flat paths) and is
    the structure check: its key paths must equal the checkpoint's,
    else ``ValueError``. Each leaf keeps its stored dtype and goes to
    ``device``, or else to its like-leaf's device (the CPU for a leaf
    that is not a tensor).

    ``key``: load only the subtree at that top-level key (``like`` is
    the subtree's structure), selected by the manifest's paths — e.g.
    ``key="params"`` reads the params of a params-only checkpoint and of
    a Trainer's full train state alike. The key-set check then applies
    to the paths under ``key``.
    """
    if not is_valid(path):
        raise FileNotFoundError(f"no valid checkpoint at {path}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as err:
        raise CorruptCheckpointError(
            f"checkpoint {path}: unreadable manifest ({err})"
        ) from err
    prefix = "" if key is None else f"[{key!r}]"
    pairs = _flatten(like, prefix)
    paths = [p for p, _ in pairs]
    by_path = {e["path"]: e for e in manifest["leaves"]
               if e["path"].startswith(prefix)}
    if set(paths) != set(by_path):
        missing = set(paths) - set(by_path)
        extra = set(by_path) - set(paths)
        raise ValueError(
            f"checkpoint structure mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}"
        )
    out = {}
    for p, like_leaf in pairs:
        e = by_path[p]
        try:
            raw = np.load(os.path.join(path, e["file"]))
            t = _decode(raw, e["dtype"])
        except Exception as err:  # torn/truncated leaf
            raise CorruptCheckpointError(
                f"checkpoint {path}: leaf {e['file']} unreadable ({err})"
            ) from err
        want = tuple(like_leaf.shape) if isinstance(
            like_leaf, torch.Tensor) else np.shape(like_leaf)
        if tuple(t.shape) != tuple(want):
            raise ValueError(
                f"shape mismatch at {p}: ckpt {tuple(t.shape)} vs "
                f"expected {tuple(want)}"
            )
        dev = device if device is not None else (
            like_leaf.device if isinstance(like_leaf, torch.Tensor)
            else "cpu")
        out[p] = t.to(dev)
    return _unflatten(like, prefix, out)
