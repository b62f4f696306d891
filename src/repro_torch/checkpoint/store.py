"""Checkpointing in the reference's format: a msgpack manifest and one
``.npy`` file per leaf.

Port of ``repro.checkpoint.store``. Layout::

    <dir>/step_<k:08d>/manifest.msgpack   # treedef, shapes, dtypes, metadata
    <dir>/step_<k:08d>/arr_<i>.npy        # leaf i (np.save format)

Leaves are numbered in ``jax.tree.flatten`` order: the fields of a named
tuple in order, the keys of a dict sorted, and a None field giving no
leaf. A ``SimState`` or a ``ScenarioBank`` state saved by the JAX package
therefore restores here, and one saved here restores there. The manifest
is written with the port's own codec (``msgpack_lite``), byte for byte
what ``msgpack.packb`` writes; its ``treedef`` entry is a description of
the structure, which neither side reads back.

A save is atomic: the leaves and then the manifest go to a temporary
directory (``.tmp-step_<k>``, which ``latest_step`` never matches) that
one ``os.replace`` publishes, so a crash leaves the last complete
checkpoint or a manifest-less directory, and both are skipped on restore
(DESIGN.md §3.14's round guard never reads torn state). A checkpoint
that pins a packed layout restores only into a run of the same layout
(DESIGN.md §3.13).
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.msgpack_lite import packb, unpackb

MANIFEST = "manifest.msgpack"


def flatten(tree) -> List[Any]:
    """The leaves of a state in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for field in tree for l in flatten(field)]
    return [tree]


def unflatten(like, leaves: List[Any]):
    """A state shaped like ``like`` holding ``leaves`` (in ``flatten``
    order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[build(f) for f in node])
        if isinstance(node, (tuple, list)):
            return type(node)(build(f) for f in node)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the state has slots")
    return out


def _describe(tree) -> str:
    """The structure of a state, one ``*`` per leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "*"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<ckpt_dir>/step_<step>`` atomically and return its path:
    the leaves and then the manifest land in a temporary directory that
    one ``os.replace`` publishes (a re-save of a step replaces it)."""
    path = _step_dir(ckpt_dir, step)
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    if os.path.isdir(tmp):          # stale temporary of a crashed save
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = [_to_numpy(l) for l in flatten(tree)]
    manifest = {
        "treedef": _describe(tree),
        "n_leaves": len(leaves),
        "step": int(step),
        "metadata": metadata or {},
        "dtypes": [str(l.dtype) for l in leaves],
        "shapes": [[int(d) for d in l.shape] for l in leaves],
    }
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), leaf)
    with open(os.path.join(tmp, MANIFEST), "wb") as f:
        f.write(packb(manifest))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def _read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, MANIFEST), "rb") as f:
        return unpackb(f.read())


def restore_checkpoint(ckpt_dir: str, step: int, like_tree, device=None,
                       expected_layout: Optional[Dict[str, Any]] = None):
    """The state saved at ``step``, in the structure of ``like_tree``
    (tensors, ``meta`` tensors included: only their shapes and dtypes
    are read), each leaf checked against its shape and cast to its
    dtype. Leaves go to ``device``, else to the device of their
    ``like_tree`` leaf (the host for a ``meta`` one).

    ``expected_layout`` is the restoring run's
    ``LayoutChoice.to_metadata()``: a checkpoint that pins another
    layout raises, with both named (DESIGN.md §3.13)."""
    path = _step_dir(ckpt_dir, step)
    manifest = _read_manifest(path)
    like_leaves = flatten(like_tree)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint/tree mismatch restoring {path}: the manifest "
            f"records {manifest['n_leaves']} leaves but the supplied "
            f"like_tree has {len(like_leaves)} — the checkpoint was saved "
            f"from a different model/bank structure.")
    saved_layout = (manifest.get("metadata") or {}).get("layout")
    if (expected_layout is not None and saved_layout is not None
            and dict(saved_layout) != dict(expected_layout)):
        raise ValueError(
            f"packed-layout mismatch restoring {path}: the checkpoint was "
            f"saved under layout {dict(saved_layout)} but this run uses "
            f"layout {dict(expected_layout)}. Section folds — and so every "
            f"channel stream — depend on the layout (DESIGN.md §3.13); "
            f"rebuild the run with the checkpoint's layout "
            f"(repro_torch.common.layout_tune.apply_layout) or start "
            f"fresh.")
    leaves = []
    for i, like in enumerate(like_leaves):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        if list(arr.shape) != list(like.shape):
            raise ValueError(
                f"checkpoint/tree mismatch restoring {path}: leaf {i} was "
                f"saved with shape {tuple(arr.shape)} but the like_tree "
                f"expects {tuple(like.shape)}.")
        dev = device
        if dev is None:
            dev = "cpu" if like.device.type == "meta" else like.device
        leaves.append(torch.from_numpy(arr.copy(order="C")).to(
            device=dev, dtype=like.dtype))
    return unflatten(like_tree, leaves)


def checkpoint_metadata(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """The metadata a checkpoint was saved with (empty if none)."""
    return _read_manifest(_step_dir(ckpt_dir, step)).get("metadata", {})


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None: a directory
    counts only when its manifest exists (the manifest is written last
    and the directory published by ``os.replace``)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.isfile(os.path.join(ckpt_dir, name, MANIFEST)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None
