"""Tree checkpointing: flat-key .npz payload + JSON manifest. Port of
`repro.checkpoint.ckpt`, in the same on-disk format, so a checkpoint
written by either package loads into the other bit for bit.

The format: one `ckpt_%08d.npz` holding every leaf under its path, the
path's parts joined by "::" (dict keys sorted, list items as "[i]");
empty dicts and lists and None as zero-length marker arrays under
"__empty_dict__", "__empty_list__" and "__none__"; a bfloat16 leaf as
its uint16 bit pattern under a "__bf16__" marker (numpy has no
bfloat16); and a `ckpt_%08d.json` manifest with the step, the number of
arrays and the caller's metadata. The .npz is written to a temporary
name and then renamed, so a reader never sees half a checkpoint.

Round-resumable: the Trainer's state (parameters, optimizer moments,
round index, clock, scheduler carry) round-trips exactly.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

_SEP = "::"
_BF16_MARK = "__bf16__"


def _host_array(leaf) -> np.ndarray:
    """A tensor on any device, or a host value, as a numpy array; host
    scalars keep their numpy dtype (an np.int64 stays int64)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree):
    flat = {}

    def mark(prefix, marker):
        flat[f"{prefix}{_SEP}{marker}" if prefix else marker] = np.zeros(0)

    def walk(prefix, node):
        if isinstance(node, dict):
            if not node:   # empty containers must round-trip (sgd opt state)
                mark(prefix, "__empty_dict__")
                return
            for k in sorted(node):
                walk(f"{prefix}{_SEP}{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            if not node:
                mark(prefix, "__empty_list__")
                return
            for i, v in enumerate(node):
                walk(f"{prefix}{_SEP}[{i}]", v)
        elif node is None:
            mark(prefix, "__none__")
        elif torch.is_tensor(node) and node.dtype == torch.bfloat16:
            flat[f"{prefix}{_SEP}{_BF16_MARK}"] = (
                node.detach().cpu().view(torch.int16).numpy()
                .view(np.uint16))
        else:
            flat[prefix] = _host_array(node)

    walk("", tree)
    return flat


def _bf16(bits: np.ndarray) -> torch.Tensor:
    """A uint16 bit pattern as the bfloat16 tensor with those bits."""
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _unflatten(flat):
    tree: dict = {}
    list_marker = re.compile(r"^\[(\d+)\]$")
    for key in sorted(flat):
        parts = key.split(_SEP)
        if parts[-1] == _BF16_MARK:
            parts = parts[:-1]
            value = _bf16(flat[key])
        elif parts[-1] == "__none__":
            parts = parts[:-1]
            value = None
        elif parts[-1] == "__empty_dict__":
            parts = parts[:-1]
            value = {}
        elif parts[-1] == "__empty_list__":
            parts = parts[:-1]
            value = []
        else:
            value = flat[key]
        if not parts or parts == [""]:   # whole tree is one empty container
            tree = value
            continue
        node = tree
        for i, part in enumerate(parts):
            if i == len(parts) - 1:
                node[part] = value
            else:
                node = node.setdefault(part, {})

    def fix(node):   # {"[0]": ..., "[1]": ...} dicts back to lists
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(list_marker.match(k) for k in keys):
                return [fix(node[f"[{i}]"]) for i in range(len(keys))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(tree)


def save_checkpoint(directory: str, step: int, tree, *, metadata=None):
    """Write `tree` (nested dicts/lists of tensors on any device, numpy
    arrays, host scalars or None) as checkpoint `step` in `directory`;
    returns the .npz path."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"   # savez appends .npz unless already present
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    manifest = {"step": step, "n_arrays": len(flat),
                "metadata": metadata or {}}
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def latest_step(directory: str):
    """The highest step with a checkpoint in `directory`, else None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int | None = None):
    """Checkpoint `step` of `directory` (the latest when None) as (tree,
    step, metadata). The tree's leaves are numpy arrays, as written
    (0-dim for scalars), except bfloat16 leaves, which come back as
    `torch.bfloat16` tensors on the CPU with the written bits."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    manifest_path = os.path.join(directory, f"ckpt_{step:08d}.json")
    metadata = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            metadata = json.load(f).get("metadata", {})
    return _unflatten(flat), step, metadata
