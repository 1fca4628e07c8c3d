"""npz checkpoints: the port's own copy of the npz half of
``sea_tpu/utils/checkpoint.py``.

A checkpoint is a flat ``.npz`` of the tree's numpy leaves keyed by path
(``params/blocks/0/self_attn/0/q/w``, ``opt_state/0/1/...``, ``meta/...``),
so a file written by either package loads in the other. Trees are nested
dicts, lists and tuples (namedtuples keep their type on restore); the port
converts its tensors with ``utils.params.to_numpy`` before saving. The
orbax directories of multi-host JAX runs are not read here.

Families, as in the JAX package:
- encoder_decoder_{case}_{run}      best validation reconstruction
- temporal_{case}_{run}             best validation loss
- temporal_Checkpoint_{case}_{run}  best rollout
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def _flatten(tree, prefix=""):
    """Flatten a nested dict/list/tuple tree into {path: array}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        arr = np.asarray(tree)
        if arr.dtype.kind == "V":
            # Extended float types (bfloat16) would be stored as raw void;
            # widen to float32, exact for every sub-f32 float.
            arr = arr.astype(np.float32)
        out[prefix[:-1]] = arr
    return out


def save_pytree(path: str, tree: Any) -> None:
    """npz of the flattened leaves; restore needs a template of the same
    structure (restore_pytree)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def restore_pytree(path: str, template: Any) -> Any:
    """Restore leaves into the structure of ``template``, cast to the
    template's dtypes."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"No checkpoint at {path}. Train the corresponding stage first, "
            "or pass --model_path to a .npz checkpoint.")
    data = np.load(path)

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        if isinstance(tree, tuple):
            children = [rebuild(v, f"{prefix}{i}/")
                        for i, v in enumerate(tree)]
            if hasattr(tree, "_fields"):  # namedtuple: keep its type
                return type(tree)(*children)
            return tuple(children)
        if tree is None:
            return None
        key = prefix[:-1]
        if key not in data:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        leaf = data[key]
        want = np.asarray(tree)
        if leaf.shape != want.shape:
            raise ValueError(
                f"checkpoint {path} leaf {key!r} has shape {leaf.shape} "
                f"but the template expects {want.shape} — the checkpoint "
                "was saved with a different config/layout")
        if leaf.dtype.kind == "V":
            if leaf.dtype.itemsize != want.dtype.itemsize:
                raise ValueError(
                    f"checkpoint {path} leaf {key!r} has opaque dtype "
                    f"{leaf.dtype} that does not match the template's "
                    f"{want.dtype}")
            leaf = leaf.view(want.dtype)
        return leaf.astype(want.dtype)

    return rebuild(template)


def checkpoint_path(save_dir: str, kind: str, case_name: str,
                    run_name: str) -> str:
    return os.path.join(save_dir, f"{kind}_{case_name}_{run_name}.npz")


def save_checkpoint(save_dir: str, kind: str, case_name: str, run_name: str,
                    params: Any, opt_state: Any = None,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write {params, opt_state?, meta?} (numpy trees) as one npz."""
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    if meta:
        tree["meta"] = {k: np.asarray(v) for k, v in meta.items()}
    path = checkpoint_path(save_dir, kind, case_name, run_name)
    save_pytree(path, tree)
    return path


def load_params(path: str, params_template: Any) -> Any:
    """Just the params subtree of a checkpoint."""
    return restore_pytree(path, {"params": params_template})["params"]


def load_full_checkpoint(path: str, params_template: Any,
                         opt_template: Any = None):
    """(params, opt_state | None, meta dict). opt_state comes back only
    when the checkpoint carries one and ``opt_template`` is given."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        has_opt = any(k.startswith("opt_state/") for k in data.files)
        meta = {k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith("meta/")}
    template = {"params": params_template}
    if has_opt and opt_template is not None:
        template["opt_state"] = opt_template
    tree = restore_pytree(path, template)
    return tree["params"], tree.get("opt_state"), meta
