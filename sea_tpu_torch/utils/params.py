"""Parameter trees across packages.

A parameter tree is the JAX package's pytree layout — nested dicts and
lists with the npz paths as keys (``blocks/0/self_attn/0/q/w``), linear
weights ``[d_in, d_out]`` — with ``torch.Tensor`` leaves. ``from_numpy``
and ``to_numpy`` move a tree between the two packages unchanged, so a
checkpoint written by either CLI (npz, ``utils.checkpoint.save_pytree``)
serves in the other; ``to_numpy`` and ``opt_state_from_numpy`` do the
same for the optimizer state (AdamW with f32 or bf16 first
moments, or Adafactor; with the linear schedule's count or without; alone
or inside the bf16 shadow's state).
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict/list/tuple tree; None stays."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):  # namedtuple
            return type(tree)(*children)
        return type(tree)(children)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a dict/list/tuple tree in the order npz paths list them
    (dict insertion order, then index); None dropped."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_paths(tree, prefix: str = ""):
    """The npz path of each leaf (``blocks/0/attn/q/w``), in
    ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}{i}/")]
    return [] if tree is None else [prefix[:-1]]


def _tensor(a, device):
    """A numpy leaf as a tensor on ``device``, dtype kept. numpy has no
    bf16: JAX's bf16 arrays (ml_dtypes) come in by their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def from_numpy(tree, device) -> dict:
    """JAX params tree of numpy arrays (``jax.tree.map(np.asarray, p)`` or
    a ``restore_pytree`` result) -> the port's tree of tensors on
    ``device``. dtypes are kept."""
    return tree_map(lambda a: _tensor(a, device), tree)


def to_numpy(tree) -> dict:
    """The port's tree of tensors -> a tree of numpy arrays that
    ``save_pytree`` writes as a checkpoint either CLI loads. bf16 leaves are
    widened to f32 (exact), as the JAX package widens them on save. Of an
    optimizer state (train/optim.py) it gives the numpy tree of
    ``jax.tree.map(np.asarray, tx.init(params))``: the same npz paths,
    counts as int32, a bf16 mu and the bf16 shadow widened to f32."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, tree)


def opt_state_from_numpy(tree, device, mu_dtype=None):
    """An optimizer state of numpy arrays (``jax.tree.map(np.asarray,
    tx.init(p))``, or a ``restore_pytree`` result) -> the port's:
    statistics and shadow on ``device``, the counts on the host. Each part
    is recognised by its fields (an AdamW, Adafactor or schedule state;
    EmptyState becomes ``()``). A state with a shadow (two children, the
    first a state itself) comes back as a ``ShadowOptState`` with bf16
    shadow leaves. ``mu_dtype``: AdamW's first-moment dtype (a checkpoint
    stores a bf16 mu widened to f32); None keeps the arrays' own."""
    from sea_tpu_torch.train.optim import (FactoredState, ScaleByAdamState,
                                           ScaleByScheduleState,
                                           ShadowOptState)
    from sea_tpu_torch.utils.precision import to_bf16
    if len(tree) == 2 and isinstance(tree[0], tuple):
        return ShadowOptState(
            opt_state_from_numpy(tree[0], device, mu_dtype),
            to_bf16(from_numpy(tree[1], device)))

    def count(c):
        return torch.tensor(np.asarray(c), dtype=torch.int32)

    def part(s):
        fields = getattr(s, "_fields", ())  # (a tuple has a count method)
        if "mu" in fields:
            mu = from_numpy(s.mu, device)
            if mu_dtype is not None:
                mu = tree_map(lambda m: m.to(mu_dtype), mu)
            return ScaleByAdamState(count(s.count), mu,
                                    from_numpy(s.nu, device))
        if "v_row" in fields:
            return FactoredState(count(s.count),
                                 *(from_numpy(getattr(s, k), device)
                                   for k in ("v_row", "v_col", "v")))
        if "count" in fields:
            return ScaleByScheduleState(count(s.count))
        return ()

    return tuple(part(s) for s in tree)


def opt_state_template(tx, params_np):
    """The numpy tree ``to_numpy(tx.init(params))`` would give,
    for restoring a checkpoint's optimizer state, with no statistics
    allocated: ``tx.init`` runs on meta tensors of the params' shapes, and
    each floating leaf becomes a zero-stride f32 view of its shape (a bf16
    mu and the shadow are stored widened to f32), each count an int32.
    ``tx``: any optimizer of train/optim.py, shadowed or not."""
    meta = tree_map(lambda a: torch.empty(np.shape(a), dtype=torch.float32,
                                          device="meta"), params_np)

    def leaf(t):
        if t.is_floating_point():
            return np.broadcast_to(np.float32(0), tuple(t.shape))
        return np.int32(0)
    return tree_map(leaf, tx.init(meta))


def save_init_checkpoints(case, save_dir: str, *, seed: int) -> dict:
    """Initialise the port's stage-1 and stage-2 models for ``case`` from
    seeded ``torch.Generator``s (``seed`` and ``seed + 1``), the stage-1
    model sized for the data ``temporal test --synthetic`` builds, and write
    both checkpoints where that command loads them from ``save_dir``.
    Returns the numpy trees by checkpoint kind."""
    from sea_tpu_torch.data.mesh import MeshProcessor
    from sea_tpu_torch.utils.checkpoint import checkpoint_path, save_pytree
    from sea_tpu_torch.cli import _load_data
    from sea_tpu_torch.models.spatial import init_spatial
    from sea_tpu_torch.models.temporal import init_temporal
    _, coords, _ = _load_data(case, synthetic=True)
    mp = MeshProcessor(case.mesh, case.spatial.field_groups, coords)
    trees = {
        "encoder_decoder": init_spatial(
            case.spatial.with_n_inp(mp.cells_per_patch),
            torch.Generator().manual_seed(seed), device="cpu"),
        "temporal": init_temporal(
            case.temporal, torch.Generator().manual_seed(seed + 1),
            device="cpu"),
    }
    out = {}
    for kind, tree in trees.items():
        out[kind] = to_numpy(tree)
        save_pytree(checkpoint_path(save_dir, kind, case.run.case_name,
                                    case.run.run_name), {"params": out[kind]})
    return out
