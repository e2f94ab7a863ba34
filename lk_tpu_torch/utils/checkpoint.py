"""Checkpoint / resume of pipeline states: counterpart of
``lk_tpu.utils.checkpoint``.

A state (``PipelineState``, ``TrackerState``, ``VPState``: NamedTuples of
tensors, nested, or dicts of arrays) round-trips through
one .npz in ``lk_tpu``'s format: ``leaf_i`` the leaves in field order,
flattened depth first (dict keys sorted), ``n`` their count, ``meta`` an
identity string, and ``treedef`` the structure.  ``lk_tpu`` writes
``jax.tree_util``'s treedef there; the port writes its own structure
string, the dotted field paths of the leaves, so a checkpoint resumes in
the package that wrote it.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch


def _flatten(tree, path: str = "") -> Tuple[List[Any], List[str]]:
    """(leaves, their dotted paths), depth first in field order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        return [tree], [path]
    leaves, paths = [], []
    for name, sub in items:
        ls, ps = _flatten(sub, f"{path}.{name}" if path else str(name))
        leaves += ls
        paths += ps
    return leaves, paths


def _unflatten(template, leaves):
    """``template``'s structure holding the next of ``leaves`` (an
    iterator) at each leaf."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(x, leaves) for x in template))
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save_state(state: Any, path: str, meta: str = "") -> str:
    """Persist a state plus its identity: the structure string and
    ``meta`` (e.g. the pipeline config's repr; ``load_state`` rejects a
    checkpoint whose meta differs, so a VP_DETECT checkpoint cannot resume
    into a FINAL pipeline when every leaf shape coincides)."""
    leaves, paths = _flatten(state)
    arrs = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez_compressed(path, treedef=",".join(paths), n=len(leaves),
                        meta=str(meta), **arrs)
    return path


def load_state(template: Any, path: str, meta: str = "") -> Any:
    """Restore into the structure of ``template``: tensor leaves come back
    as tensors on the template leaf's device, others as numpy.

    Rejects, in this order, a different identity ``meta`` (when both sides
    give one), structure, leaf count, leaf shape and leaf dtype."""
    with np.load(path, allow_pickle=False) as z:
        n = int(z["n"])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        saved_structure = str(z["treedef"]) if "treedef" in z.files else ""
        saved_meta = str(z["meta"]) if "meta" in z.files else ""
    t_leaves, t_paths = _flatten(template)
    structure = ",".join(t_paths)
    if meta and saved_meta and saved_meta != str(meta):
        raise ValueError("checkpoint identity mismatch: saved for "
                         f"{saved_meta!r}, loading into {str(meta)!r}")
    if saved_structure and saved_structure != structure:
        raise ValueError(f"checkpoint structure mismatch:\n  saved:    "
                         f"{saved_structure}\n  template: {structure}")
    if len(t_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"{len(t_leaves)}")
    out = []
    for i, (a, b) in enumerate(zip(t_leaves, leaves)):
        shape = tuple(a.shape if isinstance(a, torch.Tensor)
                      else np.shape(a))
        if shape != tuple(b.shape):
            raise ValueError(f"leaf {i}: shape mismatch {shape} vs "
                             f"{b.shape}")
        if _np_dtype(a) != b.dtype:
            raise ValueError(f"leaf {i}: dtype mismatch {_np_dtype(a)} vs "
                             f"{b.dtype}")
        out.append(torch.from_numpy(b).to(a.device)
                   if isinstance(a, torch.Tensor) else b)
    return _unflatten(template, iter(out))
