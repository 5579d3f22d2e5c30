"""Durable checkpoint/restore of engine states and prepared IRs.

Counterpart of ``hisstools_library_tpu/utils/checkpoint.py``. The reference
library cannot persist its streaming state (private buffers,
PartitionedConvolve.h:62-81); here every state is an explicit dataclass of
tensors and host ints, so a long-running stream (broadcast processing, a
multi-hour IR render) can checkpoint mid-stream and resume bit-exactly after
a restart.

The port's states are plain dataclasses, not pytrees, so :func:`leaves` /
:func:`rebuild` flatten them explicitly, in the order that
``jax.tree_util.tree_flatten`` gives the JAX twin: dataclass fields in order
(a field marked ``metadata={"static": True}``, as ``MonoIR.tail_shift`` is,
belongs to the structure, as in the twin's treedef, and is not a leaf),
``None`` dropped, dict keys sorted, tuples and lists in order, anything else
(a tensor, a numpy array, a Python scalar) one leaf. With that order an
``.npz`` written by either package's :func:`save_npz` restores in the
other's :func:`restore_npz`. It covers ``MonoState``, ``MonoStreamState``,
``MonoBlockState``, ``PartitionedState``, ``StreamState``, ``MonoIR``,
``Split``, the tracker's states, dicts, tuples and Python scalars.

:func:`save` / :func:`restore` write the leaves with ``torch.save`` (no
orbax: it needs jax) to a temporary name that replaces ``path`` atomically.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterator, List

import numpy as np
import torch


def _fields(obj):
    return [f for f in dataclasses.fields(obj) if not f.metadata.get("static")]


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the JAX twin's ``tree_flatten`` order."""
    out: List[Any] = []

    def walk(x):
        if x is None:
            return
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in _fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        else:
            out.append(x)

    walk(tree)
    return out


def rebuild(like: Any, values) -> Any:
    """``like``'s structure with its leaves replaced, in :func:`leaves`
    order, by ``values`` (an iterable of exactly as many values)."""
    it: Iterator[Any] = iter(values)

    def walk(x):
        if x is None:
            return None
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name))
                                             for f in _fields(x)})
        if isinstance(x, dict):
            new = {k: walk(x[k]) for k in sorted(x)}
            return {k: new[k] for k in x}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return next(it)

    return walk(like)


def _check_count(found: int, like: Any) -> List[Any]:
    like_leaves = leaves(like)
    if found != len(like_leaves):
        raise ValueError(f"checkpoint has {found} leaves, "
                         f"exemplar has {len(like_leaves)}")
    return like_leaves


def _cast(a, like):
    """``a`` (a tensor or numpy array) as the exemplar leaf ``like``: a
    tensor on its device in its dtype, a numpy array in its dtype, or its
    Python scalar type (npz gives 0-d arrays back for Python scalars)."""
    if isinstance(like, torch.Tensor):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, like.dtype)
    return type(like)(a.item() if hasattr(a, "item") else a)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


def save(path: str, state: Any) -> None:
    """Write ``state``'s leaves atomically to ``path``: ``torch.save`` to a
    temporary name beside it, then ``os.replace`` over any checkpoint there,
    so ``path`` holds either the old checkpoint or the whole new one."""
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save([_to_host(x) for x in leaves(state)], tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore(path: str, like: Any) -> Any:
    """Read a checkpoint written by :func:`save` back into the structure of
    ``like`` (an exemplar with the right structure, shapes and dtypes, e.g. a
    fresh state from ``init_stream_state``): tensors come back on ``like``'s
    devices, in its dtypes."""
    stored = torch.load(os.path.abspath(path), weights_only=True)
    like_leaves = _check_count(len(stored), like)
    return rebuild(like, [_cast(a, l) for a, l in zip(stored, like_leaves)])


def save_npz(path: str, state: Any) -> None:
    """Dependency-light alternative in the JAX twin's format: the leaves as
    numpy arrays in one .npz (not atomic)."""
    np.savez(path, *[x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                     else np.asarray(x) for x in leaves(state)])


def restore_npz(path: str, like: Any) -> Any:
    with np.load(path) as z:
        arrays = [z[k] for k in z.files]
    like_leaves = _check_count(len(arrays), like)
    return rebuild(like, [_cast(a, l) for a, l in zip(arrays, like_leaves)])
