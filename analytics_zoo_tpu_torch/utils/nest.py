"""Structure flatten/pack (the tf.nest contract over lists/tuples/dicts)."""

from __future__ import annotations

from typing import Any, Callable, List


def _is_structure(x: Any) -> bool:
    return isinstance(x, (list, tuple, dict))


def flatten(structure: Any) -> List[Any]:
    """Depth-first leaf list; dict leaves ordered by sorted key
    (tf.nest semantics)."""
    if not _is_structure(structure):
        return [structure]
    if isinstance(structure, dict):
        items = [structure[k] for k in sorted(structure)]
    else:
        items = structure
    out: List[Any] = []
    for v in items:
        out.extend(flatten(v))
    return out


def pack_sequence_as(structure: Any, flat: List[Any]) -> Any:
    """Inverse of flatten: rebuild ``structure``'s shape from ``flat``."""
    def build(s, it):
        if not _is_structure(s):
            return next(it)
        if isinstance(s, dict):
            return type(s)((k, build(s[k], it)) for k in sorted(s))
        vals = [build(v, it) for v in s]
        return type(s)(vals) if not isinstance(s, tuple) else tuple(vals)

    it = iter(flat)
    try:
        packed = build(structure, it)
    except (StopIteration, RuntimeError) as e:
        # RuntimeError covers StopIteration surfacing through generators
        raise ValueError(
            f"too few leaves ({len(flat)}) for structure") from e
    leftovers = list(it)
    if leftovers:
        raise ValueError(f"{len(leftovers)} extra leaves for structure")
    return packed


def map_structure(fn: Callable, structure: Any) -> Any:
    return pack_sequence_as(structure, [fn(x) for x in flatten(structure)])
