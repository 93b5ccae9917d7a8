"""Small shared utilities: file listing and list coercion."""

from __future__ import annotations

import glob
import os
from typing import Any, List


def get_file_list(path: str, recursive: bool = False) -> List[str]:
    """List files under a path/glob (reference get_file_list)."""
    if os.path.isdir(path):
        pattern = os.path.join(path, "**" if recursive else "*")
        return sorted(f for f in glob.glob(pattern, recursive=recursive)
                      if os.path.isfile(f))
    return sorted(f for f in glob.glob(path) if os.path.isfile(f))


def to_list(x: Any) -> List[Any]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]
