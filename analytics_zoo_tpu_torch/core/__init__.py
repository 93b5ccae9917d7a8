# The names below load on first use (PEP 562): ``core.profiling`` and
# ``core.config`` import without torch (see the package's ``__init__``).
_LAZY = {
    "ZooConfig": "analytics_zoo_tpu_torch.core.config",
    "ZooContext": "analytics_zoo_tpu_torch.core.context",
    "get_zoo_context": "analytics_zoo_tpu_torch.core.context",
    "init_zoo_context": "analytics_zoo_tpu_torch.core.context",
    "resolve_device": "analytics_zoo_tpu_torch.core.context",
    "set_zoo_context": "analytics_zoo_tpu_torch.core.context",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(_LAZY[name]), name)
    globals()[name] = value
    return value
