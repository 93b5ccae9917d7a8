"""Every public name a JAX package ``__init__`` exposes imports from the
port's counterpart package, or stands on ``NOT_PORTED`` beside the
ROADMAP A item its module waits for.

The names are read from the JAX ``__init__`` sources with ``ast`` (the
``from ... import`` names and plain assignments), so the test imports
none of the JAX package.  Then the clash of a module and a function of
one name in ``ops`` (``embedding_bag``, ``dequant_matmul``,
``flash_attention`` are functions in the JAX package and modules in the
port): both spellings work.  And the port's packages keep loading torch
only on first use where they did (the top package and ``core``).
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "analytics_zoo_tpu"

# the JAX names whose modules are not ported yet, by the ROADMAP A item
# that ports them
NOT_PORTED = {
    "analytics_zoo_tpu.core": {"make_mesh": "A9", "HostRoster": "A9"},
    "analytics_zoo_tpu.ops": {"ring_attention": "A9", "RING_MIN_LEN": "A9"},
    "analytics_zoo_tpu.robust": {"MeshReplicaLostError": "A9"},
    "analytics_zoo_tpu.nn.layers": {"ShardedEmbeddingTable": "A9",
                                    "SparseMoE": "A9",
                                    "moe_aux_loss": "A9"},
    "analytics_zoo_tpu.tfpark": {name: "A10" for name in (
        "convert_keras_model", "GANEstimator", "KerasModel",
        "TFGraphOptimizer", "TFNet", "TFOptimizer")},
}
# JAX packages with no port package yet, by their ROADMAP A item
PACKAGES_NOT_PORTED = {
    "analytics_zoo_tpu.parallel": "A9",
    "analytics_zoo_tpu.nnframes": "A10",
    "analytics_zoo_tpu.analysis": "A10",
}


def _exposed(init: pathlib.Path):
    """The names a package ``__init__`` binds: ``from ... import`` names
    and assignments (``__all__`` and private names left out)."""
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names
                      if a.name != "*"]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def _jax_packages():
    pkgs = []
    for init in sorted(JAX_ROOT.rglob("__init__.py")):
        rel = init.parent.relative_to(ROOT)
        pkgs.append(".".join(rel.parts))
    return pkgs


def _waiting(pkg):
    """The ROADMAP item a JAX package waits for, when it or a parent is
    not ported."""
    for name, item in PACKAGES_NOT_PORTED.items():
        if pkg == name or pkg.startswith(name + "."):
            return item
    return None


@pytest.mark.parametrize("pkg", [p for p in _jax_packages()
                                 if _waiting(p) is None])
def test_every_jax_package_name_imports_from_the_port(pkg):
    port = importlib.import_module(
        pkg.replace("analytics_zoo_tpu", "analytics_zoo_tpu_torch", 1))
    init = ROOT.joinpath(*pkg.split(".")) / "__init__.py"
    waiting = NOT_PORTED.get(pkg, {})
    missing = [n for n in _exposed(init)
               if n not in waiting and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
    # the list holds only names still missing: a name ported moves off
    ported = [n for n in waiting if hasattr(port, n)]
    assert not ported, f"{ported} are ported: take them off NOT_PORTED"
    assert set(waiting.values()) <= {"A9", "A10"}


def test_not_ported_packages_are_still_missing():
    for pkg in PACKAGES_NOT_PORTED:
        port = pkg.replace("analytics_zoo_tpu", "analytics_zoo_tpu_torch", 1)
        assert importlib.util.find_spec(port) is None, port
    for pkg in NOT_PORTED:
        assert (ROOT.joinpath(*pkg.split(".")) / "__init__.py").exists()


def test_the_layer_vocabulary_is_off_the_list():
    """The merge classes, advanced activations, torch-style layers and
    embeddings are ported; only the A9 layers wait."""
    assert set(NOT_PORTED["analytics_zoo_tpu.nn.layers"].values()) == {"A9"}
    import analytics_zoo_tpu_torch.nn as nn

    for name in ("Add", "Average", "PReLU", "SReLU", "GaussianNoise",
                 "CAdd", "Narrow", "SelectTable", "WordEmbedding",
                 "SparseEmbedding", "SparseDense", "Parameter",
                 "StatelessLayer"):
        assert hasattr(nn, name), name


@pytest.mark.parametrize("name", ["embedding_bag", "dequant_matmul",
                                  "flash_attention"])
def test_ops_module_is_its_function(name):
    """``ops.<name>`` is called as the JAX function is and is also the
    port's module: attribute access, ``from ops import <name>`` and
    ``import analytics_zoo_tpu_torch.ops.<name>`` give one object."""
    import analytics_zoo_tpu_torch.ops as ops

    mod = importlib.import_module(f"analytics_zoo_tpu_torch.ops.{name}")
    assert getattr(ops, name) is mod
    exec(f"from analytics_zoo_tpu_torch.ops import {name} as m; "
         f"import analytics_zoo_tpu_torch.ops.{name} as m2; "
         f"assert m is m2 is mod", {"mod": mod})
    fn = getattr(mod, name)
    rs = np.random.RandomState(0)
    if name == "embedding_bag":
        table = torch.from_numpy(rs.randn(10, 4).astype(np.float32))
        ids = torch.tensor([[1, 2, 0], [3, 0, 0]], dtype=torch.int32)
        args = (table, ids, "mean", 0)
    elif name == "dequant_matmul":
        x = torch.from_numpy(rs.randn(3, 8).astype(np.float32))
        q = torch.from_numpy(rs.randint(-127, 128, (8, 5)).astype(np.int8))
        args = (x, q, torch.full((5,), 0.01))
    else:
        q = torch.from_numpy(rs.randn(1, 2, 8, 16).astype(np.float32))
        args = (q, q, q)
    assert torch.equal(ops.__getattr__(name)(*args), fn(*args))
    assert torch.equal(getattr(ops, name)(*args), fn(*args))


def test_ops_names_are_the_jax_functions():
    import analytics_zoo_tpu_torch.ops as ops
    from analytics_zoo_tpu_torch.ops import (attention, dequant_matmul,
                                             dispatch, embedding_bag,
                                             quantization)

    assert ops.int8_dot is quantization.int8_dot
    assert ops.quantize_program is quantization.quantize_program
    assert ops.Calibrator is quantization.Calibrator
    assert ops.dot_product_attention is attention.dot_product_attention
    assert ops.select_path is dispatch.select_path
    assert ops.pack_int4 is dequant_matmul.pack_int4
    assert (ops.embedding_bag_reference
            is embedding_bag.embedding_bag_reference)
    with pytest.raises(AttributeError):
        ops.no_such_name


def test_top_package_and_core_load_torch_on_first_use():
    """Importing the package, ``core`` and a trigger does not import
    torch (a load client starts without it)."""
    code = ("import sys, analytics_zoo_tpu_torch, "
            "analytics_zoo_tpu_torch.core as core; "
            "t = core.MaxEpoch(3); s = core.TriggerState(epoch=3); "
            "assert t(s); assert 'torch' not in sys.modules; "
            "core.ZooConfig; analytics_zoo_tpu_torch.ZooConfig; "
            "assert 'torch' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
