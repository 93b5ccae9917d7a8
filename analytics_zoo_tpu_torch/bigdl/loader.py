"""BigDL-format model reader (weights-only, pure python), the JAX
package's ``bigdl/loader.py``: the decoder is copied, and reads the file
through a ``memoryview`` (fields are views, storages ``np.frombuffer``
views), so a model of several hundred MB decodes without copying its
floats; ``import_weights_by_name`` loads into a port net.

Reference capability: ``Net.load`` / ``Net.loadBigDL``
(zoo/src/main/scala/com/intel/analytics/zoo/pipeline/api/Net.scala:136-189)
load Analytics-Zoo/BigDL ``.model`` files — the format of the published
pretrained zoo (models/common/ZooModel.scala:183).  Those loaders
deserialize the full JVM module graph; here the GRAPH is rebuilt natively
(models/, nn/) and only the tensors are imported, so the reader decodes
just the protobuf weight payload.

Wire format (reverse-validated against the artifacts the reference
ships: pyzoo/test/zoo/resources/models/bigdl/bigdl_lenet.model and
zoo/src/test/resources/models/zoo_keras/small_*.model):

- The file is one ``BigDLModule`` message: name=1, subModules=2
  (recursive), weight=3, bias=4, preModules=5, nextModules=6,
  moduleType=7, attr map=8 (key=1/value=2 entries), version=9, train=10,
  namePostfix=11, id=12, parameters=16 (repeated tensor).
- ``BigDLTensor``: datatype=1, size=2 (packed), stride=3, offset=4
  (1-based), dimension=5, nElements=6, storage=8, id=9.
- ``TensorStorage``: datatype=1, float_data=2 (packed f32),
  double_data=3, id=9.
- Tensor data is DEDUPLICATED: in-tree tensors carry only ids; the root
  (or a container) attr map holds a ``"global_storage"`` entry — an
  AttrValue whose NameAttrList (field 14) maps tensor-id → AttrValue
  (tensorValue=10) holding the storage with actual data.

Layout: the importer copies SpatialConvolution weights to HWIO and
Linear weights as ``(out, in)ᵀ``, with no reordering of a Linear that
follows a flatten of NCHW features (BigDL's) into the port's NHWC
``Flatten``; the port matches the JAX package there (ROADMAP C, the
reference's fault 6).
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch.bigdl")

# -- wire primitives (protobuf TLV) -----------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _varints(val: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


# -- decoded structures ------------------------------------------------------


@dataclass
class _Tensor:
    size: Tuple[int, ...] = ()
    offset: int = 1
    n_elements: int = 0
    storage_id: Optional[int] = None
    tensor_id: Optional[int] = None
    data: Optional[np.ndarray] = None       # present only in storage map


@dataclass
class BigDLModule:
    """One node of the decoded module tree (weights resolved)."""

    name: str = ""
    module_type: str = ""
    weight: Optional[np.ndarray] = None
    bias: Optional[np.ndarray] = None
    parameters: List[np.ndarray] = field(default_factory=list)
    children: List["BigDLModule"] = field(default_factory=list)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def _decode_tensor(buf: bytes) -> _Tensor:
    t = _Tensor()
    for fnum, wtype, val in _fields(buf):
        if fnum == 2:
            t.size = tuple(_varints(val) if wtype == 2 else [val])
        elif fnum == 4:
            t.offset = val
        elif fnum == 6:
            t.n_elements = val
        elif fnum == 8:                      # TensorStorage
            # accumulate-and-concatenate (like onnx/proto.py's float
            # handling): a proto2-style unpacked writer emits one field
            # entry PER element, so overwriting t.data would keep only
            # the last one
            chunks: List[np.ndarray] = []
            for f2, w2, v2 in _fields(val):
                if f2 == 2:                  # float_data (packed or not)
                    chunks.append(
                        np.frombuffer(v2, np.float32) if w2 == 2
                        else np.asarray([struct.unpack("<f", v2)[0]],
                                        np.float32))
                elif f2 == 3:                # double_data (packed or not)
                    chunks.append(
                        (np.frombuffer(v2, np.float64) if w2 == 2
                         else np.asarray([struct.unpack("<d", v2)[0]],
                                         np.float64)).astype(np.float32))
                elif f2 == 9:
                    t.storage_id = v2
            if chunks:
                t.data = (chunks[0] if len(chunks) == 1
                          else np.concatenate(chunks))
        elif fnum == 9:
            t.tensor_id = val
    return t


def _decode_attr_storage_map(buf: bytes) -> Dict[int, _Tensor]:
    """AttrValue(nameAttrList=14) → {tensor_id: storage tensor}."""
    out: Dict[int, _Tensor] = {}
    for fnum, _, val in _fields(buf):
        if fnum != 14:
            continue
        for f2, _, v2 in _fields(val):
            if f2 != 2:                      # map entries
                continue
            key, av = None, None
            for f3, _, v3 in _fields(v2):
                if f3 == 1:
                    key = int(bytes(v3).decode())
                elif f3 == 2:
                    av = v3
            if key is None or av is None:
                continue
            for f4, _, v4 in _fields(av):
                if f4 == 10:                 # tensorValue
                    out[key] = _decode_tensor(v4)
    return out


def _decode_module(buf: bytes, storages: Dict[int, _Tensor]
                   ) -> BigDLModule:
    m = BigDLModule()
    raw: Dict[str, _Tensor] = {}
    params: List[_Tensor] = []
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            m.name = bytes(val).decode()
        elif fnum == 2:
            m.children.append(_decode_module(val, storages))
        elif fnum == 3:
            raw["weight"] = _decode_tensor(val)
        elif fnum == 4:
            raw["bias"] = _decode_tensor(val)
        elif fnum == 7:
            m.module_type = bytes(val).decode()
        elif fnum == 8:                      # attr entry: global_storage?
            key, av = None, None
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    key = v2
                elif f2 == 2:
                    av = v2
            if key == b"global_storage" and av is not None:
                storages.update(_decode_attr_storage_map(av))
        elif fnum == 16:
            params.append(_decode_tensor(val))
    # resolve after the whole subtree parsed (global_storage is an attr
    # of the root/container and may decode after child tensors)
    m._raw, m._raw_params = raw, params      # type: ignore[attr-defined]
    return m


def _resolve(m: BigDLModule, storages: Dict[int, _Tensor],
             by_storage: Dict[int, np.ndarray]) -> None:
    def mat(t: Optional[_Tensor]) -> Optional[np.ndarray]:
        if t is None:
            return None
        data = None
        if t.data is not None:
            data = t.data
        elif t.tensor_id in storages:
            data = storages[t.tensor_id].data
        elif t.storage_id in by_storage:
            data = by_storage[t.storage_id]
        if data is None:
            return None
        if t.n_elements:
            n = t.n_elements
        elif t.size:
            n = int(np.prod(t.size))
        else:
            # a size-less view into (possibly shared) storage has no
            # defensible extent — taking the rest of the buffer is a
            # guess, so say so instead of silently decoding garbage
            logger.warning(
                "tensor without size or nElements (storage_id=%s, "
                "tensor_id=%s): taking the remaining %d storage elements",
                t.storage_id, t.tensor_id, data.size - (t.offset - 1))
            n = data.size
        arr = data[t.offset - 1:t.offset - 1 + n]
        return arr.reshape(t.size) if t.size else arr

    raw = getattr(m, "_raw", {})
    m.weight = mat(raw.get("weight"))
    m.bias = mat(raw.get("bias"))
    m.parameters = [a for a in (mat(t) for t in
                                getattr(m, "_raw_params", []))
                    if a is not None]
    for attr in ("_raw", "_raw_params"):
        if hasattr(m, attr):
            delattr(m, attr)
    for c in m.children:
        _resolve(c, storages, by_storage)


def load_bigdl_weights(path: str) -> BigDLModule:
    """Decode a BigDL/Analytics-Zoo ``.model`` file into a module tree
    with resolved weight/bias arrays (reference Net.scala:136-189,
    weights only — rebuild the graph natively and feed these in)."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    storages: Dict[int, _Tensor] = {}
    root = _decode_module(buf, storages)
    by_storage = {t.storage_id: t.data for t in storages.values()
                  if t.storage_id is not None and t.data is not None}
    _resolve(root, storages, by_storage)
    return root


def _short_type(module_type: str) -> str:
    return module_type.rsplit(".", 1)[-1]


def import_weights_by_name(model, path: str,
                           name_map: Optional[Dict[str, str]] = None,
                           strict: bool = True) -> Dict[str, int]:
    """Copy a ``.model`` file's tensors into a natively built Keras-style
    model, matched by layer name (``name_map`` renames artifact→native).

    Layout conversions applied per module type:
    - SpatialConvolution ``(group, out, in, kh, kw)`` → HWIO
    - Linear ``(out, in)`` → ``(in, out)``
    Returns ``{native_layer_name: tensors_copied}``; with ``strict`` an
    artifact layer with weights but no native counterpart raises.
    """
    root = load_bigdl_weights(path)
    name_map = name_map or {}
    native_names = {lay.name for lay in model.layers}
    seeded: Dict[str, dict] = {}
    copied: Dict[str, int] = {}
    for mod in root.walk():
        if mod.weight is None and not mod.parameters:
            continue
        target_name = name_map.get(mod.name, mod.name)
        if target_name not in native_names:
            if strict:
                raise KeyError(
                    f"artifact layer {mod.name!r} "
                    f"({_short_type(mod.module_type)}) has weights but no "
                    f"native layer named {target_name!r}; pass name_map")
            continue
        kind = _short_type(mod.module_type)
        w, b = mod.weight, mod.bias
        if kind == "SpatialConvolution":
            w = np.squeeze(w, axis=0) if w.ndim == 5 else w
            new = {"kernel": np.transpose(w, (2, 3, 1, 0))}  # → HWIO
            if b is not None:
                new["bias"] = b
        elif kind == "Linear":
            new = {"kernel": np.transpose(w, (1, 0))}
            if b is not None:
                new["bias"] = b
        else:
            raise NotImplementedError(
                f"BigDL module type {kind!r}: add a layout rule here "
                "(only tensors are imported; the graph is native)")
        seeded[target_name] = new
        copied[target_name] = len(new)
    if getattr(model, "_output_shape", None) is not None:
        # a built port net holds its weights: load them now, by layer
        # and leaf; uncovered layers and leaves keep theirs
        from analytics_zoo_tpu_torch.convert import load_jax_params

        load_jax_params(model, {
            k: ({**v, **seeded[k]} if k in seeded else v)
            for k, v in model.params().items()})
    else:
        # partial seeding by layer name: the estimator fills uncovered
        # layers from the initializer and warns
        model.set_initial_weights(seeded)
    return copied
