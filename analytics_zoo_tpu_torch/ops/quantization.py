"""INT8 quantization: symmetric per-channel weights, int8 x int8 matmuls
with int32 accumulation, post-training quantization of imported programs
(the JAX package's ``ops/quantization.py``), and the feature codec of the
STREAM tier's compressed device cache.

``quantize_tensor`` is bit-identical to the JAX package's: the same f32
arithmetic, and ``torch.round`` rounds half to even as ``jnp.round``
does, so quantized trees interchange between the packages.

``int8_dot`` quantizes activations per tensor — dynamically (abs-max of
the live batch, a device scalar: no host read) or from a calibrated
scale — and multiplies int8 by int8 into int32 (``int8_matmul``:
``torch._int_mm`` on a CUDA tensor, the exact int32 product on the CPU),
then rescales in the JAX order, ``acc.float() * x_scale * w_scale``.
``weight_only=True`` keeps x in float and runs the dequantize-matmul
kernel (kernel 3).  On the CPU the results are the JAX package's bit for
bit.  ``Calibrator``, ``QuantizedProgram`` and ``quantize_program`` give
an imported ONNX program's Gemm / MatMul nodes that int8 path (the int8
``InferenceModel.load_onnx``).

``quantize_feature_array`` is the JAX package's host encode, copied
(numpy), and ``dequantize_features`` its decode on the device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["quantize_tensor", "int8_dot", "int8_matmul", "Calibrator",
           "QuantizedProgram", "quantize_program", "quantize_feature_array",
           "dequantize_features"]


def quantize_feature_array(a: np.ndarray, dtype: str = "uint8"
                           ) -> Tuple[np.ndarray, np.float32, np.float32]:
    """Host-side encode of a float feature array for the compressed
    device cache (``data/streaming.py``): ``(q, scale, zero)`` with
    ``a ≈ q * scale + zero``.  ``uint8`` is affine (min / max over the
    array), ``int8`` symmetric (abs-max, ``zero == 0``); the scales are
    scalars, so the decode is one multiply-add."""
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.floating):
        raise TypeError(f"quantize_feature_array needs floats, got "
                        f"{a.dtype}")
    if dtype == "int8":
        amax = float(np.max(np.abs(a))) if a.size else 0.0
        scale = amax / 127.0 if amax > 0 else 1.0
        q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        return q, np.float32(scale), np.float32(0.0)
    if dtype == "uint8":
        lo = float(a.min()) if a.size else 0.0
        hi = float(a.max()) if a.size else 0.0
        scale = (hi - lo) / 255.0 if hi > lo else 1.0
        q = np.clip(np.round((a - lo) / scale), 0, 255).astype(np.uint8)
        return q, np.float32(scale), np.float32(lo)
    raise ValueError(f"unknown feature cache dtype {dtype!r}; "
                     "known: uint8, int8")


def dequantize_features(q: torch.Tensor, scale, zero) -> torch.Tensor:
    """Decode gathered rows of a ``quantize_feature_array`` shard back to
    f32 (``scale`` and ``zero``: f32 scalars, tensors on ``q``'s device
    in a captured program)."""
    return q.to(torch.float32) * scale + zero


def quantize_tensor(w: torch.Tensor, axis: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: returns (int8 weights, f32 scales)
    with ``scale`` shaped to broadcast along ``axis``."""
    w = torch.as_tensor(w)
    reduce_dims = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    amax = w.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


# torch._int_mm on CUDA takes M > 16 rows and K, N multiples of 8; the
# operands are padded with zeros to that (exact in integer arithmetic)
_INT_MM_MIN_ROWS = 32
_INT_MM_MULTIPLE = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exactly.

    On a CUDA tensor it is ``torch._int_mm`` (cuBLASLt's int8 tensor-core
    product), on operands padded with zero rows to at least 32 rows and
    with zero columns / rows so K and N are multiples of 8; on the CPU the
    plain int32 product.  Other dtypes or ranks raise: there is no float
    fallback."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {x_q.dtype} "
                        f"and {w_q.dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) @ (K, N), got "
                         f"{tuple(x_q.shape)} @ {tuple(w_q.shape)}")
    if x_q.device != w_q.device:
        raise ValueError(f"int8_matmul operands on {x_q.device} and "
                         f"{w_q.device}")
    if x_q.device.type != "cuda":
        return torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32))
    m, k = x_q.shape
    n = w_q.shape[1]
    mp = max(m, _INT_MM_MIN_ROWS)
    kp, np_ = _round_up(k, _INT_MM_MULTIPLE), _round_up(n, _INT_MM_MULTIPLE)
    if (mp, kp) != (m, k):
        x_q = torch.nn.functional.pad(x_q, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w_q = torch.nn.functional.pad(w_q, (0, np_ - n, 0, kp - k))
    acc = torch._int_mm(x_q.contiguous(), w_q.contiguous())
    return acc[:m, :n]


def int8_dot(x, w_q, w_scale, x_scale=None, weight_only: bool = False):
    """``x @ dequant(w_q)`` as an int8 x int8 matmul.

    ``x`` (..., K) float; ``w_q`` (K, N) int8; ``w_scale`` per output
    channel (N,) or (1, N).  ``x_scale``: static per-tensor activation
    scale from calibration (a float or a 0-d tensor); None = dynamic
    (abs-max of the live ``x``, a device scalar, 1 where it is 0).  The
    int32 accumulation is rescaled by one f32 multiply each, in the JAX
    order.  ``weight_only=True`` keeps ``x`` in float and runs the fused
    dequantize-matmul (kernel 3; its plain version on a CPU tensor)."""
    if weight_only:
        from analytics_zoo_tpu_torch.ops.dequant_matmul import dequant_matmul

        return dequant_matmul(x, w_q, torch.reshape(w_scale, (1, -1)))
    if x_scale is None:
        amax = x.abs().amax()
        x_scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    elif not isinstance(x_scale, torch.Tensor):
        # filled on the device (no host copy, so a capture may hold it)
        x_scale = torch.full((), float(x_scale), dtype=torch.float32,
                             device=x.device)
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    lead = tuple(x_q.shape[:-1])
    acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q)
    acc = acc.reshape(lead + (acc.shape[-1],))
    return acc.to(torch.float32) * x_scale * w_scale.reshape(
        (1,) * (acc.ndim - 1) + (-1,))


def _percentile(x: torch.Tensor, q: float) -> float:
    """numpy's default ("linear") percentile of an f32 tensor's elements:
    the two order statistics around the rank taken on the tensor's device
    (``kthvalue``), the rank and the interpolation in f32 on the host, as
    numpy computes them for an f32 array."""
    flat = x.reshape(-1)
    n = flat.numel()
    f = np.float32
    qf = f(q) / f(100)
    rank = f(n - 1) * qf
    lo = int(np.clip(np.floor(rank), 0, n - 1))
    hi = min(lo + 1, n - 1)
    t = f(rank - np.floor(rank))
    a = f(flat.kthvalue(lo + 1).values.item())
    b = f(flat.kthvalue(hi + 1).values.item()) if hi != lo else a
    diff = b - a
    return float(b - diff * (f(1) - t) if t >= 0.5 else a + diff * t)


class Calibrator:
    """Records per-name activation ranges over representative batches
    (the role of OpenVINO's calibration dataset pass).

    ``observe(name, x)`` during calibration forwards (a tensor on any
    device, or an array); ``scale(name)`` afterwards gives the static
    per-tensor scale (max |x| / 127, with an optional percentile clip to
    shed outliers).  The percentile is numpy's linear rule, taken on the
    tensor's device.
    """

    def __init__(self, percentile: Optional[float] = 99.9):
        self.percentile = percentile
        self._maxes: Dict[str, List[float]] = {}

    def observe(self, name: str, x) -> None:
        x = torch.as_tensor(x).detach().to(torch.float32).abs()
        m = (_percentile(x, self.percentile)
             if self.percentile is not None else float(x.max()))
        self._maxes.setdefault(name, []).append(float(m))

    def names(self) -> List[str]:
        return sorted(self._maxes)

    def scale(self, name: str) -> float:
        if name not in self._maxes:
            raise KeyError(f"no calibration data for {name!r}; "
                           f"have: {self.names()}")
        amax = max(self._maxes[name])
        return amax / 127.0 if amax > 0 else 1.0

    def scales(self) -> Dict[str, float]:
        return {n: self.scale(n) for n in self._maxes}


# ---------------------------------------------------------------------------
# program-level post-training quantization (ONNX path)


class QuantizedProgram:
    """An OnnxProgram whose Gemm/MatMul nodes run int8 matmuls.

    Weights of quantized nodes are stored int8 in ``qweights`` (params
    keeps only the non-quantized tensors — biases, norms, ...); with a
    calibrated ``act_scales`` dict the activation quantization is static,
    otherwise dynamic per batch.  ``FunctionModel`` holds ``qweights`` as
    quantized leaves and passes them to ``call`` on their device.
    """

    _QUANT_OPS = ("Gemm", "MatMul")

    def __init__(self, program, act_scales: Optional[Dict[str, float]] =
                 None, min_size: int = 512):
        self.base = program
        self.act_scales = dict(act_scales or {})
        self.qweights: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.quantized_nodes: List[str] = []
        # dispatch by NODE (index), not weight name: a weight shared with
        # a non-quantizable consumer must stay in params, and a skipped
        # (e.g. transposed) Gemm on a quantized weight must not silently
        # take the int8 path
        self._qnode_idx: set = set()
        consumers: Dict[str, int] = {}
        for n, _ in program.nodes:
            for i in n.inputs:
                if i:
                    consumers[i] = consumers.get(i, 0) + 1
        params = dict(program.params)
        for idx, (n, _) in enumerate(program.nodes):
            if n.op_type not in self._QUANT_OPS or len(n.inputs) < 2:
                continue
            wname = n.inputs[1]
            if wname not in params or np.ndim(params[wname]) != 2:
                continue
            if int(n.attrs.get("transA", 0)) or int(n.attrs.get("transB", 0)):
                continue                       # transposed Gemm: skip
            if consumers.get(wname, 0) != 1:
                continue                       # shared initializer: skip
            w = params[wname]
            if np.size(w) < min_size:
                continue
            self.qweights[wname] = quantize_tensor(
                torch.as_tensor(np.asarray(w)), axis=-1)
            self.quantized_nodes.append(n.name or wname)
            self._qnode_idx.add(idx)
            del params[wname]
        self.params = params
        self.consts = program.consts
        self.state = dict(program.state)
        self.input_names = program.input_names
        self.output_names = program.output_names
        self.has_dropout = getattr(program, "has_dropout", False)

    @property
    def nodes(self):
        return self.base.nodes

    def call(self, params, state, *inputs, training=False, rng=None,
             qweights=None):
        """``qweights`` overrides the program's own ``{name: (q, scale)}``
        (``FunctionModel`` passes its device copies)."""
        qweights = self.qweights if qweights is None else qweights

        def quantized(idx, n, env):
            if idx not in self._qnode_idx:
                return None
            wname = n.inputs[1]
            x = env[n.inputs[0]]
            if not isinstance(x, torch.Tensor):         # a host value
                x = torch.from_numpy(np.array(x, np.float32))
            w_q, w_scale = qweights[wname]
            x_scale = self.act_scales.get(n.name or wname)
            if x_scale is not None:
                x_scale = self.base.device_value(np.float32(x_scale),
                                                 x.device)
            y = int8_dot(x, w_q, w_scale.reshape(-1), x_scale=x_scale)
            if n.op_type == "Gemm":
                y = float(n.attrs.get("alpha", 1.0)) * y
                if len(n.inputs) > 2 and n.inputs[2]:
                    bias = env[n.inputs[2]]
                    if not isinstance(bias, torch.Tensor):
                        bias = self.base.device_value(bias, y.device)
                    y = y + float(n.attrs.get("beta", 1.0)) * bias
            return y

        env: Dict[str, Any] = dict(self.consts)
        env.update(params)
        env.update(zip(self.input_names, inputs))
        env = self.base.run_nodes(env, training, rng, hook=quantized)
        outs = [env[o] for o in self.output_names]
        return (outs[0] if len(outs) == 1 else outs), state


def quantize_program(program, calibration_inputs: Optional[Sequence] = None,
                     percentile: Optional[float] = 99.9,
                     min_size: int = 512, device=None) -> QuantizedProgram:
    """Post-training quantization of an ONNX program.

    With ``calibration_inputs`` (a list of input-arg tuples of arrays),
    runs the f32 program on ``device`` (default ``cuda``) to record
    activation ranges at each quantizable matmul and bakes STATIC
    activation scales; without, activation quantization is dynamic.
    """
    from analytics_zoo_tpu_torch.core.context import resolve_device

    act_scales: Optional[Dict[str, float]] = None
    if calibration_inputs is not None:
        dev = resolve_device(device)
        cal = Calibrator(percentile=percentile)
        # activation name -> [node keys]: two matmuls sharing one input
        # each keep their own calibrated scale
        watch: Dict[str, List[str]] = {}
        for n, _ in program.nodes:
            if (n.op_type in QuantizedProgram._QUANT_OPS
                    and len(n.inputs) > 1 and n.inputs[1] in program.params
                    and np.ndim(program.params[n.inputs[1]]) == 2):
                watch.setdefault(n.inputs[0], []).append(
                    n.name or n.inputs[1])
        params = {k: torch.as_tensor(np.asarray(v)).to(dev)
                  for k, v in program.params.items()}
        def observe(idx, n, env):
            for key in (watch.get(n.inputs[0], ()) if n.inputs else ()):
                cal.observe(key, env[n.inputs[0]])

        with torch.no_grad():
            for args in calibration_inputs:
                args = args if isinstance(args, (list, tuple)) else (args,)
                env: Dict[str, Any] = dict(program.consts)
                env.update(params)
                env.update(zip(program.input_names,
                               [torch.as_tensor(np.asarray(a)).to(dev)
                                for a in args]))
                program.run_nodes(env, hook=observe)
        del params
        watched_keys = {k for keys in watch.values() for k in keys}
        act_scales = {name: cal.scale(name)
                      for name in watched_keys & set(cal._maxes)}
    return QuantizedProgram(program, act_scales=act_scales,
                            min_size=min_size)
