"""The port's Caffe and BigDL importers against the JAX package's, on the
CPU.

Caffe: the same prototxt text and caffemodel bytes (V2 ``layer`` and V1
``layers`` encodings, written here) go through both packages'
``load_caffe_parts``; the port's program runs through ``FunctionModel``
and the JAX program eagerly, on the same seeded input.  Tolerance: rtol
1e-4 / atol 1e-4 (convolution sums in another order).  The nets: a
conv / pool / fc net, Caffe's ceil-mode pooling (MAX and AVE),
BatchNorm with a scale factor plus Scale, the extended layer matrix
(PReLU, Bias, Eltwise with coefficients and MAX, Power, AbsVal, Log,
BNLL, ELU, Slice, Concat, Deconvolution), a GoogLeNet-style inception
block, and a ResNet bottleneck in the deploy prototxt's vocabulary
(bias-free Convolution, BatchNorm with use_global_stats, Scale, Eltwise
SUM, the 3x3/2 ceil-mode MAX pool, a global AVE pool, InnerProduct,
Softmax).

BigDL: a ``.model`` file written here in the wire format the reader
documents (in-tree tensors carry ids; the root's ``global_storage``
attribute holds the data) is decoded by both packages (equal trees), and
imported by name into both packages' VGG-16 at a 32x32 input: the
forwards agree within rtol 1e-4 / atol 1e-5.  A conv -> flatten ->
Linear net checks the layout rule: both packages copy a Linear as
``(out, in)ᵀ`` in front of an NHWC flatten, so neither computes what the
NCHW source computed (the reference's fault 6; the port matches the JAX
package).
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.bigdl import import_weights_by_name as jax_import
from analytics_zoo_tpu.bigdl import load_bigdl_weights as jax_bigdl
from analytics_zoo_tpu.caffe import decode_caffemodel as jax_decode
from analytics_zoo_tpu.caffe import load_caffe_parts as jax_caffe
from analytics_zoo_tpu.caffe import parse_prototxt as jax_parse
from analytics_zoo_tpu.models.image.imageclassification import \
    vgg16 as jax_vgg16
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names

from analytics_zoo_tpu_torch.bigdl import (import_weights_by_name,
                                           load_bigdl_weights)
from analytics_zoo_tpu_torch.caffe import (UnsupportedCaffeLayer,
                                           decode_caffemodel, load_caffe,
                                           load_caffe_parts, parse_prototxt)
from analytics_zoo_tpu_torch.models.image import vgg16
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.onnx import to_model
from analytics_zoo_tpu_torch.onnx.proto import _key, _ld, _write_varint

TOL = dict(rtol=1e-4, atol=1e-4)


# -- caffemodel writer (NetParameter wire bytes, V2 and V1) ----------------

def _blob(arr: np.ndarray) -> bytes:
    shape = b"".join(_key(1, 0) + _write_varint(d) for d in arr.shape)
    return _ld(7, shape) + _ld(5, arr.astype("<f4").tobytes())


def _v2_layer(name, blobs):
    return _ld(100, _ld(1, name.encode())
               + b"".join(_ld(7, _blob(b)) for b in blobs))


def _v1_layer(name, blobs):
    return _ld(2, _ld(4, name.encode())
               + b"".join(_ld(6, _blob(b)) for b in blobs))


def _caffemodel(name, layers, v1=False):
    enc = _v1_layer if v1 else _v2_layer
    return _ld(1, name.encode()) + b"".join(enc(n, b) for n, b in layers)


def _w(rs, *shape, scale=0.3):
    return (rs.randn(*shape) * scale).astype(np.float32)


TINY = """
name: "TinyNet"
input: "data"
input_dim: 2
input_dim: 2
input_dim: 8
input_dim: 8
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 3 kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc1" type: "InnerProduct" bottom: "pool1" top: "fc1"
  inner_product_param { num_output: 4 } }
layer { name: "prob" type: "Softmax" bottom: "fc1" top: "prob" }
"""

TINY_V1 = TINY.replace("layer {", "layers {").replace(
    '"Convolution"', "CONVOLUTION").replace('"ReLU"', "RELU").replace(
    '"Pooling"', "POOLING").replace('"InnerProduct"', "INNER_PRODUCT").replace(
    '"Softmax"', "SOFTMAX")


def _tiny_layers():
    rs = np.random.RandomState(0)
    return [("conv1", [_w(rs, 3, 2, 3, 3), _w(rs, 3, scale=0.1)]),
            ("fc1", [_w(rs, 4, 48, scale=0.2), _w(rs, 4, scale=0.1)])]


CEIL = """
name: "CeilNet"
input: "data"
input_dim: 2
input_dim: 2
input_dim: 7
input_dim: 7
layer { name: "pmax" type: "Pooling" bottom: "data" top: "pmax"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "pave" type: "Pooling" bottom: "pmax" top: "pave"
  pooling_param { pool: AVE kernel_size: 2 stride: 2 } }
"""

BN_SCALE = """
name: "BNNet"
input: "data"
input_dim: 2
input_dim: 3
input_dim: 4
input_dim: 4
layer { name: "bn" type: "BatchNorm" bottom: "data" top: "bn"
        batch_norm_param { eps: 0.001 } }
layer { name: "sc" type: "Scale" bottom: "bn" top: "sc"
        scale_param { bias_term: true } }
"""


def _bn_layers():
    rs = np.random.RandomState(1)
    mean, var = _w(rs, 3), np.abs(_w(rs, 3)) + 0.5
    return [("bn", [mean * 2, var * 2, np.asarray([2.0], np.float32)]),
            ("sc", [_w(rs, 3), _w(rs, 3)])]


EXT = """
name: "ExtNet"
input: "data"
input_dim: 1
input_dim: 4
input_dim: 6
input_dim: 6
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layer { name: "prelu1" type: "PReLU" bottom: "conv1" top: "prelu1" }
layer { name: "bias1" type: "Bias" bottom: "prelu1" top: "bias1" }
layer { name: "elt1" type: "Eltwise" bottom: "prelu1" bottom: "bias1"
  top: "elt1" eltwise_param { operation: SUM coeff: 2.0 coeff: 0.5 } }
layer { name: "eltmax" type: "Eltwise" bottom: "elt1" bottom: "prelu1"
  top: "eltmax" eltwise_param { operation: MAX } }
layer { name: "pow1" type: "Power" bottom: "eltmax" top: "pow1"
  power_param { power: 2.0 scale: 0.5 shift: 1.0 } }
layer { name: "abs1" type: "AbsVal" bottom: "pow1" top: "abs1" }
layer { name: "log1" type: "Log" bottom: "abs1" top: "log1"
  log_param { shift: 1.0 } }
layer { name: "bnll1" type: "BNLL" bottom: "log1" top: "bnll1" }
layer { name: "elu1" type: "ELU" bottom: "bnll1" top: "elu1"
  elu_param { alpha: 0.5 } }
layer { name: "slice1" type: "Slice" bottom: "elu1" top: "sa" top: "sb"
  slice_param { axis: 1 slice_point: 1 } }
layer { name: "cat1" type: "Concat" bottom: "sb" bottom: "sa" top: "cat1"
  concat_param { axis: 1 } }
layer { name: "deconv1" type: "Deconvolution" bottom: "cat1" top: "deconv1"
  convolution_param { num_output: 2 kernel_size: 2 stride: 2 } }
"""


def _ext_layers():
    rs = np.random.RandomState(3)
    return [("conv1", [_w(rs, 4, 4, 3, 3), _w(rs, 4, scale=0.1)]),
            ("prelu1", [(rs.rand(4) * 0.5).astype(np.float32)]),
            ("bias1", [_w(rs, 4, scale=0.2)]),
            ("deconv1", [_w(rs, 4, 2, 2, 2), _w(rs, 2, scale=0.1)])]


INCEPTION = """
name: "MiniGoogLeNet"
input: "data"
input_dim: 2
input_dim: 3
input_dim: 16
input_dim: 16
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "i_1x1" type: "Convolution" bottom: "norm1" top: "i_1x1"
  convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "i_3x3" type: "Convolution" bottom: "norm1" top: "i_3x3"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layer { name: "i_pool" type: "Pooling" bottom: "norm1" top: "i_pool"
  pooling_param { pool: MAX kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "i_pp" type: "Convolution" bottom: "i_pool" top: "i_pp"
  convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "i_cat" type: "Concat" bottom: "i_1x1" bottom: "i_3x3"
  bottom: "i_pp" top: "i_cat" }
layer { name: "gpool" type: "Pooling" bottom: "i_cat" top: "gpool"
  pooling_param { pool: AVE global_pooling: true } }
layer { name: "drop" type: "Dropout" bottom: "gpool" top: "gpool"
  dropout_param { dropout_ratio: 0.4 } }
layer { name: "fc" type: "InnerProduct" bottom: "gpool" top: "fc"
  inner_product_param { num_output: 5 } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


def _inception_layers():
    rs = np.random.RandomState(1)
    return [("conv1", [_w(rs, 8, 3, 3, 3), _w(rs, 8)]),
            ("i_1x1", [_w(rs, 4, 8, 1, 1), _w(rs, 4)]),
            ("i_3x3", [_w(rs, 4, 8, 3, 3), _w(rs, 4)]),
            ("i_pp", [_w(rs, 4, 8, 1, 1), _w(rs, 4)]),
            ("fc", [_w(rs, 5, 12), _w(rs, 5)])]


def _bn_blobs(rs, c):
    return [_w(rs, c, scale=0.1), np.abs(_w(rs, c)) + 0.5,
            np.asarray([1.0], np.float32)]


RESNET_BLOCK = """
name: "ResNetBlock"
input: "data"
input_dim: 2
input_dim: 3
input_dim: 32
input_dim: 32
layer { bottom: "data" top: "conv1" name: "conv1" type: "Convolution"
  convolution_param { num_output: 8 kernel_size: 7 pad: 3 stride: 2
  bias_term: false } }
layer { bottom: "conv1" top: "conv1" name: "bn_conv1" type: "BatchNorm"
  batch_norm_param { use_global_stats: true } }
layer { bottom: "conv1" top: "conv1" name: "scale_conv1" type: "Scale"
  scale_param { bias_term: true } }
layer { bottom: "conv1" top: "conv1" name: "conv1_relu" type: "ReLU" }
layer { bottom: "conv1" top: "pool1" name: "pool1" type: "Pooling"
  pooling_param { kernel_size: 3 stride: 2 pool: MAX } }
layer { bottom: "pool1" top: "res2a_branch1" name: "res2a_branch1"
  type: "Convolution" convolution_param { num_output: 16 kernel_size: 1
  pad: 0 stride: 1 bias_term: false } }
layer { bottom: "res2a_branch1" top: "res2a_branch1" name: "bn2a_branch1"
  type: "BatchNorm" batch_norm_param { use_global_stats: true } }
layer { bottom: "res2a_branch1" top: "res2a_branch1"
  name: "scale2a_branch1" type: "Scale" scale_param { bias_term: true } }
layer { bottom: "pool1" top: "res2a_branch2a" name: "res2a_branch2a"
  type: "Convolution" convolution_param { num_output: 4 kernel_size: 1
  pad: 0 stride: 1 bias_term: false } }
layer { bottom: "res2a_branch2a" top: "res2a_branch2a"
  name: "bn2a_branch2a" type: "BatchNorm"
  batch_norm_param { use_global_stats: true } }
layer { bottom: "res2a_branch2a" top: "res2a_branch2a"
  name: "scale2a_branch2a" type: "Scale" scale_param { bias_term: true } }
layer { bottom: "res2a_branch2a" top: "res2a_branch2a"
  name: "res2a_branch2a_relu" type: "ReLU" }
layer { bottom: "res2a_branch2a" top: "res2a_branch2b"
  name: "res2a_branch2b" type: "Convolution"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 1
  bias_term: false } }
layer { bottom: "res2a_branch2b" top: "res2a_branch2b"
  name: "bn2a_branch2b" type: "BatchNorm"
  batch_norm_param { use_global_stats: true } }
layer { bottom: "res2a_branch2b" top: "res2a_branch2b"
  name: "scale2a_branch2b" type: "Scale" scale_param { bias_term: true } }
layer { bottom: "res2a_branch2b" top: "res2a_branch2b"
  name: "res2a_branch2b_relu" type: "ReLU" }
layer { bottom: "res2a_branch2b" top: "res2a_branch2c"
  name: "res2a_branch2c" type: "Convolution"
  convolution_param { num_output: 16 kernel_size: 1 pad: 0 stride: 1
  bias_term: false } }
layer { bottom: "res2a_branch2c" top: "res2a_branch2c"
  name: "bn2a_branch2c" type: "BatchNorm"
  batch_norm_param { use_global_stats: true } }
layer { bottom: "res2a_branch2c" top: "res2a_branch2c"
  name: "scale2a_branch2c" type: "Scale" scale_param { bias_term: true } }
layer { bottom: "res2a_branch1" bottom: "res2a_branch2c" top: "res2a"
  name: "res2a" type: "Eltwise" }
layer { bottom: "res2a" top: "res2a" name: "res2a_relu" type: "ReLU" }
layer { bottom: "res2a" top: "pool5" name: "pool5" type: "Pooling"
  pooling_param { kernel_size: 8 stride: 1 pool: AVE } }
layer { bottom: "pool5" top: "fc10" name: "fc10" type: "InnerProduct"
  inner_product_param { num_output: 10 } }
layer { bottom: "fc10" top: "prob" name: "prob" type: "Softmax" }
"""


def _resnet_layers():
    rs = np.random.RandomState(5)
    out = [("conv1", [_w(rs, 8, 3, 7, 7, scale=0.1)]),
           ("bn_conv1", _bn_blobs(rs, 8)),
           ("scale_conv1", [1 + _w(rs, 8, scale=0.1), _w(rs, 8, scale=0.1)])]
    for name, shape in (("2a_branch1", (16, 8, 1, 1)),
                        ("2a_branch2a", (4, 8, 1, 1)),
                        ("2a_branch2b", (4, 4, 3, 3)),
                        ("2a_branch2c", (16, 4, 1, 1))):
        c = shape[0]
        out += [(f"res{name}", [_w(rs, *shape)]),
                (f"bn{name}", _bn_blobs(rs, c)),
                (f"scale{name}", [1 + _w(rs, c, scale=0.1),
                                  _w(rs, c, scale=0.1)])]
    out.append(("fc10", [_w(rs, 10, 16), _w(rs, 10, scale=0.1)]))
    return out


NETS = {
    "tiny_v2": (TINY, _tiny_layers, False, (2, 2, 8, 8)),
    "tiny_v1": (TINY_V1, _tiny_layers, True, (2, 2, 8, 8)),
    "ceil_mode_pools": (CEIL, list, False, (2, 2, 7, 7)),
    "batchnorm_scale": (BN_SCALE, _bn_layers, False, (2, 3, 4, 4)),
    "extended_layers": (EXT, _ext_layers, False, (1, 4, 6, 6)),
    "inception_block": (INCEPTION, _inception_layers, False, (2, 3, 16, 16)),
    "resnet_bottleneck": (RESNET_BLOCK, _resnet_layers, False,
                          (2, 3, 32, 32)),
}


def _outs(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.detach().numpy() if isinstance(o, torch.Tensor)
            else np.asarray(o) for o in outs]


@pytest.mark.parametrize("name", sorted(NETS))
def test_caffe_net_matches_jax(name):
    text, layers, v1, shape = NETS[name]
    model_bytes = _caffemodel(name, layers(), v1=v1)
    x = np.random.RandomState(9).randn(*shape).astype(np.float32)
    jprog = jax_caffe(text, model_bytes)
    want = _outs(jprog.call(jprog.params, jprog.state, x)[0])
    prog = load_caffe_parts(text, model_bytes)
    assert [n.op_type for n, _ in prog.nodes] == [
        n.op_type for n, _ in jprog.nodes]
    assert set(prog.params) == set(jprog.params)
    with torch.no_grad():
        got = _outs(to_model(prog).eval()(torch.from_numpy(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_caffe_parse_and_decode_match_jax():
    assert parse_prototxt(RESNET_BLOCK) == jax_parse(RESNET_BLOCK)
    assert parse_prototxt(TINY_V1) == jax_parse(TINY_V1)
    for v1 in (False, True):
        buf = _caffemodel("t", _tiny_layers(), v1=v1)
        got, want = decode_caffemodel(buf), jax_decode(buf)
        assert list(got) == list(want) == ["conv1", "fc1"]
        for k in want:
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(g, w)


def test_caffe_ceil_pool_shape_and_refusal(tmp_path):
    prog = load_caffe_parts(CEIL, b"")
    x = np.arange(98, dtype=np.float32).reshape(2, 1, 7, 7)
    out = to_model(prog).eval()(torch.from_numpy(x))
    assert tuple(out.shape) == (2, 1, 2, 2)     # 7 -> 3 (ceil) -> 2
    bad = TINY.replace('"Softmax"', '"ROIPooling"')
    with pytest.raises(UnsupportedCaffeLayer, match="caffe2onnx"):
        load_caffe_parts(bad, _caffemodel("t", _tiny_layers()))
    (tmp_path / "n.prototxt").write_text(TINY)
    (tmp_path / "n.caffemodel").write_bytes(_caffemodel("t", _tiny_layers()))
    prog = load_caffe(str(tmp_path / "n.prototxt"),
                      str(tmp_path / "n.caffemodel"))
    assert set(prog.params) == {"conv1_W", "conv1_b", "fc1_W", "fc1_b"}


# -- BigDL writer -----------------------------------------------------------

def _bigdl_tensor(size, tensor_id, storage_id, data=None):
    out = [_ld(2, b"".join(_write_varint(d) for d in size)),
           _key(4, 0) + _write_varint(1),
           _key(6, 0) + _write_varint(int(np.prod(size)))]
    storage = _key(9, 0) + _write_varint(storage_id)
    if data is not None:
        storage = _ld(2, np.ascontiguousarray(data, "<f4").tobytes()) \
            + storage
    out.append(_ld(8, storage))
    out.append(_key(9, 0) + _write_varint(tensor_id))
    return b"".join(out)


def write_bigdl(modules, name="model"):
    """A BigDL ``.model``: a Sequential of (name, type, weight, bias)
    modules; in-tree tensors carry only ids, and the root's
    ``global_storage`` attribute maps each tensor id to its data."""
    subs, storage_entries = [], []
    next_id = [1]

    def tensor(arr):
        tid, sid = next_id[0], next_id[0] + 1000
        next_id[0] += 1
        storage_entries.append(_ld(2, _ld(1, str(tid).encode()) + _ld(
            2, _ld(10, _bigdl_tensor(arr.shape, tid, sid, arr)))))
        return _bigdl_tensor(arr.shape, tid, sid)

    for mname, mtype, w, b in modules:
        body = [_ld(1, mname.encode()), _ld(3, tensor(w))]
        if b is not None:
            body.append(_ld(4, tensor(b)))
        body.append(_ld(7, f"com.intel.analytics.bigdl.nn.{mtype}"
                        .encode()))
        subs.append(_ld(2, b"".join(body)))
    attr = _ld(8, _ld(1, b"global_storage") + _ld(
        2, _ld(14, _ld(1, b"global_storage") + b"".join(storage_entries))))
    return (_ld(1, name.encode()) + b"".join(subs)
            + _ld(7, b"com.intel.analytics.bigdl.nn.Sequential") + attr)


VGG_REFERENCE_NAMES = [f"conv{b + 1}_{r + 1}" for b, reps in
                       enumerate((2, 2, 3, 3, 3)) for r in range(reps)]


def _vgg_modules(class_num, flat, seed=0):
    rs = np.random.RandomState(seed)
    mods, cin = [], 3
    for name, f in zip(VGG_REFERENCE_NAMES,
                       [64] * 2 + [128] * 2 + [256] * 3 + [512] * 6):
        mods.append((name, "SpatialConvolution",
                     (rs.randn(1, f, cin, 3, 3) * np.sqrt(2 / (9 * cin)))
                     .astype(np.float32),
                     (rs.randn(f) * 0.01).astype(np.float32)))
        cin = f
    for name, (i, o) in (("fc6", (flat, 4096)), ("fc7", (4096, 4096)),
                         ("fc8", (4096, class_num))):
        mods.append((name, "Linear",
                     (rs.randn(o, i) * np.sqrt(1 / i)).astype(np.float32),
                     (rs.randn(o) * 0.01).astype(np.float32)))
    return mods


def vgg_name_map(net):
    dense = [layer.name for layer in net.layers
             if type(layer).__name__ == "Dense" and layer.name != "fc"]
    out = {ref: f"b{b}c{r}" for ref, (b, r) in zip(
        VGG_REFERENCE_NAMES, [(b, r) for b, reps in
                              enumerate((2, 2, 3, 3, 3))
                              for r in range(reps)])}
    out.update(fc6=dense[0], fc7=dense[1], fc8="fc")
    return out


def test_bigdl_decodes_as_jax(tmp_path):
    path = tmp_path / "small.model"
    rs = np.random.RandomState(2)
    path.write_bytes(write_bigdl([
        ("c1", "SpatialConvolution", _w(rs, 1, 4, 3, 3, 3), _w(rs, 4)),
        ("fc", "Linear", _w(rs, 5, 16), None)]))
    got, want = load_bigdl_weights(str(path)), jax_bigdl(str(path))
    g_mods, w_mods = list(got.walk()), list(want.walk())
    assert [(m.name, m.module_type) for m in g_mods] == \
        [(m.name, m.module_type) for m in w_mods]
    for g, w in zip(g_mods, w_mods):
        for a, b in ((g.weight, w.weight), (g.bias, w.bias)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_bigdl_vgg16_import_matches_jax(tmp_path, zoo_ctx):
    path = tmp_path / "vgg16.model"
    path.write_bytes(write_bigdl(_vgg_modules(10, 512)))
    jax_reset_names()
    jnet = jax_vgg16(10, (32, 32, 3))
    reset_name_scope()
    net = vgg16(10, (32, 32, 3))
    name_map = vgg_name_map(net)
    assert name_map == vgg_name_map(jnet)
    copied = import_weights_by_name(net, str(path), name_map=name_map)
    assert copied == jax_import(jnet, str(path), name_map=name_map)
    assert len(copied) == 16 and set(copied.values()) == {2}
    x = np.random.RandomState(4).rand(4, 32, 32, 3).astype(np.float32)
    jnet.compile(optimizer="sgd", loss="mse")
    want = np.asarray(jnet.predict(x, batch_size=4))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(KeyError, match="name_map"):
        import_weights_by_name(vgg16(10, (32, 32, 3)), str(path))


def test_bigdl_linear_after_flatten_is_the_reference_fault(tmp_path,
                                                           zoo_ctx):
    """A BigDL conv -> flatten -> Linear net flattens NCHW features; both
    packages copy the Linear as ``(out, in)ᵀ`` in front of an NHWC
    ``Flatten`` with no reordering, so both compute the same function,
    which is not the source's (ROADMAP C, the reference's fault 6)."""
    from analytics_zoo_tpu.nn.layers import (Convolution2D as JConv,
                                             Dense as JDense,
                                             Flatten as JFlatten)
    from analytics_zoo_tpu.nn.topology import Sequential as JSeq

    from analytics_zoo_tpu_torch.nn import Sequential
    from analytics_zoo_tpu_torch.nn.layers import (Convolution2D, Dense,
                                                   Flatten)

    rs = np.random.RandomState(6)
    wc, bc = _w(rs, 1, 3, 2, 3, 3), _w(rs, 3)
    wl, bl = _w(rs, 4, 3 * 4 * 4), _w(rs, 4)
    path = tmp_path / "cf.model"
    path.write_bytes(write_bigdl([("conv", "SpatialConvolution", wc, bc),
                                  ("fc", "Linear", wl, bl)]))
    jnet = JSeq()
    jnet.add(JConv(3, 3, 3, border_mode="same", input_shape=(4, 4, 2),
                   name="conv"))
    jnet.add(JFlatten())
    jnet.add(JDense(4, name="fc"))
    jax_import(jnet, str(path))
    net = Sequential([Convolution2D(3, 3, 3, border_mode="same",
                                    input_shape=(4, 4, 2), name="conv"),
                      Flatten(), Dense(4, name="fc")])
    net.build(torch.Generator().manual_seed(0), (2, 4, 4, 2))
    import_weights_by_name(net, str(path))
    x = rs.randn(2, 4, 4, 2).astype(np.float32)
    jnet.compile(optimizer="sgd", loss="mse")
    want = np.asarray(jnet.predict(x, batch_size=2))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # what the NCHW source computes
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    h = torch.nn.functional.conv2d(xt, torch.from_numpy(wc[0]),
                                   torch.from_numpy(bc), padding=1)
    source = (h.flatten(1) @ torch.from_numpy(wl).t()
              + torch.from_numpy(bl)).numpy()
    assert np.abs(got - source).max() > 1e-2
