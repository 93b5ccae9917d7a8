"""The port's public signatures against the JAX package's: a JAX caller's
positional and keyword arguments land in the JAX places, and the port's
own extras (``device``, ``compute_dtype``) come only after them.  Each
signature is pinned with ``inspect.signature``; the behaviour tests run
on the CPU (``device="cpu"``) and compare batches with the JAX
``FeatureSet`` from the same seed, exactly."""

import inspect

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data.featureset import FeatureSet as JaxFS
from analytics_zoo_tpu.data.text import TextSet as JaxTextSet
from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.nn.topology import KerasNet as JaxKerasNet
from analytics_zoo_tpu.train.estimator import Estimator as JaxEstimator

from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.data.text import TextSet
from analytics_zoo_tpu_torch.deploy import InferenceModel
from analytics_zoo_tpu_torch.nn import Dense, Sequential, reset_name_scope
from analytics_zoo_tpu_torch.nn.topology import KerasNet
from analytics_zoo_tpu_torch.train.estimator import Estimator

# (name, JAX callable, port callable, the port's extras after the JAX ones)
SIGNATURES = [
    ("InferenceModel.from_keras_net", JaxIM.from_keras_net,
     InferenceModel.from_keras_net, ("device",)),
    ("InferenceModel.__init__", JaxIM.__init__, InferenceModel.__init__, ()),
    ("KerasNet.compile", JaxKerasNet.compile, KerasNet.compile,
     ("device", "compute_dtype")),
    ("KerasNet.predict", JaxKerasNet.predict, KerasNet.predict, ()),
    ("Estimator.__init__", JaxEstimator.__init__, Estimator.__init__,
     ("device",)),
    ("FeatureSet.__init__", JaxFS.__init__, FeatureSet.__init__, ()),
    ("FeatureSet.from_ndarrays", JaxFS.from_ndarrays,
     FeatureSet.from_ndarrays, ()),
    ("FeatureSet.batches", JaxFS.batches, FeatureSet.batches, ()),
    ("TextSet.to_feature_set", JaxTextSet.to_feature_set,
     TextSet.to_feature_set, ("cache_level",)),
]


def _named(fn):
    """The parameters a caller can name or pass by position, in order."""
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                          p.KEYWORD_ONLY)]


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


@pytest.mark.parametrize("name,jax_fn,port_fn,extras", SIGNATURES,
                         ids=[s[0] for s in SIGNATURES])
def test_signature_takes_the_jax_arguments_in_the_jax_places(
        name, jax_fn, port_fn, extras):
    """The JAX parameters, in the JAX order, of the same kind and with the
    same defaults, then only the port's extras; a JAX ``**kw`` stays."""
    jax_params, port_params = _named(jax_fn), _named(port_fn)
    head = port_params[:len(jax_params)]
    assert [p.name for p in head] == [p.name for p in jax_params], name
    for jp, tp in zip(jax_params, head):
        assert tp.kind == jp.kind, (name, jp.name)
        if jp.default is not inspect.Parameter.empty:
            assert tp.default == jp.default, (name, jp.name)
    assert tuple(p.name for p in port_params[len(jax_params):]) == extras
    jax_var = [p.kind for p in inspect.signature(jax_fn).parameters.values()
               if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    port_var = [p.kind for p in inspect.signature(port_fn).parameters.values()
                if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    assert port_var == jax_var, name


def _net():
    reset_name_scope()
    net = Sequential([Dense(3, input_shape=(4,))])
    net.build(torch.Generator().manual_seed(0))
    return net


def _arrays(n=37, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 4).astype(np.float32),
            rs.randint(0, 5, (n,)).astype(np.int32))


def test_from_keras_net_fifth_argument_is_the_preprocess():
    """``from_keras_net(net, params, state, False, preprocess)``: the fifth
    positional argument runs on the inputs before the net (it once landed
    in ``weight_dtype``)."""
    net = _net()
    net.eval()
    x = _arrays(8)[0]
    m = InferenceModel.from_keras_net(net, net.params(), {}, False,
                                      lambda v: v * 2.0, device="cpu",
                                      batch_buckets=(8,))
    assert m._weight_dtype == "float32"
    with torch.no_grad():
        want = net(torch.from_numpy(x) * 2.0).numpy()
    np.testing.assert_allclose(m.predict(x), want, rtol=0, atol=1e-6)


def test_inference_model_third_argument_is_the_dtype():
    """``InferenceModel(forward, buckets, dtype)`` keeps ``dtype`` as the
    JAX package does, and the name keeps its default."""
    m = InferenceModel(lambda xs: xs[0] * 2.0, (4,), "float32")
    assert m.dtype == "float32" and m.name == JaxIM(lambda xs: xs[0]).name
    np.testing.assert_array_equal(m.predict(np.ones((3, 2), np.float32)),
                                  np.full((3, 2), 2.0, np.float32))


def test_compile_fourth_argument_is_the_sharding():
    """``compile(optimizer, loss, None, "dp")`` sets the sharding to "dp";
    another regime raises naming the multi-GPU slice (ROADMAP A9);
    ``aux_loss_weight`` is accepted and kept."""
    net = _net()
    net.compile("adam", "mse", None, "dp", 0.5, device="cpu")
    assert net.estimator._sharding_strategy == "dp"
    assert net.estimator.aux_loss_weight == 0.5
    with pytest.raises(NotImplementedError, match="A9"):
        net.compile("adam", "mse", None, "tp", device="cpu")
    est = Estimator(_net(), "sgd", "mse", None, None, None, None, "dp",
                    None, 0.25, 1, device="cpu")
    assert est.aux_loss_weight == 0.25 and est.grad_accum_steps == 1


def test_predict_accepts_distributed():
    """``predict(x, batch_size, distributed)``: accepted and ignored, as
    the JAX package ignores it."""
    net = _net()
    net.compile("sgd", "mse", device="cpu")
    x, _ = _arrays(9)
    np.testing.assert_array_equal(net.predict(x, 4, False),
                                  net.predict(x, 4))


@pytest.mark.parametrize("how", ["from_ndarrays", "init"])
def test_feature_set_memory_type_in_the_jax_place(how):
    """``FeatureSet.from_ndarrays(x, y, "DRAM")`` and ``FeatureSet(arrays,
    memory_type="DRAM")`` give the JAX package's shuffled batches for one
    seed, exactly."""
    x, y = _arrays()
    if how == "from_ndarrays":
        got = FeatureSet.from_ndarrays(x, y, "DRAM", 3)
        want = JaxFS.from_ndarrays(x, y, "DRAM", 3)
    else:
        got = FeatureSet([x, y], memory_type="DRAM", seed=3)
        want = JaxFS([x, y], memory_type="DRAM", seed=3)
    assert got.memory_type == want.memory_type == "DRAM"
    for _ in range(2):  # two epochs: the same stream on both sides
        for a, b in zip(got.batches(8, shuffle=True),
                        want.batches(8, shuffle=True), strict=True):
            for u, v in zip(a, b, strict=True):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("pad_to,shuffle_buffer,drop", [
    (1, None, False), (3, None, False), (4, 10, False), (2, 10, True),
    (1, 100, False)])
def test_batches_pad_to_and_shuffle_buffer_follow_jax(pad_to, shuffle_buffer,
                                                      drop):
    """``batches(pad_to=, shuffle_buffer=)``: the batch size rounded up to a
    multiple of ``pad_to`` and the block-local permutation with the block
    order permuted give the JAX order and sizes for one seed."""
    x, y = _arrays(41, seed=2)
    got = FeatureSet([x, y], seed=5)
    want = JaxFS([x, y], seed=5)
    kw = dict(shuffle=True, drop_remainder=drop, pad_to=pad_to,
              shuffle_buffer=shuffle_buffer)
    gb, wb = list(got.batches(6, **kw)), list(want.batches(6, **kw))
    assert [len(b[0]) for b in gb] == [len(b[0]) for b in wb]
    for a, b in zip(gb, wb, strict=True):
        for u, v in zip(a, b, strict=True):
            np.testing.assert_array_equal(u, v)


def test_transforms_apply_as_in_jax():
    """``FeatureSet(arrays, memory_type, transforms)``: each batch passes
    through the transforms in order, as in the JAX package, and a DEVICE
    cache holds the transformed rows."""
    x, y = _arrays(20)
    fns = [lambda a, b: (a * 2.0, b), lambda a, b: (a + 1.0, b + 1)]
    got = FeatureSet([x, y], "DRAM", fns, seed=1)
    want = JaxFS([x, y], "DRAM", fns, seed=1)
    for a, b in zip(got.batches(7, shuffle=True),
                    want.batches(7, shuffle=True), strict=True):
        for u, v in zip(a, b, strict=True):
            np.testing.assert_array_equal(u, v)
    dev = got.device_arrays("cpu")
    np.testing.assert_array_equal(dev[0].numpy(), x * 2.0 + 1.0)
    np.testing.assert_array_equal(dev[1].numpy(), y + 1)


@pytest.mark.parametrize("memory_type", ["DISK_AND_DRAM", "DIRECT"])
def test_disk_memory_types_raise_naming_the_roadmap_item(memory_type):
    x, y = _arrays(4)
    with pytest.raises(NotImplementedError, match="A5.6"):
        FeatureSet([x, y], memory_type=memory_type)
    with pytest.raises(NotImplementedError, match="A5.6"):
        FeatureSet.from_ndarrays(x, y, memory_type)


def test_text_set_to_feature_set_takes_memory_type_first():
    """``TextSet.to_feature_set("DRAM")``: the JAX positional call."""
    ts = TextSet.from_texts(["a b c", "b c d e", "a e"], labels=[0, 1, 0])
    ts = ts.tokenize().word2idx().shape_sequence(4).generate_sample()
    fs = ts.to_feature_set("DRAM")
    assert fs.memory_type == "DRAM" and len(fs) == 3
