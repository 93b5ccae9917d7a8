"""The port's ``InferenceModel.from_function`` and ``load_torch`` against
the JAX package's loaders, on the CPU.

One function of two inputs (``tanh(x @ W + b) * y``, and a variant with
two outputs), written in ``jnp`` for the JAX package and in ``torch`` for
the port over the same numpy weights, goes through both packages'
``from_function`` with ``jit`` True and False; one seeded
``torch.nn.Module``, and its TorchScript file, go through both
packages' ``load_torch`` (the JAX package runs torch on the host).  The
same ragged batches (padded to buckets by ``predict``) give f32
answers within atol 1e-6 and rtol 1e-5.  Also: ``jit=True`` runs
through bucket programs that a compile cache warms in a second model
with zero live captures, ``load_torch`` leaves the caller's module as it
was, a function model serves behind ``ClusterServing``, and both
loaders default to the card (they raise where the process has none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.deploy import InferenceModel as JaxIM
from analytics_zoo_tpu_torch.deploy import InferenceModel

ATOL, RTOL = 1e-6, 1e-5
RS = np.random.RandomState(0)
W = RS.randn(6, 4).astype(np.float32)
B = RS.randn(4).astype(np.float32)
BUCKETS = (1, 4, 8)


def _jax_fn(x, y):
    return jnp.tanh(x @ W + B) * y


def _port_fn(x, y):
    w, b = (torch.from_numpy(a).to(x.device) for a in (W, B))
    return torch.tanh(x @ w + b) * y


def _jax_two(x, y):
    return [jnp.tanh(x @ W + B) * y, x.sum(-1)]


def _port_two(x, y):
    return [_port_fn(x, y), x.sum(-1)]


def _inputs(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(n, 6).astype(np.float32),
            rs.randn(n, 4).astype(np.float32)]


def _close(got, want):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("jit", [True, False])
@pytest.mark.parametrize("outputs", [1, 2])
def test_from_function_matches_jax(jit, outputs):
    jfn, tfn = (_jax_fn, _port_fn) if outputs == 1 else (_jax_two, _port_two)
    jm = JaxIM.from_function(jfn, jit=jit, batch_buckets=BUCKETS)
    tm = InferenceModel.from_function(tfn, jit=jit, device="cpu",
                                      batch_buckets=BUCKETS)
    assert tm.device == torch.device("cpu")
    for n, seed in ((1, 1), (3, 2), (8, 3), (13, 4)):
        xs = _inputs(n, seed)
        _close(tm.predict(xs), jm.predict(xs))
    # jit=True runs the bucket programs, jit=False the eager forward
    assert (tm._net is not None) is jit


def _module():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                               torch.nn.Dropout(0.5), torch.nn.Linear(8, 3))


def test_load_torch_matches_jax(tmp_path):
    module = _module()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    module.train()
    tm = InferenceModel.load_torch(module, device="cpu",
                                   batch_buckets=BUCKETS)
    # the caller's module is copied, not moved or switched to eval
    assert module.training
    assert all(torch.equal(before[k], v)
               for k, v in module.state_dict().items())
    jm = JaxIM.load_torch(_module(), batch_buckets=BUCKETS)
    path = str(tmp_path / "m.pt")
    torch.jit.script(_module()).save(path)
    tsm = InferenceModel.load_torch(path, device="cpu", batch_buckets=BUCKETS)
    jsm = JaxIM.load_torch(path, batch_buckets=BUCKETS)
    for n, seed in ((1, 5), (5, 6), (11, 7)):
        x = _inputs(n, seed)[0]
        want = jm.predict(x)
        _close(tm.predict(x), want)
        _close(tsm.predict(x), jsm.predict(x))
        _close(tsm.predict(x), want)


def test_from_function_programs_warm_from_the_compile_cache(tmp_path):
    from analytics_zoo_tpu_torch.deploy import CompileCache

    cold = InferenceModel.from_function(_port_fn, device="cpu",
                                        batch_buckets=BUCKETS)
    cold.attach_compile_cache(CompileCache(str(tmp_path)), name="f")
    outs = [cold.predict(_inputs(b, b)) for b in BUCKETS]
    assert cold.compile_count == len(BUCKETS)
    warm = InferenceModel.from_function(_port_fn, device="cpu",
                                        batch_buckets=BUCKETS)
    assert warm.fingerprint() == cold.fingerprint()
    warm.attach_compile_cache(CompileCache(str(tmp_path)), name="f")
    assert warm.warm() == len(BUCKETS)
    for b, out in zip(BUCKETS, outs):
        np.testing.assert_array_equal(warm.predict(_inputs(b, b)), out)
    assert warm.compile_count == 0
    # another function is another fingerprint: it warms nothing
    other = InferenceModel.from_function(_port_two, device="cpu",
                                         batch_buckets=BUCKETS)
    assert other.fingerprint() != cold.fingerprint()
    eager = InferenceModel.from_function(_port_fn, jit=False, device="cpu")
    with pytest.raises(ValueError, match="bucket programs"):
        eager.attach_compile_cache(CompileCache(str(tmp_path)))


def test_function_model_serves_behind_cluster_serving():
    from analytics_zoo_tpu_torch.deploy import (ClusterServing, InputQueue,
                                                MemoryQueue, OutputQueue,
                                                ServingConfig)

    # a record carries one tensor field: the two inputs side by side
    m = InferenceModel.from_function(lambda z: _port_fn(z[:, :6], z[:, 6:]),
                                     device="cpu", batch_buckets=BUCKETS)
    q = MemoryQueue()
    srv = ClusterServing({"f": m}, q, ServingConfig(
        batch_size=8, max_batch_delay_ms=2, decode_workers=2)).start()
    try:
        x, y = _inputs(5, 9)
        inq, outq = InputQueue(q), OutputQueue(q)
        z = np.concatenate([x, y], axis=1)
        for i in range(5):
            inq.enqueue(f"r{i}", model="f", z=z[i])
        got = np.stack([np.asarray(outq.query(f"r{i}", timeout=30.0))
                        for i in range(5)])
    finally:
        srv.stop()
    np.testing.assert_allclose(got, np.asarray(_jax_fn(x, y)), atol=ATOL,
                               rtol=RTOL)


def test_loaders_default_to_the_card(monkeypatch):
    """Without a device argument both loaders take ``cuda``, and a
    process with no card raises instead of falling to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: InferenceModel.from_function(_port_fn),
                 lambda: InferenceModel.from_function(_port_fn, jit=False),
                 lambda: InferenceModel.load_torch(_module())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    m = InferenceModel.from_function(_port_fn, jit=False)
    assert m.device == torch.device("cuda")
