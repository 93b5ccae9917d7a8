"""The port's disk tiers and STREAM tier against the JAX package.

Mirrors ``tests/test_featureset_streaming.py`` without its
multi-controller tests (``ProcessRowView``, ``data.host_lost``,
``data.shard_skew``: ROADMAP A9).  Inputs come from
``np.random.RandomState``; the port runs on the CPU, where the shard
programs run eagerly over the same slot buffers the card's graphs
replay.  Tolerances, with their reasons:

- geometry, shard orders, permutations, quantized codes, batches from
  disk: exact (the same numpy code on the same inputs);
- the decode of a quantized shard: 1 ulp of the f32 result (XLA may fuse
  the JAX multiply-add);
- stream against resident in the port, the uploader-crash and torn-shard
  fallbacks against the undisturbed run, a resumed run against the
  uninterrupted one: bit for bit (the same step on the same rows in the
  same order);
- the port's stream fit against the JAX package's ``_fit_stream``:
  per-epoch losses within rtol 1e-4 and weights within atol 1e-5 (the
  JAX step sums its gradients across an 8-device CPU mesh, so the sums
  run in other orders).
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core.context import init_zoo_context as jax_init
from analytics_zoo_tpu.data import streaming as jstream
from analytics_zoo_tpu.data.featureset import FeatureSet as JaxFS
from analytics_zoo_tpu.data.featureset import SlicedFeatureSet as JaxSliced
from analytics_zoo_tpu.data.featureset import npy_header as jax_npy_header
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.nn.layers.core import Dense as JaxDense
from analytics_zoo_tpu.nn.topology import Sequential as JaxSequential
from analytics_zoo_tpu.ops import quantization as jquant
from analytics_zoo_tpu.train import optimizers as jopt

from analytics_zoo_tpu_torch.convert import export_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.data import streaming as tstream
from analytics_zoo_tpu_torch.data.featureset import (CacheLevel, FeatureSet,
                                                     SlicedFeatureSet,
                                                     npy_header)
from analytics_zoo_tpu_torch.nn import Dense, Sequential, reset_name_scope
from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.ops import quantization as tquant
from analytics_zoo_tpu_torch.robust import FaultInjector, TrainingPreempted
from analytics_zoo_tpu_torch.train import optimizers as topt


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _float_arrays(n=256, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 12).astype(np.float32)
    w = rs.randn(12).astype(np.float32)
    return x, (x @ w > 0).astype(np.int32)


def _float_fs(level="STREAM", n=256):
    x, y = _float_arrays(n)
    return FeatureSet.from_ndarrays([x], y, cache_level=level)


def _slices(tmp_path, k=3, rows=20, seed=10):
    xs, ys, paths = [], [], []
    for j in range(k):
        x = np.random.RandomState(seed + j).randn(rows, 4).astype(np.float32)
        y = np.arange(rows, dtype=np.int32) + 100 * j
        xp, yp = tmp_path / f"x{j}.npy", tmp_path / f"y{j}.npy"
        np.save(xp, x)
        np.save(yp, y)
        xs.append(x)
        ys.append(y)
        paths.append((str(xp), str(yp)))
    return paths, np.concatenate(xs), np.concatenate(ys)


# ---------------------------------------------------------------------------
# the disk tiers


@pytest.mark.parametrize("version", [(1, 0), (2, 0), (3, 0)])
def test_npy_header_matches_jax(tmp_path, version):
    """Every ``.npy`` header version, read through numpy's public header
    readers."""
    for a in (np.arange(60, dtype=np.float64).reshape(15, 4),
              np.zeros((7,), np.int32), np.ones((3, 2, 5), np.uint8)):
        p = str(tmp_path / "a.npy")
        with open(p, "wb") as f:
            np.lib.format.write_array(f, a, version=version)
        assert npy_header(p) == jax_npy_header(p) == (a.shape, a.dtype)


def test_sliced_featureset_nbytes_and_read_rows_match_jax(tmp_path):
    paths, full_x, full_y = _slices(tmp_path)
    got, want = SlicedFeatureSet(paths), JaxSliced(paths)
    assert got.nbytes == want.nbytes == full_x.nbytes + full_y.nbytes
    assert len(got) == len(want) == 60
    assert got.cache_level == want.cache_level == CacheLevel.HOST
    for lo, hi in ((3, 9), (15, 27), (38, 55), (0, 60)):
        for g, w, f in zip(got.read_rows(lo, hi), want.read_rows(lo, hi),
                           (full_x, full_y)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, f[lo:hi])
    with pytest.raises(ValueError):
        got.read_rows(50, 70)
    with pytest.raises(ValueError, match="STREAM"):
        got.cache(CacheLevel.DEVICE)
    assert got.cache("stream").cache_level == CacheLevel.STREAM


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, False),
                                          (True, True)])
def test_sliced_batches_match_jax(tmp_path, shuffle, drop):
    """Slice by slice, a slice's leftover rows carried into the next, the
    transforms applied per batch: the JAX package's batches."""
    paths, _, _ = _slices(tmp_path, k=4, rows=13)
    fn = lambda x, y: (x * 2.0, y + 1)      # noqa: E731
    got = FeatureSet.from_npy_slices(paths, seed=3).transform(fn)
    want = JaxSliced(paths, seed=3).transform(fn)
    for a, b in zip(got.batches(8, shuffle=shuffle, drop_remainder=drop),
                    want.batches(8, shuffle=shuffle, drop_remainder=drop),
                    strict=True):
        for u, v in zip(a, b, strict=True):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("memory_type", ["DISK_AND_DRAM", "DRAM"])
def test_from_npy_files_transform_and_read_rows_match_jax(tmp_path,
                                                         memory_type):
    x, y = _float_arrays(40)
    xp, yp = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(xp, x)
    np.save(yp, y)
    got = FeatureSet.from_npy_files([xp, yp], memory_type)
    want = JaxFS.from_npy_files([xp, yp], memory_type)
    assert isinstance(got.arrays[0], np.memmap) == (memory_type != "DRAM")
    assert got.nbytes == want.nbytes
    fn = lambda a, b: (a + 1.0, b)          # noqa: E731
    got, want = got.transform(fn), want.transform(fn)
    for g, w in zip(got.read_rows(5, 17), want.read_rows(5, 17)):
        np.testing.assert_array_equal(g, w)
    for a, b in zip(got.batches(16, shuffle=True, shuffle_buffer=10),
                    want.batches(16, shuffle=True, shuffle_buffer=10),
                    strict=True):
        for u, v in zip(a, b, strict=True):
            np.testing.assert_array_equal(u, v)
    dev = got.device_arrays("cpu")
    np.testing.assert_array_equal(dev[0].numpy(), x + 1.0)


def test_from_parquet_matches_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    rs = np.random.RandomState(4)
    df = pd.DataFrame({"a": rs.randn(9).astype(np.float32),
                       "v": [rs.randn(3).astype(np.float32)
                             for _ in range(9)],
                       "label": rs.randint(0, 2, 9)})
    p = str(tmp_path / "d.parquet")
    df.to_parquet(p)
    got = FeatureSet.from_parquet(p, ["a", "v"], "label")
    want = JaxFS.from_parquet(p, ["a", "v"], "label")
    assert [a.shape for a in got.arrays] == [(9,), (9, 3), (9,)]
    for g, w in zip(got.arrays, want.arrays):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# plan geometry, the two shuffle levels, the feature codec


@pytest.mark.parametrize("divisor,batch,cache_dtype", [
    (2, 32, None), (4, 32, None), (2, 32, "uint8"), (4, 16, "int8"),
    (1, 256, None), (64, 32, None)])
def test_plan_stream_geometry_matches_jax(divisor, batch, cache_dtype):
    x, y = _float_arrays()
    got_fs = FeatureSet.from_ndarrays([x], y)
    budget = got_fs.nbytes // divisor
    got, why = tstream.plan_stream(got_fs, budget, batch,
                                   cache_dtype=cache_dtype)
    want, jwhy = jstream.plan_stream(JaxFS.from_ndarrays([x], y), budget,
                                     batch, cache_dtype=cache_dtype)
    assert (got is None) == (want is None)
    if got is None:
        assert why == jwhy.replace("HBM", "device")
        return
    for attr in ("n_rows", "n_shards", "shard_rows", "steps_per_shard",
                 "eff_batch", "slots", "cache_dtype", "specs", "quantized",
                 "dropped_rows", "device_shard_bytes",
                 "decode_bytes_per_shard"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.device_shard_bytes * got.slots <= budget + got.slots * 52
    with pytest.raises(ValueError):
        tstream.plan_stream(got_fs, budget, batch, cache_dtype="float16")


def test_shard_order_and_permutation_match_jax():
    for seed in (0, 7, 123):
        for epoch in (0, 1, 5):
            for n_shards in (1, 3, 8):
                for shuffle in (True, False):
                    np.testing.assert_array_equal(
                        tstream.epoch_shard_order(n_shards, seed, epoch,
                                                  shuffle),
                        jstream.epoch_shard_order(n_shards, seed, epoch,
                                                  shuffle))
            for n_rows in (1, 31, 32):
                for shard_id in (0, 2):
                    for pair in (False, True):
                        got = tstream.shard_permutation(
                            n_rows, seed, epoch, shard_id,
                            pair_structured=pair)
                        want = jstream.shard_permutation(
                            n_rows, seed, epoch, shard_id,
                            pair_structured=pair)
                        assert got.dtype == want.dtype == np.int32
                        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["uint8", "int8"])
def test_feature_codec_matches_jax(dtype):
    a = (np.random.RandomState(3).randn(64, 8) * 4).astype(np.float32)
    q, scale, zero = tquant.quantize_feature_array(a, dtype)
    jq, jscale, jzero = jquant.quantize_feature_array(a, dtype)
    np.testing.assert_array_equal(q, jq)
    assert (scale, zero) == (jscale, jzero) and q.dtype == np.dtype(dtype)
    back = tquant.dequantize_features(torch.from_numpy(q),
                                      torch.tensor(scale),
                                      torch.tensor(zero)).numpy()
    want = np.asarray(jquant.dequantize_features(jq, jscale, jzero))
    np.testing.assert_allclose(back, want, rtol=0, atol=np.spacing(
        np.abs(want).max()))
    assert np.max(np.abs(back - a)) <= float(scale) / 2 + 1e-6
    with pytest.raises(TypeError):
        tquant.quantize_feature_array(np.arange(4, dtype=np.int32), dtype)


# ---------------------------------------------------------------------------
# the router


def _mlp(budget, seed=7, cache_dtype=None, params=None):
    context.init_zoo_context(seed=seed, data_device_budget_bytes=budget,
                             data_cache_dtype=cache_dtype)
    reset_name_scope()
    m = Sequential([Dense(16, activation="relu", input_shape=(12,)),
                    Dense(2, activation="softmax")])
    m.compile(topt.Adam(lr=1e-2), "sparse_categorical_crossentropy",
              device="cpu")
    if params is not None:
        m.estimator.set_initial_weights(params)
    return m.estimator


@pytest.mark.parametrize("level,budget,path,code", [
    ("STREAM", 10 ** 9, "device_resident", "fits_budget"),
    ("DEVICE", 256 * 52 // 2, "stream", "over_budget"),
    ("DEVICE", 64, "host_prefetch", "stream_infeasible"),
    ("HOST", 10 ** 9, "host_prefetch", "cache_level_host"),
    ("sliced", 10 ** 9, "host_prefetch", "cache_level_host"),
    ("sliced-stream", 10 ** 9, "stream", "sliced")])
def test_router_matrix_and_counter(tmp_path, level, budget, path, code):
    """The JAX package's three-way matrix, each decision counted in
    ``data_path_selected_total{path,reason}``; a STREAM request that fits
    downgrades to resident, a sliced set streams only when asked."""
    est = _mlp(budget)
    if level.startswith("sliced"):
        x, y = _float_arrays()
        np.save(tmp_path / "x.npy", x)
        np.save(tmp_path / "y.npy", y)
        fs = FeatureSet.from_npy_slices([(str(tmp_path / "x.npy"),
                                          str(tmp_path / "y.npy"))])
        if level == "sliced-stream":
            fs = fs.cache(CacheLevel.STREAM)
    else:
        fs = _float_fs(level)
    mark = obs.METRICS.snapshot()
    got, reason = est._resolve_data_path(fs, 32)
    assert got == path
    key = ("data_path_selected_total", (("path", path), ("reason", code)))
    assert obs.METRICS.snapshot().counters.get(key, 0) == \
        mark.counters.get(key, 0) + 1
    if code == "stream_infeasible":
        assert "over device budget" in reason and "infeasible" in reason


# ---------------------------------------------------------------------------
# training through the rotation


def _fit(est, fs, epochs=2, shuffle=False, **kw):
    hist = est.fit(fs, batch_size=32, epochs=epochs, verbose=False,
                   shuffle=shuffle, **kw)
    return [r["loss"] for r in hist if "loss" in r]


def test_stream_matches_resident_bit_for_bit():
    """Four shards of 64 rows through two slots train exactly as the
    resident epoch: ``shuffle=False`` gives both the same rows in the
    same order, and each step is the same program on the same values."""
    budget = 256 * 52 // 2
    est_s = _mlp(budget)
    mark = obs.METRICS.snapshot()
    losses_s = _fit(est_s, _float_fs("STREAM"))
    assert est_s.last_data_path == "stream"
    # one dispatch a shard, counted as the JAX package counts it
    key = ("train_steps_total", (("kind", "shard"),))
    assert obs.METRICS.snapshot().counters[key] == \
        mark.counters.get(key, 0) + 16
    plan = est_s._stream_plan
    assert (plan.n_shards, plan.shard_rows, plan.slots) == (4, 64, 2)
    # one program per slot: keys ("stream", steps, slot, ...)
    assert sorted(k[1:3] for k in est_s._programs if k[0] == "stream") == \
        [(2, 0), (2, 1)]
    est_r = _mlp(10 ** 9)
    losses_r = _fit(est_r, _float_fs("DEVICE"))
    assert est_r.last_data_path == "device_resident"
    assert losses_s == losses_r
    for a, b in zip(est_s.model.parameters(), est_r.model.parameters()):
        assert torch.equal(a, b)
    overlap = obs.METRICS.snapshot().gauges.get(
        ("data_stream_overlap_frac", ()))
    assert overlap is not None and 0.0 <= overlap <= 1.0


def _jax_stream_fit(params, budget, shuffle, cache_dtype, epochs=2):
    jax_init(seed=7)
    jax_reset_names()
    m = JaxSequential([JaxDense(16, activation="relu", input_shape=(12,)),
                       JaxDense(2, activation="softmax")])
    m.compile(optimizer=jopt.Adam(lr=1e-2),
              loss="sparse_categorical_crossentropy")
    est = m.estimator
    est.ctx.config.data_device_budget_bytes = budget
    est.ctx.config.data_cache_dtype = cache_dtype
    est.set_initial_weights(params)
    x, y = _float_arrays()
    hist = est.fit(JaxFS.from_ndarrays([x], y, cache_level="STREAM"),
                   batch_size=32, epochs=epochs, verbose=False,
                   shuffle=shuffle)
    assert est.last_data_path == "stream"
    return [r["loss"] for r in hist], est.params


@pytest.mark.parametrize("shuffle,cache_dtype", [(False, None),
                                                 (True, None),
                                                 (True, "uint8")])
def test_stream_losses_match_jax_fit_stream(shuffle, cache_dtype):
    """The same plan, shard orders, in-shard permutations and codec as
    the JAX package's ``_fit_stream``: the same per-epoch losses and
    weights."""
    budget = 256 * 52 // 2
    rs = np.random.RandomState(5)
    shapes = {"dense_1": {"kernel": (12, 16), "bias": (16,)},
              "dense_2": {"kernel": (16, 2), "bias": (2,)}}
    params = {layer: {leaf: (rs.randn(*shape) * 0.3).astype(np.float32)
                      for leaf, shape in sub.items()}
              for layer, sub in shapes.items()}
    jlosses, jparams = _jax_stream_fit(params, budget, shuffle, cache_dtype)
    est = _mlp(budget, cache_dtype=cache_dtype, params=params)
    losses = _fit(est, _float_fs("STREAM"), shuffle=shuffle)
    assert est.last_data_path == "stream"
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    got = export_params(est.model)
    for layer, leaves in got.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(v, np.asarray(jparams[layer][leaf]),
                                       atol=1e-5)


def test_stream_quantized_decode_trains_near_exact():
    """A uint8 device cache, decoded after the gather, trains within the
    quantization's reach of the exact run, and counts its decoded
    bytes."""
    budget = 256 * 52 // 2
    mark = obs.METRICS.snapshot()
    losses_q = _fit(_mlp(budget, cache_dtype="uint8"), _float_fs())
    losses_e = _fit(_mlp(budget), _float_fs())
    np.testing.assert_allclose(losses_q, losses_e, atol=5e-3)
    key = ("data_decode_bytes_total", (("dtype", "uint8"),))
    assert obs.METRICS.snapshot().counters.get(key, 0) > \
        mark.counters.get(key, 0)


def test_stream_from_sliced_featureset_with_transform(tmp_path):
    """A SlicedFeatureSet pinned to STREAM rotates straight from its
    ``.npy`` slices, its transform applied once per shard, and trains as
    the in-memory set with the transform applied up front."""
    x, y = _float_arrays()
    paths = []
    for k in range(4):
        xp, yp = tmp_path / f"x{k}.npy", tmp_path / f"y{k}.npy"
        np.save(xp, x[k * 64:(k + 1) * 64] / 2.0)
        np.save(yp, y[k * 64:(k + 1) * 64])
        paths.append((str(xp), str(yp)))
    fs = SlicedFeatureSet(paths).transform(lambda a, b: (a * 2.0, b))
    est = _mlp(fs.nbytes // 2)
    losses = _fit(est, fs.cache("STREAM"))
    assert est.last_data_path == "stream"
    assert "sliced" in est.last_data_path_reason
    assert losses == _fit(_mlp(fs.nbytes // 2), _float_fs("STREAM"))


@pytest.mark.parametrize("site,at,kw", [
    ("data.shard_upload", 1, {"exc": RuntimeError("device gone")}),
    ("data.shard_torn", 2, {"action": "torn"})])
def test_upload_faults_fall_back_without_losing_the_epoch(site, at, kw):
    """An uploader crash or a torn shard mid-rotation finishes the epoch
    from host batches, each shard in the order its program would have
    gathered it: the undisturbed run's losses and weights, bit for bit,
    one fallback counted, and the next epoch streams again."""
    budget = 256 * 52 // 2
    ref = _mlp(budget)
    losses_ref = _fit(ref, _float_fs(), epochs=3, shuffle=True)
    key = ("data_stream_fallbacks_total", (("reason", "upload_error"),))
    mark = obs.METRICS.snapshot()
    fi = FaultInjector().plan(site, at=at, **kw)
    est = _mlp(budget)
    with fi:
        losses = _fit(est, _float_fs(), epochs=3, shuffle=True)
    assert fi.fired[site] == 1
    assert est.last_data_path == "stream"
    assert losses == losses_ref
    for a, b in zip(est.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)
    assert obs.METRICS.snapshot().counters.get(key, 0) == \
        mark.counters.get(key, 0) + 1


def test_stream_preempt_resume_restores_shard_cursor(tmp_path):
    """A preemption mid-rotation flushes the shard cursor; the resumed
    fit re-derives the epoch's shard order and restarts at that shard,
    landing on the uninterrupted run's weights bit for bit."""
    budget = 256 * 52 // 2
    ref = _mlp(budget)
    _fit(ref, _float_fs(), epochs=3, shuffle=True)
    est = _mlp(budget)
    est.set_checkpoint(str(tmp_path))
    # one preempt check per shard: call 6 is epoch 2's third shard
    with FaultInjector().plan("estimator.preempt", at=6):
        with pytest.raises(TrainingPreempted):
            _fit(est, _float_fs(), epochs=3, shuffle=True)
    est2 = _mlp(budget)
    est2.set_checkpoint(str(tmp_path))
    _fit(est2, _float_fs(), epochs=3, shuffle=True, resume=True)
    assert est2.finished_epochs == 3
    assert est2.global_step == ref.global_step == 3 * 8
    for a, b in zip(est2.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)


def test_flight_recorder_trips_on_a_stream_fallback(tmp_path):
    budget = 256 * 52 // 2
    est = _mlp(budget)
    rec = est.arm_flight_recorder(window_s=0.0)
    with FaultInjector().plan("data.shard_upload", at=1,
                              exc=RuntimeError("device gone")):
        _fit(est, _float_fs(), epochs=1)
    last = rec.last_record()
    assert last is not None
    assert "data_stream_fallbacks_total" in str(last)
