"""The port's host modules against the JAX package: ``native`` (crc32c,
masked crc32c, gather_rows), ``data/preprocessing.py``,
``data/tfrecord.py``, ``data/giant_table.py``, ``data/image3d.py``,
``utils`` and ``ZooConfig``'s dict / yaml forms, and the two existing
modules that now go through ``native`` (``core/summary.py``'s event
framing, ``FeatureSet``'s batch gathers).

Every comparison is exact: these modules are host code on numpy and
Python integers, and the port computes the same values bit for bit.
"""

import json
import struct
import sys

import numpy as np
import pytest

from analytics_zoo_tpu import native as jnative
from analytics_zoo_tpu.core.config import ZooConfig as JZooConfig
from analytics_zoo_tpu.core.summary import crc32c as jax_py_crc32c
from analytics_zoo_tpu.data import giant_table as jgiant
from analytics_zoo_tpu.data import image3d as jimage3d
from analytics_zoo_tpu.data import preprocessing as jpre
from analytics_zoo_tpu.data import tfrecord as jtfr
from analytics_zoo_tpu.data.image import ImageFeature as JImageFeature
from analytics_zoo_tpu.utils import nest as jnest

from analytics_zoo_tpu_torch import native
from analytics_zoo_tpu_torch.core.config import ZooConfig
from analytics_zoo_tpu_torch.core.summary import crc32c as py_crc32c
from analytics_zoo_tpu_torch.data import giant_table
from analytics_zoo_tpu_torch.data import image3d
from analytics_zoo_tpu_torch.data import preprocessing as pre
from analytics_zoo_tpu_torch.data import tfrecord as tfr
from analytics_zoo_tpu_torch.data.image import ImageFeature
from analytics_zoo_tpu_torch.utils import (flatten, get_file_list,
                                           map_structure, nest,
                                           pack_sequence_as, to_list)

CRC_SIZES = (0, 1, 7, 8, 9, 63, 64, 1000, 65537)


# ---------------------------------------------------------------------------
# native
# ---------------------------------------------------------------------------

def test_native_builds_under_its_own_name(tmp_path, monkeypatch):
    assert native.available()
    monkeypatch.setenv("ZOO_NATIVE_CACHE", str(tmp_path))
    path = native._cache_path()
    assert path.startswith(str(tmp_path))
    assert "zoo_native_torch_" in path
    assert path != jnative._cache_path()


@pytest.mark.parametrize("n", CRC_SIZES)
def test_crc32c_matches_jax_and_the_table(n):
    data = np.random.RandomState(n).bytes(n)
    want = jnative.crc32c(data)
    assert native.crc32c(data) == want
    assert native._py_crc32c(data) == want == jax_py_crc32c(data)
    assert native.masked_crc32c(data) == jnative.masked_crc32c(data)


def test_crc32c_known_vectors():
    assert native.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert native.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("shape,dtype", [((100, 17), np.float32),
                                         ((50, 4, 3), np.float64),
                                         ((64,), np.int32),
                                         ((5000, 64), np.int64)])
def test_gather_rows_is_fancy_indexing(shape, dtype):
    rs = np.random.RandomState(len(shape))
    src = (rs.randn(*shape) * 100).astype(dtype)
    idx = rs.randint(-shape[0], shape[0], 4096)       # negatives wrap
    got = native.gather_rows(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, jnative.gather_rows(src, idx))
    assert got.dtype == src.dtype


@pytest.mark.parametrize("bad", [10, -11, 1 << 40])
def test_gather_rows_out_of_range_raises_like_numpy(bad):
    src = np.arange(30, dtype=np.float32).reshape(10, 3)
    idx = np.array([0, 3, bad])
    with pytest.raises(IndexError):
        src[idx]
    with pytest.raises(IndexError):
        native.gather_rows(src, idx)
    with pytest.raises(IndexError):
        jnative.gather_rows(src, idx)


def test_gather_rows_threads_follow_the_batch_bytes(monkeypatch):
    """With no thread count given, a gather takes one thread per
    ``GATHER_BYTES_PER_THREAD`` of output (at least 1, at most 8), so a
    small batch pays no thread starts; the rows are numpy's at any
    count."""
    import os

    lib = native._load()
    seen = []

    class Spy:
        def zoo_gather_rows(self, *args):
            seen.append(args[-1])
            return lib.zoo_gather_rows(*args)

    monkeypatch.setattr(native, "_load", lambda: Spy())
    rs = np.random.RandomState(12)
    src = rs.randint(0, 255, (8192, 4096)).astype(np.uint8)   # 4 KiB rows
    per = native.GATHER_BYTES_PER_THREAD
    for n_bytes in (per // 4, per, 4 * per, 8 * per):
        idx = rs.randint(0, len(src), n_bytes // 4096)
        np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    cap = min(8, os.cpu_count() or 1)
    assert seen == [1, 1, min(4, cap), cap]
    native.gather_rows(src, np.arange(3), n_threads=5)
    assert seen[-1] == 5


def test_gather_rows_fallback_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    src = np.arange(40).reshape(20, 2)
    idx = np.array([3, -1, 7])
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    data = b"fallback"
    assert native.crc32c(data) == jax_py_crc32c(data)


def test_summary_framing_goes_through_native(tmp_path):
    """The TensorBoard writer's masked crc is ``native``'s, and the file
    reads in both packages."""
    from analytics_zoo_tpu.core.summary import read_scalars as jread

    from analytics_zoo_tpu_torch.core import summary

    assert summary._masked_crc is native.masked_crc32c
    w = summary.SummaryWriter(str(tmp_path))
    for step in range(5):
        w.add_scalar("loss", 1.0 / (step + 1), step)
    w.close()
    want = [(s, v) for s, v in summary.read_scalars(str(tmp_path), "loss")]
    assert [(s, v) for s, v in jread(str(tmp_path), "loss")] == want
    assert len(want) == 5


def test_featureset_batches_take_the_native_gather(monkeypatch):
    """Batches of 1 MiB or more go through ``gather_rows``, smaller ones
    through numpy; the batches are the JAX FeatureSet's either way."""
    from analytics_zoo_tpu.data.featureset import FeatureSet as JFS

    from analytics_zoo_tpu_torch.data import featureset
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet

    calls = []
    real = native.gather_rows

    def spy(a, idx):
        calls.append(a.shape)
        return real(a, idx)

    monkeypatch.setattr(native, "gather_rows", spy)
    rs = np.random.RandomState(3)
    big = rs.randn(4096, 256).astype(np.float32)      # 1 KiB rows
    small = rs.randint(0, 9, (4096,)).astype(np.int32)
    port = FeatureSet.from_ndarrays([big, small])
    ref = JFS.from_ndarrays([big, small])
    for a, b in zip(port.batches(1024, shuffle=True),
                    ref.batches(1024, shuffle=True)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert calls and all(s == big.shape for s in calls)
    assert featureset._gather(small, np.arange(5)).tolist() == \
        small[:5].tolist()


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def _pairs():
    rs = np.random.RandomState(5)
    return [
        ("SeqToTensor", dict(size=(2, 3)), [[1, 2, 3], [4, 5, 6]]),
        ("SeqToTensor", dict(dtype=np.int64), [1, 2, 3]),
        ("ScalarToTensor", {}, 2.5),
        ("ArrayToTensor", dict(size=(3, 2)), rs.randn(6)),
        ("ArrayToTensor", dict(dtype=np.float64), rs.randn(4, 2)),
        ("ToFloat32", {}, rs.randint(0, 5, (3,))),
        ("TensorToSample", {}, (np.ones(2), 1)),
        ("TensorToSample", {}, np.ones(3)),
    ]


@pytest.mark.parametrize("i", range(len(_pairs())))
def test_preprocessing_class_is_exact(i):
    name, kw, value = _pairs()[i]
    got = getattr(pre, name)(**kw)(value)
    want = getattr(jpre, name)(**kw)(value)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_chains_flatten_and_compose_as_in_jax():
    def build(m):
        a = m.SeqToTensor() >> m.ToFloat32()
        b = a >> (m.ArrayToTensor(size=(3,)) >> m.ScalarToTensor().chain(
            m.ToFloat32()))
        return a, b

    (pa, pb), (ja, jb) = build(pre), build(jpre)
    assert [type(s).__name__ for s in pb.stages] == \
        [type(s).__name__ for s in jb.stages]
    assert len(pb.stages) == 5
    assert isinstance(pb, pre.ChainedPreprocessing)
    np.testing.assert_array_equal(pa([1, 2, 3]), ja([1, 2, 3]))
    np.testing.assert_array_equal(
        pre.ChainedPreprocessing([pre.SeqToTensor(), np.square])([1, 2]),
        jpre.ChainedPreprocessing([jpre.SeqToTensor(), np.square])([1, 2]))


def test_feature_label_preprocessing_and_map_arrays():
    rs = np.random.RandomState(6)
    xs = [rs.randn(5, 3), rs.randint(0, 4, (5, 2))]
    y = rs.randint(0, 2, (5,))

    def make(m, feature):
        return m.FeatureLabelPreprocessing(feature, m.ScalarToTensor())

    for feat in ("SeqToTensor", "ToFloat32"):
        p = make(pre, getattr(pre, feat)())
        j = make(jpre, getattr(jpre, feat)())
        fx, fy = p.map_arrays(xs, y)
        jx, jy = j.map_arrays(xs, y)
        for a, b in zip(fx, jx):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(fy, jy)
        got, want = p((xs[0][0], 1)), j((xs[0][0], 1))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(p(xs[0][1]), j(xs[0][1]))
    no_label = pre.FeatureLabelPreprocessing(pre.ToFloat32())
    assert no_label((np.ones(2), 7))[1] == 7


# ---------------------------------------------------------------------------
# TFRecords
# ---------------------------------------------------------------------------

def _examples(n=20):
    rs = np.random.RandomState(7)
    return [{"user": np.array([rs.randint(1, 6041)], np.int64),
             "item": np.array([rs.randint(-5, 3707)], np.int64),
             "dense": rs.randn(3).astype(np.float32),
             "tags": [b"a", "bc".encode()] if i % 2 else ["x"],
             "label": np.array([float(i % 2)], np.float32)}
            for i in range(n)]


def test_tfrecord_files_are_byte_identical_and_read_in_both(tmp_path):
    exs = _examples()
    port_recs = [tfr.make_example(e) for e in exs]
    jax_recs = [jtfr.make_example(e) for e in exs]
    assert port_recs == jax_recs
    p, j = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    tfr.write_tfrecords(p, port_recs)
    jtfr.write_tfrecords(j, jax_recs)
    assert open(p, "rb").read() == open(j, "rb").read()
    for path in (p, j):
        got = tfr.read_example_file(path)
        want = jtfr.read_example_file(path)
        assert len(got) == len(want) == len(exs)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                if isinstance(w[k], list):
                    assert g[k] == w[k]
                else:
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k])
    assert list(tfr.read_tfrecords(j)) == list(jtfr.read_tfrecords(p))


@pytest.mark.parametrize("where", ["length_crc", "payload", "payload_crc"])
def test_tfrecord_flipped_byte_raises_in_both(tmp_path, where):
    path = str(tmp_path / "r.tfrecord")
    tfr.write_tfrecords(path, [tfr.make_example(e) for e in _examples(3)])
    raw = bytearray(open(path, "rb").read())
    (length,) = struct.unpack("<Q", raw[:8])
    pos = {"length_crc": 9, "payload": 12 + length // 2,
           "payload_crc": 12 + length + 1}[where]
    raw[pos] ^= 0x40
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        list(tfr.read_tfrecords(path))
    with pytest.raises(ValueError, match="corrupt"):
        list(jtfr.read_tfrecords(path))
    # verify=False reads past the checksum in both
    assert list(tfr.read_tfrecords(path, verify=False)) == \
        list(jtfr.read_tfrecords(path, verify=False))


def test_tfrecord_truncated_raises(tmp_path):
    path = str(tmp_path / "t.tfrecord")
    tfr.write_tfrecords(path, [b"abcdef"])
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-3])
    with pytest.raises(ValueError, match="truncated"):
        list(tfr.read_tfrecords(path))


# ---------------------------------------------------------------------------
# the giant table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 37), (12_345_678, 12_345_999),
                                   (10 ** 8 - 300, 10 ** 8)])
def test_giant_table_rows_are_exact(lo, hi):
    t = giant_table.SyntheticGiantTable(10 ** 8, 16, seed=7)
    j = jgiant.SyntheticGiantTable(10 ** 8, 16, seed=7)
    got = t.rows(lo, hi)
    assert got.dtype == np.float32 and got.shape == (hi - lo, 16)
    np.testing.assert_array_equal(got, j.rows(lo, hi))
    np.testing.assert_array_equal(t.row(lo), j.row(lo))
    assert t.nbytes == j.nbytes == 10 ** 8 * 16 * 4
    assert len(t) == 10 ** 8 and t.shape == (10 ** 8, 16)


def test_giant_table_chunks_and_bounds(monkeypatch):
    t = giant_table.SyntheticGiantTable(1000, 3, seed=11, scale=0.5)
    whole = t.rows(0, 1000)
    monkeypatch.setattr(giant_table.SyntheticGiantTable, "_CHUNK_CELLS", 7)
    np.testing.assert_array_equal(t.rows(0, 1000), whole)
    np.testing.assert_array_equal(
        whole, jgiant.SyntheticGiantTable(1000, 3, seed=11,
                                          scale=0.5).rows(0, 1000))
    assert np.abs(whole).max() < 0.5
    with pytest.raises(IndexError):
        t.rows(5, 1001)
    with pytest.raises(ValueError):
        giant_table.SyntheticGiantTable(0, 3)


# ---------------------------------------------------------------------------
# ZooConfig forms
# ---------------------------------------------------------------------------

def test_zoo_config_from_dict_to_dict_round_trip():
    d = {"seed": 3, "nan_policy": "raise", "serving_batch_size": 64,
         "not_a_field": [1, 2], "other": {"x": 1}}
    cfg = ZooConfig.from_dict(d)
    jcfg = JZooConfig.from_dict(d)
    assert cfg.seed == jcfg.seed == 3
    assert cfg.nan_policy == "raise" and cfg.serving_batch_size == 64
    assert cfg.extra == jcfg.extra == {"not_a_field": [1, 2],
                                       "other": {"x": 1}}
    back = ZooConfig.from_dict(cfg.to_dict())
    assert back == cfg
    assert back.to_dict()["extra"] == cfg.extra
    assert ZooConfig().extra == {} and ZooConfig().extra is not \
        ZooConfig().extra


@pytest.mark.parametrize("with_yaml", [True, False])
def test_zoo_config_from_yaml_and_json_fallback(tmp_path, monkeypatch,
                                                with_yaml):
    doc = {"seed": 9, "serving": {"batch_size": 16, "replicas": 2},
           "retry": {"max_attempts": 7}, "custom": {"deep": {"key": 1}}}
    path = tmp_path / "cfg.yaml"
    if with_yaml:
        import yaml

        path.write_text(yaml.safe_dump(doc))
    else:
        path.write_text(json.dumps(doc))
        monkeypatch.setitem(sys.modules, "yaml", None)   # import fails
    cfg = ZooConfig.from_yaml(str(path))
    jcfg = JZooConfig.from_yaml(str(path))
    assert cfg.seed == jcfg.seed == 9
    assert cfg.serving_batch_size == jcfg.serving_batch_size == 16
    assert cfg.serving_replicas == 2 and cfg.retry_max_attempts == 7
    assert cfg.extra == jcfg.extra == {"custom_deep_key": 1}


# ---------------------------------------------------------------------------
# image3d
# ---------------------------------------------------------------------------

def _volume(channels=False):
    rs = np.random.RandomState(8)
    shape = (16, 20, 24, 2) if channels else (16, 20, 24)
    return rs.rand(*shape).astype(np.float32)


def _transforms(m):
    rs = np.random.RandomState(9)
    field = (rs.randn(16, 20, 24, 3) * 1.5).astype(np.float32)
    mat = np.eye(3) + rs.randn(3, 3) * 0.1
    return [
        ("crop_centered", m.Crop3D(patch_size=(8, 10, 12))),
        ("crop_at", m.Crop3D(start=(2, 3, 4), patch_size=(5, 6, 7))),
        ("random_crop", m.RandomCrop3D((7, 9, 11))),
        ("rotate", m.Rotate3D(yaw=0.3, pitch=-0.2, roll=0.5)),
        ("rotate_nearest", m.Rotate3D(yaw=0.7, order=0)),
        ("affine", m.AffineTransform3D(mat, translation=(1.0, -2.0, 0.5))),
        ("warp", m.Warp3D(field)),
        ("warp_unclamped", m.Warp3D(field, clamp=False)),
        ("chain", m.Crop3D(patch_size=(12, 16, 20))
         | m.Rotate3D(roll=0.25) | m.RandomCrop3D((6, 6, 6))),
    ]


@pytest.mark.parametrize("channels", [False, True])
@pytest.mark.parametrize("i", range(9))
def test_image3d_transform_is_exact(i, channels):
    name, port_t = _transforms(image3d)[i]
    _, jax_t = _transforms(jimage3d)[i]
    vol = _volume(channels)
    got = port_t(ImageFeature(image=vol.copy()),
                 np.random.RandomState(4)).image
    want = jax_t(JImageFeature(image=vol.copy()),
                 np.random.RandomState(4)).image
    assert got.shape == want.shape and got.dtype == want.dtype, name
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_utils_nest_and_files(tmp_path):
    s = {"b": [1, (2, 3)], "a": {"y": 4, "x": [5]}}
    assert flatten(s) == jnest.flatten(s) == [5, 4, 1, 2, 3]
    assert pack_sequence_as(s, list("abcde")) == \
        jnest.pack_sequence_as(s, list("abcde"))
    assert map_structure(lambda v: v * 2, s) == \
        jnest.map_structure(lambda v: v * 2, s)
    with pytest.raises(ValueError):
        nest.pack_sequence_as(s, [1, 2])
    with pytest.raises(ValueError):
        nest.pack_sequence_as(s, list(range(6)))
    (tmp_path / "d").mkdir()
    for name in ("b.txt", "a.txt", "d/c.txt"):
        (tmp_path / name).write_text("x")
    from analytics_zoo_tpu.utils import get_file_list as jget

    for rec in (False, True):
        assert get_file_list(str(tmp_path), rec) == jget(str(tmp_path), rec)
    assert to_list(None) == [] and to_list((1, 2)) == [1, 2]
    assert to_list(3) == [3]


# ---------------------------------------------------------------------------
# no JAX, and no pandas needed
# ---------------------------------------------------------------------------

def test_new_modules_import_no_jax_and_run_without_pandas():
    """The slice's modules, driven through their entry points (a TFRecord
    file into TFEstimator, an MTNet search in threads, a vmapped
    population, the native library, the giant table), load neither jax
    nor the JAX package; with pandas unimportable, ``automl`` still
    imports and everything but its DataFrame front end runs."""
    import os
    import pathlib
    import subprocess

    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import sys, os, tempfile, numpy as np, torch\n"
        "sys.modules['pandas'] = None\n"
        "from analytics_zoo_tpu_torch.core import context\n"
        "context.init_zoo_context(device='cpu')\n"
        "import analytics_zoo_tpu_torch.utils, analytics_zoo_tpu_torch.native"
        " as native\n"
        "from analytics_zoo_tpu_torch.data import (SyntheticGiantTable,"
        " Preprocessing, image3d, tfrecord)\n"
        "from analytics_zoo_tpu_torch.models import NeuralCF\n"
        "from analytics_zoo_tpu_torch.tfpark import (TFDataset, TFEstimator,"
        " EstimatorSpec)\n"
        "from analytics_zoo_tpu_torch.automl import search\n"
        "from analytics_zoo_tpu_torch.automl.model.mtnet import MTNet\n"
        "assert native.available()\n"
        "d = tempfile.mkdtemp(); p = os.path.join(d, 'r.tfrecord')\n"
        "tfrecord.write_tfrecords(p, [tfrecord.make_example({'user': [1 + k"
        " % 9], 'item': [1 + k % 7], 'label': [k % 5]}) for k in range(64)])\n"
        "ncf = NeuralCF(10, 8, device='cpu')\n"
        "fn = lambda f, l, m, prm: EstimatorSpec(m, model=ncf.model,"
        " loss='sparse_categorical_crossentropy')\n"
        "ds = TFDataset.from_tfrecord_file(p, ['user', 'item'], 'label')\n"
        "TFEstimator(fn).train(lambda: ds, batch_size=16)\n"
        "x = np.random.RandomState(0).randn(40, 8, 2).astype(np.float32)\n"
        "y = x[:, -1, :1]\n"
        "eng = search.SearchEngine(dict(search.MTNetGridRandomRecipe(1,"
        " time_steps=(2,), long_nums=(3,)).search_space([]), epochs=1),"
        " num_samples=2, max_parallel=2)\n"
        "eng.run(lambda c: MTNet().fit_eval(x, y, **c))\n"
        "assert all('error' not in r.extra for r in eng.results)\n"
        "v = search.SearchEngine({'a': search.Uniform(0, 1)}, num_samples=3,"
        " backend='vmap')\n"
        "v.run(lambda c: c['a'] * torch.ones(()))\n"
        "assert all('error' not in r.extra for r in v.results)\n"
        "assert SyntheticGiantTable(10 ** 8, 2, seed=11).rows(5, 9).shape"
        " == (4, 2)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('analytics_zoo_tpu.')"
        " or m == 'analytics_zoo_tpu']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
