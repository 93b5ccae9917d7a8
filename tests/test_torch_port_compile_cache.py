"""The port's persistent program-signature cache
(``analytics_zoo_tpu_torch/deploy/compile_cache.py``) and the bucket
programs of its ``InferenceModel``, against ``tests/test_compile_cache.py``'s
contract for the JAX package:

- a COLD model pays one live capture per bucket signature and persists
  each; a WARM one (a fresh model over the same weights and cache
  directory — and, in the last test, a second OS process) captures them
  all in ``warm()`` and serves with ``compile_count == 0``;
- the corruption matrix: a truncated entry, a bit-flipped payload and a
  bad magic quarantine to ``<file>.corrupt`` and the next request
  captures afresh; a header from another torch build is a detected
  ``version_skew``, left on disk and overwritten; a torn store leaves no
  entry;
- eviction by mtime beyond ``max_entries``;
- the entry format is the JAX package's: each side reads the other's
  entries.

On the CPU nothing is captured: a program is the bucket's forward over
its static input buffers, run eagerly, and ``compile_count`` counts the
signatures installed live, as on the card.  NeuralCF at a small width
(50 users, 40 items, embeddings 8), seeded weights, int8 and float32.
Outputs of a warm model equal the cold model's exactly (the same
forward on the same weights and inputs).  The JAX package is imported
only inside the tests that compare with it, so the restart test's worker
processes, which import this module, import torch alone.
"""

import json
import os
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.deploy import (CompileCache, InferenceModel,
                                            plan_buckets)
from analytics_zoo_tpu_torch.deploy.compile_cache import (CompileCacheCorrupt,
                                                          cache_env)
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.nn import reset_name_scope

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = (1, 8)
USERS, ITEMS = 50, 40
WIDTH = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8)


def _net(seed=0):
    """A small NeuralCF with seeded numpy weights, and request arrays."""
    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, device="cpu", **WIDTH)
    rs = np.random.RandomState(seed)
    load_jax_params(ncf.model, {
        layer: {leaf: (rs.randn(*v.shape) * 0.1).astype(np.float32)
                for leaf, v in sub.items()}
        for layer, sub in export_params(ncf.model).items()})
    u = rs.randint(1, USERS + 1, (64, 1)).astype(np.int32)
    i = rs.randint(1, ITEMS + 1, (64, 1)).astype(np.int32)
    return ncf.model, [u, i]


def _model(net, buckets=BUCKETS, weight_dtype="int8"):
    """A FRESH InferenceModel over the same net — same weights, same
    fingerprint, no programs: a simulated restart."""
    return InferenceModel.from_keras_net(net, weight_dtype=weight_dtype,
                                         batch_buckets=buckets, device="cpu")


def _entry_files(root):
    return sorted(fn for fn in os.listdir(root) if fn.endswith(".xc"))


def _cover_buckets(m, x):
    """Predict once per bucket; returns {bucket: output}."""
    return {b: np.asarray(m.predict([a[:b] for a in x]))
            for b in m.batch_buckets}


class TestWarmStart:
    def test_cold_captures_once_per_bucket_then_warm_restart_captures_zero(
            self, tmp_path):
        net, x = _net()
        cache = CompileCache(str(tmp_path))

        cold = _model(net).attach_compile_cache(cache, name="ncf")
        cold_out = _cover_buckets(cold, x)
        assert cold.compile_count == len(BUCKETS)
        assert cold.warm_count == 0
        assert len(_entry_files(tmp_path)) == len(BUCKETS)
        assert cache.stats()["events"].get("miss", 0) == len(BUCKETS)

        # "restart": a fresh model + fresh cache handle over the same dir
        cache2 = CompileCache(str(tmp_path))
        warm = _model(net).attach_compile_cache(cache2, name="ncf")
        assert warm.warm() == len(BUCKETS)
        warm_out = _cover_buckets(warm, x)
        assert warm.compile_count == 0, (
            "warm restart paid a live capture for a cached signature")
        assert warm.warm_count == len(BUCKETS)
        assert cache2.stats()["events"].get("hit", 0) >= len(BUCKETS)
        for b in BUCKETS:
            np.testing.assert_array_equal(cold_out[b], warm_out[b])

    def test_repeat_predict_on_a_signature_loads_once(self, tmp_path):
        net, x = _net()
        cache = CompileCache(str(tmp_path))
        m = _model(net).attach_compile_cache(cache)
        for _ in range(3):
            m.predict([a[:1] for a in x])
        # one miss+store, then the in-memory program table answers
        assert m.compile_count == 1
        assert cache.stats()["events"] == {"miss": 1}

    def test_fingerprint_isolates_models(self, tmp_path):
        """A model with other weights must not warm from the first
        model's signatures."""
        net_a, x = _net(seed=0)
        cache = CompileCache(str(tmp_path))
        _cover_buckets(_model(net_a).attach_compile_cache(cache), x)
        fp_a = _model(net_a).fingerprint()
        net_b, _ = _net(seed=1)
        mb = _model(net_b).attach_compile_cache(CompileCache(str(tmp_path)))
        assert mb.fingerprint() != fp_a
        assert mb.warm() == 0
        # the weight dtype is part of the fingerprint too
        assert _model(net_a, weight_dtype="float32").fingerprint() != fp_a

    def test_attach_requires_native_net(self, tmp_path):
        m = InferenceModel(lambda xs: xs[0] * 2.0)
        with pytest.raises(ValueError, match="native net"):
            m.attach_compile_cache(CompileCache(str(tmp_path)))

    def test_threads_share_the_bucket_programs(self, tmp_path):
        """Eight threads predicting through warmed programs get the
        answers of one thread, with no live capture."""
        net, x = _net()
        cache = CompileCache(str(tmp_path))
        want = _cover_buckets(_model(net).attach_compile_cache(cache), x)
        m = _model(net).attach_compile_cache(CompileCache(str(tmp_path)))
        assert m.warm() == len(BUCKETS)
        got, errors = {}, []

        def worker(t):
            try:
                for r in range(20):
                    b = BUCKETS[(t + r) % len(BUCKETS)]
                    out = np.asarray(m.predict([a[:b] for a in x]))
                    got.setdefault((t, b), []).append(out)
            except Exception as e:   # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        for (_, b), outs in got.items():
            for out in outs:
                np.testing.assert_array_equal(out, want[b])
        assert m.compile_count == 0

    def test_threads_on_a_new_signature_make_one_program(self, tmp_path):
        """Eight threads sending one new signature at once: one program,
        one eager warm-up taken, one cache miss and one entry stored,
        one live capture counted, and every thread the same answer."""
        net, x = _net()
        want = _cover_buckets(_model(net), x)[8]
        cache = CompileCache(str(tmp_path))
        m = _model(net).attach_compile_cache(cache)
        start = threading.Barrier(8)
        got, errors = [], []

        def worker():
            try:
                start.wait(timeout=30)
                got.append(np.asarray(m.predict([a[:8] for a in x])))
            except Exception as e:   # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert len(got) == 8
        for out in got:
            np.testing.assert_array_equal(out, want)
        (prog,) = m._programs.values()
        assert prog.warm_up_taken and m.compile_count == 1
        assert cache.stats()["events"] == {"miss": 1}
        assert len(_entry_files(tmp_path)) == 1


class TestCorruptionMatrix:
    """Each damage flavour quarantines (or detects) the entry, counts the
    event, and the caller recovers with a clean capture."""

    def _one_entry(self, tmp_path):
        net, x = _net()
        cache = CompileCache(str(tmp_path))
        m = _model(net, buckets=(8,)).attach_compile_cache(cache)
        m.predict([a[:8] for a in x])
        files = _entry_files(tmp_path)
        assert len(files) == 1
        return net, x, os.path.join(str(tmp_path), files[0])

    @pytest.mark.parametrize("damage", ["truncated", "bitflip", "bad_magic"])
    def test_damaged_entry_quarantined_then_recaptured(self, tmp_path,
                                                       damage):
        net, x, path = self._one_entry(tmp_path)
        data = bytearray(open(path, "rb").read())
        if damage == "truncated":
            data = data[:len(data) // 2]
        elif damage == "bitflip":
            data[-1] ^= 0xFF
        else:
            data[:4] = b"NOPE"
        with open(path, "wb") as f:
            f.write(bytes(data))
        n0 = TIMERS.count("serving/compile_cache_corrupt")
        cache = CompileCache(str(tmp_path))
        m = _model(net, buckets=(8,)).attach_compile_cache(cache)
        assert m.warm() == 0
        assert os.path.exists(path + ".corrupt")
        assert not os.path.exists(path)
        assert cache.stats()["events"].get("corrupt", 0) >= 1
        assert TIMERS.count("serving/compile_cache_corrupt") > n0
        # a clean capture re-stores under the same digest
        m.predict([a[:8] for a in x])
        assert m.compile_count == 1
        assert os.path.exists(path)

    def test_read_entry_raises_typed_error(self, tmp_path):
        _, _, path = self._one_entry(tmp_path)
        with open(path, "r+b") as f:
            f.truncate(6)
        with pytest.raises(CompileCacheCorrupt):
            CompileCache(str(tmp_path))._read_entry(path)

    def test_version_skew_detected_and_overwritten(self, tmp_path):
        """A header from another torch build is a *detected* skew: the
        file stays on disk (no quarantine) and the caller's recapture
        overwrites the same digest in place."""
        net, x, path = self._one_entry(tmp_path)
        data = open(path, "rb").read()
        (hlen,) = struct.unpack_from("<I", data, 4)
        header = json.loads(data[8:8 + hlen].decode("utf-8"))
        header["torch"] = "0.0.0-ancient"
        hdr = json.dumps(header, sort_keys=True).encode("utf-8")
        with open(path, "wb") as f:
            f.write(data[:4] + struct.pack("<I", len(hdr)) + hdr
                    + data[8 + hlen:])

        n0 = TIMERS.count("serving/compile_cache_version_skew")
        cache = CompileCache(str(tmp_path))
        m = _model(net, buckets=(8,)).attach_compile_cache(cache)
        assert m.warm() == 0
        assert os.path.exists(path), "skewed entry must stay, not vanish"
        assert not os.path.exists(path + ".corrupt")
        assert cache.stats()["events"].get("version_skew", 0) >= 1
        assert TIMERS.count("serving/compile_cache_version_skew") > n0

        m.predict([a[:8] for a in x])            # recapture overwrites
        assert m.compile_count == 1
        hdr2 = CompileCache(str(tmp_path))._read_entry(path)[0]
        assert hdr2["torch"] == cache_env()["torch"]

    def test_torn_store_leaves_no_entry(self, tmp_path, monkeypatch):
        """A crash mid-store never leaves a half-written file under the
        real entry name (atomic tmp + os.replace)."""
        net, x = _net()
        cache = CompileCache(str(tmp_path))

        def boom(src, dst):
            raise OSError("disk died mid-replace")

        monkeypatch.setattr(os, "replace", boom)
        m = _model(net, buckets=(8,)).attach_compile_cache(cache)
        with pytest.raises(OSError):
            m.predict([a[:8] for a in x])
        monkeypatch.undo()
        assert _entry_files(tmp_path) == []
        assert all(not fn.endswith(".tmp") for fn in os.listdir(tmp_path))


class TestEviction:
    def test_gc_evicts_oldest_beyond_cap(self, tmp_path):
        net, x = _net()
        cache = CompileCache(str(tmp_path), max_entries=2)
        m = _model(net, buckets=(1, 4, 8)).attach_compile_cache(cache)
        for t, b in zip((100.0, 200.0, 300.0), (1, 4, 8)):
            m.predict([a[:b] for a in x])
            for fn in _entry_files(tmp_path):
                p = os.path.join(str(tmp_path), fn)
                if os.path.getmtime(p) > t:
                    os.utime(p, (t, t))
        assert len(_entry_files(tmp_path)) == 2, (
            "store() must gc to max_entries")
        assert len(cache.entries()) == 2


class TestEntryFormat:
    """The port writes the JAX package's entry format: magic, header,
    CRC and payload length read back by the JAX reader, and the other
    way round."""

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_each_side_reads_the_others_entries(self, tmp_path, writer):
        import zlib

        from analytics_zoo_tpu.deploy.compile_cache import \
            CompileCache as JaxCompileCache

        sig = {"in": [[[8, 1], "int32"], [[8, 1], "int32"]], "dev": "cpu",
               "top_n": 0, "weight_dtype": "int8"}
        payload = json.dumps(sig, sort_keys=True).encode("utf-8")
        port, jax_side = CompileCache(str(tmp_path)), JaxCompileCache(
            str(tmp_path))
        if writer == "port":
            path = port.store("fp", sig)
            header, got = jax_side._read_entry(path)
        else:
            path = os.path.join(str(tmp_path), "entry.xc")
            hdr = json.dumps({"fingerprint": "fp", "sig": sig},
                             sort_keys=True).encode("utf-8")
            with open(path, "wb") as f:
                f.write(b"AZXC" + struct.pack("<I", len(hdr)) + hdr
                        + struct.pack("<IQ", zlib.crc32(payload),
                                      len(payload)) + payload)
            header, got = port._read_entry(path)
        assert header["fingerprint"] == "fp" and header["sig"] == sig
        assert got == payload


class TestPlanBuckets:
    """The shared bucket-overflow policy, as the JAX package's."""

    @pytest.mark.parametrize("n,buckets,plan", [
        (5, (8, 64), [(5, 8)]), (8, (8, 64), [(8, 8)]),
        (64, (8, 64), [(64, 64)]), (100, (8, 64), [(64, 64), (36, 64)]),
        (70, (8, 64), [(64, 64), (6, 8)]),
        (129, (8, 64), [(64, 64), (64, 64), (1, 8)])])
    def test_plans(self, n, buckets, plan):
        from analytics_zoo_tpu.deploy import plan_buckets as jax_plan

        assert plan_buckets(n, buckets) == plan == jax_plan(n, buckets)

    def test_rows_conserved_and_buckets_legal(self):
        buckets = (1, 8, 64)
        for n in (1, 7, 63, 65, 200):
            plan = plan_buckets(n, buckets)
            assert sum(m for m, _ in plan) == n
            assert all(b in buckets and m <= b for m, b in plan)


_WORKER = """
import json, sys
import numpy as np
sys.path.insert(0, {root!r})
from tests.test_torch_port_compile_cache import _cover_buckets, _model, _net
from analytics_zoo_tpu_torch.deploy import CompileCache
net, x = _net()
cache = CompileCache({cache!r})
m = _model(net).attach_compile_cache(cache, name="ncf")
warmed = m.warm()
out = _cover_buckets(m, x)
print(json.dumps({{"fingerprint": m.fingerprint(), "warmed": warmed,
                  "compile_count": m.compile_count,
                  "warm_count": m.warm_count,
                  "events": cache.stats()["events"],
                  "out": {{str(b): v.tolist() for b, v in out.items()}}}}))
"""


def test_warm_restart_across_real_processes(tmp_path):
    """Process A captures and persists; process B, a separate OS process
    over the same cache directory, reaches full bucket coverage with zero
    live captures and only ``hit`` events, and answers as A did."""
    code = _WORKER.format(root=str(ROOT), cache=str(tmp_path / "cache"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def run():
        res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                             env=env, capture_output=True, text=True,
                             timeout=240)
        assert res.returncode == 0, res.stderr
        return json.loads(res.stdout.strip().splitlines()[-1])

    cold, warm = run(), run()
    nb = len(BUCKETS)
    assert cold["warmed"] == 0 and cold["compile_count"] == nb
    assert cold["events"].get("miss", 0) == nb
    assert warm["fingerprint"] == cold["fingerprint"], (
        "the seeded build must fingerprint alike in both processes")
    assert warm["warmed"] == nb and warm["warm_count"] == nb
    assert warm["compile_count"] == 0, (
        "the second process paid live captures despite a full cache")
    assert warm["events"].get("hit", 0) >= nb
    assert warm["events"].get("corrupt", 0) == 0
    assert warm["out"] == cold["out"]
