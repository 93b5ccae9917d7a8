"""The port's ClusterServing against the JAX package's, on the CPU.

A narrow NeuralCF (50 users, 40 items, embeds 8, MLP 16/8) and a
2-layer, hidden-64 BERTClassifier(2) (vocab 300, 2 heads, intermediate
128, L = 16) get the same seeded numpy weights in both packages
(``convert.load_jax_params`` on the port's side).  NCF takes one (2,)
int32 (user, item) record field, split on the device by the served
model's ``preprocess``; BERT takes one (16,) int32 id field.  Both
models live in one worker with ``postprocess_top_n=2``.

The same 200 records (150 NCF, 50 BERT), with one malformed record, one
for an unknown model and one whose TTL has run out, go through the JAX
ClusterServing (MemoryQueue) and the port's (MemoryQueue and FileQueue):
top-2 values within 1e-5 (f32 sums in other orders), equal top-2
indices, equal error codes, no record lost.  The weights are random, so
no two scores of a row tie (``lax.top_k`` and ``torch.topk`` order ties
differently); the test checks that its inputs hold no such tie.

Also: a record pushed by the JAX ``InputQueue`` over a ``FileQueue`` is
answered by the port's worker and read by the JAX ``OutputQueue``; the
port's synchronous ``serve_once`` gives the pipeline's answers; the
shared-memory path hands tensors to the bucket with no codec copy;
every record's span chain is complete;
``health()`` reports every stage; hot reload swaps in weights saved by
``save_model``; and the Recommender helpers follow ``fit`` (the repaired
stale-weights fault) and match the JAX model after the same fit.

Every wait takes a deadline and every worker is stopped in ``finally``.
"""

import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.deploy import ClusterServing as JaxCS
from analytics_zoo_tpu.deploy import FileQueue as JaxFileQueue
from analytics_zoo_tpu.deploy import InputQueue as JaxInputQueue
from analytics_zoo_tpu.deploy import MemoryQueue as JaxMemoryQueue
from analytics_zoo_tpu.deploy import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.deploy import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.models import NeuralCF as JaxNCF
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.tfpark import text_estimators as jtext

from analytics_zoo_tpu_torch.convert import load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.deploy import (ClusterServing, FileQueue,
                                            InferenceModel, InputQueue,
                                            MemoryQueue, OutputQueue,
                                            ServingConfig, ShmQueue,
                                            encode_tensor, shm_available)
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.observe import TRACER, find_orphans
from analytics_zoo_tpu_torch.observe import parse_prometheus
from analytics_zoo_tpu_torch.tfpark import BERTClassifier
from analytics_zoo_tpu_torch.train import optimizers as topt

jopt = importlib.import_module("analytics_zoo_tpu.train.optimizers")

USERS, ITEMS = 50, 40
NCF_KW = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8)
BERT_CFG = dict(vocab=300, hidden_size=64, n_block=2, nhead=2,
                intermediate_size=128, max_position_len=64)
L = 16
N_NCF, N_BERT = 150, 50
TOL = 1e-5
TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def split_pair(x):
    """The served NCF's preprocess: one (B, 2) id pair → (user, item)."""
    return x[:, :1], x[:, 1:]


def _ncf_params(jncf, seed=0):
    shapes, _ = jncf.model.build(jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    return {layer: {leaf: (rs.randn(*np.shape(v)) * 0.5).astype(np.float32)
                    for leaf, v in sub.items()}
            for layer, sub in shapes.items()}


def _bert_params(jnet, seed=1):
    jparams, _ = jnet.build(jax.random.PRNGKey(0), (2, L), (2, L))
    rs = np.random.RandomState(seed)

    def fill(path, x):
        shape = np.shape(x)
        if path and str(path[-1].key) == "gamma":
            return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (0.05 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jparams)


@pytest.fixture(scope="module")
def nets():
    """The JAX and port nets with one set of numpy weights each."""
    jax_reset_names()
    jncf = JaxNCF(USERS, ITEMS, table_placement="replicated", **NCF_KW)
    jbert = jtext.BERTClassifier(2, bert_config=BERT_CFG)
    ncf_p, bert_p = _ncf_params(jncf), _bert_params(jbert)
    reset_name_scope()
    tncf = NeuralCF(USERS, ITEMS, device="cpu", **NCF_KW)
    tbert = BERTClassifier(2, bert_config=BERT_CFG)
    load_jax_params(tncf.model, ncf_p)
    load_jax_params(tbert, bert_p)
    return dict(jncf=jncf, jbert=jbert, tncf=tncf, tbert=tbert,
                ncf_p=ncf_p, bert_p=bert_p)


def _port_models(nets):
    return {
        "ncf": InferenceModel.from_keras_net(
            nets["tncf"].model, device="cpu", preprocess=split_pair,
            batch_buckets=(1, 8, 64)),
        "bert": InferenceModel.from_keras_net(
            nets["tbert"], device="cpu", batch_buckets=(1, 8, 32))}


def _jax_models(nets):
    return {
        "ncf": JaxIM.from_keras_net(
            nets["jncf"].model, nets["ncf_p"], {}, preprocess=split_pair,
            batch_buckets=(1, 8, 64)),
        "bert": JaxIM.from_keras_net(
            nets["jbert"], jax.tree_util.tree_map(jnp.asarray,
                                                  nets["bert_p"]), {},
            batch_buckets=(1, 8, 32))}


def _records(seed=0):
    """(kind, uri, fields) for the 200 served records."""
    rs = np.random.RandomState(seed)
    out = []
    for r in range(N_NCF):
        pair = np.array([rs.randint(1, USERS + 1), rs.randint(1, ITEMS + 1)],
                        np.int32)
        out.append(("ncf", f"n{r}", {"x": pair}))
    for r in range(N_BERT):
        out.append(("bert", f"b{r}",
                    {"ids": rs.randint(0, BERT_CFG["vocab"], L)
                     .astype(np.int32)}))
    order = rs.permutation(len(out))
    return [out[k] for k in order]


# the records the pipeline must refuse, with the code each must carry
BAD = {"bad_fields": "malformed", "bad_model": "malformed",
       "bad_expired": "expired"}


def _push_all(queue, iq):
    recs = _records()
    for model, uri, fields in recs:
        iq.enqueue(uri=uri, model=model, **fields)
    # no tensor field at all: the worker's decode refuses it
    queue.push({"uri": "bad_fields", "ts": time.time(), "fmt": "tensor",
                "model": "ncf", "note": "no tensors"})
    iq.enqueue(uri="bad_model", model="resnet",
               x=np.zeros(2, np.int32))
    # a client TTL that ran out long ago: shed at claim
    queue.push({"uri": "bad_expired", "ts": time.time() - 10.0,
                "ttl_ms": 1.0, "fmt": "tensor", "model": "ncf",
                "x": (np.ones(2, np.int32) if iq.wire == "binary"
                      else encode_tensor(np.ones(2, np.int32)))})
    return [uri for _, uri, _ in recs] + list(BAD)


def _collect(oq, uris):
    return {u: oq.query(u, timeout=TIMEOUT) for u in uris}


def _serve(cs_cls, cfg_cls, models, queue, iq_cls, oq_cls, **cfg):
    cfg = dict(dict(postprocess_top_n=2, batch_size=32, decode_workers=2,
                    max_batch_delay_ms=2.0), **cfg)
    cs = cs_cls(models, queue, cfg_cls(**cfg)).start()
    try:
        uris = _push_all(queue, iq_cls(queue))
        return _collect(oq_cls(queue), uris), cs.health()
    finally:
        cs.stop()


@pytest.fixture(scope="module")
def jax_answers(nets):
    answers, _ = _serve(JaxCS, JaxServingConfig, _jax_models(nets),
                        JaxMemoryQueue(), JaxInputQueue, JaxOutputQueue)
    return answers


def _assert_same(got, want):
    assert set(got) == set(want)
    for uri, w in want.items():
        g = got[uri]
        if uri in BAD:
            assert isinstance(g, dict) and g["code"] == BAD[uri], (uri, g)
            assert w["code"] == BAD[uri], (uri, w)
            continue
        assert [p[0] for p in g] == [p[0] for p in w], (uri, g, w)
        np.testing.assert_allclose([p[1] for p in g], [p[1] for p in w],
                                   rtol=0, atol=TOL, err_msg=uri)
        # tie-free: the two scores of a pair differ by far more than TOL
        assert abs(w[0][1] - w[1][1]) > 10 * TOL, (uri, w)


@pytest.mark.parametrize("backend", ["memory", "file"])
def test_cluster_serving_matches_jax(nets, jax_answers, backend, tmp_path):
    queue = (MemoryQueue() if backend == "memory"
             else FileQueue(str(tmp_path / "spool")))
    got, health = _serve(ClusterServing, ServingConfig, _port_models(nets),
                         queue, InputQueue, OutputQueue)
    _assert_same(got, jax_answers)
    assert health["records_served"] == N_NCF + N_BERT + 1
    for stage in ("queue_wait", "decode", "batch_wait", "device",
                  "respond", "e2e"):
        assert health["stages"][stage]["count"] > 0, stage
    assert set(health["models"]) == {"ncf", "bert"}


def test_jax_client_over_file_queue_to_port_worker(nets, jax_answers,
                                                   tmp_path):
    """The JAX package's InputQueue writes the spool, the port's worker
    answers, the JAX package's OutputQueue reads the answers."""
    root = str(tmp_path / "spool")
    cs = ClusterServing(_port_models(nets), FileQueue(root), ServingConfig(
        postprocess_top_n=2, batch_size=32, decode_workers=2)).start()
    try:
        jq = JaxFileQueue(root)
        iq = JaxInputQueue(jq)
        recs = _records()[:40]
        for model, uri, fields in recs:
            iq.enqueue(uri=uri, model=model, **fields)
        got = _collect(JaxOutputQueue(jq), [u for _, u, _ in recs])
    finally:
        cs.stop()
    _assert_same(got, {u: jax_answers[u] for u in got})


def test_serve_once_matches_pipeline(nets, jax_answers):
    queue = MemoryQueue()
    cs = ClusterServing(_port_models(nets), queue,
                        ServingConfig(postprocess_top_n=2, batch_size=256,
                                      pipeline=False))
    uris = _push_all(queue, InputQueue(queue))
    deadline = time.monotonic() + TIMEOUT
    while len(queue) and time.monotonic() < deadline:
        cs.serve_once()
    got = _collect(OutputQueue(queue), uris)
    _assert_same(got, jax_answers)


@pytest.mark.skipif(not shm_available(),
                    reason="POSIX shared memory unavailable here")
def test_shm_path_makes_no_codec_copy(nets, jax_answers):
    q = ShmQueue(name="parity", slots=64, slot_bytes=1 << 12)
    copies = TIMERS.count("serving/codec_tensor_copies")
    try:
        cs = ClusterServing(_port_models(nets), q, ServingConfig(
            postprocess_top_n=2, batch_size=32, decode_workers=2)).start()
        try:
            iq = InputQueue(q)
            recs = _records()[:60]
            for model, uri, fields in recs:
                iq.enqueue(uri=uri, model=model, **fields)
            got = _collect(OutputQueue(q), [u for _, u, _ in recs])
        finally:
            cs.stop()
    finally:
        q.stop()
    _assert_same(got, {u: jax_answers[u] for u in got})
    assert TIMERS.count("serving/codec_tensor_copies") == copies


def test_every_record_has_a_complete_span_chain(nets):
    """Every claimed record's trace holds its root and stage spans with
    no orphan and a terminal status (``ok`` or its typed error code), as
    the JAX package's span-chain test holds them; the metrics registry
    round-trips through the Prometheus text."""
    queue = MemoryQueue()
    cs = ClusterServing(_port_models(nets), queue, ServingConfig(
        postprocess_top_n=2, batch_size=32, decode_workers=2)).start()
    try:
        uris = _push_all(queue, InputQueue(queue))
        _collect(OutputQueue(queue), uris)
        text = cs.metrics_text()
    finally:
        cs.stop()
    roots = {s["attrs"].get("uri"): s for s in TRACER.snapshot()
             if s["name"] == "serving/request"}
    for uri in uris:
        chain = TRACER.verify_chain(roots[uri]["trace"])
        assert chain["complete"], (uri, chain)
        assert not find_orphans(chain["spans"])
        status = chain["root"]["status"]
        assert status == BAD.get(uri, "ok"), (uri, status)
        if uri not in BAD:
            names = {sp["name"] for sp in chain["spans"]}
            assert {"serving/decode", "serving/batch_wait",
                    "serving/respond"} <= names, (uri, names)
    series = parse_prometheus(text)["series"]
    assert series['serving_records_total{model="ncf",outcome="ok"}'] >= N_NCF


def test_hot_reload_swaps_in_saved_weights(nets, tmp_path):
    path = str(tmp_path / "ncf_model")
    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, device="cpu", **NCF_KW)
    load_jax_params(ncf.model, nets["ncf_p"])
    ncf.save_model(path)
    queue = MemoryQueue()
    model = InferenceModel.load(path, device="cpu", preprocess=split_pair,
                                batch_buckets=(1, 8))
    cs = ClusterServing(model, queue, ServingConfig(postprocess_top_n=2,
                                                    batch_size=8))
    cs.enable_hot_reload(path, check_interval_s=0.05)
    cs.start()
    iq, oq = InputQueue(queue), OutputQueue(queue)
    x = np.array([3, 7], np.int32)
    try:
        before = oq.query(iq.enqueue(uri="h0", x=x), timeout=TIMEOUT)
        changed = {k: {leaf: v * 2.0 for leaf, v in sub.items()}
                   for k, sub in nets["ncf_p"].items()}
        load_jax_params(ncf.model, changed)
        time.sleep(0.05)            # a newer mtime than the first save
        ncf.save_model(path)
        want = InferenceModel.from_keras_net(
            ncf.model, device="cpu", preprocess=split_pair).predict(x[None])
        deadline = time.monotonic() + TIMEOUT
        after, k = before, 0
        while time.monotonic() < deadline:
            k += 1
            after = oq.query(iq.enqueue(uri=f"h{k}", x=x), timeout=TIMEOUT)
            if after != before:
                break
            time.sleep(0.05)
    finally:
        cs.stop()
    assert after != before
    top = np.argsort(-want[0])[:2]
    assert [p[0] for p in after] == [int(j) for j in top]
    np.testing.assert_allclose([p[1] for p in after], want[0][top],
                               atol=TOL)


def test_replicas_share_the_model_programs(nets):
    """A second replica of a model (the supervisor's rebuild of a slot)
    serves from the programs the first one made, with the same answers;
    a replica on another device raises, naming the multi-GPU item."""
    m = _port_models(nets)["ncf"]
    x = np.stack([f["x"] for k, _, f in _records() if k == "ncf"][:8])
    (first,) = m.replica_forwards(1, top_n=2)
    want = first.harvest(first.dispatch([x]))
    (progs,) = [list(m._programs.values())]
    (second,) = m.replica_forwards(1, top_n=2)
    for g, w in zip(second.harvest(second.dispatch([x])), want):
        np.testing.assert_array_equal(g, w)
    assert list(m._programs.values()) == progs and len(progs) == 1
    with pytest.raises(NotImplementedError, match="A9"):
        m.replica_forwards(1, devices=[torch.device("meta")])


# ---------------------------------------------------------------------------
# the Recommender helpers follow the trained net (ROADMAP C, port fault 1)


def _ncf_pair_trained(steps_batches):
    from analytics_zoo_tpu import init_zoo_context as jax_init_context

    jax_init_context()
    jax_reset_names()
    jncf = JaxNCF(USERS, ITEMS, table_placement="replicated", **NCF_KW)
    params = _ncf_params(jncf, seed=4)
    reset_name_scope()
    tncf = NeuralCF(USERS, ITEMS, device="cpu", **NCF_KW)
    load_jax_params(tncf.model, params)
    jncf.compile(optimizer=jopt.Adam(lr=1e-2),
                 loss="sparse_categorical_crossentropy")
    jncf.estimator.set_initial_weights(params)
    tncf.compile(optimizer=topt.Adam(lr=1e-2),
                 loss="sparse_categorical_crossentropy")
    return jncf, tncf


def test_recommendations_follow_fit_and_match_jax():
    """recommend, fit two steps, recommend again: the second answer is
    the trained net's and the JAX model's after the same fit (scores
    within 1e-4: the JAX step sums its gradients over an 8-device CPU
    mesh, so the trained weights differ in the last digits); an
    explicitly built int8 serving model is rebuilt on the new weights."""
    jncf, tncf = _ncf_pair_trained(2)
    items = np.arange(1, ITEMS + 1)
    users = np.arange(1, USERS + 1)
    tncf.inference_model(weight_dtype="int8")
    first = tncf.recommend_for_user(3, items, max_items=5)
    rs = np.random.RandomState(8)
    u = rs.randint(1, USERS + 1, (64, 1)).astype(np.int32)
    i = rs.randint(1, ITEMS + 1, (64, 1)).astype(np.int32)
    y = rs.randint(0, 5, 64).astype(np.int32)
    jncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    tncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    second = tncf.recommend_for_user(3, items, max_items=5)
    assert [s for _, s in second] != [s for _, s in first]
    assert tncf._inference._weight_dtype == "int8"
    # the same ranking from a float32 model of the trained weights, and
    # from the JAX model after the same two steps
    tncf.inference_model()
    got_u = tncf.recommend_for_user(3, items, max_items=10)
    got_i = tncf.recommend_for_item(5, users, max_users=10)
    want_u = jncf.recommend_for_user(3, items, max_items=10)
    want_i = jncf.recommend_for_item(5, users, max_users=10)
    for got, want in ((got_u, want_u), (got_i, want_i)):
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got],
                                   [w[1] for w in want], atol=1e-4)
    # unchanged weights keep the serving model; an in-place update, a
    # copy into a weight and a replaced weight are each seen
    kept = tncf._inference
    assert tncf.recommend_for_item(5, users, max_users=10) == got_i
    assert tncf._inference is kept
    with torch.no_grad():
        for p in tncf.model.parameters():
            p.mul_(0.5)
    third = tncf.recommend_for_user(3, items, max_items=10)
    assert [s for _, s in third] != [s for _, s in got_u]
    assert tncf._inference is not kept
    head = next(la for la in tncf.model.layers if la.name == "ncf_head")
    for change in (lambda w: w.copy_(w.flip(0)),
                   lambda w: head.set_leaf("kernel", w.flip(0).clone())):
        kept = tncf._inference
        with torch.no_grad():
            change(head.leaf("kernel"))
        before = [s for _, s in third]
        third = tncf.recommend_for_user(3, items, max_items=10)
        assert tncf._inference is not kept
        assert [s for _, s in third] != before
