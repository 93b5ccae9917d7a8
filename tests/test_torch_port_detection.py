"""The PyTorch port's object detection (``models/objectdetection``:
boxes, prior matching, NMS, the MultiBox loss, SSD, mAP, drawing)
against the JAX package on the CPU.

Weights come from ``np.random.RandomState`` in the JAX tree's shapes and
reach the port through ``convert.load_jax_params``.  Tolerances, with
their reasons:

- IoU, NMS (indices, labels, boxes and scores), class targets, the
  matched centres and mAP: exact (the same f32 operations element by
  element; argmax takes the first of equal values and the final ranking
  is a stable sort in both packages);
- the log-size part of a loc target (``encode_boxes``) and ``decode``:
  within 2 units in the last place (XLA's ``log`` and ``exp`` differ
  from PyTorch's in the last bit on a few percent of inputs); against
  the jitted JAX assigner, within 1e-6 relative (XLA's rewrites of the
  divisions);
- ``multibox_loss`` and its gradients: within 1e-5 (f32 sums in another
  order);
- SSD300 at ``width_mult=0.125``: per-prior loc and conf within 1e-4 of
  the largest value (a 20-layer trunk of f32 convolutions);
- four SGD ``fit_detection`` steps (learning rate 1e-4, see ``LR``):
  losses within 1e-5 relative, parameters and BN statistics within
  1e-5; ``detect`` afterwards: the same labels, boxes and scores within
  1e-5.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names

from analytics_zoo_tpu_torch.convert import (export_params, export_state,
                                             load_jax_params)
from analytics_zoo_tpu_torch.models import objectdetection as tod
from analytics_zoo_tpu_torch.nn import reset_name_scope

jbbox = importlib.import_module("analytics_zoo_tpu.models.objectdetection.bbox")
jnms = importlib.import_module("analytics_zoo_tpu.models.objectdetection.nms")
jloss = importlib.import_module("analytics_zoo_tpu.models.objectdetection.loss")
jssd = importlib.import_module("analytics_zoo_tpu.models.objectdetection.ssd")
jeval = importlib.import_module(
    "analytics_zoo_tpu.models.objectdetection.evaluation")
tbbox = importlib.import_module(
    "analytics_zoo_tpu_torch.models.objectdetection.bbox")
tnms = importlib.import_module(
    "analytics_zoo_tpu_torch.models.objectdetection.nms")

# SGD's rate for the training parity: at 1e-2 and 1e-3 the two packages
# part by 1e-4 to 2% of the loss within three epochs (BN over batches of
# 8 on 1x1 maps, and hard-negative mining whose cut falls among hundreds
# of background losses within float noise of each other, turn last-bit
# differences into different steps); at 1e-4 they agree within 3e-7
LR = 1e-4

TINY_CONFIG = {
    "image_size": 64,
    "feature_sizes": (8, 4, 2, 1, 1, 1),
    "min_sizes": (6, 13, 26, 38, 51, 58),
    "max_sizes": (13, 26, 38, 51, 58, 70),
    "aspect_ratios": ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def _boxes(rs, n, lo=0.0, hi=0.7):
    xy = rs.uniform(lo, hi, (n, 2))
    wh = rs.uniform(0.02, 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _priors(cfg=TINY_CONFIG):
    return tbbox.generate_priors(cfg["feature_sizes"], cfg["image_size"],
                                 cfg["min_sizes"], cfg["max_sizes"],
                                 cfg["aspect_ratios"])


def _ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return int(np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64)).max())


# ---------------------------------------------------------------------------
# boxes and matching


def test_priors_iou_encode_decode_match_jax():
    rs = np.random.RandomState(0)
    for cfg in (TINY_CONFIG, tod.SSD300_CONFIG):
        np.testing.assert_array_equal(_priors(cfg), jbbox.generate_priors(
            cfg["feature_sizes"], cfg["image_size"], cfg["min_sizes"],
            cfg["max_sizes"], cfg["aspect_ratios"]))
    a, b = _boxes(rs, 60), _boxes(rs, 45)
    np.testing.assert_array_equal(
        tbbox.iou_matrix(a, b, device="cpu").numpy(),
        np.asarray(jbbox.iou_matrix(a, b)))
    want = np.asarray(jbbox.encode_boxes(jnp.asarray(a[:45]),
                                         jnp.asarray(b)))
    got = tbbox.encode_boxes(a[:45], b, device="cpu").numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    assert _ulps(got[:, 2:], want[:, 2:]) <= 2
    loc = rs.randn(45, 4).astype(np.float32)
    want = np.asarray(jbbox.decode_boxes(jnp.asarray(loc), jnp.asarray(b)))
    assert _ulps(tbbox.decode_boxes(loc, b, device="cpu").numpy(),
                 want) <= 2


def _assert_match(gt, labels, priors, thr=0.5):
    jl, jc = jbbox.match_priors(gt, labels, jnp.asarray(priors), thr)
    tl, tc = tbbox.match_priors(gt, labels, priors, thr, device="cpu")
    jl, jc = np.asarray(jl), np.asarray(jc)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tl.numpy()[:, :2], jl[:, :2])
    assert _ulps(tl.numpy()[:, 2:], jl[:, 2:]) <= 2
    return tc.numpy()


@pytest.mark.parametrize("g", [1, 3, 7])
def test_match_priors_matches_jax_on_random_gts(g):
    rs = np.random.RandomState(g)
    priors = _priors()
    for _ in range(10):
        labels = rs.randint(0, 4, g).astype(np.int32)
        _assert_match(_boxes(rs, g), labels, priors)


def test_match_priors_duplicate_best_prior_and_padding_after_prior_0():
    """The JAX scatter's repeated indices, last write in gt order: two
    real gts whose best prior is the same (the later one takes it), and
    padding rows after a gt whose best prior is prior 0 (they write
    prior 0's pre-scatter value back, undoing the forced match)."""
    priors = np.array([[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                       [0.0, 0.5, 0.5, 1.0], [0.5, 0.0, 1.0, 0.5]],
                      np.float32)
    # two gts, both best matched by prior 1 (below the threshold)
    gt = np.array([[0.6, 0.6, 0.7, 0.7], [0.8, 0.8, 0.95, 0.95],
                   [0.0, 0.0, 0.0, 0.0]], np.float32)
    cls = _assert_match(gt, np.array([2, 5, 0], np.int32), priors)
    assert cls[1] == 5
    # a small gt in prior 0 (forced there, IoU < 0.5), then padding
    gt = np.array([[0.05, 0.05, 0.15, 0.15], [0.0, 0.0, 0.0, 0.0],
                   [0.0, 0.0, 0.0, 0.0]], np.float32)
    cls = _assert_match(gt, np.array([3, 0, 0], np.int32), priors)
    assert cls[0] == 0        # undone, as in the JAX package
    cls = _assert_match(gt[:1], np.array([3], np.int32), priors)
    assert cls[0] == 3        # without padding the forced match stands
    # padding between real gts, and a gt whose best prior is also 0
    gt = np.array([[0.1, 0.1, 0.45, 0.45], [0.0, 0.0, 0.0, 0.0],
                   [0.55, 0.1, 0.9, 0.45], [0.02, 0.02, 0.2, 0.2]],
                  np.float32)
    _assert_match(gt, np.array([1, 0, 4, 6], np.int32), priors)
    _assert_match(gt, np.array([1, 2, 0, 6], np.int32), priors, thr=0.3)


def test_target_assigner_matches_jax_over_a_batch():
    """The port assigns a batch on its device in one pass: numpy in,
    numpy out, as the JAX assigner: class targets exact, loc targets
    within 1e-6 relative (the JAX assigner is jitted, and XLA rewrites
    the variance divisions and fuses the encode arithmetic; the eager
    JAX ``match_priors`` above holds the port to 2 ulps)."""
    rs = np.random.RandomState(5)
    priors = _priors()
    gt = np.stack([_boxes(rs, 4) for _ in range(6)])
    labels = rs.randint(0, 5, (6, 4)).astype(np.int32)
    labels[:, 0] = 0
    want = jssd.SSDTargetAssigner(priors)(gt, labels)
    got = tod.SSDTargetAssigner(priors, device="cpu")(gt, labels)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-6,
                               atol=1e-6)
    tens = tod.SSDTargetAssigner(priors, device="cpu")(
        torch.from_numpy(gt), torch.from_numpy(labels))
    np.testing.assert_array_equal(tens.numpy(), got)


# ---------------------------------------------------------------------------
# NMS


def _scores(rs, p, c, ties):
    s = rs.rand(p, c).astype(np.float32) ** 3
    if ties:
        s = np.round(s * 8) / 8              # many equal scores
    return (s / np.maximum(s.sum(1, keepdims=True), 1e-6)).astype(
        np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,max_out", [(300, 100), (40, 60)])
def test_nms_matches_jax(p, max_out, ties):
    """The same indices (with -1 padding) and count; ``max_output`` above
    the box count included."""
    rs = np.random.RandomState(p)
    boxes = _boxes(rs, p)
    scores = _scores(rs, p, 3, ties)[:, 1]
    for thr, sthr in ((0.45, 0.01), (0.3, 0.2), (0.7, 0.0)):
        want_i, want_c = jnms.nms(boxes, scores, thr, sthr, max_out)
        got_i, got_c = tod.nms(boxes, scores, thr, sthr, max_out,
                               device="cpu")
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert int(got_c) == int(want_c)


@pytest.mark.parametrize("ties", [False, True])
def test_batched_class_nms_matches_jax(ties):
    rs = np.random.RandomState(7)
    boxes = _boxes(rs, 250)
    scores = _scores(rs, 250, 6, ties)
    for kw in (dict(), dict(score_threshold=0.0, max_per_class=20,
                            max_total=30),
               dict(iou_threshold=0.3, max_per_class=80, max_total=500)):
        want = jnms.batched_class_nms(jnp.asarray(boxes),
                                      jnp.asarray(scores), **kw)
        got = tod.batched_class_nms(boxes, scores, device="cpu", **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        batched = tnms.class_nms_batch(
            torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])),
            torch.from_numpy(np.stack([scores, scores[::-1].copy()])),
            **kw)
        for g, w in zip(batched, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the MultiBox loss


@pytest.mark.parametrize("ties", [False, True])
def test_multibox_loss_value_and_gradient_match_jax(ties):
    """The loss and its gradients for the predictions: hard negatives by
    a stable rank (ties among the negatives' losses when ``ties``)."""
    rs = np.random.RandomState(3)
    B, P, C = 3, 120, 5
    cls_t = rs.randint(0, C, (B, P))
    cls_t[rs.rand(B, P) < 0.8] = 0
    cls_t[2] = 0                                    # no positives
    loc_t = rs.randn(B, P, 4).astype(np.float32)
    loc_p = rs.randn(B, P, 4).astype(np.float32)
    logits = rs.randn(B, P, C).astype(np.float32)
    if ties:
        logits = np.round(logits)
    for ratio, w in ((3.0, 1.0), (1.5, 0.5)):
        f = (lambda a, b: jloss.multibox_loss(
            a, b, jnp.asarray(loc_t), jnp.asarray(cls_t), ratio, w))
        want, (wa, wb) = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(loc_p), jnp.asarray(logits))
        a = torch.from_numpy(loc_p).requires_grad_(True)
        b = torch.from_numpy(logits).requires_grad_(True)
        got = tod.multibox_loss(a, b, torch.from_numpy(loc_t),
                                torch.from_numpy(cls_t), ratio, w)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(wa), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(wb), rtol=0,
                                   atol=1e-5)
    y_true = np.concatenate([loc_t, cls_t[..., None].astype(np.float32)], -1)
    loss = tod.MultiBoxLoss()
    assert loss.batch_structured
    np.testing.assert_allclose(
        float(loss(torch.from_numpy(y_true), (torch.from_numpy(loc_p),
                                              torch.from_numpy(logits)))),
        float(jloss.MultiBoxLoss()(jnp.asarray(y_true), (
            jnp.asarray(loc_p), jnp.asarray(logits)))), rtol=1e-5)
    np.testing.assert_allclose(
        tod.smooth_l1(torch.tensor([-2.0, -0.5, 0.0, 0.5, 2.0])).numpy(),
        [1.5, 0.125, 0.0, 0.125, 1.5])


# ---------------------------------------------------------------------------
# SSD


def _ssd_weights(tm, seed):
    rs = np.random.RandomState(seed)
    params = {ln: {k: (rs.randn(*v.shape) * 0.1).astype(np.float32)
                   for k, v in leaves.items()}
              for ln, leaves in tm.params().items()}
    for ln, leaves in params.items():
        if ln.endswith("_bn"):
            leaves["gamma"] = (1.0 + 0.1 * rs.randn(
                *leaves["gamma"].shape)).astype(np.float32)
    state = {ln: {k: ((0.75 + 0.5 * rs.rand(*v.shape)) if "var" in k
                      else 0.1 * rs.randn(*v.shape)).astype(np.float32)
                  for k, v in leaves.items()}
             for ln, leaves in tm.state().items() if leaves}
    return params, state


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_ssd300_per_prior_outputs_match_jax_at_width_0125():
    """SSD300's graph at width 1/8: the same layer names and leaves, and
    per-prior loc and conf (the heads' NHWC outputs flattened in (row,
    column, anchor) order, the priors' order) within 1e-4."""
    jax_reset_names()
    jm, jp = jssd.build_ssd(21, jssd.SSD300_CONFIG, 0.125)
    reset_name_scope()
    tm, tp = tod.build_ssd(21, tod.SSD300_CONFIG, 0.125)
    tm.build(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tp, jp)
    params, state = _ssd_weights(tm, 1)
    load_jax_params(tm, params, state)
    x = np.random.RandomState(2).randn(2, 300, 300, 3).astype(np.float32)
    _, jstate = jm.build(jax.random.PRNGKey(0), (2, 300, 300, 3))
    jstate.update(state)
    (wl, wc), _ = jax.jit(lambda p, s, v: jm.call(p, s, v, training=False))(
        _jtree(params), _jtree(jstate), jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        gl, gc = tm(torch.from_numpy(x))
    for g, w, what in ((gl, wl, "loc"), (gc, wc, "conf")):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=what)


def test_ssd300_full_width_priors_heads_and_size():
    """The full SSD300 configuration: 8,732 priors, heads of (B, 8732, 4)
    and (B, 8732, 21), the JAX net's parameter count (9.6 M)."""
    det = tod.ObjectDetector(21, device="cpu")
    assert det.priors.shape == (8732, 4)
    assert det.model.output_shape((2, 300, 300, 3)) == [(2, 8732, 4),
                                                         (2, 8732, 21)] \
        or tuple(map(tuple, det.model.output_shape((2, 300, 300, 3)))) == (
            (2, 8732, 4), (2, 8732, 21))
    n = sum(p.numel() for p in det.model.parameters())
    jax_reset_names()
    jm, _ = jssd.build_ssd(21, jssd.SSD300_CONFIG, 1.0)
    shapes = jax.eval_shape(lambda k: jm.build(k, (1, 300, 300, 3))[0],
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))
    assert 9_000_000 < n < 10_000_000
    assert det.config()["class_num"] == 21
    with pytest.raises(ValueError, match="feature_sizes"):
        bad = dict(TINY_CONFIG, feature_sizes=(8, 4, 2, 1, 1, 2))
        tod.ObjectDetector(3, config=bad, width_mult=0.125, device="cpu")


def _detector_pair(seed=0):
    from analytics_zoo_tpu.train.optimizers import SGD as JSGD

    from analytics_zoo_tpu_torch.train.optimizers import SGD

    jax_reset_names()
    jdet = jssd.ObjectDetector(class_num=3, config=TINY_CONFIG,
                               width_mult=0.125)
    reset_name_scope()
    tdet = tod.ObjectDetector(3, config=TINY_CONFIG, width_mult=0.125,
                              device="cpu")
    params, state = _ssd_weights(tdet.model, seed)
    load_jax_params(tdet.model, params, state)
    jdet.model.compile(optimizer=JSGD(lr=LR), loss=jdet.loss())
    # the JAX trees list every layer, weightless ones as {}
    jp, js = jax.eval_shape(lambda k: jdet.model.build(k, (8, 64, 64, 3)),
                            jax.random.PRNGKey(0))
    # marked built: set_initial_weights places the trees at once
    jdet.estimator.params = {}
    jdet.estimator.set_initial_weights({k: params.get(k, {}) for k in jp},
                                       {k: state.get(k, {}) for k in js})
    tdet.compile(SGD(lr=LR), tdet.loss())
    return jdet, tdet, params, state


def _data(n=16, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.randn(n, 64, 64, 3).astype(np.float32)
    boxes = np.zeros((n, 2, 4), np.float32)
    labels = np.zeros((n, 2), np.int32)
    for i in range(n):
        k = 1 + i % 2
        boxes[i, :k] = _boxes(rs, k, 0.0, 0.45)
        labels[i, :k] = rs.randint(1, 3, k)
    return imgs, boxes, labels


def test_fit_detection_and_detect_match_jax():
    """Two epochs of SGD at batch 8 in data order, then ``detect`` on
    held-out images: losses, parameters and BN statistics (which moved),
    then the detections.  (Shuffled, the packages draw the same pair
    permutations, but the batches' different membership of the mining
    cut makes the second epoch part by 6e-5.)"""
    jdet, tdet, params, state = _detector_pair()
    imgs, boxes, labels = _data()
    jh = jdet.fit_detection(imgs, boxes, labels, batch_size=8, nb_epoch=2,
                            verbose=False, shuffle=False)
    th = tdet.fit_detection(imgs, boxes, labels, batch_size=8, nb_epoch=2,
                            verbose=False, shuffle=False)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-5)
    jp = jax.tree_util.tree_map(np.asarray, jdet.estimator.params)
    for ln, leaves in export_params(tdet.model).items():
        for k, v in leaves.items():
            np.testing.assert_allclose(v, jp[ln][k], rtol=0, atol=1e-5,
                                       err_msg=f"{ln}.{k}")
    moved = max(float(np.abs(v - params[ln][k]).max())
                for ln, leaves in export_params(tdet.model).items()
                for k, v in leaves.items())
    assert moved > 1e-3
    js = jax.tree_util.tree_map(np.asarray, jdet.estimator.state)
    for ln, leaves in export_state(tdet.model).items():
        for k, v in leaves.items():
            np.testing.assert_allclose(v, js[ln][k], rtol=0, atol=1e-5)
    test, _, _ = _data(5, seed=9)
    for kw in (dict(score_threshold=0.3), dict(score_threshold=0.05,
                                                max_detections=20)):
        # the JAX detect keeps the post-processing it jitted on its first
        # call, with that call's thresholds (ssd.py:669-681); the port's
        # programs are keyed by them, so each call honours its own
        jdet._post = None
        want = jdet.detect(test, batch_size=2, **kw)
        got = tdet.detect(test, batch_size=2, **kw)
        assert len(got) == len(want) == 5
        for (gb, gs, gl), (wb, ws, wl) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-5)
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    # one program per batch signature: the ragged last batch is padded
    assert len(tdet._detect_programs) == 2


def test_detect_post_processing_matches_jax_on_the_same_head_outputs():
    """decode, softmax and the class NMS on the same (loc, conf): the JAX
    ``detect``'s jitted post-processing against the port's program:
    equal labels, boxes and scores within 1e-6 (XLA fuses the jitted
    decode's products and softmax, a few ulps)."""
    rs = np.random.RandomState(4)
    priors = _priors()
    P = priors.shape[0]
    loc = (0.5 * rs.randn(3, P, 4)).astype(np.float32)
    conf = (2 * rs.randn(3, P, 4)).astype(np.float32)

    def jpost(lo, co):
        b = jbbox.decode_boxes(lo, jnp.asarray(priors))
        p = jax.nn.softmax(co, axis=-1)
        return jax.vmap(lambda bb, ss: jnms.batched_class_nms(
            bb, ss, iou_threshold=0.45, score_threshold=0.01,
            max_total=100))(b, p)

    want = jax.jit(jpost)(jnp.asarray(loc), jnp.asarray(conf))
    b = tbbox.decode_boxes(torch.from_numpy(loc), torch.from_numpy(priors))
    got = tnms.class_nms_batch(b, torch.softmax(torch.from_numpy(conf), -1),
                               0.45, 0.01, 50, 100)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-6)


def test_detector_registry_and_save_load(tmp_path):
    from analytics_zoo_tpu_torch.models.common import (_MODEL_REGISTRY,
                                                       ZooModel)

    _, tdet, _, _ = _detector_pair(3)
    assert _MODEL_REGISTRY["ObjectDetector"] is tod.ObjectDetector
    tdet.save_model(str(tmp_path / "od"))
    back = ZooModel.load_model(str(tmp_path / "od"), device="cpu")
    assert back.config() == json.loads(json.dumps(tdet.config()))
    for ln, leaves in export_params(back.model).items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(
                v, tdet.model.params()[ln][k].numpy())


# ---------------------------------------------------------------------------
# mAP and drawing


def _dets(rs, n_img, classes):
    out = []
    for _ in range(n_img):
        g = rs.randint(1, 4)
        gt = _boxes(rs, g)
        gl = rs.randint(1, classes + 1, g)
        d = rs.randint(0, 6)
        db = np.concatenate([gt + rs.randn(g, 4).astype(np.float32) * 0.03,
                             _boxes(rs, d)])
        ds = rs.rand(g + d).astype(np.float32)
        dl = np.concatenate([gl, rs.randint(1, classes + 1, d)])
        out.append((db, ds, dl, gt, gl))
    return out


@pytest.mark.parametrize("use_07", [False, True])
def test_mean_average_precision_matches_jax(use_07):
    rs = np.random.RandomState(8)
    jm = jeval.MeanAveragePrecision(5, 0.5, use_07)
    tm = tod.MeanAveragePrecision(5, 0.5, use_07)
    for args in _dets(rs, 20, 5):
        jm.add(*args)
        tm.add(*args)
    assert tm.per_class_ap() == jm.per_class_ap()
    assert tm.result() == jm.result()
    jv, tv = jeval.PascalVocEvaluator(), tod.PascalVocEvaluator()
    for args in _dets(rs, 30, 20):
        jv.add(*args)
        tv.add(*args)
    assert tv.summary() == jv.summary()
    rec, prec = np.array([0.5, 1.0]), np.array([1.0, 0.5])
    assert tod.average_precision(rec, prec, use_07) == \
        jeval.average_precision(rec, prec, use_07)


def test_draw_detections_matches_jax(tmp_path):
    jvis = importlib.import_module(
        "analytics_zoo_tpu.models.objectdetection.visualizer")
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (60, 80, 3)).astype(np.uint8)
    boxes, scores, labels = _boxes(rs, 3), rs.rand(3), np.array([1, 5, 9])
    names = ["bg"] + [f"c{i}" for i in range(10)]
    np.testing.assert_array_equal(
        tod.draw_detections(img, boxes, scores, labels, names),
        jvis.draw_detections(img, boxes, scores, labels, names))
    paths = tod.save_detection_images(str(tmp_path), [img],
                                      [(boxes, scores, labels)])
    assert len(paths) == 1 and (tmp_path / "detection_0.jpg").exists()
