#!/usr/bin/env python3
"""Drive the PyTorch port (``analytics_zoo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``analytics_zoo_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together) and prints the
   card (``nvidia-smi --query-gpu=name,power.limit``).
2. Kernel phase: each kernel against its plain PyTorch version on the
   card, at the serving slice's shapes and at the repo's kernel-bench
   shapes; times the kernel, the plain version and, where one exists, a
   single PyTorch call computing the same function, beside the least
   time the card could take (``bound_ms``: bytes over 3.35 TB/s or f32
   operations over 67 TFLOP/s, the larger).  ``*_ms`` is device time
   (the calls captured in a CUDA graph and replayed, timed by CUDA
   events); ``*_call_ms`` is time per call from a host loop, launch
   cost included.
   Tolerances: embedding bag rtol 1e-5 / atol 1e-5 elementwise;
   dequantize-matmul max |err| <= 1e-4 * max |plain| (K-long f32 sums
   in another order).
3. Serving phase (the main path): NeuralCF at the MovieLens-1M width
   (6040 users, 3706 items, embeds 20, MLP 40/20/10, 5 classes) with
   seeded weights, served through ``InferenceModel`` in float32, int8
   and int4: single requests from several threads through a
   ``DynamicBatcher`` and one ``recommend_for_user`` over every item.
   Kernel launch counts are zeroed just before and read just after; the
   outputs are held against the same model run with every kernel call
   routed to its plain version on the card (``ops.dispatch.forced``),
   atol 1e-5.
4. Prints the kernels JSON line and, last, the ok line.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
BAG_SRC = "analytics_zoo_tpu_torch/csrc/embedding_bag.cu"
DQ_SRC = "analytics_zoo_tpu_torch/csrc/dequant_matmul.cu"
BAG_TPU = "analytics_zoo_tpu/ops/embedding_bag.py:98"
DQ_TPU = "analytics_zoo_tpu/ops/dequant_matmul.py:112"
USERS, ITEMS = 6040, 3706


def log(*a):
    print(*a, flush=True)


def call_ms(torch, fn, iters):
    """Milliseconds per call of ``fn`` from the host, by CUDA events over
    ``iters`` back-to-back calls after warm-up: the host's launch cost is
    in the number wherever it exceeds the device's work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device milliseconds per call of ``fn``: ``iters`` calls captured
    into one CUDA graph, replayed and timed by CUDA events, so the host's
    launch cost is out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timings(torch, fns, iters):
    """``{name}_ms`` (device, CUDA graph) and ``{name}_call_ms`` (host
    loop) for each named function; None where the function is None."""
    out = {}
    for name, fn in fns.items():
        key = "ms" if name == "kernel" else f"{name}_ms"
        out[key] = device_ms(torch, fn, iters) if fn else None
        out[key.replace("ms", "call_ms")] = (call_ms(torch, fn, iters)
                                             if fn else None)
    return out


def bound(nbytes, flops):
    """The least time the card could take: the larger of bytes over the
    memory rate and f32 operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops}


# ---------------------------------------------------------------------------
# kernel phase


def bag_case(torch, eb, label, vocab, dim, bags, nnz, combiner, pad_id,
             clip=False, iters=200):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + vocab + bags + nnz)
    table = torch.randn(vocab, dim, device="cuda", generator=g) * 0.5
    lo, hi = (-vocab // 8, vocab + vocab // 8) if clip else (0, vocab)
    ids = torch.randint(lo, hi, (bags, nnz), device="cuda", generator=g,
                        dtype=torch.int32)
    if pad_id is not None:
        ids[torch.rand(bags, nnz, device="cuda", generator=g) < 0.25] = pad_id
    out = eb.embedding_bag(table, ids, combiner, pad_id)
    ref = eb.embedding_bag_reference(table, ids, combiner, pad_id)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    ok = bool(torch.all(err <= 1e-5 + 1e-5 * ref.abs()))
    live = ids if pad_id is None else ids[ids != pad_id]
    rows = int(torch.unique(live.clamp(0, vocab - 1)).numel())
    nbytes = 4 * (rows * dim + bags * nnz + bags * dim)
    flops = int(live.numel()) * dim + bags * dim
    library = None
    if combiner != "sqrtn" and not clip:
        lids = ids.long()

        def library():
            return F.embedding_bag(lids, table, mode=combiner,
                                   padding_idx=pad_id)
    case = {
        "case": label, "vocab": vocab, "dim": dim, "bags": bags,
        "nnz": nnz, "combiner": combiner, "pad_id": pad_id, "clip": clip,
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max() / ref.abs().max().clamp_min(1e-30)),
        **bound(nbytes, flops),
        **timings(torch, {
            "kernel": lambda: eb.embedding_bag(table, ids, combiner, pad_id),
            "plain": lambda: eb.embedding_bag_reference(table, ids,
                                                        combiner, pad_id),
            "library": library}, iters),
    }
    if not ok:
        raise AssertionError(f"embedding_bag kernel disagrees with its "
                             f"plain version: {case}")
    return case


def dq_case(torch, dq, label, m, k, n, bits, iters=200):
    rs = np.random.RandomState(SEED + m + k + bits)
    w = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    q, scale = dq.quantize_weights(w, bits=bits)
    q, scale = q.cuda(), scale.cuda()
    g = torch.Generator(device="cuda").manual_seed(SEED + m + k)
    x = torch.randn(m, k, device="cuda", generator=g)
    out = dq.dequant_matmul(x, q, scale, bits=bits, rows=k)
    ref = dq.dequant_matmul_reference(x, q, scale, bits=bits, rows=k)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    top = float(ref.abs().max())
    w_f32 = (dq.unpack_int4(q, k) if bits == 4 else q).float() \
        * scale.reshape(1, -1)
    case = {
        "case": label, "m": m, "k": k, "n": n, "bits": bits,
        "max_abs_err": err, "max_rel_err": err / max(top, 1e-30),
        **bound(4 * m * k + q.numel() + 4 * n + 4 * m * n, 2 * m * n * k),
        **timings(torch, {
            "kernel": lambda: dq.dequant_matmul(x, q, scale, bits=bits,
                                                rows=k),
            "plain": lambda: dq.dequant_matmul_reference(
                x, q, scale, bits=bits, rows=k),
            "library": lambda: torch.matmul(x, w_f32)}, iters),
    }
    if not err <= 1e-4 * top:
        raise AssertionError(f"dequant_matmul kernel disagrees with its "
                             f"plain version: {case}")
    return case


def kernel_phase(torch, eb, dq):
    bag_cases, dq_cases = [], []
    for vocab in (USERS + 1, ITEMS + 1):
        for bags in (1, 8, 64, 256):
            bag_cases.append(bag_case(
                torch, eb, "slice", vocab, 20, bags, 1, "sum", None))
    for combiner in ("sum", "mean", "sqrtn"):
        for pad_id in (0, None):
            bag_cases.append(bag_case(
                torch, eb, "large", 1 << 20, 64, 4096, 32, combiner,
                pad_id, iters=20))
    bag_cases.append(bag_case(torch, eb, "large_clip", 1 << 20, 64, 4096,
                              32, "sum", None, clip=True, iters=20))
    for bits in (8, 4):
        for m in (1, 8, 64, 256):
            dq_cases.append(dq_case(torch, dq, "slice", m, 40, 40, bits))
        dq_cases.append(dq_case(torch, dq, "large", 1024, 4096, 4096, bits,
                                iters=10))
    dq_cases.append(dq_case(torch, dq, "large_odd_k", 1024, 4095, 4096, 4,
                            iters=10))
    for c in bag_cases + dq_cases:
        log("kernel_case", json.dumps(c))
    return bag_cases, dq_cases


# ---------------------------------------------------------------------------
# serving phase


def seeded_params(model, seed):
    """Random weights in the JAX package's tree layout (tables and dense
    kernels scaled so the softmax head is far from uniform)."""
    rs = np.random.RandomState(seed)
    return {layer: {leaf: (rs.randn(*v.shape) * 0.5).astype(np.float32)
                    for leaf, v in sub.items()}
            for layer, sub in model.params().items()}


def serve(ncf, im, weight_dtype, batcher_cls, users, items):
    """Answer single requests from six threads through a DynamicBatcher,
    then one recommend_for_user over every item.  Returns the answers,
    the recommendation and the request latencies in ms."""
    batcher = batcher_cls(im, max_batch=32, max_latency_ms=2.0)
    answers = [None] * len(users)
    lat_ms = [None] * len(users)
    errors = []

    def client(rows):
        for r in rows:
            t0 = time.perf_counter()
            try:
                answers[r] = batcher.predict([users[r:r + 1],
                                              items[r:r + 1]])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
            lat_ms[r] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client,
                                args=(range(t, len(users), 6),))
               for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    batcher.close()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"{weight_dtype} serving failed: {errors[:1]}")
    rec = ncf.recommend_for_user(1, np.arange(1, ITEMS + 1), max_items=10)
    return np.concatenate(answers), rec, lat_ms


def serving_phase(torch, eb, dq):
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.deploy import DynamicBatcher
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced

    ncf = NeuralCF(USERS, ITEMS, class_num=5, user_embed=20, item_embed=20,
                   hidden_layers=(40, 20, 10), mf_embed=20, device="cuda")
    load_jax_params(ncf.model, seeded_params(ncf.model, SEED))
    rs = np.random.RandomState(SEED + 1)
    users = rs.randint(1, USERS + 1, (48, 1)).astype(np.int32)
    items = rs.randint(1, ITEMS + 1, (48, 1)).astype(np.int32)
    all_items = np.arange(1, ITEMS + 1).reshape(-1, 1).astype(np.int32)
    results = {}

    # the main path's window: the launch counts start at 0 here, and the
    # routing counters are read as the window since this snapshot
    eb.LAUNCHES.reset()
    dq.LAUNCHES.reset()
    window = METRICS.snapshot()
    for wd in ("float32", "int8", "int4"):
        init_zoo_context()
        im = ncf.inference_model(weight_dtype=wd)
        n0 = (eb.LAUNCHES.value, dq.LAUNCHES.value)
        im.predict([users[:1], items[:1]])
        per_forward = (eb.LAUNCHES.value - n0[0], dq.LAUNCHES.value - n0[1])
        want = (4, 0 if wd == "float32" else 1)
        if per_forward != want:
            raise AssertionError(f"{wd}: one forward launched "
                                 f"{per_forward} (bag, dq), want {want}")
        t0 = time.perf_counter()
        answers, rec, lat = serve(ncf, im, wd, DynamicBatcher, users, items)
        wall = time.perf_counter() - t0
        got_scores = (im.predict([np.full_like(all_items, 1), all_items],
                                 batch_size=1024) * np.arange(1, 6)).sum(-1)
        n1 = (eb.LAUNCHES.value, dq.LAUNCHES.value)

        # the same model through the plain versions, on the card
        with forced(PATH_REFERENCE):
            ref = im.predict([users, items])
            ref_scores = (im.predict([np.full_like(all_items, 1), all_items],
                                     batch_size=1024)
                          * np.arange(1, 6)).sum(-1)
        if (eb.LAUNCHES.value, dq.LAUNCHES.value) != n1:
            raise AssertionError("a kernel launched on the plain path")

        if answers.shape != (48, 5) or not np.all(np.isfinite(answers)):
            raise AssertionError(f"{wd}: bad answers {answers.shape}")
        if not np.allclose(answers.sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"{wd}: rows do not sum to 1")
        err = float(np.abs(answers - ref).max())
        score_err = float(np.abs(got_scores - ref_scores).max())
        tenth = np.sort(ref_scores)[-10]
        rec_ok = (len(rec) == 10 and all(
            ref_scores[item - 1] >= tenth - 1e-5 for item, _ in rec))
        if err > 1e-5 or score_err > 1e-5 or not rec_ok:
            raise AssertionError(
                f"{wd}: kernels disagree with the plain path: answers "
                f"{err}, scores {score_err}, top-10 ok {rec_ok}")
        results[wd] = {
            "requests": len(lat), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "batcher_wall_s": wall, "max_abs_err_vs_plain": err,
            "launches_one_forward": list(per_forward),
            "weight_nbytes": im.weight_nbytes(),
            "top1_item": rec[0][0]}
        log("serving", wd, json.dumps(results[wd]))

    launches = {"embedding_bag": eb.LAUNCHES.value,
                "dequant_matmul": dq.LAUNCHES.value}
    counters = METRICS.delta(window)["counters"]
    routed = {k: counters.get(
        f'ops_kernel_selected_total{{kernel="{k}",path="cuda"}}', 0)
        for k in ("embedding_gather", "dequant_matmul")}
    log("serving_launches", json.dumps(launches),
        "ops_kernel_selected_total{path=cuda}", json.dumps(routed))
    if not all(routed.values()) or not all(launches.values()):
        raise AssertionError(f"main path missed a kernel: {launches} "
                             f"{routed}")
    return launches


# ---------------------------------------------------------------------------


def headline(cases, name, route, src, tpu, launches, pick):
    head = next(c for c in cases if pick(c))
    return {"name": name, "route": route, "source": src, "replaces": tpu,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {k: head[k] for k in head if k in (
                "vocab", "dim", "bags", "nnz", "m", "k", "n", "bits")},
            "cases": cases}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import dequant_matmul as dq
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("nvidia-smi:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    libs = _build.build()
    log("build_s", round(time.perf_counter() - t0, 3),
        json.dumps({k: str(v) for k, v in libs.items()}))
    for name, path in libs.items():
        log(f"ptxas[{name}]:", " | ".join(
            ln.strip() for ln in path.with_suffix(".log").read_text()
            .splitlines() if "registers" in ln or "spill" in ln))

    bag_cases, dq_cases = kernel_phase(torch, eb, dq)
    launches = serving_phase(torch, eb, dq)
    kernels = [
        headline(bag_cases, "embedding_bag_fwd", "cuda", BAG_SRC, BAG_TPU,
                 launches["embedding_bag"],
                 lambda c: c["vocab"] == USERS + 1 and c["bags"] == 256),
        headline(dq_cases, "dequant_matmul", "cuda", DQ_SRC, DQ_TPU,
                 launches["dequant_matmul"],
                 lambda c: c["m"] == 256 and c["bits"] == 8),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
