#!/usr/bin/env python3
"""Time the embedding-bag backward (kernel 2) of this checkout against an
earlier checkout's on one GPU, in turns, and break this one's time down
by device kernel.

    python3 bag_bwd_compare.py --parent DIR [--iters N]

DIR holds an earlier checkout's ``analytics_zoo_tpu_torch/csrc`` (for
example ``git archive <commit> analytics_zoo_tpu_torch/csrc | tar -x -C
build/parent``).  Its ``embedding_bag.cu`` is built with this checkout's
``nvcc`` flags into ``build/bag_bwd_compare/`` and called through its own
C entry: the single-launch entry of the atomic kernel
(``zoo_embedding_bag_bwd_f32``, a zero-fill and a scatter), or this
checkout's (``zoo_embedding_bag_bwd``) through the port's wrapper.  Both
run at the legs of ``chip_smoke.py``'s kernel phase (``LEGS``), on the
same ids and gradient, timed the smoke's way (``chip_smoke.device_ms``:
a CUDA graph of ``iters`` calls, CUDA events) in the order parent,
change, change, parent.  Each leg's change is also held to the plain
version (atol 1e-6 + 1e-5 of the summed magnitude) and its two calls to
the same bits, and profiled once (``torch.profiler``: device
milliseconds per call by kernel).  One JSON line per leg, then the card.
Exits non-zero without a CUDA device.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "bag_bwd_compare"
SEED = 0
# (label, vocab, dim, bags, nnz, ids: "uniform" / "zipf" / "text", iters)
LEGS = [("slice", 6041, 20, 2048, 1, "uniform", 200),
        ("wide_tower", 2000, 2, 8192, 2, "uniform", 200),
        ("wnd_deep_column", 5001, 64, 8192, 1, "uniform", 200),
        ("session_gather", 37484, 100, 10240, 1, "uniform", 200),
        ("text_embed_front_padded", 5001, 200, 64000, 1, "text", 50),
        ("text_embed_zipf", 5001, 200, 64000, 1, "zipf", 50),
        ("large", 1 << 20, 64, 4096, 32, "uniform", 20),
        ("large_zipf", 1 << 20, 64, 4096, 32, "zipf", 20),
        ("past_2^31", (1 << 25) + 3, 64, 4096, 32, "uniform", 6)]


def device_ms_by_kernel(torch, cs, fn, calls):
    """Device milliseconds per call of ``fn`` by kernel (and memset), from
    ``torch.profiler`` over ``calls`` eager calls after a warm-up."""
    import re

    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"bag_bwd_[a-z]+|Memset", e.key)
        if name and cs.device_us(e) > 0:
            out[name.group(0)] = (out.get(name.group(0), 0.0)
                                  + cs.device_us(e) / calls / 1e3)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bag_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--iters", type=int, default=0)
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    src = Path(args.parent) / "analytics_zoo_tpu_torch/csrc/embedding_bag.cu"
    so = OUT / "parent.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
        return 1
    old = ctypes.CDLL(str(so))
    old.zoo_embedding_bag_bwd_f32.restype = ctypes.c_int
    old.zoo_embedding_bag_bwd_f32.argtypes = eb._ARGS + eb._STREAM
    _build.build(["embedding_bag"])

    def parent_bwd(vocab, ids, g):
        dtab = torch.empty((vocab, g.shape[1]), device="cuda")
        rc = old.zoo_embedding_bag_bwd_f32(
            ids.data_ptr(), g.data_ptr(), dtab.data_ptr(), vocab,
            g.shape[1], ids.shape[0], ids.shape[1], 0, 0, 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent backward failed: {rc}")
        return dtab

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for label, vocab, dim, bags, nnz, kind, iters in LEGS:
        iters = args.iters or iters
        if kind == "text":
            ids = torch.from_numpy(cs.text_corpus(128, cs.SEED + 51)[0]
                                   ).reshape(-1, 1).cuda()
        elif kind == "zipf":
            ids = cs.zipf_ids(torch, gen, vocab, (bags, nnz))
        else:
            ids = torch.randint(0, vocab, (bags, nnz), device="cuda",
                                generator=gen, dtype=torch.int32)
        g = torch.randn(bags, dim, device="cuda", generator=gen)

        def change():
            return eb.embedding_bag_backward(vocab, ids, g, "sum", None)

        def parent():
            return parent_bwd(vocab, ids, g)

        got = change()
        same = bool(torch.equal(change(), got))
        ref = eb.embedding_bag_backward_reference(vocab, ids, g, "sum", None)
        mass = eb.embedding_bag_backward_reference(vocab, ids, g.abs(),
                                                   "sum", None)
        ok = bool(((got - ref).abs() <= 1e-6 + 1e-5 * mass).all())
        del got, ref, mass
        torch.cuda.empty_cache()
        turns = []
        for who in ("parent", "change", "change", "parent"):
            turns.append([who, cs.device_ms(
                torch, parent if who == "parent" else change, iters)])
            torch.cuda.empty_cache()
        by_kernel = device_ms_by_kernel(torch, cs, change,
                                        2 if vocab > 1 << 24 else 10)
        plan = eb.bag_bwd_plan(vocab, dim, bags, nnz)
        print(json.dumps({
            "leg": label, "vocab": vocab, "dim": dim, "bags": bags,
            "nnz": nnz, "ids": kind, "iters": iters, "route": plan.route,
            "device_ops": plan.device_ops, "within_tolerance": ok,
            "bit_equal_repeat": same, "turns_ms": turns,
            "change_ms_per_device_kernel": by_kernel, "card": card}),
            flush=True)
        if not (ok and same):
            return 1
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
