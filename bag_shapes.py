#!/usr/bin/env python3
"""Time the embedding-bag forward kernel's knobs on one GPU, and measure
where the kernel and ``F.embedding_bag`` cross over in table size.

    python3 bag_shapes.py [--parent DIR]

``csrc/embedding_bag.cu`` carries the forward's knobs in one entry,
``kFwd = {depth, warps}``: piece loads in flight per lane and warps per
block.  This script builds a variant of that source per candidate in
``CANDIDATES`` (the first is the one the source carries; one ``nvcc``
each, started together, into ``build/bag_shapes/``) and times each
variant's forward at the legs of ``chip_smoke.py`` in f32 and bf16
(``LEGS``), through the port's own wrapper (``embedding_bag``) with the
variant's library loaded in place of the built one.  Times are device
time (launches captured in a CUDA graph and replayed, CUDA events):
``ms`` replays one launch on the same inputs, so the bench's 31.5 MB of
rows stay in the 50 MB L2; ``cold_ms`` (bench legs) cycles through 8
copies of the table, so each launch reads its rows from device memory.
Each variant's outputs are held to the plain version (f32 rtol 1e-5 /
atol 1e-5, bf16 one rounding of the table's type).  One JSON line per
(leg, candidate), then one per candidate with its ptxas registers and
spill bytes.  ``--parent DIR`` also times the f32 forward of an earlier
checkout unpacked at DIR beside the source's at the f32 legs, in turns.

Then, with the source's own knobs, one JSON line per table size V in
``GATE_VOCABS`` at the NCF serving shapes (N = 1, D = 20, B = 1 ... 256)
and at the bench shape (B = 4096, N = 32, D = 64): the kernel's time
beside ``F.embedding_bag``'s on the same inputs.  The JAX package routes
tables under 4096 rows away from its TPU kernel; these lines say whether
such a gate pays on this card.  Last, the card.  Exits non-zero without
a CUDA device.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

SEED = 0
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "bag_shapes"
# (depth, warps); the first is the source's
CANDIDATES = [(4, 8), (2, 8), (6, 8), (8, 8), (16, 8), (4, 4), (4, 16)]
KNOBS = ("depth", "warps")
PATTERN = r"(constexpr FwdShape kFwd = )\{[^}]*\}"
# (label, vocab, bags, nnz, dim, table type, zipf ids)
LEGS = [("bench_f32", 1 << 20, 4096, 32, 64, "float32", False),
        ("bench_bf16", 1 << 20, 4096, 32, 64, "bfloat16", False),
        ("bench_zipf_f32", 1 << 20, 4096, 32, 64, "float32", True),
        ("slice_b256", 6041, 256, 1, 20, "float32", False),
        ("slice_b1", 6041, 1, 1, 20, "float32", False)]
GATE_VOCABS = (1024, 3707, 4096, 6041, 65536, 1 << 20)
GATE_SHAPES = [(1, 1, 20), (8, 1, 20), (64, 1, 20), (256, 1, 20),
               (4096, 32, 64)]                      # (bags, nnz, dim)


def build_variants(build, parent=None):
    """One nvcc per candidate (and one for the parent's source), all
    started together; returns the logs in that order."""
    csrc = ROOT / "analytics_zoo_tpu_torch" / "csrc"
    src = (csrc / "embedding_bag.cu").read_text()
    sources = []
    for cand in CANDIDATES:
        text, n = re.subn(PATTERN, rf"\g<1>{{{', '.join(map(str, cand))}}}",
                          src)
        if n != 1:
            raise RuntimeError("no kFwd entry in the source")
        sources.append((csrc, text))
    if parent is not None:
        pdir = Path(parent) / "analytics_zoo_tpu_torch" / "csrc"
        sources.append((pdir, (pdir / "embedding_bag.cu").read_text()))
    procs = []
    for i, (hdrs, text) in enumerate(sources):
        d = OUT / str(i)
        d.mkdir(parents=True, exist_ok=True)
        for header in hdrs.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "embedding_bag.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "embedding_bag.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for i, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"variant {i} failed to build:\n{out}")
        logs.append(out)
    return logs


def ptxas(log):
    """Registers and spill bytes of each bag_fwd instance in one log."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
             "d": "f64"}
    out = {}
    for part in log.split("Compiling entry function")[1:]:
        m = re.search(r"bag_fwdI(f|d|13__nv_bfloat16|6__half)Li(\d+)E",
                      part)
        if not m:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        regs = re.search(r"Used (\d+) registers", part)
        out[f"{types[m.group(1)]}/{m.group(2)}"] = {
            "registers": int(regs.group(1)),
            "spill_bytes": int(spill.group(1)) + int(spill.group(2))}
    return out


def leg_inputs(torch, leg):
    from chip_smoke import zipf_ids

    _, vocab, bags, nnz, dim, dtype, zipf = leg
    g = torch.Generator(device="cuda").manual_seed(SEED + vocab + bags + nnz)
    table = (torch.randn(vocab, dim, device="cuda", generator=g) * 0.5).to(
        getattr(torch, dtype))
    ids = (zipf_ids(torch, g, vocab, (bags, nnz)) if zipf else
           torch.randint(0, vocab, (bags, nnz), device="cuda", generator=g,
                         dtype=torch.int32))
    return table, ids


def parent_fwd(torch, lib, table, ids):
    """The earlier f32-only forward (``zoo_embedding_bag_fwd_f32``), sum,
    no pad, on the current stream."""
    out = torch.empty(ids.shape[0], table.shape[1], device="cuda")
    rc = lib.zoo_embedding_bag_fwd_f32(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), table.shape[0],
        table.shape[1], ids.shape[0], ids.shape[1], 0, 0, 0,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"parent forward launch failed ({rc})")
    return out


def agrees(torch, eb, table, ids):
    out = eb.embedding_bag(table, ids, "sum", None)
    ref = eb.embedding_bag_reference(table, ids, "sum", None)
    torch.cuda.synchronize()
    err = (out.double() - ref.double()).abs()
    if table.dtype == torch.float32:
        return bool(torch.all(err <= 1e-5 + 1e-5 * ref.abs()))
    terms = eb.embedding_bag_reference(table.double().abs(), ids, "sum",
                                       None)
    return bool(torch.all(err <= 2.0 ** -7 * ref.double().abs()
                          + 1e-5 * terms))


def gate(torch, eb, device_ms):
    """Kernel and ``F.embedding_bag`` at each V of ``GATE_VOCABS``."""
    import torch.nn.functional as F

    for vocab in GATE_VOCABS:
        g = torch.Generator(device="cuda").manual_seed(SEED + vocab)
        for bags, nnz, dim in GATE_SHAPES:
            table = torch.randn(vocab, dim, device="cuda", generator=g)
            ids = torch.randint(0, vocab, (bags, nnz), device="cuda",
                                generator=g, dtype=torch.int32)
            lids = ids.long()
            iters = 20 if bags > 256 else 200
            kernel = device_ms(
                torch, lambda: eb.embedding_bag(table, ids, "sum", None),
                iters)
            library = device_ms(
                torch, lambda: F.embedding_bag(lids, table, mode="sum"),
                iters)
            print(json.dumps({"gate": True, "vocab": vocab, "bags": bags,
                              "nnz": nnz, "dim": dim, "ms": kernel,
                              "library_ms": library,
                              "library_over_kernel": library / kernel}),
                  flush=True)


def main() -> int:
    import argparse
    import ctypes

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an earlier checkout whose "
                    "csrc/embedding_bag.cu exports the f32-only "
                    "zoo_embedding_bag_fwd_f32: timed beside the source "
                    "at the f32 legs, in turns (parent, source, source, "
                    "parent)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bag_shapes: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb
    from chip_smoke import cold_cycle, device_ms

    logs = build_variants(_build, args.parent)
    libs = [ctypes.CDLL(str(OUT / str(i) / "lib.so"))
            for i in range(len(logs))]
    for lib in libs[:len(CANDIDATES)]:
        for fn, (restype, argtypes) in eb._SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
    if args.parent:
        old_fwd = libs[-1].zoo_embedding_bag_fwd_f32
        old_fwd.restype = ctypes.c_int
        old_fwd.argtypes = eb._SIGNATURES["zoo_embedding_bag_bwd_f32"][1]

    def fwd(table, ids):
        return lambda: eb.embedding_bag(table, ids, "sum", None)

    def timed(leg, table, ids, call):
        """(warm ms, cold ms or None): warm replays one launch on the same
        inputs, whose rows stay in L2; cold cycles through table copies."""
        iters = 20 if leg[2] > 256 else 200
        warm = device_ms(torch, call(table, ids), iters)
        if leg[2] <= 256:
            return warm, None
        return warm, device_ms(torch, cold_cycle(lambda i: call(
            copies[i], ids)), 24)

    for leg in LEGS:
        table, ids = leg_inputs(torch, leg)
        copies = ([table.clone() for _ in range(8)] if leg[2] > 256
                  else None)
        for i, cand in enumerate(CANDIDATES):
            _build._libs["embedding_bag"] = libs[i]
            ok = agrees(torch, eb, table, ids)
            warm, cold_ms = timed(leg, table, ids, fwd)
            print(json.dumps({"leg": leg[0], "knobs": dict(zip(KNOBS, cand)),
                              "source_default": i == 0,
                              "agrees_with_plain": ok, "ms": warm,
                              "cold_ms": cold_ms}), flush=True)
        if args.parent and leg[5] == "float32":
            lib = libs[-1]
            _build._libs["embedding_bag"] = libs[0]

            def old(t, i_):
                return lambda: parent_fwd(torch, lib, t, i_)
            turns = [timed(leg, table, ids, f) for f in (old, fwd, fwd, old)]
            print(json.dumps({"leg": leg[0], "compare": "parent, source, "
                              "source, parent", "ms": [t[0] for t in turns],
                              "cold_ms": [t[1] for t in turns]}), flush=True)
        del copies
        torch.cuda.empty_cache()
    for i, cand in enumerate(CANDIDATES):
        print(json.dumps({"knobs": dict(zip(KNOBS, cand)),
                          "ptxas": ptxas(logs[i])}), flush=True)
    _build._libs["embedding_bag"] = libs[0]          # the source's knobs
    gate(torch, eb, device_ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print("nvidia-smi:", card)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
