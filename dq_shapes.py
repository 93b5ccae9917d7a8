#!/usr/bin/env python3
"""Time tile shapes of the dequantize-matmul kernels on one GPU.

    python3 dq_shapes.py

``csrc/dequant_matmul.cu`` has two kernels: ``dq_wgmma`` for large
problems, whose shape per x type (warpgroups per block, ring stages,
slices in flight) is in its ``WgShape`` entries (f32, and the generic
one that bf16 and f16 take), and ``dq_mma`` for small problems and rows
off 16 bytes, whose tile (block M x N x K, warps along M and N, ring
stages) is ``kMmaShape``.  This
script builds variants of that source, the i-th with the i-th candidate
of every entry written in (one ``nvcc`` each, started together, into
``build/dq_shapes/``), and one more with the source's shapes and the
other number of bf16 pieces of f32 x (two in place of three,
``kPieces``), and times the kernel of every variant at the legs of
``chip_smoke.py`` that reach each entry, through the port's own wrapper
(``dequant_matmul``) with the variant's library loaded in place of the
built one.  Each time is device time (10 launches captured in a CUDA
graph and replayed, CUDA events); each variant's outputs are held to the
plain version at the smoke's tolerance and its error against the exact
product (f64) is printed, with its ptxas registers and spill bytes.  One
JSON line per (entry, candidate) and one per leg of the pieces variant,
then the card.  Exits non-zero without a CUDA device.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

SEED = 0
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "dq_shapes"
# entry -> candidate shapes; the first is the one the source carries.
# wg_*: (warpgroups, stages, in_flight); mma: (bm, bn, bk, wm, wn, stages)
CANDIDATES = {
    "wg_f32": [(4, 3, 0), (2, 3, 1), (2, 3, 0), (4, 2, 0)],
    "wg_16": [(4, 4, 1), (2, 4, 1), (4, 3, 1), (4, 5, 1), (4, 3, 0)],
    "mma": [(32, 32, 64, 2, 1, 2), (32, 32, 32, 2, 1, 2),
            (64, 64, 32, 2, 2, 2), (64, 64, 64, 2, 2, 2),
            (32, 64, 64, 1, 2, 2)],
}
PATTERNS = {
    "wg_f32": r"(struct WgShape<float> \{\s*static constexpr WgCfg k = )"
              r"\{[^}]*\}",
    "wg_16": r"(template <typename T>\s*struct WgShape \{\s*static "
             r"constexpr WgCfg k = )\{[^}]*\}",
    "mma": r"(constexpr Cfg kMmaShape = )\{[^}]*\}",
}
# entry -> the smoke's legs (label, m, k, n, bits, x type) there; the mma
# entry's N = 1000 leg is a large problem whose weight rows are off 16
# bytes
LEGS = {
    "wg_f32": [("bench_int8", 1024, 4096, 4096, 8, "float32"),
               ("bench_int4", 1024, 4096, 4096, 4, "float32"),
               ("bert_768_768", 4096, 768, 768, 8, "float32"),
               ("bert_768_3072", 4096, 768, 3072, 8, "float32"),
               ("bert_3072_768", 4096, 3072, 768, 8, "float32")],
    "wg_16": [("bench_int8_bf16", 1024, 4096, 4096, 8, "bfloat16"),
              ("bench_int4_bf16", 1024, 4096, 4096, 4, "bfloat16"),
              ("bench_int8_f16", 1024, 4096, 4096, 8, "float16"),
              ("bert_768_768_bf16", 4096, 768, 768, 8, "bfloat16"),
              ("bert_768_3072_bf16", 4096, 768, 3072, 8, "bfloat16"),
              ("bert_3072_768_bf16", 4096, 3072, 768, 8, "bfloat16")],
    "mma": [("slice_m1", 1, 40, 40, 8, "float32"),
            ("slice_m256", 256, 40, 40, 8, "float32"),
            ("slice_m256_int4", 256, 40, 40, 4, "float32"),
            ("mid_1024_768_768", 1024, 768, 768, 8, "float32"),
            ("n1000_2048_1024", 2048, 1024, 1000, 8, "float32")],
}


def variant_source(src, i):
    """The source with the i-th candidate (or the first, for a shorter
    list) of every entry."""
    for entry, cands in CANDIDATES.items():
        cand = cands[i] if i < len(cands) else cands[0]
        src, n = re.subn(PATTERNS[entry],
                         rf"\g<1>{{{', '.join(map(str, cand))}}}", src)
        if n != 1:
            raise RuntimeError(f"no shape entry {entry} in the source")
    return src


def pieces_source(src):
    """The source with the other number of bf16 pieces of f32 x (two or
    three)."""
    m = re.search(r"constexpr int kPieces = ([23]);", src)
    if not m:
        raise RuntimeError("no kPieces in the source")
    other = 5 - int(m.group(1))
    return src.replace(m.group(0), f"constexpr int kPieces = {other};"), \
        other


def build_variants(build):
    csrc = ROOT / "analytics_zoo_tpu_torch" / "csrc"
    src = (csrc / "dequant_matmul.cu").read_text()
    count = max(len(c) for c in CANDIDATES.values())
    sources = [variant_source(src, i) for i in range(count)]
    sources.append(pieces_source(src)[0])
    procs = []
    for i, text in enumerate(sources):
        d = OUT / str(i)
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "dequant_matmul.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "dequant_matmul.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for i, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"variant {i} failed to build:\n{out}")
        logs.append(out)
    return logs


def ptxas(log, entry, cand):
    """Registers and spill bytes of the entry's instances in one log."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    kernel = "dq_mma" if entry == "mma" else "dq_wgmma"
    want = {"wg_f32": ("f",), "wg_16": ("13__nv_bfloat16", "6__half"),
            "mma": tuple(types)}[entry]
    out = {}
    for part in log.split("Compiling entry function")[1:]:
        m = re.search(rf"{kernel}I(f|13__nv_bfloat16|6__half)Li(\d)E",
                      part)
        if not m or m.group(1) not in want:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        regs = re.search(r"Used (\d+) registers", part)
        out[f"{types[m.group(1)]}/int{m.group(2)}"] = {
            "registers": int(regs.group(1)),
            "spill_bytes": int(spill.group(1)) + int(spill.group(2))}
    return out


def leg_inputs(torch, dq, leg):
    label, m, k, n, bits, dtype = leg
    rs = np.random.RandomState(SEED + m + k + bits)
    w = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    q, scale = dq.quantize_weights(w, bits=bits)
    q, scale = q.cuda(), scale.cuda()
    g = torch.Generator(device="cuda").manual_seed(SEED + m + k)
    x = torch.randn(m, k, device="cuda", generator=g).to(
        getattr(torch, dtype))
    ref = dq.dequant_matmul_reference(x, q, scale, bits=bits, rows=k)
    wq = (dq.unpack_int4(q, k) if bits == 4 else q).double()
    exact = (x.double() @ wq) * scale.double().reshape(1, -1)
    return x, q, scale, bits, k, ref, exact


def run_leg(torch, dq, device_ms, inp):
    x, q, scale, bits, k, ref, exact = inp
    out = dq.dequant_matmul(x, q, scale, bits=bits, rows=k)
    torch.cuda.synchronize()
    d, top = (out.double() - ref.double()).abs(), float(ref.abs().max())
    if x.dtype == torch.float32:
        ok = float(d.max()) <= 1e-4 * top
    else:
        rtol = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -10
        ok = bool(torch.all(d <= rtol * ref.double().abs() + 1e-5 * top))
    exact_err = float((out.double() - exact).abs().max()
                      / exact.abs().max())
    ms = device_ms(torch, lambda: dq.dequant_matmul(x, q, scale, bits=bits,
                                                    rows=k), 10)
    return ms, ok, exact_err


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("dq_shapes: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import dequant_matmul as dq
    from chip_smoke import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    logs = build_variants(_build)
    libs = []
    for i in range(len(logs)):
        lib = ctypes.CDLL(str(OUT / str(i) / "lib.so"))
        for fn, (restype, argtypes) in dq._SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs.append(lib)
    inputs = {entry: [leg_inputs(torch, dq, leg) for leg in legs]
              for entry, legs in LEGS.items()}
    for entry, cands in CANDIDATES.items():
        for i, cand in enumerate(cands):
            _build._libs["dequant_matmul"] = libs[i]
            times, errs, ok = {}, {}, True
            for leg, inp in zip(LEGS[entry], inputs[entry]):
                ms, leg_ok, exact_err = run_leg(torch, dq, device_ms, inp)
                times[leg[0]], errs[leg[0]] = ms, exact_err
                ok = ok and leg_ok
            names = (("bm", "bn", "bk", "wm", "wn", "stages")
                     if entry == "mma" else
                     ("warpgroups", "stages", "in_flight"))
            print(json.dumps({
                "entry": entry, "shape": dict(zip(names, cand)),
                "source_default": i == 0, "agrees_with_plain": ok,
                "ptxas": ptxas(logs[i], entry, cand), "ms": times,
                "max_rel_err_vs_exact": errs}), flush=True)
    # f32 x as the other number of bf16 pieces, at the source's shapes
    csrc = ROOT / "analytics_zoo_tpu_torch" / "csrc" / "dequant_matmul.cu"
    other = pieces_source(csrc.read_text())[1]
    for pieces, lib in ((5 - other, libs[0]), (other, libs[-1])):
        _build._libs["dequant_matmul"] = lib
        for leg, inp in zip(LEGS["wg_f32"], inputs["wg_f32"]):
            ms, ok, exact_err = run_leg(torch, dq, device_ms, inp)
            print(json.dumps({"pieces": pieces, "leg": leg[0], "ms": ms,
                              "agrees_with_plain": ok,
                              "max_rel_err_vs_exact": exact_err}),
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print("nvidia-smi:", card)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
