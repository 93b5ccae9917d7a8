#!/usr/bin/env python3
"""Time block shapes of the flash-attention backward kernels on one GPU.

    python3 flash_bwd_shapes.py

``csrc/flash_attention_bwd.cu`` picks one block shape (warps, m-tiles of
16 rows per warp, rows per ring tile, bf16 A fragments held in registers)
per kernel, input type and padded width, in its ``DqShape`` and
``DkvShape`` tables.  This script builds variants of that source, the
i-th with the i-th candidate of every table entry written in (one
``nvcc`` each, started together, into ``build/flash_bwd_shapes/``), and
times ``flash_bwd_dq`` and ``flash_bwd_dkv`` of every variant at the
legs of ``chip_smoke.py`` that reach each entry, through the port's own
wrappers (``launch_bwd_dq`` / ``launch_bwd_dkv``) with the variant's
library loaded in place of the built one.  Each time is device time
(20 launches, 3 at L = 2048, captured in a CUDA graph and replayed,
CUDA events); each variant's gradients are held to the plain backward at
the smoke's tolerance, and its ptxas registers and spill bytes are
printed.  One JSON line per (entry, candidate), then the card.  Exits
non-zero without a CUDA device.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

SEED = 0
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_bwd_shapes"
# (table, type, DMAX) -> candidate shapes (warps, m-tiles, rows, hold);
# the first is the one the source carries
CANDIDATES = {
    ("DqShape", "float", 64): [(4, 2, 32, 0), (4, 1, 64, 0), (8, 1, 64, 0),
                               (4, 1, 32, 0), (8, 1, 32, 0), (2, 2, 32, 0),
                               (2, 1, 32, 0), (4, 2, 16, 0), (2, 2, 16, 0)],
    ("DkvShape", "float", 64): [(4, 2, 16, 0), (4, 1, 64, 0), (8, 1, 64, 0),
                                (8, 1, 32, 0), (2, 1, 32, 0), (4, 1, 16, 0),
                                (2, 1, 64, 0), (4, 1, 32, 0), (2, 2, 16, 0)],
    ("DqShape", "__nv_bfloat16", 64): [(4, 1, 64, 1), (8, 1, 64, 1),
                                       (4, 1, 64, 0), (4, 2, 32, 1),
                                       (4, 1, 32, 1), (2, 1, 64, 1),
                                       (2, 2, 32, 0)],
    ("DkvShape", "__nv_bfloat16", 64): [(4, 1, 64, 1), (8, 1, 64, 1),
                                        (4, 1, 64, 0), (4, 1, 32, 1),
                                        (2, 1, 64, 1), (2, 1, 32, 1),
                                        (4, 2, 16, 0), (2, 2, 16, 0)],
    ("DqShape", "float", 128): [(8, 1, 32, 0), (4, 1, 64, 0), (4, 1, 32, 0),
                                (8, 1, 16, 0), (2, 1, 32, 0)],
    ("DkvShape", "float", 128): [(8, 1, 32, 0), (4, 1, 32, 0), (4, 1, 16, 0),
                                 (8, 1, 16, 0)],
    ("DqShape", "__nv_bfloat16", 128): [(4, 1, 64, 0), (4, 1, 32, 1),
                                        (8, 1, 32, 1), (8, 1, 64, 0)],
    ("DkvShape", "__nv_bfloat16", 128): [(8, 1, 16, 0), (4, 1, 16, 0),
                                         (2, 1, 16, 0)],
}
# (type, DMAX) -> the smoke's legs (label, b, h, lq, lk, d, causal) there
LEGS = {
    ("float", 64): [("bert_train_l128", 32, 12, 128, 128, 64, False),
                    ("bench_l2048", 4, 8, 2048, 2048, 64, False)],
    ("__nv_bfloat16", 64): [("bert_l512_bf16", 8, 12, 512, 512, 64, False),
                            ("bert_train_l128_bf16", 32, 12, 128, 128, 64,
                             False)],
    ("float", 128): [("bench_l2048_d128_causal", 4, 8, 2048, 2048, 128,
                      True)],
    ("__nv_bfloat16", 128): [("ragged_d72_bf16", 8, 12, 256, 256, 72,
                              False)],
}


def variant_source(src, i):
    """The source with the i-th candidate (or the last one, for a shorter
    list) of every table entry."""
    for (table, ty, dmax), cands in CANDIDATES.items():
        w, m, rows, hold = cands[min(i, len(cands) - 1)]
        pattern = (rf"(struct {table}<{ty}, {dmax}> \{{\s*static constexpr "
                   rf"Cfg k = )\{{[^}}]*\}}")
        src, n = re.subn(pattern, rf"\g<1>{{{w}, {m}, {rows}, "
                         rf"{'true' if hold else 'false'}}}", src)
        if n != 1:
            raise RuntimeError(f"no {table}<{ty}, {dmax}> entry in the source")
    return src


def build_variants(build):
    csrc = ROOT / "analytics_zoo_tpu_torch" / "csrc"
    src = (csrc / "flash_attention_bwd.cu").read_text()
    count = max(len(c) for c in CANDIDATES.values())
    procs = []
    for i in range(count):
        d = OUT / str(i)
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "flash_attention_bwd.cu").write_text(variant_source(src, i))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "flash_attention_bwd.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    for i, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"variant {i} failed to build:\n{out}")
        logs.append(out)
    return logs


def ptxas(log, table, ty, dmax, cand):
    """Registers and spill bytes of the entry's instance in one log."""
    w, m, rows, hold = cand
    kernel = "flash_bwd_dq" if table == "DqShape" else "flash_bwd_dkv"
    mangled = (f"{kernel}I{'f' if ty == 'float' else '13__nv_bfloat16'}"
               f"Li{dmax}ELi{w}ELi{m}ELi{rows // 8}ELb{hold}E")
    at = log.find(mangled)
    if at < 0:
        return None
    part = log[at:at + 600]
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      part)
    regs = re.search(r"Used (\d+) registers", part)
    return {"registers": int(regs.group(1)),
            "spill_bytes": int(spill.group(1)) + int(spill.group(2))}


def leg_inputs(torch, fa, leg, ty):
    label, b, h, lq, lk, d, causal = leg
    dtype = torch.float32 if ty == "float" else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 5 * lq + lk + d)
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=g)
                   .to(dtype) for n in (lq, lk, lk, lq))
    out, lse = fa.flash_attention_lse_reference(q, k, v, causal)
    lse = lse.float()
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    ops = fa.bwd_operands(q, k, v, out, lse, do)
    return ops, ref, causal, d ** -0.5, dtype


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_shapes: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from chip_smoke import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    logs = build_variants(_build)
    libs = []
    for i in range(len(logs)):
        lib = ctypes.CDLL(str(OUT / str(i) / "lib.so"))
        for fn, (restype, argtypes) in fa._BWD_SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs.append(lib)
    inputs = {key: [leg_inputs(torch, fa, leg, key[0]) for leg in legs]
              for key, legs in LEGS.items()}
    for (table, ty, dmax), cands in CANDIDATES.items():
        launch = fa.launch_bwd_dq if table == "DqShape" else fa.launch_bwd_dkv
        for i, cand in enumerate(cands):
            _build._libs["flash_attention_bwd"] = libs[i]
            times, ok = {}, True
            for leg, (ops, ref, causal, scale, dtype) in zip(
                    LEGS[(ty, dmax)], inputs[(ty, dmax)]):
                got = launch(*ops, causal, scale)
                got = (got,) if table == "DqShape" else got
                want = ref[:1] if table == "DqShape" else ref[1:]
                tol = (8e-3, 8e-3) if dtype == torch.bfloat16 else (2e-5, 1e-4)
                ok = ok and all(bool(torch.all(
                    (x.float() - y.float()).abs()
                    <= tol[0] + tol[1] * y.float().abs()))
                    for x, y in zip(got, want))
                iters = 3 if leg[3] >= 2048 else 20
                times[leg[0]] = device_ms(
                    torch, lambda: launch(*ops, causal, scale), iters)
            print(json.dumps({
                "table": table, "type": ty, "dmax": dmax,
                "shape": {"warps": cand[0], "mtiles": cand[1],
                          "rows": cand[2], "hold": bool(cand[3])},
                "source_default": i == 0, "agrees_with_plain": ok,
                **(ptxas(logs[i], table, ty, dmax, cand) or {}),
                "ms": times}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print("nvidia-smi:", card)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
