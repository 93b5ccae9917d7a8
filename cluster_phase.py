"""Phase 9 of ``chip_smoke.py`` (ClusterServing) alone, on the card: one
compact JSON line of its numbers per queue (records/s, each model's
device-stage and e2e p50, the card's busy share from the events each
bucket graph records, sync-fallback batches, the answers' largest
error against the plain versions).

    python3 cluster_phase.py NAME

``NAME`` labels the line.  To compare two checkouts on one card, unpack
the other one beside this one and run the script from each in turn in
one call (parent, change, change, parent): the host's pace differs from
call to call.
"""
import json
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import dequant_matmul as dq
from analytics_zoo_tpu_torch.ops import embedding_bag as eb
from analytics_zoo_tpu_torch.ops import flash_attention as fa


def main(name: str) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    _build.build()
    captured = []
    cs.log = lambda tag, line: captured.append((tag, line))
    t0 = time.time()
    cs.cluster_serving_phase(torch, eb, dq, fa, card)
    full = json.loads(dict(captured)["cluster_serving"])
    out = {"tree": name, "card": card, "phase_s": time.time() - t0}
    for r in full["runs"]:
        s = r["stages_by_model"]
        out[r["backend"]] = {
            "records_per_s": r["client"]["records_per_s"],
            "device_p50_ms": {m: s[m]["device"]["p50_ms"] for m in s},
            "device_batches": {m: s[m]["device"]["count"] for m in s},
            "e2e_p50_ms": {m: s[m]["e2e"]["p50_ms"] for m in s},
            "busy_run": r["device_busy_run"]["device_busy_share"],
            "busy_s_by_model": r["device_busy_run"]["device_s_by_model"],
            "busy_1s": (r["device_busy_one_second"] or {}).get(
                "device_busy_share"),
            "fallback": r["counters"]["sync_fallback_batches"],
            "max_abs_err": {m: c["max_abs_err"]
                            for m, c in r["checks"].items()}}
    print("cluster_phase", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
