"""Standalone open-loop client process.

One OS process = one open-loop client: it builds its schedule from
``(shape, seed)``, attaches to the shared ``FileQueue`` spool a
``server_main`` process is serving, fires the schedule, drains, and
writes a JSON summary to ``--outfile`` for the harness to fold.  Several
of these can drive one server at once, so the offered load really
crosses process boundaries — no shared GIL, no shared clock, no shared
rng.  A client never touches CUDA.

Usage::

    python -m analytics_zoo_tpu_torch.loadgen.client_main \
        --queue-root /tmp/spool --outfile /tmp/c0.json \
        --shape steady --qps 40 --duration-s 8 --seed 3
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--queue-root", required=True)
    p.add_argument("--queue-name", default="loadgen_stream")
    p.add_argument("--outfile", required=True)
    p.add_argument("--leg", default="steady")
    p.add_argument("--shape", default="steady",
                   choices=("steady", "ramp", "burst"))
    p.add_argument("--qps", type=float, default=20.0)
    p.add_argument("--high-qps", type=float, default=None,
                   help="ramp peak / burst rate (defaults to 5x --qps)")
    p.add_argument("--burst-at-s", type=float, default=3.0)
    p.add_argument("--burst-dur-s", type=float, default=2.0)
    p.add_argument("--duration-s", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", default="default")
    p.add_argument("--in-dim", type=int, default=12)
    p.add_argument("--ttl-ms", type=float, default=None)
    p.add_argument("--uri-prefix", default=None)
    p.add_argument("--drain-timeout-s", type=float, default=60.0)
    p.add_argument("--window-s", type=float, default=1.0)
    return p.parse_args(argv)


def build_shape(args):
    from analytics_zoo_tpu_torch.loadgen.arrivals import (DiurnalRamp,
                                                          FlashCrowd, Steady)
    high = args.high_qps if args.high_qps is not None else 5.0 * args.qps
    if args.shape == "ramp":
        return DiurnalRamp(args.qps, high, period_s=args.duration_s)
    if args.shape == "burst":
        return FlashCrowd(args.qps, high, args.burst_at_s,
                          args.burst_dur_s)
    return Steady(args.qps)


def main(argv=None) -> int:
    args = parse_args(argv)
    from analytics_zoo_tpu_torch.deploy.serving import (FileQueue, InputQueue,
                                                        OutputQueue)
    from analytics_zoo_tpu_torch.loadgen import slo as slo_mod
    from analytics_zoo_tpu_torch.loadgen.arrivals import arrival_times
    from analytics_zoo_tpu_torch.loadgen.client import OpenLoopClient
    from analytics_zoo_tpu_torch.loadgen.payloads import (PayloadClass,
                                                          PayloadMix)

    q = FileQueue(args.queue_root, name=args.queue_name)
    schedule = arrival_times(build_shape(args), args.duration_s,
                             args.seed)
    mix = PayloadMix([PayloadClass(args.model, shape=(args.in_dim,),
                                   dtype="float32", ttl_ms=args.ttl_ms)])
    client = OpenLoopClient(InputQueue(q), OutputQueue(q), schedule, mix,
                            leg=args.leg, seed=args.seed,
                            uri_prefix=args.uri_prefix,
                            query_timeout_s=5.0)
    records = client.run(drain_timeout_s=args.drain_timeout_s)

    outcomes = slo_mod.outcome_counts(records)
    oks = [r.latency_s * 1e3 for r in records
           if r.outcome == "ok" and r.latency_s is not None]
    lags = [r.lag_s * 1e3 for r in records if r.lag_s is not None]
    windows = slo_mod.fold_windows(records, args.window_s,
                                   args.duration_s)
    summary = {
        "leg": args.leg, "shape": args.shape, "seed": args.seed,
        "qps_target": args.qps, "duration_s": args.duration_s,
        "scheduled": len(schedule),
        "offered": len(records),
        "sent": sum(1 for r in records if r.t_sent is not None),
        "answered_ok": outcomes.get("ok", 0),
        "outcomes": outcomes,
        "open_loop_drops": client.open_loop_drops,
        "latency_p50_ms": slo_mod.percentile(oks, 50),
        "latency_p99_ms": slo_mod.percentile(oks, 99),
        "send_lag_p99_ms": slo_mod.percentile(lags, 99),
        "windows": windows,
    }
    with open(args.outfile, "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
