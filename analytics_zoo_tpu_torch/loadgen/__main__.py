"""Report generator: run every load leg and write the SLO artifact.

::

    python -m analytics_zoo_tpu_torch.loadgen \\
        --out loadgen_report.json [--workdir DIR] [--quick] [--device cpu]

The artifact's schema is the JAX package's (docs/LOADGEN.md).  The kill
leg's server processes serve on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="loadgen_report.json")
    p.add_argument("--workdir", default=None,
                   help="scratch dir for the kill leg's spool/cache "
                        "(a fresh tempdir when omitted)")
    p.add_argument("--quick", action="store_true",
                   help="halved durations for smoke runs")
    p.add_argument("--device", default="cuda",
                   help="the device the kill leg's servers run on")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch.loadgen.harness import default_report
    from analytics_zoo_tpu_torch.loadgen.slo import write_artifact

    workdir = args.workdir or tempfile.mkdtemp(prefix="loadgen-")
    t0 = time.monotonic()
    report = default_report(workdir, quick=args.quick, device=args.device)
    report["run_metadata"]["wall_s"] = round(time.monotonic() - t0, 2)
    write_artifact(args.out, report)
    print(f"wrote {os.path.abspath(args.out)} "
          f"({report['run_metadata']['wall_s']}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
