"""Standalone serving process for cross-process load legs.

Runs a full ``ClusterServing`` pipeline over a ``FileQueue`` spool so
real OS-process clients (``loadgen/client_main.py`` or the in-process
kill-leg client) can reach it from outside.  The model is built
DETERMINISTICALLY — seeded weights, seeded data, reset name scope,
fitted on ``--device`` (default ``cuda``) — so every process that runs
this module on the same device produces the identical fingerprint and a
successor process warm-starts from the predecessor's persistent compile
cache with zero live captures.

The process is a supervisor and a worker, as a pre-loading web server
is: the supervisor imports torch and the port once, never touches the
device, and forks the worker, which fits the model, serves and owns the
CUDA context.  When the worker dies by a signal (a crash, an OOM kill,
the kill leg's SIGKILL) the supervisor forks a new one after
``--restart-delay-s``, at most ``--max-restarts`` times: the successor is
a new process with a new CUDA context that warms its graphs from the
compile cache, without importing torch again.  SIGTERM or SIGINT to the
supervisor stops the worker cleanly (final status dump) and exits with
its code, 0; a worker whose supervisor is gone stops.

Where the installation ships no bytecode for torch (one installed under
``PYTHONDONTWRITEBYTECODE``), the compile-cache directory also keeps the
interpreter's bytecode (``<cache-dir>/bytecode``, ``sys.pycache_prefix``)
for every module the process imports after it starts, torch's included:
the first server compiles those sources once and a server started
afresh on the same cache loads their bytecode (the process writes
bytecode into that directory only).  The package's own ``__init__`` and
``loadgen``'s import no torch, so the prefix is in place before torch
loads.

The worker periodically dumps a status JSON (atomic replace) carrying
the warm-start proof (``compile_count``, ``warm_count``, cache event
counts) plus serving health, its ``pid``, its supervisor's, and how many
workers died before it (``restarts``, ``previous_exit``); the kill leg
reads it instead of scraping logs.

The JAX package's pod mode (``--model bag``, ``--pod-processes``,
``--mesh-replicas``, ``--local-devices``: a sharded-table model served
by a mesh replica across processes) waits for pod-scale serving; those
options raise ``NotImplementedError`` naming ROADMAP A9.

Usage::

    python -m analytics_zoo_tpu_torch.loadgen.server_main \\
        --queue-root /tmp/spool --cache-dir /tmp/cache \\
        --status-file /tmp/server.status.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, Optional


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--queue-root", required=True)
    p.add_argument("--queue-name", default="loadgen_stream")
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--status-file", required=True)
    p.add_argument("--device", default="cuda",
                   help="the device the model is fitted and served on")
    p.add_argument("--slo-p99-ms", type=float, default=1000.0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--decode-workers", type=int, default=2)
    p.add_argument("--max-batch-delay-ms", type=float, default=3.0)
    p.add_argument("--status-interval", type=int, default=2,
                   help="dump status every N ticks of ClusterServing's "
                        "health supervisor")
    p.add_argument("--autoscale", action="store_true")
    p.add_argument("--restart-delay-s", type=float, default=0.0,
                   help="seconds between a worker's death and its successor")
    p.add_argument("--max-restarts", type=int, default=8,
                   help="successors forked for workers dead by a signal")
    # the JAX package's pod mode (ROADMAP A9)
    p.add_argument("--model", default="dense", choices=["dense", "bag"])
    p.add_argument("--pod-processes", type=int, default=0)
    p.add_argument("--mesh-replicas", type=int, default=0)
    p.add_argument("--local-devices", type=int, default=0)
    return p.parse_args(argv)


def build_model(device="cuda"):
    """The deterministic two-layer Dense model shared by every loadgen
    server process: seeded context + seeded data => identical
    fingerprint in every process on one device."""
    import numpy as np

    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.nn import Sequential, reset_name_scope
    from analytics_zoo_tpu_torch.nn.layers.core import Activation, Dense
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    buckets = (1, 4, 8)
    in_dim, out_dim = 12, 4
    rs = np.random.RandomState(0)
    reset_name_scope()
    net = Sequential([Dense(16, input_shape=(in_dim,)),
                      Activation("relu"), Dense(out_dim)])
    net.compile(optimizer=Adam(1e-2), loss="mse", device=device)
    x = rs.randn(32, in_dim).astype(np.float32)
    net.fit(x, rs.randn(32, out_dim).astype(np.float32), batch_size=16,
            nb_epoch=1, verbose=False)
    return InferenceModel.from_keras_net(net, device=device,
                                         batch_buckets=buckets)


def cache_bytecode(cache_dir: str) -> Optional[str]:
    """Where the installation ships no bytecode for torch, write and
    read the bytecode of every module imported from now on under
    ``<cache_dir>/bytecode``; the directory, or None where it ships its
    own (a prefix would hide it)."""
    import importlib.util

    spec = importlib.util.find_spec("torch")
    if spec is None or spec.origin is None or os.path.exists(
            importlib.util.cache_from_source(spec.origin)):
        return None
    prefix = os.path.join(os.path.abspath(cache_dir), "bytecode")
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    return prefix


def _pod_options(args) -> list:
    return [opt for opt, on in (
        ("--model bag", args.model == "bag"),
        ("--pod-processes > 1", args.pod_processes > 1),
        ("--mesh-replicas > 0", args.mesh_replicas > 0),
        ("--local-devices", bool(args.local_devices))) if on]


def _dump_status(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def preload() -> None:
    """Import torch and what a worker runs, touching no device."""
    import numpy  # noqa: F401
    import torch  # noqa: F401

    from analytics_zoo_tpu_torch.deploy import (  # noqa: F401
        ClusterServing, InferenceModel, ServingConfig)
    from analytics_zoo_tpu_torch.deploy.serving import FileQueue  # noqa
    from analytics_zoo_tpu_torch.nn import Sequential  # noqa: F401
    from analytics_zoo_tpu_torch.nn.layers.core import Dense  # noqa: F401
    from analytics_zoo_tpu_torch.train.estimator import Estimator  # noqa
    from analytics_zoo_tpu_torch.train.optimizers import Adam  # noqa: F401


def serve(args, supervisor_pid: int, restarts: int,
          previous_exit: Optional[int], imports_s: float) -> int:
    """The worker: fit, serve, dump status until SIGTERM/SIGINT or its
    supervisor's end; 0."""
    t_start = time.time()
    from analytics_zoo_tpu_torch.deploy import ClusterServing, ServingConfig
    from analytics_zoo_tpu_torch.deploy.serving import FileQueue

    model = build_model(args.device)
    t_built = time.time()
    q = FileQueue(args.queue_root, name=args.queue_name)
    cfg = ServingConfig(
        batch_size=args.batch_size, poll_timeout_s=0.05,
        max_batch_delay_ms=args.max_batch_delay_ms,
        decode_workers=args.decode_workers,
        supervisor_interval_s=0.1,
        compile_cache_dir=args.cache_dir,
        slo_p99_ms={"default": args.slo_p99_ms},
        autoscale=args.autoscale, autoscale_interval_s=0.2,
        autoscale_cooldown_s=0.5)
    srv = ClusterServing({"default": model}, q, cfg).start()

    # Full bucket coverage through the REPLICA dispatch path before
    # declaring ready: the cold process stores every bucket signature
    # in the compile cache; a successor warms the whole set and serves
    # the storm with zero live captures.
    import numpy as np
    xcov = np.random.RandomState(1).randn(8, 12).astype(np.float32)
    rep = model.replica_forwards(n=1)[0]
    for b in model.batch_buckets:
        rep.harvest(rep.dispatch([xcov[:b]]))
    t_ready = time.time()
    # seconds to ready, by part: the supervisor's imports (once, before
    # the first worker), then this worker's own, from its fork
    startup = {"imports": imports_s,
               "build_and_fit": t_built - t_start,
               "serve_and_cover": t_ready - t_built,
               "worker_total": t_ready - t_start}

    def status_payload() -> Dict[str, Any]:
        h = srv.health()
        audit = srv.autoscale_audit()
        return {
            "ready": True,
            "pid": os.getpid(),
            "supervisor_pid": supervisor_pid,
            "restarts": restarts,
            "previous_exit": previous_exit,
            "t": time.time(),
            "ready_t": t_ready,
            "startup_s": startup,
            "device": str(model.device),
            "fingerprint": model.fingerprint(),
            "compile_count": int(model.compile_count),
            "warm_count": int(model.warm_count),
            "cache": h.get("compile_cache"),
            "records_served": h.get("records_served"),
            "queue": h.get("queue"),
            "models": h.get("models"),
            "mesh": h.get("mesh"),
            "pod_id": None,
            "autoscale_flaps": (audit or {}).get("flaps"),
        }

    def dump() -> None:
        try:
            _dump_status(args.status_file, status_payload())
        except Exception:           # status is best-effort telemetry
            pass

    dump()                          # the readiness barrier for callers
    srv.add_scenario_check("loadgen_status_dump", dump,
                           every=args.status_interval)

    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
    signal.signal(signal.SIGINT, lambda *_: stop_evt.set())
    while not stop_evt.wait(0.2) and os.getppid() == supervisor_pid:
        pass
    srv.stop()
    dump()                          # final post-traffic truth
    return 0


def supervise(args, imports_s: float) -> int:
    """Fork a worker and wait for it; fork a successor when it dies by a
    signal.  The exit code is the last worker's (128 + the signal for
    one killed past ``--max-restarts``)."""
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError("the supervisor initialised CUDA before its "
                           "fork; a forked worker could not use it")
    state: Dict[str, Any] = {"stop": False, "worker": None}

    def on_signal(signum, _frame):
        state["stop"] = True
        if state["worker"] is not None:
            os.kill(state["worker"], signal.SIGTERM)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    restarts, previous = 0, None
    while not state["stop"]:
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:                # the worker
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.signal(signal.SIGINT, signal.SIG_DFL)
            code = 1
            try:
                code = serve(args, os.getppid(), restarts, previous,
                             imports_s)
            except BaseException:
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        state["worker"] = pid
        if state["stop"]:           # a signal came during the fork
            os.kill(pid, signal.SIGTERM)
        code = os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1])
        state["worker"] = None
        if state["stop"] and code == -signal.SIGTERM:
            return 0                # stopped before its handler was set
        if code >= 0:
            return code
        if state["stop"] or restarts >= args.max_restarts:
            return 128 - code
        print(f"worker {pid} died by signal {-code}; forking its "
              f"successor", flush=True)
        restarts, previous = restarts + 1, code
        time.sleep(args.restart_delay_s)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    pod = _pod_options(args)
    if pod:
        raise NotImplementedError(
            f"{', '.join(pod)}: pod-scale serving (a sharded-table model, "
            f"a process group, mesh replicas) is not ported yet "
            f"(ROADMAP A9)")
    cache_bytecode(args.cache_dir)
    t0 = time.time()
    preload()
    return supervise(args, time.time() - t0)


if __name__ == "__main__":
    sys.exit(main())
