"""Fleet-scale load harness: production-shaped open-loop traffic with an
SLO fold (docs/LOADGEN.md).  The JAX package's ``loadgen/``, ported: the
numpy parts are copies that give the same schedules, payloads and folds
byte for byte, and the legs drive the port's ``ClusterServing``.

- ``arrivals``    — Poisson schedules over composable traffic shapes
  (steady / diurnal ramp / flash crowd), thinning-sampled so the
  offered schedule is deterministic in ``(shape, duration, seed)``.
- ``payloads``    — payload distributions over model/shape/dtype and
  the two-model shifting mix.
- ``client``      — the open-loop client: sends on the schedule no
  matter how slow the server is (no coordinated omission), latency is
  measured schedule-to-answer.
- ``adversarial`` — slow clients holding result leases, malformed
  floods, expired-TTL floods.
- ``slo``         — fold per-request records into windows; sustained
  QPS at SLO, shed fraction by model, recovery-time-to-SLO; the JSON
  artifact writer.
- ``harness``     — scenario legs wiring all of the above to a live
  ``ClusterServing`` (including the SIGKILL-mid-storm warm-restart
  leg over real OS processes, served on the card by default).
"""

from analytics_zoo_tpu_torch.loadgen.arrivals import (  # noqa: F401
    DiurnalRamp, FlashCrowd, ShapeSum, Steady, arrival_times,
    interarrivals)
from analytics_zoo_tpu_torch.loadgen.client import (  # noqa: F401
    OpenLoopClient, RequestRecord)
from analytics_zoo_tpu_torch.loadgen.payloads import (  # noqa: F401
    PayloadClass, PayloadMix, saturated_images)
from analytics_zoo_tpu_torch.loadgen.slo import (  # noqa: F401
    fold_windows, percentile, recovery_time_to_slo,
    shed_fraction_by_model, sustained_qps_at_slo, write_artifact)
