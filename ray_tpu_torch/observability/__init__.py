"""Fleet observability plane — cross-replica time ledger, Perfetto request
timelines, and SLO burn-rate monitoring.

The per-engine planes (metrics registry, flight recorder, trace buffer)
are process-local; this package is the layer above them, as in the
reference package: the ledger attributes fleet wall-clock to
host-schedule / device / commit / host-gap per replica (the MFU-style
accounting that ranks where a replica's time goes on the card), the
collector diff-merges histogram snapshots and flight rings into one
fleet view, the SLO monitor turns live request histograms into
multi-window burn rates, and the Perfetto exporter stitches one sampled
request's cross-actor spans into a single loadable timeline.

Everything here reads host state only (Python values the engines return);
nothing launches work on the card or holds a tensor.
"""

from ray_tpu_torch.observability.collector import (  # noqa: F401
    FleetCollector,
    fleet_snapshot,
)
from ray_tpu_torch.observability.ledger import (  # noqa: F401
    LEDGER_COLUMNS,
    fleet_ledger,
    mfu_estimate,
    replica_ledger,
    step_ledger,
)
from ray_tpu_torch.observability.perfetto import (  # noqa: F401
    perfetto_trace,
    write_perfetto_trace,
)
from ray_tpu_torch.observability.slo_monitor import (  # noqa: F401
    SLOBurnRateMonitor,
)
