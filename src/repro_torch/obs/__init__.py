"""The compute ledger and the measured-cost pass, with the metrics they and
the serving engine publish (the port's part of the JAX package's ``obs``;
spans, events, the timeline, Prometheus text and the flight recorder are
not ported)."""
from repro_torch.obs.ledger import (RunLedger, active_ledger, attach_ledger,
                                    detach_ledger, normalize_records,
                                    read_ledger, savings_report)
from repro_torch.obs.metrics import (RATE_BUCKETS, counter_group, gauge,
                                     histogram)

__all__ = ["RunLedger", "active_ledger", "attach_ledger", "detach_ledger",
           "normalize_records", "read_ledger", "savings_report", "gauge",
           "histogram", "counter_group", "RATE_BUCKETS"]
