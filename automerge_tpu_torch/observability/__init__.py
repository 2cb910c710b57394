"""Metrics, tracing, and forensics for the fleet engine.

The reference has no tracing/profiling/metrics at all (SURVEY.md §5 — its
only observability is patchCallback/Observable/getHistory, which this
framework also provides). A batched device engine needs more: you cannot
see a device dispatch from a patchCallback, and when one document in a
10k-doc fused batch is quarantined you need to know which one, in what
phase, and what happened around it. Four layers, one package:

- **Counters & roll-ups** (metrics.py): per-fleet monotonic `Metrics`,
  `timed` phase seconds, `register_dispatch_source`/`dispatch_counts`
  and `register_health_source`/`health_counts` system-wide roll-ups,
  and the `trace` wrapper around `torch.profiler`.
- **Host-phase spans** (spans.py): `span(name, **attrs)` — near-zero
  overhead while disabled, a bounded ring while enabled — instrumented
  at every hot seam (native parse, SHA, turbo gate/stage/commit, device
  dispatch, mirror rebuild, actor remap, journal append/commit/fsync,
  checkpoint, compaction, recovery replay, Bloom build/probe, sync
  encode/decode). `export_chrome_trace` writes Perfetto-loadable JSON
  that lines up beside a `trace()` device capture.
- **Latency histograms** (hist.py): fixed log2-bucket `Histogram`s with
  p50/p95/p99 summaries and bucketwise `snapshot()`/`delta()` — batch
  apply latency, fsync latency, sync round-trip, per-doc change bytes,
  recovery per-doc replay time.
- **Flight recorder** (recorder.py): an always-on bounded ring of
  structured health events (doc ids, durable ids, typed error names,
  change-byte digests) that dumps a JSON forensic report automatically
  on quarantine, recovery truncation/rot, and SyncOverflow — each dump
  also carrying the span ring's tail, so a traced run's report includes
  the phase timeline around the fault without span churn ever evicting
  the fault events themselves.

And the tenant telemetry plane on top (ISSUE-10):

- **SLO accounting** (slo.py): per-(tenant, kind) SLIs — latency,
  availability split by rejection class, subscription freshness — as
  rolling deltas over the histograms/counters above, with multi-window
  burn-rate alerting (hysteretic, edge-triggered, flight-recorded).
- **Exposition** (export.py): Prometheus text format over every
  counter, histogram, and SLO gauge, served by the stdlib-only
  `MetricsExporter` (`AUTOMERGE_TPU_METRICS_PORT`; unset = fully off)
  or written atomically to a snapshot file.
- **Trace stitching** (tracecontext.py): `TraceContext` minted per
  service request, span `links` on the fused batches, and an opt-in
  wire envelope so two peers' sync span trees share one trace id —
  merged by `tools/obs_report.py --stitch`.

`enable()`/`disable()` flip spans + histograms together (the switch the
bench's <=2% overhead budget is measured across); the flight recorder's
event ring and the SLO accounting stay on either way (the latter has
its own switch: `DocService(slo=False)`). `tools/obs_report.py` renders
a phase-attribution report from an exported trace or a forensic dump.
"""

from . import hist as _hist
from . import recorder as _recorder
from . import spans as _spans
from .export import (MetricsExporter, maybe_start_exporter,
                     render_prometheus)
from .hist import (Histogram, histogram, histogram_delta,
                   histogram_snapshot, record_value)
from .metrics import (Counters, Metrics, counts_delta, dispatch_counts,
                      dispatch_delta, health_counts, health_delta,
                      register_dispatch_source, register_health_source,
                      timed, trace)
from .perf import (PerfBaselines, baselines, disable_observatory,
                   dump_ledger, enable_observatory, instrument_kernel,
                   kernel_report, kernel_snapshot, perf_stats,
                   register_mem_source, sample_watermarks,
                   watermark_snapshot)
from .recorder import (configure as configure_flight_recorder, clear_events,
                       dump_flight_record, flight_stats, last_flight_record,
                       recent_events, record_event)
from .slo import SloPolicy, SloRegistry, outcome_class, slo_stats
from .spans import (clear as clear_spans, export_chrome_trace, iter_spans,
                    record_span, span, span_count, span_seq, spanned,
                    spans_dropped)
from .tracecontext import TraceContext

__all__ = [
    'Metrics', 'timed', 'trace',
    'register_dispatch_source', 'dispatch_counts',
    'register_health_source', 'health_counts',
    'counts_delta', 'health_delta', 'dispatch_delta',
    'span', 'span_seq', 'spanned', 'iter_spans', 'clear_spans',
    'span_count', 'export_chrome_trace', 'record_span', 'spans_dropped',
    'Histogram', 'histogram', 'record_value', 'histogram_snapshot',
    'histogram_delta',
    'record_event', 'recent_events', 'clear_events', 'dump_flight_record',
    'last_flight_record', 'flight_stats', 'configure_flight_recorder',
    'SloPolicy', 'SloRegistry', 'outcome_class', 'slo_stats',
    'MetricsExporter', 'maybe_start_exporter', 'render_prometheus',
    'TraceContext', 'Counters',
    'PerfBaselines', 'baselines', 'enable_observatory',
    'disable_observatory', 'instrument_kernel', 'kernel_snapshot',
    'kernel_report', 'dump_ledger', 'register_mem_source',
    'sample_watermarks', 'watermark_snapshot', 'perf_stats',
    'enable', 'disable', 'enabled',
]


def enable(span_capacity=4096):
    """Turn span recording AND histogram recording on (the observe
    switch; off by default — the hot seams' instrumentation cost while
    off is one flag check per seam)."""
    _spans.enable(capacity=span_capacity)
    _hist.enable()


def disable():
    """Turn spans + histograms off (rings/registries are retained for
    inspection until the next enable()/reset)."""
    _spans.disable()
    _hist.disable()


def enabled():
    return _spans.on() or _hist.on()
