"""Prometheus exposition: every counter, histogram, and SLO gauge on a
machine-scrapable surface.

``render_prometheus()`` renders text-format 0.0.4 exposition from an
ATOMIC snapshot — every value is copied into plain data first, and a
histogram's ``_count`` is derived from the very bucket vector the
``_bucket`` lines are printed from, so a scrape racing a service tick
can never show cumulative buckets that disagree with their own count
(the classic torn-read artifact of rendering live state field by
field). What lands on the page:

- the health-counter roll-up (``automerge_tpu_health_total``) and the
  device-dispatch roll-up (``automerge_tpu_dispatch_total``),
- every registered histogram as cumulative buckets + sum + count
  (log2 bucket upper bounds as ``le`` labels, trailing empty buckets
  collapsed into ``+Inf``),
- the span ring's truncation state (``automerge_tpu_spans_dropped``),
- and, when an ``SloRegistry`` is passed: per-(tenant, kind) request
  outcome counters, per-pair committed-latency histograms, burn-rate /
  alert gauges per SLO and window, and worst cursor-lag gauges.

``MetricsExporter`` is the stdlib-only serving thread: an HTTP server
on ``127.0.0.1:<port>`` answering ``GET /metrics`` (port 0 binds an
ephemeral port — the test mode), plus ``write_snapshot()`` for
scrape-less environments: the same exposition rendered to a temp file
and atomically renamed into place, so a sidecar tailing the file never
reads a half-written page. ``maybe_start_exporter()`` is the
env-driven entry: ``AUTOMERGE_TPU_METRICS_PORT`` unset means fully
disabled — no server, no thread, nothing started.
"""

import os
import threading

from . import hist as _hist
from . import spans as _spans
from .metrics import dispatch_counts, health_counts

__all__ = ['render_prometheus', 'snapshot_all', 'MetricsExporter',
           'maybe_start_exporter', 'METRICS_PORT_ENV',
           'METRICS_SNAPSHOT_ENV', 'SHARD_ENV']

METRICS_PORT_ENV = 'AUTOMERGE_TPU_METRICS_PORT'
METRICS_SNAPSHOT_ENV = 'AUTOMERGE_TPU_METRICS_SNAPSHOT'
SHARD_ENV = 'AUTOMERGE_TPU_SHARD'
_PREFIX = 'automerge_tpu'


def _sanitize(name):
    """A Prometheus-legal metric-name fragment."""
    out = []
    for ch in str(name):
        out.append(ch if (ch.isascii() and (ch.isalnum() or ch == '_'))
                   else '_')
    frag = ''.join(out)
    return frag if not frag[:1].isdigit() else '_' + frag


def _label(value):
    """A Prometheus-escaped label VALUE (quotes/backslashes/newlines)."""
    return str(value).replace('\\', '\\\\').replace('"', '\\"') \
        .replace('\n', '\\n')


def _fmt(value):
    if isinstance(value, float):
        return repr(value)
    return str(value)


def _hist_snapshot(h):
    """Torn-read-proof plain snapshot of one histogram: the bucket
    vector is copied ONCE and count derived from that same copy, so
    the rendered cumulative buckets always sum to the rendered count
    even while another thread is recording. The SUM is derived the same
    way — from the per-bucket sums vector copied inside a counts-stable
    bracket (copy counts, copy sums, re-copy counts; retry on movement),
    and Histogram.record updates sums BEFORE counts, so every record
    the page counts has its value in the page's sum (the page may
    additionally carry the value of a record still in flight — sum is
    an upper bound by at most the in-flight writers' values, never an
    undercount of what _count claims). That is what makes
    rate(..._sum)/rate(..._count) PromQL honest under concurrent
    recording."""
    for _ in range(8):
        counts = list(h.counts)
        sums = list(h.sums)
        if list(h.counts) == counts:
            break
    return {'counts': counts, 'count': sum(counts),
            'sum': float(sum(sums)), 'scale': h.scale}


def snapshot_all(slo=None, fleets=(), router=None, control=None):
    """Every exposed value as plain data — the atomic snapshot both the
    text renderer and the snapshot-file mode serialize from. ``router``
    (an in-process ShardRouter) adds per-shard tick-overrun telemetry:
    each shard's slipped-tick counter and last pump seconds.
    ``control`` (a control/ Controller) adds the controller's own
    gauges — its ``gauges()`` copies under the controller lock, the
    same torn-read-proof contract the SLO reads carry."""
    snap = {
        'health': health_counts(),
        'dispatch': dispatch_counts(fleets),
        'spans_dropped': _spans.spans_dropped(),
        'histograms': {name: _hist_snapshot(h)
                       for name, h in list(_hist._registry.items())},
    }
    if router is not None:
        snap['shard_slips'] = {sid: s.ticks_slipped
                               for sid, s in router.shards.items()}
        snap['shard_pump_s'] = {sid: s.last_pump_s
                                for sid, s in router.shards.items()}
    if control is not None:
        snap['control'] = control.gauges()
    if slo is not None:
        snap['slo_tallies'] = slo.tallies()
        snap['slo_gauges'] = slo.gauges()
        snap['slo_lag'] = slo.lag_gauges()
        snap['slo_hists'] = {key: _hist_snapshot(h)
                             for key, h in slo.histograms().items()}
    # the perf observatory's three legs (perf.py), each empty until its
    # switch is on — no series churn for processes that never enable it
    from . import perf as _perf
    snap['perf_seams'] = _perf.baseline_gauges()
    snap['kernels'] = _perf.kernel_snapshot()
    snap['mem'] = _perf.watermark_snapshot() if _perf._mem_last else None
    return snap


def _labelset(*parts):
    """'{a,b}' from the non-empty label fragments, '' when none."""
    joined = ','.join(p for p in parts if p)
    return f'{{{joined}}}' if joined else ''


def _render_hist_lines(lines, metric, snap, labels=''):
    counts = snap['counts']
    scale = snap['scale']
    cum = 0
    last = max((b for b, c in enumerate(counts) if c), default=-1)
    sep = ',' if labels else ''
    for b in range(last + 1):
        cum += counts[b]
        le = (1 << b) / scale
        lines.append(f'{metric}_bucket{{{labels}{sep}le="{_fmt(le)}"}} '
                     f'{cum}')
    lines.append(f'{metric}_bucket{{{labels}{sep}le="+Inf"}} '
                 f'{snap["count"]}')
    lines.append(f'{metric}_sum{{{labels}}} {_fmt(snap["sum"])}'
                 if labels else f'{metric}_sum {_fmt(snap["sum"])}')
    lines.append(f'{metric}_count{{{labels}}} {snap["count"]}'
                 if labels else f'{metric}_count {snap["count"]}')


def render_prometheus(slo=None, fleets=(), shard=None, router=None,
                      control=None):
    """The full text-format 0.0.4 exposition page (one trailing
    newline), rendered from ``snapshot_all``. ``shard`` stamps a
    ``shard="<id>"`` label on EVERY sample line — the process-level
    identity a multi-shard deployment scrapes by (one exporter per
    shard process; the in-process ``ShardRouter`` testbed renders one
    page per shard the same way), so per-shard dashboards and the
    failover runbooks can select a single failure domain."""
    snap = snapshot_all(slo=slo, fleets=fleets, router=router,
                        control=control)
    sl = f'shard="{_label(shard)}"' if shard is not None else ''
    lines = []

    lines.append(f'# TYPE {_PREFIX}_health_total counter')
    for name, value in sorted(snap['health'].items()):
        ls = _labelset(sl, 'counter="%s"' % _label(name))
        lines.append(f'{_PREFIX}_health_total{ls} {value}')
    lines.append(f'# TYPE {_PREFIX}_dispatch_total counter')
    for name, value in sorted(snap['dispatch'].items()):
        ls = _labelset(sl, 'source="%s"' % _label(name))
        lines.append(f'{_PREFIX}_dispatch_total{ls} {value}')
    lines.append(f'# TYPE {_PREFIX}_spans_dropped gauge')
    lines.append(f'{_PREFIX}_spans_dropped{_labelset(sl)} '
                 f'{snap["spans_dropped"]}')
    if 'shard_slips' in snap:
        # per-shard tick-overrun telemetry (ISSUE-12 satellite): the
        # loadgen's aggregate ticks_slipped, attributed per failure
        # domain — which shard's tick work does not fit the cadence.
        # The `shard` label here is the FAILURE DOMAIN the counter
        # describes (the in-process router testbed exposes all of its
        # shards from one page); a process-level `shard=` identity
        # label composes alongside it as `proc_shard`.
        psl = f'proc_{sl}' if sl else ''
        lines.append(f'# TYPE {_PREFIX}_shard_ticks_slipped_total '
                     f'counter')
        for sid, n in sorted(snap['shard_slips'].items()):
            ls = _labelset(psl, f'shard="{_label(sid)}"')
            lines.append(f'{_PREFIX}_shard_ticks_slipped_total{ls} {n}')
        lines.append(f'# TYPE {_PREFIX}_shard_pump_seconds gauge')
        for sid, v in sorted(snap['shard_pump_s'].items()):
            ls = _labelset(psl, f'shard="{_label(sid)}"')
            lines.append(f'{_PREFIX}_shard_pump_seconds{ls} {_fmt(v)}')

    if snap.get('control'):
        # the control plane's own reasoning as series (control/): how
        # often each (policy, action) decided — split by mode, so a
        # shadow deployment graphs would-have-acted next to an active
        # one — plus direction reversals (the anti-oscillation number),
        # currently-active policy state, and decision latency. The
        # process `shard=` identity composes alongside like every other
        # domain label.
        ctl = snap['control']
        lines.append(f'# TYPE {_PREFIX}_control_decisions_total counter')
        for (policy, action, mode), n in sorted(
                ctl['decisions'].items()):
            ls = _labelset(sl, (f'policy="{_label(policy)}",'
                                f'action="{_label(action)}",'
                                f'mode="{_label(mode)}"'))
            lines.append(f'{_PREFIX}_control_decisions_total{ls} {n}')
        lines.append(f'# TYPE {_PREFIX}_control_reversals_total counter')
        for policy, n in sorted(ctl['reversals'].items()):
            ls = _labelset(sl, f'policy="{_label(policy)}"')
            lines.append(f'{_PREFIX}_control_reversals_total{ls} {n}')
        lines.append(f'# TYPE {_PREFIX}_control_policy_active gauge')
        for (policy, target), value in sorted(ctl['active'].items()):
            ls = _labelset(sl, (f'policy="{_label(policy)}",'
                                f'target="{_label(target)}"'))
            lines.append(f'{_PREFIX}_control_policy_active{ls} '
                         f'{_fmt(value)}')
        lines.append(f'# TYPE {_PREFIX}_control_windows_total counter')
        lines.append(f'{_PREFIX}_control_windows_total{_labelset(sl)} '
                     f'{ctl["windows"]}')
        lines.append(f'# TYPE {_PREFIX}_control_last_decision_tick '
                     f'gauge')
        lines.append(f'{_PREFIX}_control_last_decision_tick'
                     f'{_labelset(sl)} '
                     f'{ctl["last_decision_tick"] or 0}')
        lines.append(f'# TYPE {_PREFIX}_control_decide_seconds gauge')
        for which, key in (('last', 'decide_s_last'),
                           ('max', 'decide_s_max')):
            ls = _labelset(sl, f'window="{which}"')
            lines.append(f'{_PREFIX}_control_decide_seconds{ls} '
                         f'{_fmt(ctl[key])}')

    if snap.get('perf_seams'):
        # seam perf baselines (perf.py): trailing baseline vs newest
        # window, the drift ratio the alert machinery judges, and the
        # alert state — one series set per seam that closed a window
        lines.append(f'# TYPE {_PREFIX}_perf_baseline_seconds gauge')
        lines.append(f'# TYPE {_PREFIX}_perf_window_seconds gauge')
        lines.append(f'# TYPE {_PREFIX}_perf_drift_ratio gauge')
        lines.append(f'# TYPE {_PREFIX}_perf_alert_active gauge')
        rows = {'perf_baseline_seconds': 'baseline_s',
                'perf_window_seconds': 'window_s',
                'perf_drift_ratio': 'drift',
                'perf_alert_active': 'alert'}
        for seam, gauge in sorted(snap['perf_seams'].items()):
            ls = _labelset(sl, f'seam="{_label(seam)}"')
            for metric, key in rows.items():
                lines.append(f'{_PREFIX}_{metric}{ls} '
                             f'{_fmt(gauge[key])}')
    if snap.get('kernels'):
        # device-kernel cost ledger: dispatches + blocking wall seconds
        # per kernel kind (flops/bytes live in obs_report --floor — the
        # AOT cost analysis has no place on a scrape hot path)
        lines.append(f'# TYPE {_PREFIX}_kernel_dispatches_total counter')
        lines.append(f'# TYPE {_PREFIX}_kernel_seconds_total counter')
        for kind, row in sorted(snap['kernels'].items()):
            ls = _labelset(sl, f'kernel="{_label(kind)}"')
            lines.append(f'{_PREFIX}_kernel_dispatches_total{ls} '
                         f'{row["dispatches"]}')
            lines.append(f'{_PREFIX}_kernel_seconds_total{ls} '
                         f'{_fmt(row["seconds"])}')
    if snap.get('mem'):
        # memory watermarks: current resident bytes + process-lifetime
        # high per tier (rss rides as its own tier)
        lines.append(f'# TYPE {_PREFIX}_mem_bytes gauge')
        lines.append(f'# TYPE {_PREFIX}_mem_high_bytes gauge')
        for tier, value in sorted(snap['mem']['current'].items()):
            ls = _labelset(sl, f'tier="{_label(tier)}"')
            lines.append(f'{_PREFIX}_mem_bytes{ls} {value}')
        for tier, value in sorted(snap['mem']['high'].items()):
            ls = _labelset(sl, f'tier="{_label(tier)}"')
            lines.append(f'{_PREFIX}_mem_high_bytes{ls} {value}')

    for name, hsnap in sorted(snap['histograms'].items()):
        metric = f'{_PREFIX}_{_sanitize(name)}'
        lines.append(f'# TYPE {metric} histogram')
        _render_hist_lines(lines, metric, hsnap, labels=sl)

    if 'slo_tallies' in snap:
        lines.append(f'# TYPE {_PREFIX}_slo_requests_total counter')
        for (tenant, kind), tally in sorted(snap['slo_tallies'].items()):
            for cls, value in sorted(tally.items()):
                ls = _labelset(sl, (f'tenant="{_label(tenant)}",'
                                    f'kind="{_label(kind)}",'
                                    f'outcome="{_label(cls)}"'))
                lines.append(f'{_PREFIX}_slo_requests_total{ls} {value}')
        lines.append(f'# TYPE {_PREFIX}_slo_burn_rate gauge')
        lines.append(f'# TYPE {_PREFIX}_slo_alert_active gauge')
        burn, alert = [], []
        for (tenant, kind, sli), gauge in sorted(
                snap['slo_gauges'].items()):
            labels = (f'tenant="{_label(tenant)}",kind="{_label(kind)}",'
                      f'sli="{_label(sli)}"')
            for window in ('fast', 'slow'):
                ls = _labelset(sl, f'{labels},window="{window}"')
                if f'{window}_burn' in gauge:
                    burn.append(f'{_PREFIX}_slo_burn_rate{ls} '
                                f'{_fmt(gauge[f"{window}_burn"])}')
                if f'alert_{window}' in gauge:
                    alert.append(f'{_PREFIX}_slo_alert_active{ls} '
                                 f'{gauge[f"alert_{window}"]}')
        lines.extend(burn)
        lines.extend(alert)
        if snap['slo_lag']:
            lines.append(f'# TYPE {_PREFIX}_slo_cursor_lag_ticks_max '
                         f'gauge')
            for (tenant, kind), lag in sorted(snap['slo_lag'].items()):
                ls = _labelset(sl, (f'tenant="{_label(tenant)}",'
                                    f'kind="{_label(kind)}"'))
                lines.append(f'{_PREFIX}_slo_cursor_lag_ticks_max{ls}'
                             f' {lag}')
        if snap['slo_hists']:
            metric = f'{_PREFIX}_slo_request_latency_seconds'
            lines.append(f'# TYPE {metric} histogram')
            for (tenant, kind), hsnap in sorted(snap['slo_hists'].items()):
                labels = (f'tenant="{_label(tenant)}",'
                          f'kind="{_label(kind)}"')
                _render_hist_lines(lines, metric, hsnap,
                                   labels=','.join(
                                       p for p in (sl, labels) if p))

    return '\n'.join(lines) + '\n'


class MetricsExporter:
    """The serving thread (see the module docstring). ``start()`` binds
    and serves; ``stop()`` shuts the server down and joins the thread.
    With ``port=None`` no server is created — the instance is then a
    snapshot-file writer only."""

    def __init__(self, port=0, host='127.0.0.1', slo=None, fleets=(),
                 snapshot_path=None, shard=None, router=None,
                 control=None):
        self._port_arg = port
        self.host = host
        self.slo = slo
        self.fleets = tuple(fleets)
        self.snapshot_path = snapshot_path
        self.shard = shard
        self.router = router
        self.control = control
        self.port = None
        self._server = None
        self._thread = None

    def render(self):
        return render_prometheus(slo=self.slo, fleets=self.fleets,
                                 shard=self.shard, router=self.router,
                                 control=self.control)

    # -- HTTP mode ------------------------------------------------------

    def start(self):
        """Bind (port 0 = ephemeral; ``self.port`` is then the real
        one) and serve /metrics from a daemon thread. No-op when
        ``port=None`` (snapshot-only mode) or already started."""
        if self._port_arg is None or self._server is not None:
            return self
        import http.server

        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split('?', 1)[0] not in ('/metrics', '/'):
                    self.send_error(404)
                    return
                body = exporter.render().encode()
                self.send_response(200)
                self.send_header('Content-Type',
                                 'text/plain; version=0.0.4; '
                                 'charset=utf-8')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):    # scrapes are not stderr news
                pass

        self._server = http.server.ThreadingHTTPServer(
            (self.host, int(self._port_arg)), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name='metrics-exporter',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Shut the server down, close the socket, join the thread."""
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None
        self.port = None

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    # -- snapshot-file mode ---------------------------------------------

    def write_snapshot(self, path=None):
        """Render the exposition to ``path`` (default: the configured
        ``snapshot_path``) atomically: temp file + rename, so a reader
        never sees a torn page. Returns the path written."""
        path = path if path is not None else self.snapshot_path
        if path is None:
            raise ValueError('no snapshot path configured')
        body = self.render()
        tmp = f'{path}.tmp.{os.getpid()}'
        with open(tmp, 'w') as f:
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


def maybe_start_exporter(slo=None, fleets=(), shard=None, router=None,
                         control=None):
    """The env-driven entry point: ``AUTOMERGE_TPU_METRICS_PORT`` set
    starts (and returns) a serving ``MetricsExporter`` on that port
    (0 = ephemeral); ``AUTOMERGE_TPU_METRICS_SNAPSHOT`` set (with no
    port) returns a snapshot-only exporter bound to that file path;
    NEITHER set returns None with zero threads started — telemetry
    export is strictly opt-in. ``AUTOMERGE_TPU_SHARD`` (or the `shard`
    arg, which wins) stamps the shard identity label on every sample —
    how a shard process names its failure domain to the scraper."""
    port = os.environ.get(METRICS_PORT_ENV)
    snapshot = os.environ.get(METRICS_SNAPSHOT_ENV)
    if shard is None:
        shard = os.environ.get(SHARD_ENV) or None
    if port is not None and port != '':
        exporter = MetricsExporter(port=int(port), slo=slo, fleets=fleets,
                                   snapshot_path=snapshot or None,
                                   shard=shard, router=router,
                                   control=control)
        return exporter.start()
    if snapshot:
        return MetricsExporter(port=None, slo=slo, fleets=fleets,
                               snapshot_path=snapshot, shard=shard,
                               router=router, control=control)
    return None
