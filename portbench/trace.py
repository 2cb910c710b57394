"""The traced window: torch.profiler over CPU and CUDA, the program's
host spans on, the interpreter's collector pauses timed, and the reading
of the profiler's trace.

Adapted from chip_smoke.py:898-959 (`traced`, `device_line`). Where those
sum the device rows of `key_averages()`, this reads the exported trace's
events, so that the device's busy time is the union of its operations'
intervals, each kernel can be tied to the harness's step that launched it
(by the launch's correlation id), and each idle gap to the innermost host
span open when it began.
"""

import bisect
import gc
import heapq
import json
import os
import tempfile
import time

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
STEP = 'pb.step'             # the harness's range around one timed step
ALIGN = 'pb.align'           # marks the host clock in the trace's clock


def step_range():
    """A profiler range around one timed step (a no-op cost when the
    profiler is off)."""
    import torch
    return torch.profiler.record_function(STEP)


class Window:
    """Context for the traced window. On exit: `wall_s`, `gc_s`, `spans`
    (the program's host spans as (name, t0_ns, t1_ns, tid)) and `events`
    (the profiler trace's complete events)."""

    def __init__(self, on, device='cuda'):
        self.on = on
        self.cuda = device != 'cpu'
        self.prof = None
        self.wall_s = 0.0
        self.gc_s = 0.0
        self.spans = []
        self.events = []
        self.align_ns = None
        self._gc = [0.0, 0.0]

    def _on_gc(self, phase, _info):
        if phase == 'start':
            self._gc[1] = time.perf_counter()
        else:
            self._gc[0] += time.perf_counter() - self._gc[1]

    def __enter__(self):
        if self.on:
            import torch
            from automerge_tpu_torch import observability
            from automerge_tpu_torch.observability import spans
            observability.enable(span_capacity=1 << 20)
            spans.clear()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.align_ns = time.perf_counter_ns()
            with torch.profiler.record_function(ALIGN):
                pass
            gc.callbacks.append(self._on_gc)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on and self.cuda:
            import torch
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        if not self.on:
            return False
        gc.callbacks.remove(self._on_gc)
        self.gc_s = self._gc[0]
        from automerge_tpu_torch import observability
        from automerge_tpu_torch.observability import spans
        self.prof.__exit__(None, None, None)
        observability.disable()
        self.spans = [(r['name'], r['t0_ns'], r['t1_ns'], r['tid'])
                      for r in spans.iter_spans()]
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
        finally:
            os.unlink(path)
        self.events = [e for e in data.get('traceEvents', [])
                       if e.get('ph') == 'X']
        self.prof = None
        return False


def _cat(e):
    return str(e.get('cat', '')).lower()


def _union(intervals):
    """Merged [start, end] intervals of `intervals`, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, spans=(), align_ns=None, top=10):
    """The device's reading of a traced window, from the trace's complete
    events (times in microseconds):

    - busy_us: the union of the device operations' intervals;
    - ops: [(name, us)] of the device operations, summed by name, longest
      first;
    - step_kernel_us: the device time of every kernel and memset (not
      copies) whose launch lies inside a harness step range;
    - idle_by_span: [(label, us)] of the idle gaps between device
      operations inside the window, each labelled by the innermost host
      span (the program's, else the harness's step, else 'harness')
      open when the gap began, summed by label, longest first.
    """
    dev, launches, steps, align = [], {}, [], None
    for e in events:
        cat = _cat(e)
        ts, dur = float(e.get('ts', 0.0)), float(e.get('dur', 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get('name', '?'), cat,
                        (e.get('args') or {}).get('correlation')))
        elif cat in LAUNCH_CATS:
            corr = (e.get('args') or {}).get('correlation')
            if corr is not None:
                launches[corr] = ts
        elif cat == 'user_annotation' and e.get('name') == STEP:
            steps.append((ts, ts + dur))
        elif cat == 'user_annotation' and e.get('name') == ALIGN:
            align = ts
    merged = _union([(s, t) for s, t, *_ in dev])
    busy = sum(t - s for s, t in merged)
    by_name = {}
    for s, t, name, _cat_, _c in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    steps = _union(steps)
    starts = [s for s, _ in steps]

    def in_step(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= steps[i][1]
    step_kernel = sum(t - s for s, t, _n, cat, corr in dev
                      if cat != 'gpu_memcpy' and corr in launches
                      and in_step(launches[corr]))
    gaps = [(merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    idle = {}
    for label, us in _idle_pieces(gaps, spans, align_ns, align, steps):
        idle[label] = idle.get(label, 0.0) + us
    return dict(busy_us=busy,
                ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
                step_kernel_us=step_kernel,
                steps=len(steps),
                idle_by_span=sorted(idle.items(),
                                    key=lambda kv: -kv[1])[:top])


def _idle_pieces(gaps, spans, align_ns, align_us, steps):
    """Each gap (sorted by start) cut at the host spans' edges, each piece
    as (label, us): the innermost span open over it (the latest-started
    one), the program's spans mapped onto the trace's clock by the
    alignment mark, else the harness's step range, else 'harness'."""
    if align_ns is not None and align_us is not None:
        off = align_us - align_ns / 1e3
        ivs = [(t0 / 1e3 + off, t1 / 1e3 + off, name)
               for name, t0, t1, _tid in spans]
    else:
        ivs = []
    ivs += [(s, t, STEP) for s, t in steps]
    ivs.sort()
    edges = sorted({x for s, t, _n in ivs for x in (s, t)})
    heap, j = [], 0
    for g0, g1 in gaps:
        lo = bisect.bisect_right(edges, g0)
        hi = bisect.bisect_left(edges, g1)
        cuts = [g0] + edges[lo:hi] + [g1]
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            while j < len(ivs) and ivs[j][0] <= mid:
                # innermost = latest start; a step range loses ties
                heapq.heappush(heap, (-ivs[j][0], ivs[j][2] == STEP,
                                      ivs[j][1], ivs[j][2]))
                j += 1
            while heap and heap[0][2] < mid:
                heapq.heappop(heap)
            yield (heap[0][3] if heap else 'harness'), b - a
