"""Which contract applies where in the torch port. Paths are
repo-relative posix.

The port's copy of automerge_tpu/analysis/scopes.py with every table
re-pointed at `automerge_tpu_torch/`. The scope tables are deliberately
explicit rather than clever: a rule that silently widens its own scope
is how a linter starts crying wolf, and one that silently narrows is how
it stops catching anything. Every entry names the reason it is (or is
not) in scope.

What the port's tables leave out, and why:
- `automerge_tpu_torch/analysis/` itself (its fixtures-in-docstrings
  and rule tables are not product code), as in the reference;
- `chip_smoke.py` and the tests: the reference's gate lints its own
  `tools/` and `bench.py`, the port's gate lints the package alone (its
  on-card script and tests are harnesses, not shipped code);
- `frontend/` and `observability/` from the determinism scope: the
  frontend's change-timestamp default is the reference API's
  documented behavior, observability timestamps real time (as in the
  reference).
"""

import re

ANALYSIS_PREFIX = 'automerge_tpu_torch/analysis/'


def in_package(path):
    return path.startswith('automerge_tpu_torch/') and \
        not path.startswith(ANALYSIS_PREFIX)


def lintable(path):
    """Everything the tree-wide checks (except-pass, message-matching,
    counter discipline) cover: the port's package."""
    return in_package(path)


# --- typed-errors -----------------------------------------------------------
# The funnel modules hold the reference decoder's internal raise style
# (hundreds of intentional bare ValueErrors, converted at the guarded
# entry points); they are copies of the reference's, whose boundary
# discipline tools/fuzz_wire.py enforces dynamically, so the static rule
# exempts them and watches every other module's decode-named surface.
FUNNEL_MODULES = frozenset({
    'automerge_tpu_torch/columnar.py',
    'automerge_tpu_torch/encoding.py',
})

# Public functions with these name shapes are decode surfaces: hostile
# bytes (wire, disk, cursor) reach them, so only automerge_tpu_torch.errors
# classes may escape. encode_/generate_/receive_/ingest_ names are NOT
# here on purpose: encode direction never sees hostile bytes, and the
# receive/ingest surfaces raise API-misuse errors (array-shape guards,
# fallback-routing signals) that are caller bugs, not wire corruption.
DECODE_NAME_RE = re.compile(
    r'^(decode_|parse_|read_|split_|inflate)')


def typed_raise_scope(path):
    return in_package(path) and path not in FUNNEL_MODULES


# --- kernel-ledger ----------------------------------------------------------
def kernel_scope(path):
    return in_package(path)


# Host-path modules where a `torch.` dispatch inside a per-document loop
# breaks the O(1)-dispatch contract (one fused dispatch per batch, never
# one per doc). The iterable-name heuristic keeps the legitimate bounded
# loops out: per SEQUENCE-CLASS pool loops and fixed array-tuple grows
# iterate names that do not match the doc-shaped pattern.
PER_DOC_ITER_RE = re.compile(
    r'\b(docs|doc_ids|doc_indices|doc_handles|handles|peers|links|'
    r'subscribers|sessions|tenants|n_docs|num_docs)\b')


def host_loop_scope(path):
    return in_package(path) and (
        path.startswith(('automerge_tpu_torch/fleet/',
                         'automerge_tpu_torch/service/',
                         'automerge_tpu_torch/shard/',
                         'automerge_tpu_torch/query/',
                         'automerge_tpu_torch/backend/')))


# --- determinism ------------------------------------------------------------
# The deterministic replica paths: two replicas applying the same
# changes must produce byte-identical state, so wall-clock and unseeded
# randomness are banned (the injected-clock rule). observability/ and
# frontend/ are deliberately OUT (see the module docstring).
DETERMINISTIC_RE = re.compile(
    r'^automerge_tpu_torch/(fleet|backend|service|shard|query)/')


def deterministic_scope(path):
    return bool(DETERMINISTIC_RE.match(path))


ENCODE_NAME_RE = re.compile(r'(^|_)encode')


def encode_scope(path):
    return in_package(path)


# --- counter-discipline -----------------------------------------------------
STATS_NAME_RE = re.compile(r'(_stats|_counters|_health)$')
RESERVED_SOURCE_RE = re.compile(r'total|fleet\d+')


def counter_scope(path):
    return lintable(path)


# --- lock-discipline --------------------------------------------------------
# Modules whose module-level state is reachable from more than one
# thread: the reference's threaded surfaces (the native pool's
# completion callbacks, the Prometheus exporter's scrape thread, the
# service's pump threads, the recorder's ring consumers, the
# kernel-ledger wrapper, the exchange, the control plane) and the
# port's own: the CUDA kernel wrappers and their build, which the shard
# router's pump threads launch at once. Mutating a module-level
# container here outside a `with <lock>` block (and outside Counters,
# which locks internally) is a static race candidate.
THREADED_MODULES = frozenset({
    'automerge_tpu_torch/native/__init__.py',
    'automerge_tpu_torch/observability/metrics.py',
    'automerge_tpu_torch/observability/export.py',
    'automerge_tpu_torch/observability/recorder.py',
    'automerge_tpu_torch/observability/spans.py',
    'automerge_tpu_torch/observability/perf.py',
    'automerge_tpu_torch/service/core.py',
    'automerge_tpu_torch/fleet/exchange.py',
    # the control plane: its gauges are read by the exporter's scrape
    # thread while the pump thread commits decisions (the controller
    # lock brackets both sides; module stats are Counters)
    'automerge_tpu_torch/control/signals.py',
    'automerge_tpu_torch/control/policies.py',
    'automerge_tpu_torch/control/controller.py',
    # the port's kernel wrappers and their build (launch counters,
    # per-device set-up, the build cache)
    'automerge_tpu_torch/fleet/cuda_build.py',
    'automerge_tpu_torch/fleet/merge_kernel.py',
    'automerge_tpu_torch/fleet/register_kernel.py',
    'automerge_tpu_torch/fleet/seq_kernel.py',
    'automerge_tpu_torch/fleet/sync_kernels.py',
    'automerge_tpu_torch/fleet/sharding.py',
})


def threaded_scope(path):
    return path in THREADED_MODULES
