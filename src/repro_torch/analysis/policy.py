"""The privacy-egress policy: what is SECRET, what sanitizes, what is a wire.

This file is the checked-in contract that `egress.py` (static taint pass)
and `runtime.py` (wire guard) both enforce.  It holds the same sets as the
JAX package's ``repro.analysis.policy``: every wire verb of the port
(``Channel.send``, ``Coordinator.request``, the codec's ``pack``, the
telemetry exporters) and every party-local transform it sends through
(``core/crypto.py``, ``core/binning.py``, ``core/party.py``,
``streaming/ingest.py``) already carries one of those names.  The paper's
trust model (Federated Forest, arXiv:1905.10053) allows exactly three
things to cross a party boundary:

  * salted **hashed** sample IDs (the ingest alignment handshake),
  * **party-locally binned** feature codes plus bin boundaries,
  * **masked / encoded** label statistics (leaf stats, encoded class ids,
    pairwise-cancelling regression masks).

Everything else derived from `PartyBlock.x / .ids / .y` (and the streaming
equivalents retained on `SourceScan`) is SECRET and must never reach
`Channel.send` / the transport codec.

Extending the policy for a new message type
-------------------------------------------
1. If the new field is derived through a *new* party-local transform, add
   the transform's function name to ``SANITIZERS`` — and make sure it
   really is non-invertible party-side (binning, hashing, masking).
2. If a wire payload legitimately carries raw data (e.g. a party
   provisioning its *own* worker process), keep the static suppression
   ``# egress: ok(reason)`` on the send line AND wrap the runtime send in
   ``analysis.runtime.allow_egress(reason)`` — the two must stay paired so
   the linter and the wire agree.
3. New sink verbs (a second transport, a new RPC helper) go in ``SINKS``.
"""
from __future__ import annotations

import dataclasses

# Attribute names whose *read* introduces raw/private data, wherever the
# object came from.  These are the raw fields of PartyBlock, SourceScan and
# the per-chunk blocks yielded by ChunkedSource.iter_chunks.
SECRET_ATTRS = frozenset({"x", "ids", "y"})

# Attribute reads that are protocol metadata, never raw data — they break
# taint even on a tainted object.  (`hashes` is the salted-hash digest
# array retained by SourceScan; boundaries/edges are bin edges, which the
# paper sends in the clear.)
SAFE_ATTRS = frozenset({
    "name", "n_features", "n_rows", "n_samples", "n_chunks", "shape",
    "size", "dtype", "ndim", "feature_ids", "feature_names", "hashes",
    "boundaries", "edges", "version", "schema", "fingerprint", "capacity",
    "rank_error", "n_bins", "seed", "party", "index",
})

# Callables (matched by bare function / method name) whose RESULT is clean
# regardless of argument taint: the registered party-local transforms.
# Keep this list short and honest — everything here must be reviewed as
# non-invertible from the other side of the wire.
SANITIZERS = frozenset({
    "hash_ids",                 # crypto: salted SHA-256 of raw sample IDs
    "hashed_ids",               # PartyBlock method wrapping hash_ids
    "align_ids", "align_hashed",  # intersection positions of hashed IDs
    "bin_dataset", "apply_bins",  # core.binning: party-local quantile codes
    "interior_quantiles",
    "bin_party_blocks",         # party.VerticalPartition party-local binning
    "party_stream_bin",         # streaming.ingest sketch-boundary binning
    "encode_labels",            # crypto: dense class re-encoding
    "mask_regression_targets",  # crypto: additive target masking
    "pairwise_cancelling_masks",  # crypto: zero-sum mask shares
    "encode_feature_names",
})

# Call verbs that put their arguments on the wire.  Matched by bare name at
# the call site (method or function).  `send`/`sendall` are the socket
# layer, `pack` is the msgpack codec entry, `request`/`_send`/`exchange`
# are the coordinator RPC helpers that forward payloads to Channel.send.
# The observability verbs (`span`/`event`/`begin`/`observe` and the trace
# exporters) are wire-sensitive too: spans cross processes in the telemetry
# op and land in exported artifacts, so a tainted argument to any of them
# is raw data leaving the party exactly like a socket send — the linter
# proves span/metric payloads stay metadata-only.
SINKS = frozenset({"send", "sendall", "pack", "request", "_send",
                   "exchange",
                   "span", "event", "begin", "observe",
                   "export_jsonl", "write_chrome_trace", "chrome_trace"})

# Builtins/uti calls whose result never carries payload data even when fed
# tainted arguments (sizes, types, formatting of scalars).
NEUTRAL_CALLS = frozenset({
    "len", "int", "float", "bool", "str", "repr", "format", "type", "id",
    "isinstance", "issubclass", "hasattr", "range", "print", "min", "max",
    "sum", "abs", "round", "hash",
})

# Modules (globs relative to the analysis root) the passes skip entirely.
EXCLUDE_GLOBS = ("analysis/*", "analysis/**/*")

# --- rules/asserts.py -------------------------------------------------------
# Bare `assert` is allowed only in demo/self-check entry points: launch/*
# scripts are executed unoptimized by CI as integration gates, and their
# asserts ARE the test.  Library code must raise, or it silently passes
# under `python -O`.
ASSERT_EXEMPT_GLOBS = ("launch/*", "launch/**/*")

# --- rules/determinism.py ---------------------------------------------------
# Legacy global-state numpy RNG calls — banned everywhere in src/repro_torch.
LEGACY_RNG_FNS = frozenset({
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "choice", "permutation", "shuffle", "normal", "uniform",
    "standard_normal", "get_state", "set_state",
})
# Deterministic zones: protocol bodies and sketch/compaction code where
# time-dependent values would break bit-identity and resumability.  A
# function decorated with `register_program` is a zone wherever it lives.
DETERMINISM_ZONE_GLOBS = (
    "streaming/sketch.py", "streaming/ingest.py",
    "core/tree.py", "core/binning.py", "core/impurity.py",
)
TIME_CALLS = frozenset({"time", "monotonic", "perf_counter",
                        "process_time", "now", "utcnow", "uuid4"})

# --- rules/locks.py ---------------------------------------------------------
# Modules whose threading classes must carry a "Lock discipline" docstring
# section (the single authoritative field→lock map the rule checks).
LOCK_MODULES = ("serving/fleet.py", "serving/queue.py")
# Method names that mutate a container in place.
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "clear", "update", "add", "remove", "discard", "setdefault",
    "insort",
})


@dataclasses.dataclass(frozen=True)
class Policy:
    secret_attrs: frozenset = SECRET_ATTRS
    safe_attrs: frozenset = SAFE_ATTRS
    sanitizers: frozenset = SANITIZERS
    sinks: frozenset = SINKS
    neutral_calls: frozenset = NEUTRAL_CALLS
    exclude_globs: tuple = EXCLUDE_GLOBS
    assert_exempt_globs: tuple = ASSERT_EXEMPT_GLOBS
    legacy_rng_fns: frozenset = LEGACY_RNG_FNS
    determinism_zone_globs: tuple = DETERMINISM_ZONE_GLOBS
    time_calls: frozenset = TIME_CALLS
    lock_modules: tuple = LOCK_MODULES
    mutator_methods: frozenset = MUTATOR_METHODS


DEFAULT_POLICY = Policy()
