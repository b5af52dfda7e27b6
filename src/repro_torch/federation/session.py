"""Federation — the session object that owns the federated lifecycle.

The paper's system is one coordinated protocol: regional clients join a
session, train jointly (Alg. 2), and answer predictions with one round of
communication (Alg. 5/6)::

    fed = Federation(parties=2)                 # on the CUDA card
    part = fed.ingest(party_blocks)             # party-first: align + bin
    part = fed.ingest(x_train, y_train)         # or the raw-matrix adapter
    part = fed.ingest(chunked_sources)          # or streamed, out-of-core
    model = fed.fit(ForestParams(...))          # FittedModel (Estimator)
    preds = fed.predict(model, x_test)          # one-round, leaf-compacted
    server = fed.serve(model, ServeConfig())    # bucketed, a CUDA graph each
    fleet = fed.serve_fleet(model, ServeConfig(), n_cells=4)
    model = fed.fit_resumable(spec, ckpt_dir)   # break-point recoverable
    fed.save(model, ckpt_dir); model = fed.load(ckpt_dir, spec)

    with Federation(parties=3, substrate="distributed") as fed:
        ...                                     # one process per party
    mesh = make_forest_mesh(trees=2, parties=2)    # launch/mesh.py
    with Federation(parties=2, substrate="sharded", mesh=mesh) as fed:
        ...                                     # one rank per mesh position

``fit`` dispatches on the spec type — ForestParams, BoostParams or
LinearParams — and every fitted handle conforms to the Estimator protocol.
``predict``/``serve`` cache the LeafTable compaction plan (and the server)
per model and rebuild it whenever the model's ``trees_`` changes (a refit,
or a ``fit_resumable`` continuation that extended the forest), so serving
state never goes stale against a refreshed model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import streaming
from repro_torch.core import crypto
from repro_torch.core.boosting import (BoostParams, FederatedBoosting,
                                       split_rounds, stack_rounds)
from repro_torch.core.fedlinear import FederatedLinear, LinearParams
from repro_torch.core.forest import FederatedForest
from repro_torch.core.party import (VerticalPartition, make_vertical_partition,
                                    partition_from_blocks)
from repro_torch.core.partyblock import (DataSource, PartyBlock,
                                         is_block_sequence)
from repro_torch.core.types import ForestParams
from repro_torch.device import resolve_device
from repro_torch.federation import programs
from repro_torch.federation.estimator import Estimator
from repro_torch.federation.substrate import resolve_substrate
from repro_torch.observability import trace as tracing


def _token_matches(old: tuple, new: tuple) -> bool:
    """Compare engine model tokens: object entries by identity (the stored
    token pins them, so ids can't be reused), value entries by equality."""
    prim = (int, float, str, bool, type(None))
    return len(old) == len(new) and all(
        (o == n) if isinstance(o, prim) else (o is n)
        for o, n in zip(old, new))


class Federation:
    """A federated-learning session: participants + substrate + lifecycle.

    Args:
      parties: number of participating parties M (the vertical split width).
      substrate: "simulated" (all parties in this process, the default),
        "sharded" (one ``torch.distributed`` rank per position of
        ``mesh``), "distributed" (one OS process per party, on ``device``),
        or a pre-built substrate.  Close a sharded or distributed session
        with :meth:`close` or a ``with`` block.
      mesh: the rank mesh of the sharded substrate (launch/mesh.py); its
        "parties" axis must equal ``parties``.  Ingest stays in this
        process, as for the simulated substrate.
      hist_impl: session-level histogram backend override — folded into
        every spec this session fits (None defers to the spec's own
        ``hist_impl``).
      n_bins: default quantile-bin count for :meth:`ingest`.
      seed: default partitioning seed for :meth:`ingest`.
      device: where fit and predict run.  None means the CUDA card, and
        raises on a host without one; pass "cpu" to run on the CPU.
      **substrate_opts: options of a named substrate's factory (the
        distributed one's ``round_timeout``, ``retry``, ...).
    """

    def __init__(self, parties: int = 2, substrate: Any = "simulated",
                 hist_impl: str | None = None, n_bins: int = 32,
                 seed: int = 0, device: torch.device | str | None = None,
                 mesh=None, **substrate_opts):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the forest vote sums leaf counts in a matrix product: keep it
            # in full float32 (prediction._check_full_f32 asserts it)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self.parties = int(parties)
        self.hist_impl = hist_impl
        self.n_bins = int(n_bins)
        self.seed = int(seed)
        if isinstance(substrate, str):
            substrate_opts.setdefault("device", self.device)
        self.substrate = resolve_substrate(substrate, mesh=mesh,
                                           parties=self.parties,
                                           **substrate_opts)
        self.mesh = getattr(self.substrate, "mesh", None)
        sub_dev = getattr(self.substrate, "device", None)
        if sub_dev is not None and torch.device(sub_dev) != self.device:
            raise ValueError(f"substrate {self.substrate.name!r} runs on "
                             f"{sub_dev} but the session on {self.device}")
        self._partition: VerticalPartition | None = None
        self._y: np.ndarray | None = None
        # streaming-ingest state (repro_torch.streaming): the per-party
        # PartyStreams of a streamed ingest and its knobs — what
        # ingest_append extends
        self._stream: dict | None = None
        # sample IDs of the ingested training set in aligned (row) order —
        # the canonical common ordering for party-block ingest, arange for
        # the pre-aligned raw-matrix path
        self.aligned_ids_: np.ndarray | None = None
        # id(model) -> (model, trees_ ref, LeafTable): the plan is valid
        # exactly while the model still holds that PartyTree stack
        self._plans: dict[int, tuple[Any, Any, Any]] = {}
        # (id(model), ServeConfig, engine class[, ("fleet", n)]) ->
        # (model, server or fleet, model token): serve()'s cache
        self._servers: dict[tuple, tuple[Any, Any, tuple]] = {}

    # ------------------------------------------------------------------ data
    def ingest(self, data, y: np.ndarray | None = None, *,
               n_bins: int | None = None, contiguous: bool = True,
               seed: int | None = None, salt: str = crypto.DEFAULT_SALT,
               validate: bool = False, chunk_rows: int | None = None,
               sketch_capacity: int | None = None) -> VerticalPartition:
        """Ingest the session's training set; remembers (partition, y) so
        ``fit(spec)`` needs no further arguments.  Three shapes, dispatched
        in this order:

        Streaming: a sequence with at least one chunked source
        (:mod:`repro_torch.streaming` — ``ChunkedCSVSource``,
        ``ArraySource``, a ``DataProduct``) runs out-of-core: every source
        is scanned chunk-wise (hashed IDs + mergeable quantile sketches),
        aligned, and binned in a second chunked pass — the raw features are
        never held densely, and the result is bit-identical to the
        in-memory build while the sketches stay exact (within their
        tracked rank-error bound past that).  ``chunk_rows`` bounds the
        pass working set, ``sketch_capacity`` the sketch memory/accuracy
        trade-off.  ``ingest_append`` can then land new rows.

        Party-first (paper §3.1/§4.3): a sequence of per-party
        :class:`PartyBlock`s (or DataSources loading them — e.g.
        ``CSVSource`` per regional file), each holding raw features keyed
        by that party's own sample IDs, with exactly one party holding the
        labels.  The blocks are aligned on hashed IDs (superset and
        out-of-order rows collapse onto the canonical common ordering),
        binned party-locally (per-feature, hence lossless —
        ``validate=True`` asserts bit-equality with central binning), and
        stacked into the VerticalPartition fit and predict consume.

        Raw matrix: a centrally held, pre-aligned raw (N, F) matrix plus
        ``y``, adapted into pre-aligned PartyBlocks split across the
        session's M parties (``contiguous``/``seed`` steer the feature
        assignment).

        The aligned sample IDs land on ``self.aligned_ids_``.  Raises
        ValueError on an empty ID intersection, on duplicate IDs within a
        party, and on labels held by more than one party.
        """
        if streaming.is_chunked_sequence(data):
            if y is not None or not contiguous or seed is not None:
                raise ValueError(
                    "streamed ingest: labels ride on the label-holding "
                    "party's chunks, and feature assignment is owned by "
                    "the sources (feature_ids) — y/contiguous/seed do not "
                    "apply")
            if len(data) != self.parties:
                raise ValueError(f"got {len(data)} party sources but the "
                                 f"session declares {self.parties} parties")
            return self._ingest_stream(data, n_bins=n_bins or self.n_bins,
                                       salt=salt, validate=validate,
                                       chunk_rows=chunk_rows,
                                       sketch_capacity=sketch_capacity)
        if chunk_rows is not None or sketch_capacity is not None:
            raise ValueError("chunk_rows/sketch_capacity apply to streamed "
                             "ingest (chunked sources) only")
        if is_block_sequence(data):
            if y is not None:
                raise ValueError(
                    "party-first ingest: labels ride on their owning "
                    "PartyBlock (y=...), not as a separate argument")
            if not contiguous or seed is not None:
                raise ValueError(
                    "contiguous/seed steer the raw-matrix adapter's feature "
                    "assignment; party blocks own theirs (feature_ids, or "
                    "contiguous ids in canonical name order)")
            if len(data) != self.parties:
                raise ValueError(f"got {len(data)} party blocks but the "
                                 f"session declares {self.parties} parties")
            # a transport-backed substrate ingests party-side: blocks load,
            # hash and bin inside each party's own process, and only hashes
            # + binned values cross the wire
            ingest_blocks = getattr(self.substrate, "ingest_blocks", None)
            if ingest_blocks is not None:
                part, y_aligned, ids = ingest_blocks(
                    data, n_bins or self.n_bins, salt=salt, validate=validate)
            else:
                part, y_aligned, ids = partition_from_blocks(
                    data, n_bins or self.n_bins, salt=salt, validate=validate)
            self._partition, self._y = part, y_aligned
            self.aligned_ids_ = ids
            self._stream = None
            return part
        if isinstance(data, (PartyBlock, DataSource)):
            raise TypeError("pass PartyBlocks as a sequence: "
                            "ingest([block_a, block_b, ...])")
        part = make_vertical_partition(
            np.asarray(data), self.parties, n_bins or self.n_bins,
            contiguous=contiguous, seed=self.seed if seed is None else seed,
            validate=validate)
        self._partition = part
        self._y = None if y is None else np.asarray(y)
        self.aligned_ids_ = np.arange(part.n_samples)
        self._stream = None
        return part

    def _ingest_stream(self, sources, *, n_bins: int, salt: str,
                       validate: bool, chunk_rows: int | None,
                       sketch_capacity: int | None,
                       append: bool = False) -> VerticalPartition:
        """Streamed ingest: in this process ("local" mode), or party-side
        through a transport-backed substrate's ``ingest_stream`` hook
        ("distributed" mode: each worker scans and bins its own chunks;
        only hashes, sketch-derived boundaries, binned values and the
        aligned labels cross the wire, and the workers hold the streams
        that ``ingest_append`` extends)."""
        chunk_rows = chunk_rows if chunk_rows is not None \
            else streaming.DEFAULT_CHUNK_ROWS
        capacity = sketch_capacity if sketch_capacity is not None \
            else streaming.DEFAULT_CAPACITY
        knobs = {"n_bins": n_bins, "salt": salt, "chunk_rows": chunk_rows,
                 "capacity": capacity}
        ingest_stream = getattr(self.substrate, "ingest_stream", None)
        if ingest_stream is not None:
            part, y, ids = ingest_stream(
                sources, n_bins, salt=salt, validate=validate,
                chunk_rows=chunk_rows, capacity=capacity, append=append)
            self._stream = {"mode": "distributed", **knobs}
        else:
            if append:
                streams = self._stream["streams"]
                streaming.append_streams(streams, sources)
                part, y, ids = streaming.assemble_streams(streams, n_bins)
            else:
                part, y, ids, streams = streaming.streaming_ingest(
                    sources, n_bins, chunk_rows=chunk_rows,
                    capacity=capacity, salt=salt, validate=validate)
            self._stream = {"mode": "local", "streams": streams, **knobs}
        self._partition, self._y = part, y
        self.aligned_ids_ = ids
        return part

    def ingest_append(self, sources) -> VerticalPartition:
        """Land newly published party data onto a streamed ingest.

        ``sources`` are chunked sources (or blocks/products) whose chunks
        name existing parties: each is scanned once and appended to that
        party's stream — product versions must strictly advance — and the
        partition is re-assembled over old + new rows (bin edges move when
        rows land, so every row re-bins; hashing and sketching of already-
        scanned sources is never repeated).  Rows join the training set
        once every party holds them.

        The re-assembled partition replaces the session training set; a
        following ``fit``/``fit_resumable`` trains on the concatenated data
        (bit-identical to a from-scratch ingest of the union), and cached
        plans refresh as after any refit.
        """
        if self._stream is None:
            raise ValueError(
                "ingest_append extends a streamed ingest: call "
                "ingest([...chunked sources...]) first (in-memory ingests "
                "re-ingest the full block set instead)")
        st = self._stream
        return self._ingest_stream(
            sources, n_bins=st["n_bins"], salt=st["salt"], validate=False,
            chunk_rows=st["chunk_rows"], sketch_capacity=st["capacity"],
            append=True)

    @property
    def labels_(self) -> np.ndarray | None:
        """The ingested labels, gathered onto the aligned row ordering."""
        return self._y

    # ------------------------------------------------------------------- fit
    def fit(self, spec, partition: VerticalPartition | None = None,
            y: np.ndarray | None = None, **model_kw) -> Estimator:
        """Train the model ``spec`` describes (ForestParams, BoostParams or
        LinearParams) on this session's substrate and device; returns the
        fitted handle."""
        partition, y = self._training_set(partition, y)
        self._check_binning(spec, partition)
        model = self._model_for(self._apply_session(spec), **model_kw)
        with tracing.TRACER.span(f"fit.{type(spec).__name__}",
                                 category="host",
                                 substrate=self.substrate.name,
                                 parties=self.parties):
            return model.fit(partition, y)

    def fit_resumable(self, spec: ForestParams, ckpt_dir: str, *,
                      trees_per_chunk: int = 2,
                      partition: VerticalPartition | None = None,
                      y: np.ndarray | None = None,
                      model: FederatedForest | None = None,
                      **model_kw) -> Estimator:
        """Break-point-recoverable forest fit (paper §4.1) on this session's
        substrate and device; chunk checkpoints land in ``ckpt_dir``.

        The incremental-fit entry point: rerun with a larger
        ``spec.n_estimators`` to extend a checkpointed forest (only the new
        trees build — bit-identical to a from-scratch fit at the larger
        count), or after ``ingest_append`` to retrain on the grown data
        (the checkpoint fingerprint detects the changed partition and the
        fit cleanly restarts).  Pass ``model=`` to continue an existing
        fitted handle in place: its cached plan refreshes automatically
        when its trees change."""
        if not isinstance(spec, ForestParams):
            raise TypeError("fit_resumable is forest-only")
        partition, y = self._training_set(partition, y)
        self._check_binning(spec, partition)
        if model is not None:
            if not isinstance(model, FederatedForest):
                raise TypeError("fit_resumable(model=...) continues a "
                                "FederatedForest handle")
            if model_kw:
                raise ValueError("model= continues an existing handle; "
                                 "constructor kwargs don't apply")
            model.params = self._apply_session(spec)
        else:
            model = FederatedForest(self._apply_session(spec),
                                    substrate=self.substrate,
                                    device=self.device, **model_kw)
        return model.fit_resumable(partition, y, ckpt_dir,
                                   trees_per_chunk=trees_per_chunk)

    def _training_set(self, partition, y):
        partition = partition if partition is not None else self._partition
        y = y if y is not None else self._y
        if partition is None or y is None:
            raise ValueError("no training data: call ingest(x, y) first or "
                             "pass (partition, y) explicitly")
        if partition.n_parties != self.parties:
            raise ValueError(f"partition has {partition.n_parties} parties, "
                             f"session declares {self.parties}")
        return partition, y

    @staticmethod
    def _check_binning(spec, partition):
        """A spec binned differently from the partition would histogram
        truncated bin ids and silently train a wrong model — reject it
        (LinearParams has no bins)."""
        spec_bins = getattr(spec, "n_bins", None)
        if spec_bins is not None and spec_bins != partition.n_bins:
            raise ValueError(
                f"spec.n_bins={spec_bins} but the partition was ingested "
                f"with n_bins={partition.n_bins}; re-ingest with matching "
                f"bins (Federation(n_bins=...) or ingest(n_bins=...))")

    def _apply_session(self, spec):
        """Fold session-level settings into a spec (hist_impl is owned here)."""
        if self.hist_impl is not None and hasattr(spec, "hist_impl") \
                and dataclasses.is_dataclass(spec):
            spec = dataclasses.replace(spec, hist_impl=self.hist_impl)
        return spec

    def _model_for(self, spec, **model_kw) -> Estimator:
        kw = dict(substrate=self.substrate, device=self.device, **model_kw)
        if isinstance(spec, ForestParams):
            return FederatedForest(spec, **kw)
        if isinstance(spec, BoostParams):
            return FederatedBoosting(spec, **kw)
        if isinstance(spec, LinearParams):
            return FederatedLinear.from_params(spec, **kw)
        raise TypeError(f"unknown model spec {type(spec).__name__} "
                        "(expected ForestParams | BoostParams | LinearParams)")

    # --------------------------------------------------------------- predict
    def predict(self, model: Estimator, x_test: np.ndarray) -> np.ndarray:
        """One-round prediction through the session.

        Forests go through the leaf-compacted mask with a per-model cached
        LeafTable plan, rebuilt automatically when ``model.trees_`` changed
        since the plan was made; other families predict as they are."""
        if isinstance(model, FederatedForest):
            return model.predict_compact(x_test,
                                         leaf_table=self._plan_for(model))
        return model.predict(x_test)

    def _plan_for(self, model):
        """The model's LeafTable — cached until its trees_ is swapped out."""
        cached = self._plans.get(id(model))
        if cached is not None and cached[0] is model \
                and cached[1] is model.trees_:
            return cached[2]
        table = model.leaf_table()
        self._plans[id(model)] = (model, model.trees_, table)
        return table

    # ----------------------------------------------------------------- serve
    def serve(self, model: Estimator, config=None, *, traffic=None,
              server_cls=None, **server_kw):
        """Stand up a serving engine for ``model``, pre-bound to the
        session's substrate, on the device the model's tensors live on (the
        session's: the card unless it was made with ``device="cpu"``).  The
        engine class is dispatched on the model family (forest ->
        ForestServer, boosting -> BoostingServer, F-LR -> LinearServer —
        serving/engine.server_for).

        ``config`` is a :class:`repro_torch.serving.ServeConfig` — buckets,
        compact, max_inflight, autotune_buckets, allow_degraded in one
        hashable value object that doubles as the server-cache key.  The
        pre-config keywords (``serve(model, buckets=..., compact=...)``)
        still work through a one-shot adapter that emits a
        DeprecationWarning.

        ``config.autotune_buckets`` derives the bucket set from observed
        traffic instead of the warm-start guess: pass ``traffic``
        (wave_stats / request_stats records, or plain row counts) to tune a
        fresh server up front; on a cached server the engine's own
        ``wave_stats`` are used, and the bucket set is refreshed in place
        through ``set_buckets`` — the same way ``trees_`` changes refresh
        plans, with the compile-once contract holding per autotune epoch.

        On a sharded session the server runs on the session's mesh: it
        shares the session's ranks.

        Repeated calls with an equal (model, config) return the same server
        — its compiled bucket programs (CUDA graphs on the card) are reused
        — unless the model's state changed, in which case the server is
        refreshed in place (plan rebuilt, stale programs dropped)."""
        from repro_torch.serving import autotune, engine
        from repro_torch.serving.config import adapt_legacy_kwargs
        config = adapt_legacy_kwargs(config, server_kw)
        cls = server_cls or engine.server_for(model, self.substrate)
        warm = config.resolved_buckets(engine.DEFAULT_BUCKETS)
        # only the knob-free path is cached: extra server_kw (vote_impl,
        # mask_dtype, ...) isn't part of the key, and silently returning a
        # server built with different knobs would drop the request
        cacheable = not server_kw
        key = (id(model), config, cls)
        cached = self._servers.get(key) if cacheable else None
        if cached is not None and cached[0] is model:
            server, token = cached[1], cached[2]
            if not _token_matches(token, cls.model_token(model)):
                server.refresh_from(model)
                self._servers[key] = (model, server, cls.model_token(model))
            if config.autotune_buckets:
                source = traffic if traffic is not None else server.wave_stats
                tuned = autotune.autotune_buckets(source, warm=server.buckets)
                if tuned != server.buckets:
                    server.set_buckets(tuned)
            return server
        if config.autotune_buckets and traffic is not None:
            warm = autotune.autotune_buckets(traffic, warm=warm)
        server_kw.setdefault("substrate", self.substrate)
        if issubclass(cls, engine.ForestServer):
            server_kw.setdefault("allow_degraded", config.allow_degraded)
        server = cls.from_model(model, buckets=warm, compact=config.compact,
                                max_inflight=config.max_inflight, **server_kw)
        if cacheable:
            self._servers[key] = (model, server, cls.model_token(model))
        return server

    def serve_fleet(self, model: Estimator, config=None, *,
                    n_cells: int = 4, traffic=None, server_cls=None,
                    **fleet_kw):
        """Stand up a :class:`repro_torch.serving.ServingFleet` for
        ``model``: ``n_cells`` replicated serving engines (each built
        exactly as ``serve`` would build one — same substrate, same
        ServeConfig semantics, its own CUDA stream and graphs) behind
        consistent-hash routing and admission control (serving/fleet.py).
        Extra keywords (``max_queue_rows``, ``rate_limit_rows_per_s``,
        ``max_poison_retries``, ``snapshot_hook``, ...) pass through to the
        fleet front door.

        Cache/refresh semantics match ``serve``: repeated calls with an
        equal (model, config, n_cells) return the same fleet — every cell's
        compiled bucket programs are reused — unless the model's state
        changed, in which case each cell refreshes in place.  With
        ``config.autotune_buckets`` a cached fleet re-derives buckets PER
        CELL from that cell's own observed traffic (its ``wave_stats``), so
        cells serving different row-size mixes tune independently; buckets
        that survive a retune keep their programs (compile-once per
        autotune epoch, per cell).  Only the knob-free path is cached, as
        with ``serve``."""
        from repro_torch.serving import autotune, engine
        from repro_torch.serving.config import ServeConfig
        from repro_torch.serving.fleet import ServingFleet
        if int(n_cells) < 1:
            raise ValueError(f"n_cells must be >= 1, got {n_cells}")
        config = config if config is not None else ServeConfig()
        cls = server_cls or engine.server_for(model, self.substrate)
        cacheable = not fleet_kw
        key = (id(model), config, cls, ("fleet", int(n_cells)))
        cached = self._servers.get(key) if cacheable else None
        if cached is not None and cached[0] is model:
            fleet, token = cached[1], cached[2]
            if not _token_matches(token, cls.model_token(model)):
                for cell in fleet.cells.values():
                    cell.server.refresh_from(model)
                self._servers[key] = (model, fleet, cls.model_token(model))
            if config.autotune_buckets:
                for cell in fleet.cells.values():
                    tuned = autotune.autotune_buckets(
                        cell.server.wave_stats, warm=cell.server.buckets)
                    if tuned != cell.server.buckets:
                        cell.server.set_buckets(tuned)
            return fleet
        warm = config.resolved_buckets(engine.DEFAULT_BUCKETS)
        if config.autotune_buckets and traffic is not None:
            warm = autotune.autotune_buckets(traffic, warm=warm)
        server_kw: dict = {"substrate": self.substrate}
        if issubclass(cls, engine.ForestServer):
            server_kw["allow_degraded"] = config.allow_degraded
        servers = {
            f"cell{i}": cls.from_model(
                model, buckets=warm, compact=config.compact,
                max_inflight=config.max_inflight, **server_kw)
            for i in range(int(n_cells))}
        fleet = ServingFleet(servers, **fleet_kw)
        if cacheable:
            self._servers[key] = (model, fleet, cls.model_token(model))
        return fleet

    # ------------------------------------------------------------ checkpoint
    def save(self, model: Estimator, ckpt_dir: str,
             step: int | None = None) -> str:
        """Checkpoint a fitted tree model's PartyTree stack
        (ckpt/checkpoint.py, the JAX package's format), tagged with its
        model family so ``load`` refuses to rehydrate it as another family
        — a boosting stack reloaded as a forest would average leaf values
        instead of summing Newton steps.  Default step = the stack's tree
        (round) count."""
        from repro_torch import ckpt
        if isinstance(model, FederatedBoosting):
            if not model.trees_:
                raise TypeError("save() expects a fitted model")
            stack = stack_rounds(model.trees_)
            step = len(model.trees_) if step is None else int(step)
            meta = {"family": "boosting", "task": model.params.task,
                    "n_rounds": len(model.trees_),
                    "learning_rate": float(model.params.learning_rate),
                    "base": float(model.base_)}
            return ckpt.save_checkpoint(ckpt_dir, step, stack, meta=meta)
        trees = getattr(model, "trees_", None)
        if trees is None or not hasattr(trees, "is_leaf"):
            raise TypeError("save() expects a fitted forest/boosting model")
        step = int(trees.is_leaf.shape[1]) if step is None else int(step)
        return ckpt.save_checkpoint(ckpt_dir, step, trees,
                                    meta={"family": "forest"})

    def load(self, ckpt_dir: str, params, *,
             step: int | None = None,
             partition: VerticalPartition | None = None,
             decode=None, trees=None, **model_kw) -> Estimator:
        """Rehydrate a fitted model handle from a checkpoint, on this
        session's device.

        ``load`` dispatches on the checkpoint's model-family tag (written by
        :meth:`save`, in either package): a ForestParams spec requires a
        forest (or untagged) checkpoint, a BoostParams spec a boosting one —
        a mismatch raises instead of predicting garbage.

        The label decode is reconstructed from (n_classes, seed) for
        encrypted-classification forests (crypto.label_decoder), so a loaded
        model predicts true labels without the original fit in memory.
        CAVEAT: checkpoints store only the PartyTree stack, not the
        fit-time privacy flags — a forest trained with the non-default
        ``encrypt_labels=False`` (or ``mask_regression=True``) MUST be
        loaded with the same flags in ``model_kw`` (or an explicit
        ``decode``).  ``partition`` defaults to the session's ingested one
        (predict bins through it).  ``trees`` accepts an already-loaded
        stack to avoid a second read (``ForestServer.from_checkpoint``)."""
        from repro_torch import ckpt
        from repro_torch.serving.engine import load_forest_trees
        if step is None:
            step = ckpt.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        meta = ckpt.read_meta(ckpt_dir, step)
        family = meta.get("family")
        if isinstance(params, BoostParams):
            if family != "boosting":
                raise ValueError(
                    f"checkpoint at {ckpt_dir} step {step} holds a "
                    f"{family or 'forest (untagged legacy)'} model but "
                    f"load() was given BoostParams; load it with the spec "
                    f"of the family it was saved as")
            return self._load_boosting(ckpt_dir, params, step, meta,
                                       partition, trees, **model_kw)
        if family not in (None, "forest"):
            raise ValueError(
                f"checkpoint at {ckpt_dir} step {step} holds a {family!r} "
                f"model; rehydrating it as a forest would predict garbage — "
                f"load it with the matching spec (e.g. BoostParams)")
        if not isinstance(params, ForestParams):
            raise TypeError(f"load() dispatches on ForestParams | "
                            f"BoostParams, got {type(params).__name__}")
        model = FederatedForest(self._apply_session(params),
                                substrate=self.substrate, device=self.device,
                                **model_kw)
        model.trees_ = trees if trees is not None \
            else load_forest_trees(ckpt_dir, step, device=self.device)
        model.partition_ = partition if partition is not None \
            else self._partition
        stack_parties = int(model.trees_.is_leaf.shape[0])
        if model.partition_ is not None \
                and model.partition_.n_parties != stack_parties:
            raise ValueError(
                f"checkpointed stack has {stack_parties} parties but the "
                f"attached partition has {model.partition_.n_parties}; pass "
                f"the partition this forest was fitted with (or none)")
        if decode is None and params.task == "classification" \
                and model.encrypt_labels:
            decode = crypto.label_decoder(params.n_classes, params.seed)
        elif decode is None and params.task == "regression" \
                and model.mask_regression:
            decode = crypto.regression_unmasker(params.seed)
        model._decode = decode if decode is not None \
            else (lambda v: np.asarray(v))
        return model

    def _load_boosting(self, ckpt_dir: str, params: BoostParams, step: int,
                       meta: dict, partition, trees,
                       **model_kw) -> FederatedBoosting:
        """Rehydrate a FederatedBoosting handle from a family-tagged
        checkpoint: the round stack splits back into per-round trees; base,
        task and learning rate come from the metadata."""
        from repro_torch.serving.engine import load_forest_trees
        if params.task != meta.get("task"):
            raise ValueError(
                f"checkpointed boosting model was fitted with "
                f"task={meta.get('task')!r} but the spec says "
                f"{params.task!r}")
        if abs(float(params.learning_rate)
               - float(meta.get("learning_rate", params.learning_rate))) \
                > 1e-12:
            raise ValueError(
                f"checkpointed boosting model used "
                f"learning_rate={meta.get('learning_rate')} but the spec "
                f"says {params.learning_rate} — predictions would rescale "
                f"every round's step")
        stack = trees if trees is not None \
            else load_forest_trees(ckpt_dir, step, device=self.device)
        model = FederatedBoosting(self._apply_session(params),
                                  substrate=self.substrate, device=self.device,
                                  **model_kw)
        model.trees_ = split_rounds(stack)
        model.base_ = float(meta["base"])
        model._partition = partition if partition is not None \
            else self._partition
        stack_parties = int(stack.is_leaf.shape[0])
        if model._partition is not None \
                and model._partition.n_parties != stack_parties:
            raise ValueError(
                f"checkpointed stack has {stack_parties} parties but the "
                f"attached partition has {model._partition.n_parties}; pass "
                f"the partition this model was fitted with (or none)")
        return model

    # ------------------------------------------------------------ programs
    def fit_program(self, spec: ForestParams,
                    hist_impl: str | None = None) -> Callable:
        """The substrate-wrapped forest fit program (``spec`` resolved:
        no "auto" knobs) — fn(xb, feat_gid, feat_sels, weights, y_stats)."""
        return programs.forest_fit_program(
            self.substrate, self._apply_session(spec), hist_impl)

    def predict_program(self, spec: ForestParams, **kw) -> Callable:
        """The substrate-wrapped one-round predict program (see
        programs.forest_predict_program for the knobs)."""
        return programs.forest_predict_program(
            self.substrate, self._apply_session(spec), **kw)

    # ---------------------------------------------------------- observability
    def collect_telemetry(self) -> dict:
        """Roll party-side telemetry up into this process (distributed
        substrate: each live worker's trace spans join the session tracer
        and its metrics merge under a ``party<i>.`` prefix — metadata only,
        the rollup op carries no arrays).  The simulated substrate has
        nothing to collect.  Returns ``{party: {"spans": n, "metrics": n}}``."""
        collect = getattr(self.substrate, "collect_telemetry", None)
        return collect() if collect is not None else {}

    def trace_spans(self) -> list[dict]:
        """Buffered trace spans (session + any collected party spans)."""
        self.collect_telemetry()
        return tracing.TRACER.spans()

    def export_trace(self, jsonl_path: str,
                     chrome_path: str | None = None) -> int:
        """Collect + export the session trace; returns the span count.

        ``jsonl_path`` gets one span per line; ``chrome_path`` optionally
        gets a Chrome trace-event file for chrome://tracing / Perfetto."""
        from repro_torch.observability import export
        spans = self.trace_spans()
        export.export_jsonl(spans, jsonl_path)
        if chrome_path is not None:
            export.write_chrome_trace(spans, chrome_path)
        return len(spans)

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Tear down the session's substrate — a distributed session's party
        processes and sockets; the simulated substrate has nothing to tear
        down."""
        self.substrate.shutdown()

    def __enter__(self) -> "Federation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"Federation(parties={self.parties}, "
                f"substrate={self.substrate.name!r}, "
                f"device={str(self.device)!r})")
