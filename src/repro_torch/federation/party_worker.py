"""The party process: one region's service in the party-per-process substrate.

``worker_main`` dials the coordinator, announces its party index, and serves
protocol messages until shutdown, computing on the device the coordinator
named (the CUDA card, or the CPU):

  * ``run``      — execute a registered protocol body (federation/
    distributed.py: forest fit/predict, F-LR predict, toy conformance),
    exchanging collectives through :class:`~repro_torch.federation.
    distributed.Comm` on the same channel.  Received host arrays become
    tensors on the worker's device; results go back as host arrays.  Body
    exceptions are reported back with their traceback; an ``abort``
    mid-collective drops the run silently.  After each run the worker adds
    the histogram kernel's new launches to its ``kernels.histogram.launches``
    counter, which reaches the coordinator through ``telemetry``.
  * ``load_block`` / ``hash_block_ids`` / ``bin_block`` — the ingest
    handshake: the block (raw features, raw IDs, maybe labels) is loaded and
    *kept here*; only salted hashes, party-locally binned values, and the
    aligned labels ever go back up the wire.
  * ``stream_scan`` / ``stream_bin`` — the same handshake over a chunked
    source streamed here (``streaming.PartyStream`` held by the worker).
  * ``dist_init`` — join a ``torch.distributed`` world as one rank of the
    sharded substrate (federation/sharded.py); ``run`` messages marked
    ``comm: "ranks"`` then exchange their collectives rank to rank
    (``sharded.DistComm``) instead of through the coordinator.
  * ``bind``     — cache large per-party operands (model trees, weight
    blocks), already on the device, under a bind id so serving calls only
    ship the request rows.
  * ``ping``     — health check.
  * ``chaos``    — arm a one-shot injected fault for the NEXT run message:
    ``drop_run`` (swallow it), ``delay_run`` (sleep first), ``die``
    (hard process exit).  Exists for the fault-injection tests.
  * ``telemetry`` — the observability rollup: reply with this process's
    buffered trace spans and metric snapshot (plain metadata — numbers,
    names, ids — never raw arrays), so party-side telemetry aggregates at
    the coordinator without new wire types.

Run messages carry the coordinator's span context under ``_trace``; the
worker attaches it so its spans parent under the coordinator's span.

Workers are daemon processes: if the coordinator dies, so do they.
"""
from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch

from repro_torch.federation import transport
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing


def _init_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:             # "cuda": this process's current card
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        # the forest vote and F-LR's logits are full-float32 products
        # (prediction._check_full_f32), as in the session process
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    else:
        # M workers share the host's cores with the session process: one
        # thread each.  The distributed tests hold the forests these
        # workers build equal, bit for bit, to the session's own
        # multi-threaded simulated fit.
        torch.set_num_threads(1)
    return dev


def worker_main(host: str, port: int, index: int, device: str = "cpu") -> None:
    from repro_torch.federation import sharded
    tracing.TRACER.process = f"party{index}"
    dev = _init_device(device)
    ch = transport.connect(host, port)
    ch.send({"op": "hello", "party": index})
    try:
        _serve(ch, index, dev)
    finally:
        sharded.leave_world()


def _serve(ch, index: int, dev: torch.device) -> None:
    from repro_torch.federation import distributed
    binds: dict[int, dict] = {}
    chaos: dict | None = None
    block = None
    stream = None
    rank = None                       # this worker's DistComm, once a rank
    while True:
        try:
            msg = ch.recv(None)
        except transport.TransportError:
            return                                  # coordinator is gone
        op = msg.get("op")
        if op == "shutdown":
            return
        if op == "ping":
            ch.send({"op": "pong", "party": index,
                     "nonce": msg.get("nonce")})
        elif op == "chaos":
            chaos = {"mode": msg["mode"],
                     "seconds": float(msg.get("seconds") or 0.0)}
            ch.send({"op": "chaos_ack", "nonce": msg.get("nonce")})
        elif op == "bind":
            binds[msg["bind"]] = {int(k): distributed.on_device(v, dev)
                                  for k, v in (msg.get("args") or {}).items()}
            ch.send({"op": "bind_ack", "nonce": msg.get("nonce")})
        elif op == "run":
            with tracing.TRACER.attach(msg.get("_trace")):
                if chaos is not None:
                    mode, secs = chaos["mode"], chaos["seconds"]
                    chaos = None                    # one-shot
                    if mode == "drop_run":
                        continue
                    if mode == "die":
                        os._exit(1)
                    if mode == "delay_run":
                        with tracing.TRACER.span("chaos.delay",
                                                 category="host",
                                                 seconds=secs):
                            time.sleep(secs)
                _handle_run(ch, msg, index, binds, dev, rank)
        elif op == "telemetry":
            ch.send({"op": "telemetry", "party": index,
                     "nonce": msg.get("nonce"),
                     "spans": tracing.TRACER.drain(),
                     "metrics": telemetry.REGISTRY.snapshot()})
        elif op in ("load_block", "hash_block_ids", "bin_block"):
            block = _handle_ingest(ch, msg, block)
        elif op in ("stream_scan", "stream_bin"):
            stream = _handle_stream(ch, msg, stream)
        elif op == "dist_init":
            rank = _handle_dist_init(ch, msg, dev, rank)
        # anything else (stale abort/coll_result of a superseded run): skip


def _handle_dist_init(ch, msg, dev, rank):
    """Join the sharded substrate's ``torch.distributed`` world; returns
    this rank's DistComm (the worker's previous one if it fails)."""
    from repro_torch.federation import sharded
    try:
        comm = sharded.join_world(msg, dev)
        tracing.TRACER.process = f"rank{comm.rank}"
        ch.send({"op": "dist_ready", "nonce": msg.get("nonce"),
                 "rank": comm.rank})
        return comm
    except Exception as e:
        _reply_error(ch, msg.get("nonce"), e)
        return rank


def _handle_run(ch, msg, index, binds, dev, rank) -> None:
    from repro_torch.federation import distributed, sharded
    from repro_torch.kernels import histogram
    rid = msg["run"]
    launches = histogram.histogram_cuda.launches
    try:
        ranks = msg.get("comm") == "ranks"
        programs = ({**distributed.DIST_PROGRAMS, **sharded.RANK_PROGRAMS}
                    if ranks else distributed.DIST_PROGRAMS)
        body = programs.get(msg["name"])
        if body is None:
            raise transport.ProtocolError(
                f"unknown protocol program {msg['name']!r} "
                f"(have {sorted(programs)})")
        if ranks and rank is None:
            raise transport.ProtocolError(
                "a rank program before dist_init: this worker is no rank")
        args = list(msg.get("args") or ())
        for pos, val in (binds.get(msg.get("bound")) or {}).items():
            args[int(pos)] = val
        comm = rank if ranks else distributed.Comm(
            ch, rid, msg["party_index"], msg["n_parties"], dev)
        with tracing.TRACER.span(f"worker.{msg['name']}",
                                 category="compute", rid=rid, party=index):
            out = body(comm, msg.get("payload") or {}, *args)
        ch.send({"op": "result", "run": rid, "data": out})
    except distributed.RunAborted:
        pass                                        # superseded: back to idle
    except Exception as e:                          # report, don't die
        try:
            ch.send({"op": "error", "run": rid,
                     "message": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()})
        except transport.TransportError:
            pass
    finally:
        new = histogram.histogram_cuda.launches - launches
        if new:
            telemetry.REGISTRY.counter("kernels.histogram.launches").inc(new)


def _reply_error(ch, nonce, e: Exception) -> None:
    try:
        ch.send({"op": "error", "nonce": nonce,
                 "message": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()})
    except transport.TransportError:
        pass


def _check_unique(name, ids) -> None:
    if np.unique(ids).size != ids.size:
        raise ValueError(
            f"party {name!r} has duplicate sample IDs: alignment would be "
            f"ambiguous — deduplicate before ingest")


def _handle_ingest(ch, msg, block):
    """The party side of distributed_ingest; returns the (new) held block."""
    from repro_torch.core import binning
    from repro_torch.core.partyblock import CSVSource, PartyBlock
    op, nonce = msg["op"], msg.get("nonce")
    try:
        if op == "load_block":
            spec = msg["source"]
            if spec["kind"] == "csv":
                block = CSVSource(
                    path=spec["path"], name=spec.get("name"),
                    id_column=spec.get("id_column", "id"),
                    label_column=spec.get("label_column", "label"),
                    delimiter=spec.get("delimiter", ",")).load()
            else:
                names = spec.get("feature_names")
                block = PartyBlock(
                    name=spec["name"], x=spec["x"], ids=spec["ids"],
                    y=spec.get("y"), feature_ids=spec.get("feature_ids"),
                    feature_names=tuple(names) if names else None)
            ch.send({"op": "block_meta", "nonce": nonce,
                     "name": block.name, "n_features": block.n_features,
                     "feature_ids": block.feature_ids,
                     "has_y": block.y is not None})
        elif op == "hash_block_ids":
            if block is None:
                raise RuntimeError("no block loaded (load_block first)")
            _check_unique(block.name, block.ids)
            ch.send({"op": "hashes", "nonce": nonce,
                     "hashes": block.hashed_ids(msg["salt"])})
        else:                                       # bin_block
            if block is None:
                raise RuntimeError("no block loaded (load_block first)")
            pos = np.asarray(msg["positions"], np.int64)
            x_i = block.x[pos]
            if block.feature_ids is not None:       # party-local order ->
                x_i = x_i[:, np.argsort(block.feature_ids)]  # ascending gid
            xb_i, b_i = binning.bin_dataset(x_i, int(msg["n_bins"]))
            # Aligned labels return to the coordinator session: the paper's
            # trust model (§4.3) keeps labels with the label-owner driving
            # training, and fit-time masking (mask_regression_targets /
            # encode_labels) applies downstream when privacy flags are set.
            # `block.y[pos]` is a fancy-index COPY (a slice would be a
            # tagged view), so the runtime guard agrees with this
            # suppression by construction.
            ch.send({"op": "binned", "nonce": nonce, "xb": xb_i,  # egress: ok(aligned labels to the coordinator/label-owner session per the paper's trust model; masked downstream when privacy flags are set)
                     "boundaries": b_i,
                     "y": block.y[pos] if block.y is not None else None})
    except Exception as e:
        _reply_error(ch, nonce, e)
    return block


def _handle_stream(ch, msg, stream):
    """The party side of distributed_streaming_ingest; returns the held
    PartyStream.  The stream (raw chunks scanned from this party's own
    source, raw IDs, sketches) lives here; only hashed IDs, sketch-derived
    boundaries, binned values, and the aligned labels go back up the wire."""
    from repro_torch import streaming
    from repro_torch.core import crypto
    from repro_torch.federation.distributed import stream_source_from_spec
    op, nonce = msg["op"], msg.get("nonce")
    try:
        if op == "stream_scan":
            source = stream_source_from_spec(msg["source"])
            if msg.get("append"):
                if stream is None:
                    raise RuntimeError(
                        "no stream held (stream_scan without append first)")
            else:
                stream = streaming.PartyStream(
                    chunk_rows=int(msg["chunk_rows"]),
                    capacity=int(msg["capacity"]),
                    salt=msg.get("salt", crypto.DEFAULT_SALT))
            stream.extend(source)
            merged = stream.merged_scan()
            _check_unique(merged.name, merged.ids)
            ch.send({"op": "stream_meta", "nonce": nonce,
                     "name": merged.name, "n_rows": merged.n_rows,
                     "hashes": merged.hashes,
                     "feature_ids": merged.feature_ids,
                     "n_features": merged.sketches.n_features,
                     "has_y": merged.y is not None})
        else:                                       # stream_bin
            if stream is None:
                raise RuntimeError("no stream held (stream_scan first)")
            pos = np.asarray(msg["positions"], np.int64)
            xb_i, b_i, y_i = streaming.party_stream_bin(
                stream, pos, int(msg["n_bins"]))
            ch.send({"op": "stream_binned", "nonce": nonce, "xb": xb_i,
                     "boundaries": b_i, "y": y_i})
    except Exception as e:
        _reply_error(ch, nonce, e)
    return stream
