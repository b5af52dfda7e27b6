#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a host with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main path on the card, in phases; a failure in any
phase ends the run with a non-zero exit and no result line.

  1. build    — compile the CUDA histogram kernel from the checkout's source;
  2. kernel   — hold the kernel against its plain PyTorch version at the
                main path's shapes (integer stats bit-equal, float stats
                within rtol = atol = 1e-5, two launches bit-identical), hold
                each party's slice of the features, and one that straddles
                a feature group, bit-equal to the whole launch at the main
                shape, and time it beside the plain version and
                ``index_add_`` (float stats; the integer route's time
                beside), with its blocks per launch and scratch bytes;
                then at the boosting shape (L = 32, C = 3) on signed
                stats, each cell within the float route's error model
                (γ from ``launch_plan``'s summation depth, times the
                histogram of |stats|), its err/bound printed;
  3. main     — the paper's target-marketing table at full size (156,198
                customers x 95 features, two parties): ingest -> fit ->
                one-round predict through ``Federation``, with the kernel's
                launches counted, and the losslessness check FF(2) == FF(1);
                then one more fit and predict under ``torch.profiler``, for
                the device's busy time, idle share and kernels by time;
  4. frontier — regression at the superconduct size with depth 10, so the
                multi-pass frontier runs through the kernel; FF(2) == FF(1)
                bit for bit on the card;
  5. cpu      — at the quickstart's size, the classification forest fitted
                on the card equals the one fitted on the CPU, bit for bit;
                on a small regression fixture without near-ties, the same
                splits and leaf stats within rtol 1e-5;
  6. attention — the flash-attention kernel against its plain version on
                the sweep of tests/test_kernels.py in both types (bfloat16
                through the tensor-core route, float32 through the CUDA-core
                route), windows, a ragged causal Sq > Sk (rows without keys
                exactly 0), Sq = Sk = 1000 (no multiple of a tile) and the
                serving path's prefill shape (float32 within 2e-3, bfloat16
                within 3e-2 and, element by element, within the tensor-core
                route's error model; two launches bit-identical and
                counted); timed
                beside the plain version and
                ``scaled_dot_product_attention``, with the TFLOP/s achieved;
  7. serve    — dense-LM serving at internlm2-1.8b's full width and depth
                (bf16, random weights from a seed): two waves of prefill
                (8 x 2048 tokens) and 32 greedy tokens through
                ``launch/serve.py::serve_batch``, one kernel launch per layer
                per prefill; a third wave traced, with the attention
                kernel's device time and its share of the prefill; then, in
                float32 at 2 layers, the last logits of prefill(S + 1)
                (attention through the kernel) against prefill(S) +
                decode_step(S) (attention through the plain
                ``_sdpa_chunked``);
  8. party-first — phase 3's table cut into two shuffled party extracts
                (``make_party_views``: ~105k common rows plus ~5.9k rows
                only one party holds, string IDs), and through them: party
                blocks ingested in memory (trees and predictions equal to
                the pre-aligned matrix's, bit for bit); each block written
                to a CSV and streamed back out-of-core (16,384-row chunks,
                the sketch exact: partition, labels, IDs and forest equal);
                a versioned append (80 % as version 1, the rest as version
                2) equal to the whole stream; ``fit_resumable`` in chunks
                of 5 trees equal to a from-scratch fit — extended from 10
                to 20 trees with only the new trees' kernel launches,
                resumed after the newest chunk is deleted, restarted by the
                fingerprint after the append — and ``save`` -> ``load`` in
                a fresh session predicting the fitted model's predictions;
                with host seconds of each ingest, ``fit_resumable`` against
                ``fit`` (and the two in turn, twice each),
                checkpoint bytes and save / restore ms;
  9. boosting — binary boosting on phase 3's table (50 rounds, depth 6)
                and regression boosting at the superconduct size, each with
                FB(2) == FB(1) bit for bit, training loss non-increasing,
                seconds and histogram launches a round, and one boosting
                fit traced; save -> load; on small fixtures, every round
                refitted on the CPU from the card's margin with the same
                splits; F-LR (400 steps) on the card against the CPU; and
                phase 3's forest predicted by the classical multi-round
                protocol, equal to the one-round prediction bit for bit;
 10. serve    — phase 3's forest behind ``fed.serve`` (buckets 32/256/2048,
                one CUDA graph captured per bucket at warmup and none
                after): its 39,050 test rows (19 waves of 2048 + one of 256)
                equal to ``fed.predict`` bit for bit, dense == compact,
                timed in turn with ``fed.predict``; 400 requests of 1-99
                rows (``rng.integers(1, 100)``, seed 0) through a
                ``RequestQueue`` at ``max_inflight`` 1 and 4, each request
                equal to ``predict``, sync == async, with wave p50/p95/p99,
                rows/s and party-sum bytes, and one drain traced; phase 9's
                boosting and F-LR models served equal to their ``predict``
                (the F-LR logits' largest difference printed);
                ``ForestServer.from_checkpoint``; a 4-cell fleet on the one
                card drained on threads (buckets captured lazily inside the
                drains), equal to the single server, then ``kill_cell`` with
                half the traffic pending: nothing lost, ``FleetMetrics``
                printed;
 11. distributed — the party-per-process substrate on the one card: two
                party worker processes ingest phase 8's extracts (partition,
                labels and hashed IDs equal to the in-process ingest), fit
                phase 3's forest with the histogram kernel over their own
                columns (the simulated fit's PartyTree, all seven fields;
                each worker's launches counted through the telemetry
                rollup), serve the 39,050 test rows through ``fed.serve``
                and ``fed.predict`` 2,048 of them (equal to the in-process
                predict); the fit's seconds, wire bytes and collective
                rounds, served rows/s and wave p50/p95 printed; then on
                tests/test_distributed.py's 3-party fixture a killed party:
                degraded answers equal to the surviving trees' forest, and
                refused without ``allow_degraded``;
 12. privacy  — the port's egress linter over ``src/repro_torch`` and this
                script (0 findings); then, with the guard armed
                (``REPRO_EGRESS_GUARD=1`` before the spawn, so the workers
                enforce it too), phase 11's ingest -> fit -> serve again,
                equal to phase 11's partition, labels, hashed IDs, PartyTree
                (all seven fields) and served answers bit for bit, 340
                histogram launches in each worker, the guarded fit and
                serve timed beside phase 11's and the messages checked in
                the session counted; raw payloads (a block's ``x``, a column
                view, ``torch.from_numpy(x)``, a CPU-tensor slice, ``ids``)
                sent through a real TCP ``Channel`` refused with their key
                paths, hashed IDs passed and round-tripped;
 13. sharded  — the sharded substrate (``torch.distributed`` ranks, one
                per mesh position, collectives rank to rank): (a) on a
                (trees=1, parties=2) gloo mesh, two ranks on the card, phase
                11's party-first ingest and phase 3's forest — the PartyTree
                (all seven fields) equal to the simulated and distributed
                fits, 340 histogram launches a rank, collective rounds and
                bytes per fit (staged bytes too), the 39,050 test rows
                served equal to ``fed.predict``; F-LR on the same ranks
                (labels equal); (b) the same fit on a (2, 2) mesh, four
                ranks on the card, 170 launches a rank; (c) boosting on a
                (2, 1) mesh with ``tree_sharded=False`` equal to the
                simulated substrate; (d) NCCL at one rank (two with two
                cards) equal to the simulated FF(M); (e) phase 8's extracts
                as Parquet, streamed in 16,384-row chunks, equal to the
                in-memory ingest (partition, labels, IDs, forest); (f) the
                train CLI at the paper's size (8 trees, depth 6; accuracy
                equal to the session's) and over phase 8's CSVs with
                ``--ckpt-dir``,
                killed after its first chunk and rerun; (g) the trace CLI
                over phase 11's span file (exit 0, sections, Chrome file);
                (h) on (a)'s ranks ``hist_subtraction`` fits (alone and
                with a frontier cap of 64) equal to the plain forest, and
                the classical predict (one party sum per level, rank to
                rank) equal to ``predict``; both on (b)'s too;
 14. train and MoE — (a) one training step of internlm2-1.8b at full
                width (2 layers, float32, batch 2 x 128) on the card
                against the CPU from the same weights: loss within rtol
                1e-5, every gradient leaf within 1e-3 of its largest
                magnitude, the parameters after one AdamW step within
                1e-3·lr where the gradient is at least 1e-2 of its leaf's
                largest (2·lr elsewhere: Adam's first step amplifies
                rounding in near-zero gradients); (b) micro_batch 2 against
                8 on the card, the same bounds; (c) internlm2-1.8b at full
                width and depth (bf16, remat "unit", batch 8 x 2048,
                micro_batch 2, 10 steps at lr 3e-4): CE at step 0 within 2
                of ln V and falling, ms a step, tokens/s, 6·N·tokens/s over
                the bf16 peak, peak memory, one step traced; no flash
                launch in any training step; (d) the MoE layer at
                qwen2-moe-a2.7b's full width in float32, card against CPU:
                the same kept slots, y within 1e-4 of its largest
                magnitude, aux within 1e-6; (e) qwen2-moe-a2.7b served at
                full width and depth (bf16, random weights): two waves of
                8 x 2048 prompts + 32 greedy tokens, 24 flash launches a
                prefill, a prefill traced, the MoE layer timed; (f)
                qwen2-moe-a2.7b trained at full width (2 layers, bf16, 10
                steps on one batch, as tests/test_archs_smoke.py's
                test_train_step_reduces_loss): CE falls;
 15. SSM, xLSTM, hybrid — (a) the Mamba2 (zamba2-7b's width), mLSTM and
                sLSTM (xlstm-350m's) blocks at full width in float32, card
                against CPU from one set of weights (300 tokens, then a
                decode step from the cache): y and every cache leaf within
                1e-4 of the leaf's largest magnitude; ``chunked_ssd`` at
                zamba2-7b's head shape (H 112, P 64, N 64, chunk 256)
                against the float64 recurrence; (b) phase 6's check at head
                dim 112 (bf16 within 3e-2 and ``_bf16_bound``, float32
                within 2e-3, two launches bit-equal), timed at zamba2-7b's
                prefill shape beside SDPA, with the bound; (c) zamba2-7b
                served at full width and depth (bf16, random weights,
                phase 7's two waves; 13 flash launches a prefill, one a
                shared-attention use), one prefill traced; float32
                prefill(S+1) against prefill(S) + decode at 9 layers (one
                unit and the tail); (d) xlstm-350m served the same way (no
                flash launch), the float32 check at 4 layers; (e) a float32
                training step card == CPU at zamba2-7b's full width, 6
                layers, batch 1 x 64 (phase 14 (a)'s bounds); xlstm-350m
                at full width and depth (8 x 128) and zamba2-7b at full
                width and 6 layers (8 x 512) trained in bf16, remat "unit",
                2 and 6 steps on one batch: CE from within 2 of ln V, falling,
                no flash launch, one zamba2-7b step traced.
 16. encoder-decoder and VLM — (a) phase 6's check on whisper-large-v3's
                shapes, non-causal: the encoder's self-attention (B 8, H
                20, Sq = Sk = 1500, D 64: a ragged last key tile) and the
                cross-attention (Sq 416, Sk 1500), bf16 timed beside SDPA
                (``is_causal=False``) and the bound, float32 twins
                untimed; (b) whisper-large-v3 served at full width and
                depth (32 encoder + 32 decoder layers, bf16, random
                weights): two waves of 8 prompts of 416 tokens with 8 x
                1500 frames from ``synthetic_lm_batches``, 32 greedy
                tokens, 96 flash launches a prefill (encoder, decoder
                self- and cross-attention), one wave traced; (c)
                qwen2-vl-2b served the same way on phase 7's waves, the
                first 256 positions patches, 28 flash launches a prefill;
                (d) both in float32 at full width and 2 layers: prefill(S+1)
                against prefill(S) + decode within 2e-3 (argmax equal), and
                a training step card == CPU (phase 14 (a)'s bounds); (e)
                both trained at full width, 8 layers (whisper 8 + 8), in
                bf16, remat "unit", 3 steps at lr 3e-4 on one batch
                (whisper 8 x 448 with 8 x 1500 frames; qwen2-vl 8 x 2048
                in microbatches of 2): CE from within 2 of ln V, falling,
                no flash launch, one step of each traced;
 17. sharded LM — (a) phi3.5-moe-42b-a6.6b at full width, 2 layers,
                float32, tensor- and expert-parallel
                (``models/parallel.py::ShardedLM``, one process a rank,
                weights drawn leaf by leaf from the unsharded model's seed):
                on a (data, model) = (1, 1) NCCL rank bit-equal to the
                unsharded model (logits, 8 greedy tokens), on (1, 2) gloo
                ranks sharing the card within 2e-3 with argmax equal, one
                flash launch a layer a prefill on each rank, and on both a
                decode step against the unsharded prefill(S+1) within 2e-3
                (at a capacity of 8.0, which drops nothing);
                (b) the bf16 attention levers (``attn_probs_bf16``,
                ``attn_scores_bf16``) at decode, internlm2-1.8b at full
                width, 2 layers: card == CPU within 2e-2, the lever moving
                the logits; (c) phase 6's check at a model rank's prefill
                shape on four cards (B 8, H 8, S 2048, D 128, causal),
                timed beside SDPA and the bound;
 18. sharded training — (a) phi3.5-moe-42b-a6.6b at full width, 1
                layer, float32, FSDP × tensor-parallel
                (``ShardedLM(..., mode="train")``: ``param_specs(mode=
                "train")``, ``opt_specs``, a rank's rows of the batch): the
                unsharded step's loss, CE, aux and gradients on the card
                (moved to the host, the model freed) against a (data,
                model) = (1, 1) NCCL rank bit for bit, and (2, 1) and (1, 2)
                gloo ranks sharing the card within rtol 1e-5 (loss, CE, aux)
                and 1e-3 of each leaf's largest gradient (every 97th element
                of each rank's slice), no flash launch, FSDP gathers at (2,
                1); (b) on the (1, 1) rank, 2 layers in bf16, two steps on
                8 x 1024 under each remat policy ("unit", "dots",
                "attn_out"): the second's seconds and the peak memory.
 19. sharded layouts — on gloo ranks sharing the card, float32, full
                width, 1 layer: (a) glm4-9b at (data, model) = (1, 4), its
                2 kv heads each replicated on the two ranks whose q heads
                read it: served (logits within 2e-3 of the unsharded
                model's, argmax equal, one flash launch a rank, a decode
                step against the unsharded prefill(S+1) within 2e-3) and
                trained (loss, CE within rtol 1e-5, every leaf's gradient
                slice within 1e-3 of its largest, the shared kv heads'
                gradients bit-equal on their two ranks); (b) phi3.5-moe
                with ``expert_data`` (the expert stacks split over "data")
                at (2, 1) and (2, 2): a step against the unsharded step
                (phase 18's bounds) and phase 18's default (2, 1) loss, no
                expert stack gathered, timed beside phase 18's (2, 1) step,
                and at (2, 2) served (logits within 2e-3, argmax equal);
                (c) the flash kernel at a model rank's whisper-large-v3 (5
                heads: encoder 1500 x 1500, cross 416 on 1500, decoder 416
                causal, D 64) and qwen2-vl-2b (3 heads, 2048 causal, D 128)
                shapes at phase 6's bounds, timed beside SDPA and the
                bound; then whisper-large-v3 (1 encoder and 1 decoder layer,
                its 1500 frames) and qwen2-vl-2b (1 layer, its 256 patches)
                rebuilt in place on (a)'s (1, 4) and (b)'s (2, 2) ranks,
                their stubs passed beside the tokens, served and trained
                at (a)'s bounds (3 and 1 flash launches a rank a prefill);
                (d) the flash kernel at a model rank's zamba2-7b shape (8
                of its 32 heads, 2048 causal, D 112) timed beside SDPA and
                the bound, then zamba2-7b (one pattern unit: 5 Mamba2
                layers and a use of the shared attention block) and
                xlstm-350m (an mLSTM and an sLSTM layer) rebuilt on the
                same two worlds, each rank holding its heads of every
                recurrent leaf: served and trained at (a)'s bounds (1 and
                0 flash launches a rank a prefill; at (1, 4) 2 collective
                rounds a layer and 2 more a prefill).
 20. dry run  — (a) the dry run (``launch/cases.py``: one rank's step on
                fake tensors, counted by ``op_analysis.py`` against the
                H100 peaks of ``roofline.py``) of phase 7's serving wave
                and phase 14 (c)'s training step, on the host, held
                against what they measured: predicted peak within 15 %
                of ``max_memory_allocated``, the least time no greater
                than the measured time (the share printed), 24 flash
                launches counted a prefill; (b) whisper-large-v3 (1 + 1
                layers), qwen2-vl-2b (1 layer) and xlstm-350m (2 layers)
                at full width on 8 gloo ranks sharing the card, their
                20 / 12 / 4 heads in uneven runs of whole heads: served
                and trained at phase 19 (a)'s bounds (3 / 1 / 0 flash
                launches a rank a prefill).

Float32 products run in full float32 (no TF32) throughout.  The last lines
are each phase's seconds, the whole run's seconds, the card's name and
power limit, a JSON object with the kernels' numbers, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"



def _rl():
    """The card's peaks (device memory rate, float32 and bf16 product
    rates), each with its source, from the port's ``roofline.py``."""
    from repro_torch import roofline
    return roofline
L2_FLUSH_BYTES = 128 << 20     # more than the 50 MB L2 cache
SPLIT_FIELDS = ("is_leaf", "has_split", "split_floc", "split_bin", "owner",
                "split_gid")


PHASE_STARTS: list = []         # (phase number, start time), for the summary
# what phases 7 and 14 (c) measured, which phase 20 (a) predicts
MEASURED: dict = {}


def _phase(name: str):
    print(f"== phase {name}", flush=True)
    PHASE_STARTS.append((name.split()[0], time.perf_counter()))
    return PHASE_STARTS[-1][1]


def _phase_seconds(end: float) -> dict:
    """Each phase's seconds, from its start to the next one's (the last
    to ``end``)."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [end]
    return {n: round(e - t, 1) for (n, t), e in zip(PHASE_STARTS, ends)}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, torch, reps: int = 10, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, CUDA events around
    each, with the L2 cache flushed before each when ``flush`` is given."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


class _Lap:
    """Prints each sub-step's seconds of a phase as the sub-step ends."""

    def __init__(self, phase: str):
        self.phase, self.t = phase, time.perf_counter()

    def __call__(self, step: str) -> None:
        now = time.perf_counter()
        print(f"[phase {self.phase} ({step}): {now - self.t:.1f} s]",
              flush=True)
        self.t = now


def _host_s(fn, torch, reps: int = 3) -> float:
    """Mean host seconds of ``fn`` over ``reps`` calls after one warm call,
    ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def phase_kernel(torch, hist, ref, ops) -> list[dict]:
    """Kernel vs plain version at the main path's histogram shapes."""
    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    shapes = [  # (what, N, F, B, L, C)
        ("classification root", 117148, 96, 32, 1, 2),
        ("classification depth 3", 117148, 96, 32, 8, 2),
        ("classification depth 7", 117148, 96, 32, 128, 2),
        ("regression frontier pass", 15947, 82, 64, 256, 3),
        # the node stats: one all-zero column, one bin (tree.py build_tree)
        ("node stats classification", 117148, 1, 1, 128, 2),
        ("node stats regression", 15947, 1, 1, 512, 3),
    ]
    rows = []
    for what, n, f, b, lv, c in shapes:
        g = torch.Generator(device=dev).manual_seed(n + f + lv)
        xb = torch.randint(0, b, (n, f), generator=g, device=dev,
                           dtype=torch.int32).to(torch.uint8)
        seg = torch.randint(-1, lv, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        counts = torch.randint(0, 4, (n,), generator=g, device=dev)
        onehot = torch.nn.functional.one_hot(
            torch.randint(0, c, (n,), generator=g, device=dev), c)
        int_stats = (counts[:, None] * onehot).to(torch.float32).contiguous()
        # float stats are positive, as weights and weighted y^2 are: a cell
        # then sums without cancellation, its relative error is about
        # sqrt(n)*2^-24 in any order, and rtol = atol = 1e-5 is a real bound
        flt_stats = torch.rand((n, c), generator=g, device=dev)
        xc = hist.column_major(xb)

        got = hist.histogram_cuda(xc, seg, int_stats, lv, b)
        again = hist.histogram_cuda(xc, seg, int_stats, lv, b)
        want = ref.histogram_ref(xb, seg, int_stats, lv, b)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: integer stats not bit-equal to "
                                 f"histogram_ref")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two launches differ")
        got = hist.histogram_cuda(xc, seg, flt_stats, lv, b)
        again = hist.histogram_cuda(xc, seg, flt_stats, lv, b)
        want = ref.histogram_ref(xb, seg, flt_stats, lv, b)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{what}: float stats beyond 1e-5")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two launches differ (float)")
        err = float((got - want).abs().max())

        flat, vals = ops._flat_buckets(xb, seg, flt_stats, lv, b)
        lib_out = torch.zeros((lv * f * b + 1, c), device=dev)
        ms = _time_ms(lambda: hist.histogram_cuda(xc, seg, flt_stats, lv, b),
                      torch, flush=flush)
        # the integer route, which classification fits take
        int_ms = _time_ms(lambda: hist.histogram_cuda(xc, seg, int_stats, lv,
                                                      b), torch, flush=flush)
        plain_ms = _time_ms(lambda: ref.histogram_ref(xb, seg, flt_stats, lv, b),
                            torch, reps=3, flush=flush)
        library_ms = _time_ms(lambda: lib_out.index_add_(0, flat, vals),
                              torch, flush=flush)
        if what == "classification depth 7":
            # each party's slice of the folded features, and one straddling
            # a feature-group boundary, against the whole launch
            for lo, hi in ((0, 48), (48, 96), (5, 53)):
                part = hist.histogram_cuda(hist.column_major(xb[:, lo:hi]),
                                           seg, flt_stats, lv, b)
                if not torch.equal(part, got[:, lo:hi]):
                    raise AssertionError(f"{what}: features [{lo}, {hi}) "
                                         f"alone differ from the whole launch")
            print(f"{what}: feature slices [0, 48), [48, 96), [5, 53) "
                  f"bit-equal to the whole launch (float stats): True")
        plan = hist.launch_plan(n, f, lv, b, c, hist.smem_limit(dev.index or 0))
        live = int((seg >= 0).sum())
        n_bytes = n * f + 4 * n + 4 * n * c + 4 * lv * f * b * c
        n_ops = live * f * c
        t_bytes = n_bytes / _rl().HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / _rl().F32_FLOPS * 1e3
        row = {"shape": f"N={n} F={f} B={b} L={lv} C={c}", "what": what,
               "max_abs_err": err, "ms": ms, "int_ms": int_ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "blocks": plan.blocks, "launches_per_call": plan.launches,
               "scratch_bytes": 4 * plan.part}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del xb, xc, seg, int_stats, flt_stats, flat, vals, lib_out, got, want
        torch.cuda.empty_cache()
    return rows


def phase_kernel_signed(torch, hist, ref, ops) -> dict:
    """The histogram at the boosting shape: a round's level launch at depth
    5 (N 117,148, F 96, B 32, L = 32) on boosting's C = 3 float stats
    (hh, hh·p, hh·p²), whose middle channel is signed and sums to 0 at
    the root.  A flat rtol cannot hold on such cancelling sums, so each
    cell is held to the error model of the sums: within (γ_k + γ_p)·H|s|
    of the plain version, where H|s| is the histogram of |stats|, γ_k the
    kernel's (``launch_plan``'s summation depth) and γ_p the plain
    version's (a contraction over N samples); and within γ_k·H|s| of the
    float64 histogram.  Two launches are bit-equal."""
    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    n, f, b, lv, c = 117148, 96, 32, 32, 3
    g = torch.Generator(device=dev).manual_seed(16)
    xb = torch.randint(0, b, (n, f), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    seg = torch.randint(-1, lv, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    # hessians of a logistic loss (p(1 - p) <= 1/4) and Newton targets
    # centred so that the gradients sum to 0, as at a round's root
    hh = torch.rand(n, generator=g, device=dev, dtype=torch.float64) / 4 \
        + 1e-6
    pseudo = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    pseudo -= (hh * pseudo).sum() / hh.sum()
    stats = torch.stack([hh, hh * pseudo, hh * pseudo * pseudo],
                        -1).float().contiguous()
    xc = hist.column_major(xb)
    got = hist.histogram_cuda(xc, seg, stats, lv, b)
    again = hist.histogram_cuda(xc, seg, stats, lv, b)
    if not torch.equal(got, again):
        raise AssertionError("signed C = 3: two launches differ")
    want = ref.histogram_ref(xb, seg, stats, lv, b)
    flat, vals = ops._flat_buckets(xb, seg, stats, lv, b)

    def f64_hist(v):
        out = torch.zeros((lv * f * b + 1, c), dtype=torch.float64,
                          device=dev)
        return out.index_add_(0, flat, v.double())[:-1].reshape(lv, f, b, c)
    exact, habs = f64_hist(vals), f64_hist(vals.abs())
    plan = hist.launch_plan(n, f, lv, b, c, hist.smem_limit(dev.index or 0))
    u = n * 2.0**-24
    gamma_plain = u / (1 - u)
    tiny = torch.finfo(torch.float64).tiny
    vs_plain = float(((got.double() - want.double()).abs()
                      / ((plan.gamma + gamma_plain) * habs + tiny)).max())
    vs_exact = float(((got.double() - exact).abs()
                      / (plan.gamma * habs + tiny)).max())
    if not (vs_plain <= 1 and vs_exact <= 1):
        raise AssertionError(f"signed C = 3: err/bound {vs_plain:.3g} "
                             f"against the plain version, {vs_exact:.3g} "
                             f"against float64")
    root = float(exact[..., 1].sum(dim=(0, 2))[0])
    lib_out = torch.zeros((lv * f * b + 1, c), device=dev)
    ms = _time_ms(lambda: hist.histogram_cuda(xc, seg, stats, lv, b), torch,
                  flush=flush)
    plain_ms = _time_ms(lambda: ref.histogram_ref(xb, seg, stats, lv, b),
                        torch, reps=3, flush=flush)
    library_ms = _time_ms(lambda: lib_out.index_add_(0, flat, vals), torch,
                          flush=flush)
    live = int((seg >= 0).sum())
    n_bytes = n * f + 4 * n + 4 * n * c + 4 * lv * f * b * c
    t_bytes = n_bytes / _rl().HBM_BYTES_PER_S * 1e3
    t_ops = live * f * c / _rl().F32_FLOPS * 1e3
    row = {"shape": f"N={n} F={f} B={b} L={lv} C={c}",
           "what": "boosting level, signed stats",
           "max_abs_err": float((got - want).abs().max()),
           "err_over_bound": vs_plain, "err_over_bound_f64": vs_exact,
           "gamma_kernel": plan.gamma, "gamma_plain": gamma_plain,
           "sum_depth": plan.sum_depth, "root_sum_channel1": root,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "blocks": plan.blocks, "launches_per_call": plan.launches,
           "scratch_bytes": 4 * plan.part}
    print(json.dumps(row), flush=True)
    print(f"signed C = 3 (channel 1 over all cells of feature 0 sums to "
          f"{root:.3g}): largest err/bound {vs_plain:.4f} against the plain "
          f"version, {vs_exact:.4f} against float64 (γ_k {plan.gamma:.3g} "
          f"for depth {plan.sum_depth}, γ_p {gamma_plain:.3g}); two launches "
          f"bit-equal: True", flush=True)
    return row


def _attention_work(torch, b, h, sq, sk, d, dtype, causal, window):
    """(operations, bytes) of one attention call: the two products over the
    (query, key) pairs these masks leave visible, and q, k, v and the
    output moved once (``kernels/attention.py::attention_work``, the
    formula the dry run's op counter counts the kernel by)."""
    from repro_torch.kernels.attention import attention_work
    size = 2 if dtype == torch.bfloat16 else 4
    return attention_work(b, h, sq, sk, d, size, causal, window)


def _attention_bound(n_ops, n_bytes, dtype, torch):
    """(bound ms, what bounds it): the operations over the peak rate of the
    inputs' type (bf16 tensor cores, or float32 on the CUDA cores) against
    the bytes over the memory rate."""
    rate = _rl().peak_flops(str(dtype).removeprefix("torch."))
    t_ops, t_bytes = n_ops / rate * 1e3, n_bytes / _rl().HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _bf16_bound(torch, ref, q, k, v, want, kw):
    """The largest difference the bf16 route's numbers allow, per output
    element: P rounded to bf16 moves an output by at most 2^-8 of the
    attention over |v| (taken twice), and the kernel's and the plain
    version's bf16 outputs differ by at most one ulp, 2^-7 |want|."""
    scale = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                    **kw)
    return 2**-7 * (scale + want.float().abs()) + 1e-5


def phase_attention(torch, attn, ref, cases=None) -> list[dict]:
    """The flash-attention kernel against its plain version (tolerances of
    tests/test_kernels.py: float32 2e-3, bfloat16 3e-2; bfloat16 also
    within ``_bf16_bound`` element by element), deterministic, two launches
    counted per two calls, with exact zero rows; timed at the serving
    path's prefill shape.  ``cases`` (what, B, H, Sq, Sk, D, dtype, causal,
    window, timed) replace phase 6's."""
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    default = [(f"sweep Sq={sq} Sk={sk} D={d} causal={c}" + ("" if dt == f32
              else " bf16"), 1, 2, sq, sk, d, dt, c, None, False)
             for dt in (f32, bf16)
             for sq, sk, d in ((128, 128, 64), (256, 256, 64), (128, 384, 128))
             for c in (True, False)]
    default += [
        ("window 128 f32", 2, 2, 256, 256, 64, f32, True, 128, False),
        ("window 128 bf16", 2, 2, 256, 256, 64, bf16, True, 128, False),
        ("window 16 f32", 1, 2, 96, 160, 64, f32, False, 16, False),
        ("window 16 bf16", 1, 2, 96, 160, 64, bf16, False, 16, False),
        ("ragged causal Sq=200 > Sk=72", 1, 2, 200, 72, 64, f32, True, None,
         False),
        ("ragged causal Sq=200 > Sk=72 bf16", 1, 2, 200, 72, 64, bf16, True,
         None, False),
        ("Sq=Sk=1000 bf16", 2, 2, 1000, 1000, 128, bf16, True, None, False),
        # the serving path's prefill: internlm2-1.8b, batch 8, 2048 tokens
        ("prefill bf16", 8, 16, 2048, 2048, 128, bf16, True, None, True),
        ("prefill f32 B=1", 1, 16, 2048, 2048, 128, f32, True, None, True),
    ]
    cases = cases or default
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []
    for what, b, h, sq, sk, d, dt, causal, window, timed in cases:
        g = torch.Generator(device=dev).manual_seed(sq * 7 + sk + d)
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(dt)
                   for s in (sq, sk, sk))
        kw = {"causal": causal, "window": window}
        before = attn.flash_attention.launches
        got = attn.flash_attention(q, k, v, **kw)
        again = attn.flash_attention(q, k, v, **kw)
        n_launches = attn.flash_attention.launches - before
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 2e-3 if dt == f32 else 3e-2
        if got.dtype != dt or got.shape != q.shape:
            raise AssertionError(f"{what}: output {got.dtype} "
                                 f"{tuple(got.shape)}")
        if n_launches != 2:
            raise AssertionError(f"{what}: {n_launches} kernel launches "
                                 f"counted for 2 calls")
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"{what}: beyond {tol} of the plain version")
        diff = (got.float() - want.float()).abs()
        if dt == bf16:
            ratio = float((diff / _bf16_bound(torch, ref, q, k, v, want, kw))
                          .max())
            if not ratio <= 1:
                raise AssertionError(f"{what}: {ratio:.3f} times the bf16 "
                                     f"route's error bound")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two launches differ")
        if sq > sk and causal and not bool((got[:, :, :sq - sk] == 0).all()):
            raise AssertionError(f"{what}: rows without a visible key are "
                                 f"not exactly 0")
        row = {"what": what, "shape": f"B={b} H={h} Sq={sq} Sk={sk} D={d} "
               f"{str(dt)[6:]} causal={causal} window={window}",
               "route": attn.attention_plan(d, dt, sq, sk).route,
               "max_abs_err": float(diff.max())}
        if dt == bf16:
            row["err_over_bound"] = ratio
        if timed:
            row["ms"] = _time_ms(lambda: attn.flash_attention(q, k, v, **kw),
                                 torch, flush=flush)
            row["plain_ms"] = _time_ms(
                lambda: ref.flash_attention_ref(q, k, v, **kw), torch,
                reps=3, flush=flush)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            # top-left causal alignment equals ours only at Sq == Sk
            row["library_ms"] = _time_ms(
                lambda: sdpa(q, k, v, is_causal=causal), torch, flush=flush)
            n_ops, n_bytes = _attention_work(torch, b, h, sq, sk, d, dt,
                                             causal, window)
            row["bound_ms"], row["bound_by"] = _attention_bound(
                n_ops, n_bytes, dt, torch)
            row["tflops"] = n_ops / row["ms"] / 1e9
            row["ms_over_library"] = row["ms"] / row["library_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, got, again, want, diff
        torch.cuda.empty_cache()
    return rows


def phase_serve(torch, attn) -> int:
    """Dense-LM serving at internlm2-1.8b's full width and depth; returns
    the attention kernel's launches over the two serving waves."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import lm
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = configs.get("internlm2-1.8b")
    batch, prompt_len, max_new = 8, 2048, 32
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype}; {cfg.param_count() / 1e9:.3f} B params; "
          f"weights drawn on the card in {time.perf_counter() - t0:.2f} s")
    data = lm.synthetic_lm_batches(cfg, batch, prompt_len, seed=0,
                                   device="cpu")
    print("constants from PERF.md, not measured here: PR 12's wave-1 "
          "prefill 0.312 s, decode 188.6 and 212.9 tok/s (two calls)")
    torch.cuda.reset_peak_memory_stats()
    attn.flash_attention.launches = 0
    for wave in range(2):
        prompts = next(data)["tokens"].numpy()
        before = attn.flash_attention.launches
        toks, stats = serve.serve_batch(cfg, model, prompts, max_new,
                                        cache_len=prompt_len + max_new)
        n = attn.flash_attention.launches - before
        print(f"wave {wave}: prefill {stats['prefill_s']:.4f} s = "
              f"{batch * prompt_len / stats['prefill_s']:.0f} prefill tok/s; "
              f"decode {stats['decode_s']:.4f} s = "
              f"{stats['decode_tok_s']:.1f} decode tok/s; attention kernel "
              f"launches {n}",
              flush=True)
        if n != cfg.n_layers:
            raise AssertionError(f"wave {wave}: {n} attention kernel launches, "
                                 f"expected {cfg.n_layers} (one per layer)")
        if (toks.shape != (batch, max_new) or toks.min() < 0
                or toks.max() >= cfg.vocab or not stats["logits_finite"]):
            raise AssertionError(f"wave {wave}: tokens {toks.shape} in "
                                 f"[{toks.min()}, {toks.max()}], logits finite "
                                 f"{stats['logits_finite']}")
    launches = attn.flash_attention.launches
    print(f"peak device memory over the waves: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    MEASURED["serve"] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                         "prefill_s": stats["prefill_s"],
                         "decode_step_s": stats["decode_s"] / (max_new - 1),
                         "launches": n}
    prompts = next(data)["tokens"].numpy()
    (_, stats), prof = _profile(torch, lambda: serve.serve_batch(
        cfg, model, prompts, max_new, cache_len=prompt_len + max_new),
        match="attn_")
    print("traced wave:", json.dumps(prof), flush=True)
    print(f"traced wave: attention kernel {prof['match_ms']:.3f} ms of device "
          f"time over {prof['match_count']} launches = "
          f"{prof['match_ms'] / 1e3 / stats['prefill_s']:.1%} of the traced "
          f"prefill's {stats['prefill_s']:.4f} s", flush=True)
    del model
    torch.cuda.empty_cache()

    # the same width in float32 at 2 layers: the last logits of prefill(S+1)
    # (attention through the kernel) against prefill(S) + decode_step(S)
    # (attention over the ring cache through the plain _sdpa_chunked)
    cfg32 = cfg.with_(n_layers=2, dtype="float32")
    model = transformer.init_params(cfg32, seed=0)
    s = 512
    toks = torch.as_tensor(lm._markov_tokens(np.random.default_rng(1),
                                             cfg.vocab, (2, s + 1)),
                           dtype=torch.int64, device="cuda")
    la, _ = model.prefill(toks)
    _, cache = model.prefill(toks[:, :s], cache_len=s + 1)
    lb, _ = model.decode_step(cache, toks[:, s:], s)
    err = float((la - lb).abs().max())
    top = la.topk(2, dim=-1).values
    gap = float((top[:, 0] - top[:, 1]).min())
    print(f"float32, 2 layers, S={s}, batch 2: prefill(S+1) vs "
          f"prefill(S) + decode_step(S): max |logit diff| {err:.3g} "
          f"(logits up to {float(la.abs().max()):.3g}); smallest top-2 gap "
          f"{gap:.3g}", flush=True)
    if not err <= 2e-3:
        raise AssertionError(f"prefill/decode logits differ by {err} > 2e-3")
    if not torch.equal(la.argmax(-1), lb.argmax(-1)):
        raise AssertionError("prefill/decode argmax tokens differ")
    del model, cache
    torch.cuda.empty_cache()
    return launches


def _profile(torch, fn, match: str | None = None):
    """``fn()`` once under ``torch.profiler``: returns its result and the
    host seconds (profiler overhead included), the device-busy seconds (the
    union of the kernels' intervals), the idle share and the kernels by
    device time; with ``match``, also the device ms and count of the
    kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(((sum(v) / 1e3, len(v), k) for k, v in by_name.items()),
                 reverse=True)[:6]
    busy_s = busy / 1e6
    if not events:
        raise AssertionError("the profiler recorded no device kernel")
    prof = {"host_s": host_s, "device_busy_s": busy_s,
            "device_idle_share": max(0.0, 1.0 - busy_s / host_s),
            "device_kernels": len(events),
            "top": [{"name": k[:60], "ms": ms, "count": n}
                    for ms, n, k in top]}
    if match is not None:
        hits = [t for k, v in by_name.items() if match in k for t in v]
        prof["match_ms"], prof["match_count"] = sum(hits) / 1e3, len(hits)
    return out, prof


def _fit_predict(Federation, parties, xtr, ytr, xte, params, torch,
                 device=None):
    """Ingest -> fit -> predict in a fresh session; the fit and predict
    seconds are host clock around work that ends in a device sync."""
    fed = Federation(parties=parties, n_bins=params.n_bins, device=device)
    fed.ingest(xtr, ytr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = fed.fit(params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred = fed.predict(model, xte)
    t2 = time.perf_counter()
    return fed, model, pred, t1 - t0, t2 - t1


def _trees_differ(a, b, convert, np) -> list[str]:
    ta, tb = (convert.party_trees_to_numpy(m.trees_) for m in (a, b))
    return [f for f in ta if not np.array_equal(ta[f], tb[f])]


def _same_partition(a, b, np) -> bool:
    return (np.array_equal(a.xb, b.xb) and np.array_equal(a.feat_gid,
                                                          b.feat_gid)
            and np.array_equal(a.boundaries, b.boundaries)
            and a.party_names == b.party_names)


def phase_party_first(torch, hist, x, y, xte, params,
                      chunk_rows: int = 16384, csv_dir=None) -> dict:
    """Party-first, streamed and resumable ingest and fit on the card.
    Raises on any disagreement; returns the phase's numbers, with the
    histogram kernel's launches over the whole phase.  Every timed ingest
    starts with the ID-hash memo cleared, so each hashes its IDs cold.
    The two CSV extracts are written to ``csv_dir`` (kept, for phase 13's
    train CLI) or to the phase's own temporary directory."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import convert
    from repro_torch.core import crypto
    from repro_torch.core.partyblock import PartyBlock
    from repro_torch.data import make_party_views
    from repro_torch.federation import Federation
    from repro_torch.streaming import (ArraySource, ChunkedCSVSource,
                                       DataProduct, ProductSchema)

    def session():
        return Federation(parties=2, n_bins=params.n_bins)

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 8: {what}")

    def launches():
        return hist.histogram_cuda.launches

    out: dict = {}
    start_launches = launches()
    blocks, xa, ya = make_party_views(x, y, 2, overlap=0.9, seed=0)
    out["rows"] = [b.n_samples for b in blocks]
    out["common_rows"] = len(xa)

    # 1. party blocks in memory == the pre-aligned matrix
    crypto._HASH_CACHE.clear()
    fed = session()
    t0 = time.perf_counter()
    part = fed.ingest(blocks)
    out["ingest_memory_s"] = time.perf_counter() - t0
    model = fed.fit(params)
    pred = fed.predict(model, xte)
    ref = session()
    ref.ingest(xa, ya)
    rmodel = ref.fit(params)
    bad = _trees_differ(model, rmodel, convert, np)
    check(not bad, f"party-first trees != pre-aligned trees on {bad}")
    check(np.array_equal(pred, ref.predict(rmodel, xte)),
          "party-first predictions != pre-aligned predictions")
    check(np.array_equal(fed.labels_, ya), "aligned labels != pre-aligned")

    tmp = tempfile.mkdtemp(prefix="ff_phase8_")
    try:
        # 2. each block to its own CSV, streamed back out-of-core
        t0 = time.perf_counter()
        paths = [b.to_csv(os.path.join(csv_dir or tmp, f"{b.name}.csv"))
                 for b in blocks]
        out["csv_write_s"] = time.perf_counter() - t0
        out["csv_paths"] = paths
        out["csv_bytes"] = sum(os.path.getsize(p) for p in paths)
        cap = max(out["rows"])
        fed2 = session()
        crypto._HASH_CACHE.clear()
        t0 = time.perf_counter()
        part2 = fed2.ingest([ChunkedCSVSource(p, name=b.name)
                             for p, b in zip(paths, blocks)],
                            chunk_rows=chunk_rows, sketch_capacity=cap)
        out["ingest_stream_s"] = time.perf_counter() - t0
        check(all(st.merged_scan().sketches.exact
                  for st in fed2._stream["streams"]), "the sketch compacted")
        check(_same_partition(part2, part, np),
              "streamed partition != in-memory partition")
        check(np.array_equal(fed2.labels_, fed.labels_)
              and np.array_equal(fed2.aligned_ids_, fed.aligned_ids_),
              "streamed labels or aligned IDs != in-memory")
        model2 = fed2.fit(params)
        bad = _trees_differ(model2, model, convert, np)
        check(not bad, f"streamed forest != in-memory forest on {bad}")

        # 3. a versioned append: 80 % as version 1, the rest as version 2
        def product(b, rows, version):
            sub = PartyBlock(name=b.name, x=b.x[rows], ids=b.ids[rows],
                             y=None if b.y is None else b.y[rows],
                             feature_ids=b.feature_ids)
            return DataProduct(b.name, ArraySource(sub), ProductSchema.of(b),
                               version=version)
        cuts = [int(0.8 * b.n_samples) for b in blocks]
        fed3 = session()
        crypto._HASH_CACHE.clear()
        t0 = time.perf_counter()
        fed3.ingest([product(b, slice(0, c), 1)
                     for b, c in zip(blocks, cuts)],
                    chunk_rows=chunk_rows, sketch_capacity=cap)
        out["ingest_v1_s"] = time.perf_counter() - t0
        out["v1_rows"] = fed3._partition.n_samples
        ck_append = os.path.join(tmp, "ck_append")
        fed3.fit_resumable(params, ck_append, trees_per_chunk=5)
        crypto._HASH_CACHE.clear()
        t0 = time.perf_counter()
        part3 = fed3.ingest_append([product(b, slice(c, None), 2)
                                    for b, c in zip(blocks, cuts)])
        out["append_s"] = time.perf_counter() - t0
        check(_same_partition(part3, part2, np)
              and np.array_equal(fed3.labels_, fed2.labels_)
              and np.array_equal(fed3.aligned_ids_, fed2.aligned_ids_),
              "appended partition != the whole stream's")

        # 4. fit_resumable == a from-scratch fit, bit for bit
        torch.cuda.synchronize()
        n0 = launches()
        t0 = time.perf_counter()
        scratch = fed2.fit(params)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["launches_fit20"] = launches() - n0
        n0 = launches()
        t0 = time.perf_counter()
        full = fed2.fit_resumable(params, os.path.join(tmp, "ck_full"),
                                  trees_per_chunk=5)
        torch.cuda.synchronize()
        out["fit_resumable_s"] = time.perf_counter() - t0
        check(launches() - n0 == out["launches_fit20"],
              "fit_resumable launched other than a plain fit")
        bad = _trees_differ(full, scratch, convert, np)
        check(not bad, f"fit_resumable != fit on {bad}")
        out["chunk_ckpt_bytes"] = sum(
            f.stat().st_size for f in
            Path(tmp, "ck_full", "step_00000020").iterdir())
        # fit and fit_resumable (from scratch) in turn, twice each (cut from
        # three to keep the script within its time limit)
        out["alt_fit_s"], out["alt_resumable_s"] = [], []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fed2.fit(params)
            torch.cuda.synchronize()
            out["alt_fit_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fed2.fit_resumable(params, os.path.join(tmp, f"ck_alt{i}"),
                               trees_per_chunk=5)
            torch.cuda.synchronize()
            out["alt_resumable_s"].append(time.perf_counter() - t0)

        ck = os.path.join(tmp, "ck_main")
        n0 = launches()
        m = fed2.fit_resumable(dataclasses.replace(params, n_estimators=10),
                               ck, trees_per_chunk=5)
        out["launches_fit10"] = launches() - n0
        n0 = launches()
        fed2.fit_resumable(params, ck, trees_per_chunk=5, model=m)
        out["launches_extend"] = launches() - n0
        check(out["launches_extend"]
              == out["launches_fit20"] - out["launches_fit10"]
              and 0 < out["launches_extend"] < out["launches_fit20"],
              f"the 10 -> 20 rerun launched {out['launches_extend']} times, "
              f"not the new trees' {out['launches_fit20']} - "
              f"{out['launches_fit10']}")
        bad = _trees_differ(m, scratch, convert, np)
        check(not bad, f"extended forest != from-scratch on {bad}")

        shutil.rmtree(os.path.join(ck, "step_00000020"))   # a crash
        n0 = launches()
        fed2.fit(dataclasses.replace(params, n_estimators=15))
        out["launches_fit15"] = launches() - n0
        n0 = launches()
        again = fed2.fit_resumable(params, ck, trees_per_chunk=5)
        out["launches_crash"] = launches() - n0
        check(out["launches_crash"]
              == out["launches_fit20"] - out["launches_fit15"],
              f"the rerun after the crash launched {out['launches_crash']} "
              f"times, not trees 15-19's")
        bad = _trees_differ(again, scratch, convert, np)
        check(not bad, f"resumed-after-crash forest != from-scratch on {bad}")

        n0 = launches()
        restarted = fed3.fit_resumable(params, ck_append, trees_per_chunk=5)
        out["launches_restart"] = launches() - n0
        check(out["launches_restart"] == out["launches_fit20"],
              f"after the append the fit launched {out['launches_restart']} "
              f"times, not a full fit's {out['launches_fit20']}: the "
              f"fingerprint did not restart it")
        bad = _trees_differ(restarted, scratch, convert, np)
        check(not bad, f"restarted forest != from-scratch on {bad}")

        # 5. save -> load in a fresh session -> the same predictions
        ck_save = os.path.join(tmp, "ck_save")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = fed2.save(full, ck_save)
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        out["save_bytes"] = sum(f.stat().st_size
                                for f in Path(saved).iterdir())
        out["save_files"] = sorted(f.name for f in Path(saved).iterdir())
        fresh = session()
        t0 = time.perf_counter()
        loaded = fresh.load(ck_save, params, partition=part2)
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        check(loaded.trees_.is_leaf.device == full.trees_.is_leaf.device,
              "the loaded forest is not on the session's device")
        check(np.array_equal(fresh.predict(loaded, xte),
                             fed2.predict(full, xte)),
              "loaded model's predictions != the fitted model's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches() - start_launches
    check(out["launches"] > 0, "the histogram kernel was launched no time")
    return out


def _boost(Federation, parties, xtr, ytr, bp, torch):
    """Ingest -> fit a boosting model in a fresh session; the fit seconds
    are host clock around work that ends in a device sync."""
    fed = Federation(parties=parties, n_bins=bp.n_bins)
    fed.ingest(xtr, ytr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = fed.fit(bp)
    torch.cuda.synchronize()
    return fed, model, time.perf_counter() - t0


def _train_losses(model, y, np, programs, torch) -> list[float]:
    """Training loss after each round (log-loss for the binary task, mse
    for regression), the rounds replayed on the training rows."""
    xb = torch.as_tensor(model._partition.xb, device=model.device)
    run = model._predict_runner()
    f = np.full(len(y), model.base_)
    out = []
    for trees in model.trees_:
        f = f + model.params.learning_rate * programs.party0(run(trees, xb))
        if model.params.task == "binary":
            prob = np.clip(1.0 / (1.0 + np.exp(-f)), 1e-12, 1 - 1e-12)
            out.append(float(-np.mean(y * np.log(prob)
                                      + (1 - y) * np.log(1 - prob))))
        else:
            out.append(float(np.mean((f - y) ** 2)))
    return out


def _rounds_differ(a, b, convert, np) -> list[int]:
    """Rounds whose master view (party 0's is_leaf, leaf_stats, split_gid)
    differs between two boosting models."""
    bad = []
    for r, (ta, tb) in enumerate(zip(a.trees_, b.trees_)):
        na, nb = (convert.party_trees_to_numpy(t) for t in (ta, tb))
        if any(not np.array_equal(na[k][0], nb[k][0])
               for k in ("is_leaf", "leaf_stats", "split_gid")):
            bad.append(r)
    return bad


def _card_vs_cpu_rounds(bp, x, y, np, torch, convert, programs):
    """Boosting fitted on the card, then each round refitted on the CPU
    from the card's margin after the rounds before it: the same splits,
    leaf stats within 1e-5 of the node's Σ|stat| (channels 0 and 2 are
    positive and bound channel 1's: Σ|hh·p| <= (c0 + c2) / 2); and the
    whole CPU fit's decision function within rtol 1e-5, atol 1e-6 of the
    card's.  Returns (largest leaf-stat error over its bound, largest
    decision-function difference)."""
    from repro_torch.core import FederatedBoosting, make_vertical_partition
    part = make_vertical_partition(x, 2, bp.n_bins)
    card = FederatedBoosting(bp).fit(part, y)
    cpu = FederatedBoosting(bp, device="cpu")
    prog = cpu._round_program(part)
    yy = np.asarray(y, np.float64)
    f = np.full(len(y), card.base_)
    xb = torch.as_tensor(part.xb, device="cuda")
    worst = 0.0
    for r, trees in enumerate(card.trees_):
        got = convert.party_trees_to_numpy(cpu._fit_round(prog, yy, f))
        want = convert.party_trees_to_numpy(trees)
        bad = [k for k in SPLIT_FIELDS if not np.array_equal(got[k], want[k])]
        if bad:
            raise AssertionError(f"boosting {bp.task} round {r}: cpu splits "
                                 f"!= card splits on {bad}")
        ls = want["leaf_stats"]
        err = np.abs(got["leaf_stats"] - ls).max(-1)
        scale = 1e-5 * (ls[..., 0] + ls[..., 2])
        worst = max(worst, float((err / np.maximum(scale, 1e-30)).max()))
        if not (err <= scale).all():
            raise AssertionError(f"boosting {bp.task} round {r}: leaf stats "
                                 f"beyond 1e-5 of the node's sum of |stat|")
        f = f + bp.learning_rate * programs.party0(card._pred_run(trees, xb))
    cpu.fit(part, y)
    dg, dc = card.decision_function(x), cpu.decision_function(x)
    if not np.allclose(dg, dc, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"boosting {bp.task}: card and cpu decision "
                             f"functions differ beyond rtol 1e-5")
    if bp.task == "binary" and not np.array_equal(card.predict(x),
                                                  cpu.predict(x)):
        raise AssertionError("boosting binary: card and cpu predictions "
                             "differ")
    return worst, float(np.abs(dg - dc).max())


def phase_boosting(torch, hist, forest, xte_forest) -> dict:
    """Boosting, F-LR and classical prediction on the card.  Raises on any
    disagreement; returns the phase's numbers.  ``forest`` is phase 3's
    fitted 20-tree forest, ``xte_forest`` its 39,050 test rows."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import convert
    from repro_torch.core import BoostParams, LinearParams
    from repro_torch.core.prediction import comm_rounds
    from repro_torch.data import (accuracy, make_classification,
                                  make_regression, rmse, train_test_split)
    from repro_torch.federation import Federation, programs

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 9: {what}")

    def nonincreasing(v):
        return all(b <= a + 1e-6 for a, b in zip(v, v[1:]))

    out: dict = {}
    # 1. binary boosting on the target-marketing table, two parties
    x, y = make_classification(156198, 95, 2, n_informative=24, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    bp = BoostParams(task="binary", n_rounds=50, max_depth=6, n_bins=32,
                     learning_rate=0.1, seed=0)
    hist.histogram_cuda.launches = 0
    fed, model, out["fit_s"] = _boost(Federation, 2, xtr, ytr, bp, torch)
    out["launches"] = hist.histogram_cuda.launches
    t0 = time.perf_counter()
    pred = fed.predict(model, xte)
    out["predict_s"] = time.perf_counter() - t0
    out["accuracy"] = accuracy(yte, pred)
    out["log_loss"] = _train_losses(model, ytr, np, programs, torch)
    check(out["launches"] > 0, "boosting launched the histogram no time")
    check(pred.shape == yte.shape and out["accuracy"] > 0.7,
          f"binary boosting accuracy {out['accuracy']}")
    check(nonincreasing(out["log_loss"]), "training log-loss increased")
    _, model1, out["fit1_s"] = _boost(Federation, 1, xtr, ytr, bp, torch)
    bad = _rounds_differ(model, model1, convert, np)
    check(not bad, f"binary FB(2) != FB(1) in rounds {bad}")
    check(np.array_equal(model.decision_function(xte),
                         model1.decision_function(xte)),
          "binary FB(2) decision function != FB(1)'s")
    _, out["traced"] = _profile(torch, lambda: fed.fit(bp),
                                match="hist_kernel")

    # 2. save -> load in a fresh session: the same decision function
    tmp = tempfile.mkdtemp(prefix="ff_phase9_")
    try:
        t0 = time.perf_counter()
        saved = fed.save(model, os.path.join(tmp, "boost"))
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        out["save_bytes"] = sum(f.stat().st_size
                                for f in Path(saved).iterdir())
        fresh = Federation(parties=2, n_bins=32)
        fresh.ingest(xtr, ytr)
        loaded = fresh.load(os.path.join(tmp, "boost"), bp)
        check(np.array_equal(loaded.decision_function(xte),
                             model.decision_function(xte)),
              "loaded boosting model's decision function != the fitted one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 3. regression boosting at the superconduct size
    xr, yr = make_regression(21263, 81, seed=0)
    rtr, rytr, rte, ryte = train_test_split(xr, yr, 0.25, seed=1)
    rbp = BoostParams(task="regression", n_rounds=50, max_depth=6, n_bins=64,
                      seed=0)
    n0 = hist.histogram_cuda.launches
    _, rmodel, out["reg_fit_s"] = _boost(Federation, 2, rtr, rytr, rbp, torch)
    out["reg_launches"] = hist.histogram_cuda.launches - n0
    out["rmse"] = rmse(ryte, rmodel.predict(rte))
    out["reg_std"] = float(np.std(ryte))
    out["mse"] = _train_losses(rmodel, rytr, np, programs, torch)
    check(out["rmse"] < out["reg_std"], f"regression boosting rmse "
          f"{out['rmse']} is no better than the targets' spread")
    check(nonincreasing(out["mse"]), "training mse increased")
    _, rmodel1, _ = _boost(Federation, 1, rtr, rytr, rbp, torch)
    bad = _rounds_differ(rmodel, rmodel1, convert, np)
    check(not bad, f"regression FB(2) != FB(1) in rounds {bad}")
    check(np.array_equal(rmodel.decision_function(rte),
                         rmodel1.decision_function(rte)),
          "regression FB(2) decision function != FB(1)'s")

    # 4. card vs cpu per round from a shared margin, on fixtures whose
    # rounds meet no near-tie (tests/test_torch_boosting.py's seeds)
    small = dict(n_rounds=8, max_depth=4, n_bins=16)
    xs, ys = make_regression(600, 12, seed=0)
    out["cpu_reg"] = _card_vs_cpu_rounds(
        BoostParams(task="regression", **small), xs[:450], ys[:450], np,
        torch, convert, programs)
    xs, ys = make_classification(600, 12, 2, seed=1)
    out["cpu_bin"] = _card_vs_cpu_rounds(
        BoostParams(task="binary", **small), xs[:450], ys[:450], np, torch,
        convert, programs)

    # 5. F-LR on the target-marketing table
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lmodel = fed.fit(LinearParams())
    torch.cuda.synchronize()
    out["flr_fit_s"] = time.perf_counter() - t0
    out["flr_accuracy"] = accuracy(yte, fed.predict(lmodel, xte))
    check(out["flr_accuracy"] > 0.7, f"F-LR accuracy {out['flr_accuracy']}")
    cpu_fed = Federation(parties=2, n_bins=32, device="cpu")
    cpu_fed.ingest(xtr, ytr)
    t0 = time.perf_counter()
    cmodel = cpu_fed.fit(LinearParams())
    out["flr_cpu_fit_s"] = time.perf_counter() - t0
    wg, wc = lmodel._w.cpu().numpy(), cmodel._w.numpy()
    out["flr_w_diff"] = float(np.abs(wg - wc).max())
    out["flr_w_max"] = float(np.abs(wc).max())
    check(np.allclose(wg, wc, rtol=1e-4, atol=1e-5)
          and np.allclose(lmodel._b.cpu().numpy(), cmodel._b.numpy(),
                          rtol=1e-4, atol=1e-5),
          f"F-LR card weights beyond rtol 1e-4 of the cpu's "
          f"(max diff {out['flr_w_diff']})")

    # 6. classical (one round per level) vs one-round prediction, phase 3's
    # forest
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = forest.predict(xte_forest)
    out["oneround_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    classical = forest.predict_classical(xte_forest)
    out["classical_s"] = time.perf_counter() - t0
    check(np.array_equal(classical, one), "predict_classical != predict")
    out["rounds"] = (comm_rounds(forest.params, "oneround"),
                     comm_rounds(forest.params, "classical"))
    out["rows"] = len(xte_forest)
    # phase 10 serves these models: the session, its test rows, the binary
    # boosting model and the F-LR model
    out["serve"] = {"fed": fed, "xte": xte, "boost": model, "flr": lmodel}
    return out


def _wave_ms(waves) -> dict:
    """Wave latency percentiles (ms), rows/s over the busy intervals and
    the party-sum payload of a list of ``wave_stats`` records."""
    import numpy as np

    from repro_torch.serving.metrics import busy_seconds
    lat = np.array([w["latency_s"] for w in waves]) * 1e3
    rows = sum(w["n_rows"] for w in waves)
    busy = busy_seconds((w["t0"], w["t0"] + w["latency_s"]) for w in waves)
    return {"waves": len(waves), "rows": rows,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "rows_per_s": rows / busy,
            "comm_bytes_total": sum(w["comm_bytes"] for w in waves)}


def phase_serving(torch, fed, forest, xte, s9) -> dict:
    """The bucketed serving engine, the request queue and the fleet on the
    card, over phase 3's forest (``fed``, ``forest``, its test rows
    ``xte``) and phase 9's binary boosting and F-LR models (``s9``).
    Raises on any disagreement; returns the phase's numbers."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.federation import programs, substrate
    from repro_torch.serving import (ForestServer, LinearServer, RequestQueue,
                                     ServeConfig)

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 10: {what}")

    def captures() -> int:
        return substrate.capture_graph.captures

    out: dict = {}
    want = fed.predict(forest, xte)

    # 1. one server, one CUDA graph per bucket, the whole test set
    c0 = captures()
    server = fed.serve(forest, ServeConfig())
    check(server.device.type == "cuda", f"server on {server.device}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.warmup()
    out["warmup_s"] = time.perf_counter() - t0
    check(server.buckets == (32, 256, 2048) and server.compile_count == 3
          and captures() - c0 == 3,
          f"warmup: {server.compile_count} programs, {captures() - c0} "
          f"graphs captured for buckets {server.buckets}")
    got = server.serve(xte)
    check(np.array_equal(got, want), "served != fed.predict")
    buckets = [w["bucket"] for w in server.wave_stats]
    check(buckets == [2048] * 19 + [256],
          f"waves of {len(xte)} rows went to buckets {buckets}")
    # host binning, and each bucket's graph replay against the same
    # program run eagerly on the same (static) input
    xb = forest.partition_.bin_test(xte)
    out["bin_s"] = _host_s(lambda: forest.partition_.bin_test(xte), torch)
    out["bin_2048_s"] = _host_s(
        lambda: forest.partition_.bin_test(xte[:2048]), torch, reps=10)
    prog = server._program()
    out["replay_ms"], out["eager_ms"] = {}, {}
    for b in server.buckets:
        compiled, xs = server._executable(b)
        args = server._wave_args(xs)
        check(torch.equal(compiled(*args), prog(*args)),
              f"bucket {b}: graph replay != the eager program")
        out["replay_ms"][b] = _time_ms(lambda: compiled(*args), torch)
        out["eager_ms"][b] = _time_ms(lambda: prog(*args), torch, reps=3)
    # in turn: predict, and serve / serve_binned at max_inflight 1 and 4
    asyn = fed.serve(forest, ServeConfig(max_inflight=4)).warmup()
    warm = captures()
    check(warm - c0 == 6, f"{warm - c0} graphs for two servers x 3 buckets")
    runs = {"predict": lambda: fed.predict(forest, xte),
            "serve sync": lambda: server.serve(xte),
            "serve async": lambda: asyn.serve(xte),
            "serve_binned sync": lambda: server.serve_binned(xb),
            "serve_binned async": lambda: asyn.serve_binned(xb)}
    order = list(runs) + list(runs)[::-1]
    out["turns"] = {k: [] for k in runs}
    for k in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = runs[k]()
        out["turns"][k].append(time.perf_counter() - t0)
        check(np.array_equal(again, want), f"{k} differs from predict")
    check(server.compile_count == 3 and asyn.compile_count == 3
          and captures() == warm, "serving captured or compiled again")
    dense = fed.serve(forest, ServeConfig(compact=False))
    check(np.array_equal(dense.serve(xte), got), "compact=False != True")
    out["comm_bytes"] = (server.wave_stats[0]["comm_bytes"],
                         dense.wave_stats[0]["comm_bytes"])

    # 2. mixed traffic through the request queue, sync and async
    sizes = np.random.default_rng(0).integers(1, 100, size=400)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    out["traffic_rows"] = int(sizes.sum())

    def drive(srv):
        q = RequestQueue(srv)
        rids = [q.submit(xte[a:a + n]) for a, n in zip(starts, sizes)]
        return q, rids

    def drain(srv):
        q, rids = drive(srv)
        srv.wave_stats.clear()
        t0 = time.perf_counter()
        res = q.drain()
        dt = time.perf_counter() - t0
        for rid, a, n in zip(rids, starts, sizes):
            check(np.array_equal(res[rid], want[a:a + n]),
                  f"request {rid} ({n} rows) != predict")
        return [res[r] for r in rids], dt, list(srv.wave_stats)

    out["drains"] = {"sync": [], "async": []}
    for name, srv in (("sync", server), ("async", asyn), ("async", asyn),
                      ("sync", server)):
        res, dt, waves = drain(srv)
        out["drains"][name].append(dict(_wave_ms(waves), drain_s=dt,
                                        req_rows_per_s=sizes.sum() / dt,
                                        inflight=max(w["inflight"]
                                                     for w in waves)))
        out.setdefault("res_" + name, res)
    check(all(np.array_equal(a, b) for a, b in zip(out.pop("res_sync"),
                                                   out.pop("res_async"))),
          "sync != async")
    check(server.compile_count == 3 and asyn.compile_count == 3,
          "queue traffic compiled again")
    q, _ = drive(asyn)
    _, out["traced"] = _profile(torch, q.drain)

    # 3. the other families: phase 9's binary boosting and F-LR models
    fed9, xte9 = s9["fed"], s9["xte"]
    c9 = captures()
    bserver = fed9.serve(s9["boost"], ServeConfig()).warmup()
    bgot, bwant = bserver.serve(xte9), s9["boost"].predict(xte9)
    out["boost_mismatch"] = int((bgot != bwant).sum())
    check(out["boost_mismatch"] == 0,
          f"boosting: {out['boost_mismatch']} served labels != predict")
    lserver = fed9.serve(s9["flr"], ServeConfig()).warmup()
    lgot, lwant = lserver.serve(xte9), fed9.predict(s9["flr"], xte9)
    check(captures() - c9 == 6, f"{captures() - c9} graphs for 2 x 3 buckets")
    # the largest logit difference: the same program in its regression form
    # (z itself), per bucket on the card vs at the full row count eagerly
    flr = s9["flr"]
    zserver = LinearServer(flr)
    zserver.task = "regression"
    z_served = zserver.serve(xte9)
    xs = torch.as_tensor(flr._standardized(flr._blocks(xte9)),
                         device=flr._w.device)
    z_full = programs.party0(programs.linear_predict_program(
        substrate.SimulatedSubstrate(), "regression")(xs, flr._w, flr._b[0]))
    out["logit_diff"] = float(np.abs(z_served - z_full).max())
    out["logit_min"] = float(np.abs(z_full).min())
    out["flr_mismatch"] = int((lgot != lwant).sum())
    check(out["flr_mismatch"] == 0,
          f"F-LR: {out['flr_mismatch']} served labels != predict (largest "
          f"logit difference {out['logit_diff']:.3g})")

    # 4. serving from a checkpoint
    tmp = tempfile.mkdtemp(prefix="ff_phase10_")
    try:
        fed.save(forest, os.path.join(tmp, "forest"))
        restored = ForestServer.from_checkpoint(
            os.path.join(tmp, "forest"), forest.params,
            partition=forest.partition_)
        check(np.array_equal(restored.serve(xte), want),
              "served from the checkpoint != predict")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 5. four cells on this one card, drained on threads (buckets captured
    # lazily inside the drains), then a cell killed with traffic pending
    c2 = captures()
    fleet = fed.serve_fleet(forest, ServeConfig(), n_cells=4)
    rids = {fleet.submit(xte[a:a + n], key=f"r{i}"): (a, n)
            for i, (a, n) in enumerate(zip(starts, sizes))}
    t0 = time.perf_counter()
    res = fleet.drain()
    out["fleet_drain_s"] = time.perf_counter() - t0
    check(set(res) == set(rids), "the fleet lost requests")
    for rid, (a, n) in rids.items():
        check(np.array_equal(res[rid], want[a:a + n]),
              f"fleet request {rid} != the single server's")
    out["fleet_captures"] = captures() - c2
    # the same traffic again, warm (threads), then the four cells' queues
    # drained one after another on this thread
    rids = {fleet.submit(xte[a:a + n], key=f"r{i}"): (a, n)
            for i, (a, n) in enumerate(zip(starts, sizes))}
    t0 = time.perf_counter()
    res = fleet.drain()
    out["fleet_warm_s"] = time.perf_counter() - t0
    check(set(res) == set(rids), "the warm fleet drain lost requests")
    for i, (a, n) in enumerate(zip(starts, sizes)):     # the ring's routes,
        cell = fleet.cells[fleet.ring.route(f"r{i}")]   # around the front door
        cell.queue.submit(xte[a:a + n])
    t0 = time.perf_counter()
    for cell in fleet.cells.values():
        cell.queue.drain()
    out["fleet_sequential_s"] = time.perf_counter() - t0
    for cell in fleet.cells.values():
        cell.server.wave_stats.clear()
    half = len(sizes) // 2
    keyed = [(f"k{i}", a, n) for i, (a, n) in enumerate(zip(starts, sizes))]
    rids = {fleet.submit(xte[a:a + n], key=k): (a, n)
            for k, a, n in keyed[:half]}
    res = fleet.drain()
    rids.update({fleet.submit(xte[a:a + n], key=k): (a, n)
                 for k, a, n in keyed[half:]})
    victim = max(fleet.cells_up(),
                 key=lambda c: fleet.cells[c].queue.pending_requests())
    out["pending_on_victim"] = fleet.cells[victim].queue.pending_requests()
    out["moved"] = fleet.kill_cell(victim)
    res.update(fleet.drain())
    check(not fleet.dead_letters and set(res) == set(rids),
          f"kill_cell lost requests: {len(set(rids) - set(res))} missing, "
          f"{len(fleet.dead_letters)} dead-lettered")
    for rid, (a, n) in rids.items():
        check(np.array_equal(res[rid], want[a:a + n]),
              f"request {rid} after the kill != the single server's")
    check(out["moved"] == out["pending_on_victim"] > 0,
          f"moved {out['moved']} of {out['pending_on_victim']}")
    out["fleet"] = fleet.metrics()
    return out


def _worker_launches(fed) -> list[int]:
    """Each party worker's histogram-kernel launches so far: its own
    ``kernels.histogram.launches`` counter (cumulative) through the
    telemetry rollup, which adds a worker's whole count at every call."""
    from repro_torch.observability import registry as telemetry

    def merged(p):
        c = telemetry.REGISTRY.get(f"party{p}.kernels.histogram.launches")
        return 0 if c is None else c.value
    before = [merged(p) for p in range(fed.parties)]
    fed.collect_telemetry()
    return [merged(p) - b for p, b in enumerate(before)]


def _protocol_bytes(params, n_rows: int, m: int) -> int:
    """The fit protocol's payload, reckoned from the level loop: at every
    level but the last, each party sends its (gain, gid, bin) bests
    (3 x width x 4 B) and gets the M parties' back, and sends its routing
    bits (N x 4 B) and gets their sum back."""
    per_tree = sum(m * ((3 * w * 4 + n_rows * 4)            # up
                        + (m * 3 * w * 4 + n_rows * 4))     # down
                   for w in (2 ** d for d in range(params.max_depth)))
    return params.n_estimators * per_tree


def _traced_fit(fed, params, span_file=None, label: str = "party") -> dict:
    """One distributed (or, with ``label="rank"``, sharded) fit under the
    tracer (the run message carries the session's span context, so the
    workers trace it too): for each worker, the seconds of its fit body, of
    its collective waits (its own send, the other parties' compute, the
    relay if any) and the rest (its own level compute); for the session,
    the seconds of the relayed rounds.  The spans are exported to
    ``span_file`` when one is given."""
    from repro_torch.observability import export
    from repro_torch.observability import trace as tracing
    tracer = tracing.TRACER
    tracer.reset()
    tracer.enable()
    try:
        t0 = time.perf_counter()
        fed.fit(params)
        wall = time.perf_counter() - t0
        fed.collect_telemetry()
        spans = tracer.drain()
    finally:
        tracer.disable()
    if span_file is not None:
        export.export_jsonl(spans, span_file)

    def total(proc, pred):
        return sum(s["dur"] for s in spans
                   if s["proc"] == proc and pred(s["name"]))
    out = {"wall_s": wall,
           "session_rounds_s": total(tracer.process,
                                     lambda n: n == "round")}
    n = fed.substrate.mesh.size if label == "rank" else fed.parties
    for p in range(n):
        body = total(f"{label}{p}", lambda n: n == "worker.forest_fit")
        coll = total(f"{label}{p}", lambda n: n.startswith("coll."))
        out[f"{label}{p}"] = {"fit_s": body, "collective_s": coll,
                              "compute_s": body - coll}
    return out


def phase_distributed(torch, hist, x, y, xte, params,
                      span_file=None) -> dict:
    """The party-per-process substrate on the card: two party workers (each
    its own process and CUDA context) ingest phase 8's party extracts, fit
    phase 3's forest through the histogram kernel over their own columns,
    and serve the test split; then the degraded-serving and refusal checks
    on tests/test_distributed.py's 3-party fixture.  Raises on any
    disagreement; returns the phase's numbers."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.core import ForestParams, crypto
    from repro_torch.core.tree import PartyTree
    from repro_torch.data import make_classification, make_party_views
    from repro_torch.federation import Federation
    from repro_torch.federation.distributed import surviving_trees
    from repro_torch.federation.transport import (PartyUnavailableError,
                                                  RetryPolicy)
    from repro_torch.observability import registry as telemetry
    from repro_torch.serving import ServeConfig

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 11: {what}")

    def counter(name: str) -> int:
        c = telemetry.REGISTRY.get(name)
        return 0 if c is None else c.value

    out: dict = {}
    blocks, _, _ = make_party_views(x, y, 2, overlap=0.9, seed=0)
    ref = Federation(parties=2, n_bins=params.n_bins)
    crypto._HASH_CACHE.clear()
    t0 = time.perf_counter()
    part_ref = ref.ingest(blocks)
    out["ingest_sim_s"] = time.perf_counter() - t0
    fed = Federation(parties=2, substrate="distributed",
                     n_bins=params.n_bins)
    try:
        t0 = time.perf_counter()
        fed.substrate.coordinator                  # spawn, connect
        out["start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        part = fed.ingest(blocks)
        out["ingest_s"] = time.perf_counter() - t0
        check(_same_partition(part, part_ref, np),
              "distributed partition != in-process party-first partition")
        check(np.array_equal(fed.labels_, ref.labels_),
              "distributed labels != in-process labels")
        check(np.array_equal(fed.aligned_ids_,
                             crypto.hash_ids(ref.aligned_ids_)),
              "distributed hashed IDs != the in-process IDs' hashes")
        out["rows"] = part.n_samples

        hist.histogram_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rmodel = ref.fit(params)
        torch.cuda.synchronize()
        out["sim_fit_s"] = time.perf_counter() - t0
        out["sim_launches"] = hist.histogram_cuda.launches
        hist.histogram_cuda.launches = 0
        l0 = _worker_launches(fed)
        w0 = (counter("transport.bytes_sent"),
              counter("transport.bytes_received"),
              counter("distributed.rounds"))
        t0 = time.perf_counter()
        model = fed.fit(params)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["wire_sent"] = counter("transport.bytes_sent") - w0[0]
        out["wire_received"] = counter("transport.bytes_received") - w0[1]
        out["rounds"] = counter("distributed.rounds") - w0[2]
        out["launches"] = [b - a for a, b in zip(l0, _worker_launches(fed))]
        dense = params.n_estimators * (2 * params.max_depth + 1)
        check(out["sim_launches"] == dense,
              f"the simulated fit launched {out['sim_launches']} times, not "
              f"{dense}")
        check(out["launches"] == [dense, dense],
              f"worker launches {out['launches']}, not {dense} each")
        check(hist.histogram_cuda.launches == 0,
              "the session process launched the kernel in a distributed fit")
        bad = _trees_differ(model, rmodel, convert, np)
        check(not bad, f"distributed forest != simulated forest on {bad}")
        check(model.trees_.is_leaf.is_cuda,
              "the distributed forest is not on the session's card")
        out["reckoned_bytes"] = _protocol_bytes(params, part.n_samples, 2)
        out["reckoned_rounds"] = 2 * params.n_estimators * params.max_depth
        out["traced"] = _traced_fit(fed, params, span_file)
        out["span_file"] = span_file

        want = ref.predict(rmodel, xte)
        server = fed.serve(model, ServeConfig())
        t0 = time.perf_counter()
        got = server.serve(xte)
        out["serve_s"] = time.perf_counter() - t0
        check(np.array_equal(got, want),
              "distributed served answers != in-process predict")
        t0 = time.perf_counter()
        got = server.serve(xte)
        out["serve2_s"] = time.perf_counter() - t0
        check(np.array_equal(got, want), "second serve != predict")
        waves = [w for w in server.wave_stats]
        out["waves"] = _wave_ms(waves[len(waves) // 2:])
        out["mask_bytes"] = {w["bucket"]: w["comm_bytes"] for w in waves}
        out["binds"] = server.compile_count
        t0 = time.perf_counter()
        small = fed.predict(model, xte[:2048])
        out["predict_2048_s"] = time.perf_counter() - t0
        check(np.array_equal(small, want[:2048]),
              "distributed fed.predict != in-process predict")
        # phase 12 repeats this run guarded and must give these, bit for bit
        out["results"] = {"partition": part, "labels": fed.labels_,
                          "hashed_ids": fed.aligned_ids_,
                          "trees": convert.party_trees_to_numpy(model.trees_),
                          "served": got}
    finally:
        fed.close()

    # faults: tests/test_distributed.py's degraded-serving fixture
    xf, yf = make_classification(160, 9, 2, seed=0)
    pf = ForestParams(n_estimators=10, max_depth=3, n_bins=8,
                      max_features=0.34, seed=0)
    sim = Federation(parties=3, n_bins=8)
    sim.ingest(xf, yf)
    sref = sim.fit(pf)
    fed = Federation(parties=3, substrate="distributed", n_bins=8,
                     retry=RetryPolicy(attempts=2, base=0.01, seed=0,
                                       sleeper=lambda d: None))
    try:
        fed.ingest(xf, yf)
        fmodel = fed.fit(pf)
        bad = _trees_differ(fmodel, sref, convert, np)
        check(not bad, f"3-party distributed forest != simulated on {bad}")
        server = fed.serve(fmodel, ServeConfig(buckets=(32,),
                                               allow_degraded=True))
        strict = fed.serve(fmodel, ServeConfig(buckets=(32,)))
        xt = xf[:30]
        want = sim.predict(sref, xt)
        check(np.array_equal(server.serve(xt), want)
              and np.array_equal(strict.serve(xt), want),
              "healthy served answers != predict")
        survivors = {pi: int(surviving_trees(fmodel.trees_, [pi]).size)
                     for pi in range(3)}
        victim = max(survivors, key=survivors.get)
        check(survivors[victim] > 0, "the fixture forest has no avoider trees")
        fed.substrate.chaos(victim, "die")
        got = server.serve(xt)
        stats = server.wave_stats[-1]
        check(bool(stats.get("degraded")) and victim in stats["dead_parties"]
              and stats["n_trees"] == survivors[victim],
              f"expected a degraded wave without party {victim}: {stats}")
        sel = torch.as_tensor(surviving_trees(sref.trees_, [victim]))
        deg = type(sref)(pf)
        deg.trees_ = PartyTree(*(a[:, sel.to(a.device)] for a in sref.trees_))
        deg.partition_, deg._decode = sref.partition_, sref._decode
        check(np.array_equal(got, deg.predict(xt)),
              "degraded answers != the surviving trees' forest")
        try:
            strict.serve(xt)
        except PartyUnavailableError:
            pass
        else:
            raise AssertionError("phase 11: a dead party without "
                                 "allow_degraded served an answer")
        out["victim"], out["survivors"] = victim, survivors
    finally:
        fed.close()
    return out


def _planted_sends(torch, block) -> None:
    """Raw payloads of ``block`` through a real TCP ``Channel`` pair: each
    must be refused with its key path and the block's label; the block's
    hashed IDs must pass and round-trip."""
    import socket
    import threading

    import numpy as np

    from repro_torch.analysis.runtime import PrivacyViolationError
    from repro_torch.federation.transport import Channel

    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.create_connection(lst.getsockname(), timeout=10)
    b, _ = lst.accept()
    lst.close()
    tx, rx = Channel(a, party=0), Channel(b, party=0)
    x_label = f"PartyBlock[{block.name!r}].x (raw features)"
    planted = {
        "x": (block.x, x_label),
        "column view": (block.x[:, 3], x_label),
        "torch.from_numpy": (torch.from_numpy(block.x), x_label),
        "tensor slice": (torch.from_numpy(block.x)[1000:2000], x_label),
        "ids": (block.ids, f"PartyBlock[{block.name!r}].ids (raw sample "
                           f"IDs)"),
    }
    try:
        for what, (payload, label) in planted.items():
            try:
                tx.send({"op": "leak", "payload": {what: payload}})  # egress: ok(planted raw payload: the armed guard must refuse it, checked below)
            except PrivacyViolationError as e:
                if e.path != f"msg['payload'][{what!r}]" or e.label != label:
                    raise AssertionError(
                        f"phase 12: {what} refused as {e.path} / {e.label}")
            else:
                raise AssertionError(f"phase 12: the guard let {what} out")
        # the frame (~MBs) outgrows the socket buffers: read it on a thread
        hashes, got = block.hashed_ids(), {}
        reader = threading.Thread(
            target=lambda: got.update(rx.recv(timeout=60)))
        reader.start()
        tx.send({"op": "hashes", "hashes": hashes})
        reader.join(timeout=60)
        if reader.is_alive() or not np.array_equal(got.get("hashes"), hashes):
            raise AssertionError("phase 12: hashed IDs did not round-trip")
    finally:
        tx.close()
        rx.close()


def phase_privacy(torch, hist, x, y, xte, params, dl) -> dict:
    """Phase 11's distributed path, guarded: the port's linter finds
    nothing in the port or this script; with the guard armed (the workers
    inherit it), ingest -> fit -> serve equal phase 11's results bit for
    bit with 340 histogram launches in each worker, and planted raw sends
    are refused.  Raises on any failure; returns the phase's numbers."""
    import os

    import numpy as np

    from repro_torch import convert
    from repro_torch.analysis import run_analysis
    from repro_torch.analysis import runtime
    from repro_torch.data import make_party_views
    from repro_torch.federation import Federation
    from repro_torch.serving import ServeConfig

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 12: {what}")

    out: dict = {}
    t0 = time.perf_counter()
    findings = run_analysis([SRC / "repro_torch", ROOT / "chip_smoke.py"])
    out["lint_s"] = time.perf_counter() - t0
    out["findings"] = len(findings)
    check(not findings, "the linter found " + "; ".join(
        f.render() for f in findings))

    want = dl["results"]
    prior = os.environ.get("REPRO_EGRESS_GUARD")
    os.environ["REPRO_EGRESS_GUARD"] = "1"       # before the spawn
    runtime.enable()
    checked = [0, 0.0]              # calls, host seconds inside them
    check_egress = runtime.check_egress

    def counted(msg, context=""):
        t = time.perf_counter()
        check_egress(msg, context)
        checked[0] += 1
        checked[1] += time.perf_counter() - t
    try:
        blocks, _, _ = make_party_views(x, y, 2, overlap=0.9, seed=0)
        check(all(runtime.lookup(b.x) is not None for b in blocks),
              "the armed guard did not tag the party blocks")
        fed = Federation(parties=2, substrate="distributed",
                         n_bins=params.n_bins)
        try:
            t0 = time.perf_counter()
            fed.substrate.coordinator                  # spawn, connect
            out["start_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            part = fed.ingest(blocks)
            out["ingest_s"] = time.perf_counter() - t0
            check(_same_partition(part, want["partition"], np),
                  "guarded partition != phase 11's")
            check(np.array_equal(fed.labels_, want["labels"]),
                  "guarded labels != phase 11's")
            check(np.array_equal(fed.aligned_ids_, want["hashed_ids"]),
                  "guarded hashed IDs != phase 11's")

            hist.histogram_cuda.launches = 0
            l0 = _worker_launches(fed)
            runtime.check_egress = counted
            try:
                t0 = time.perf_counter()
                model = fed.fit(params)
                torch.cuda.synchronize()
                out["fit_s"] = time.perf_counter() - t0
            finally:
                runtime.check_egress = check_egress
            out["checked_per_fit"], out["check_s"] = checked
            out["launches"] = [b - a for a, b in zip(l0,
                                                     _worker_launches(fed))]
            dense = params.n_estimators * (2 * params.max_depth + 1)
            check(out["launches"] == [dense, dense],
                  f"worker launches {out['launches']}, not {dense} each")
            check(hist.histogram_cuda.launches == 0,
                  "the session process launched the kernel")
            trees = convert.party_trees_to_numpy(model.trees_)
            bad = [f for f in want["trees"]
                   if not np.array_equal(trees[f], want["trees"][f])]
            check(len(trees) == 7 and not bad,
                  f"guarded forest != phase 11's on {bad}")

            server = fed.serve(model, ServeConfig())
            t0 = time.perf_counter()
            got = server.serve(xte)
            out["serve_s"] = time.perf_counter() - t0
            check(np.array_equal(got, want["served"]),
                  "guarded served answers != phase 11's")
            t0 = time.perf_counter()
            got = server.serve(xte)
            out["serve2_s"] = time.perf_counter() - t0
            check(np.array_equal(got, want["served"]),
                  "second guarded serve != phase 11's")
        finally:
            fed.close()
        _planted_sends(torch, blocks[0])
    finally:
        runtime.disable()
        if prior is None:
            os.environ.pop("REPRO_EGRESS_GUARD", None)
        else:
            os.environ["REPRO_EGRESS_GUARD"] = prior
    return out


def _rank_counts(fed, name: str) -> list[int]:
    """Each sharded rank's own (cumulative) counter ``name`` through the
    telemetry rollup, which adds a rank's whole count at every call."""
    from repro_torch.observability import registry as telemetry

    def merged(r):
        c = telemetry.REGISTRY.get(f"rank{r}.{name}")
        return 0 if c is None else c.value
    before = [merged(r) for r in range(fed.substrate.mesh.size)]
    fed.collect_telemetry()
    return [merged(r) - b for r, b in enumerate(before)]


def _block_to_parquet(b, path) -> str:
    """A PartyBlock as Parquet with ``to_csv``'s columns (id first, gf<N>
    features, label last)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    cols = {"id": pa.array(np.asarray(b.ids))}
    for j, gid in enumerate(b.feature_ids):
        cols[f"gf{gid}"] = pa.array(np.asarray(b.x[:, j], dtype=np.float64))
    if b.y is not None:
        cols["label"] = pa.array(np.asarray(b.y))
    pq.write_table(pa.table(cols), path)
    return path


def _cli(args, timeout: float) -> tuple[int, str, str]:
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=timeout)
    return res.returncode, res.stdout, res.stderr


def _printed_accuracy(stdout: str, key: str) -> str:
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("federated-forest:"))
    return line.split(f"{key}=")[1].split()[0]


def _train_kill_rerun(args, ckpt, timeout: float) -> dict:
    """The train CLI with ``--ckpt-dir``, killed as soon as its first chunk
    checkpoint lands, then rerun to the end: the rerun must keep the
    chunks already written (resume, not rewrite) and write the rest."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    first = Path(ckpt, "step_00000002")
    log = Path(ckpt).parent / "train_killed.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-m", *args],
                                stdout=fh, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT)
    t0 = time.perf_counter()
    try:
        while not first.exists():
            if proc.poll() is not None or time.perf_counter() - t0 > timeout:
                raise AssertionError(
                    "phase 13: the train CLI ended before its first chunk: "
                    + log.read_text()[-2000:])
            time.sleep(0.001)
        proc.kill()
    finally:
        proc.wait()
    kept = {p.name: p.stat().st_mtime_ns
            for p in sorted(Path(ckpt).glob("step_*"))}
    t0 = time.perf_counter()
    code, out, err = _cli(args, timeout)
    rerun_s = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"phase 13: the resumed train CLI exited "
                             f"{code}: {err[-2000:]}")
    after = {p.name: p.stat().st_mtime_ns
             for p in sorted(Path(ckpt).glob("step_*"))}
    return {"kept": kept, "after": after, "stdout": out, "rerun_s": rerun_s}


def phase_sharded(torch, hist, x, y, xte, params, dl, pf, work) -> dict:
    """The sharded substrate on the card, then the train and trace CLIs and
    Parquet streaming.  Raises on any disagreement; returns the numbers."""
    import dataclasses
    import json as _json
    import os

    import numpy as np

    from repro_torch import convert
    from repro_torch.core import BoostParams, ForestParams, crypto
    from repro_torch.core.fedlinear import LinearParams
    from repro_torch.data import (accuracy, make_classification,
                                  make_party_views, make_regression,
                                  train_test_split)
    from repro_torch.federation import Federation
    from repro_torch.launch.mesh import make_forest_mesh
    from repro_torch.serving import ServeConfig
    from repro_torch.streaming import ChunkedParquetSource

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 13: {what}")

    def trees_equal(model, want) -> list[str]:
        got = convert.party_trees_to_numpy(model.trees_)
        return [f for f in want if not np.array_equal(got[f], want[f])]

    out: dict = {}
    lap = _Lap("13")
    want = dl["results"]
    dense = params.n_estimators * (2 * params.max_depth + 1)
    blocks, _, _ = make_party_views(x, y, 2, overlap=0.9, seed=0)

    # (a) the sharded fit and serve: two gloo ranks on the one card
    mesh = make_forest_mesh(trees=1, parties=2, backend="gloo")
    fed = Federation(parties=2, substrate="sharded", mesh=mesh,
                     n_bins=params.n_bins)
    try:
        t0 = time.perf_counter()
        fed.substrate.coordinator                # spawn, join the world
        out["start_s"] = time.perf_counter() - t0
        part = fed.ingest(blocks)
        check(_same_partition(part, want["partition"], np)
              and np.array_equal(fed.labels_, want["labels"]),
              "sharded session's ingest != phase 11's")
        hist.histogram_cuda.launches = 0
        l0 = _rank_counts(fed, "kernels.histogram.launches")
        c0 = {k: _rank_counts(fed, f"sharded.{k}") for k in
              ("rounds", "bytes_sent", "bytes_received", "staged_bytes")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = fed.fit(params)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["launches"] = [b - a for a, b in zip(
            l0, _rank_counts(fed, "kernels.histogram.launches"))]
        for k, before in c0.items():
            out[k] = [b - a for a, b in zip(
                before, _rank_counts(fed, f"sharded.{k}"))]
        check(out["launches"] == [dense, dense],
              f"rank launches {out['launches']}, not {dense} each")
        check(hist.histogram_cuda.launches == 0,
              "the session process launched the kernel in a sharded fit")
        bad = trees_equal(model, want["trees"])
        check(not bad, f"sharded forest != simulated / distributed forest "
                       f"on {bad}")
        check(model.trees_.is_leaf.is_cuda,
              "the sharded forest is not on the session's card")
        t0 = time.perf_counter()
        model2 = fed.fit(params)
        torch.cuda.synchronize()
        out["fit2_s"] = time.perf_counter() - t0
        check(not trees_equal(model2, want["trees"]), "second fit differs")
        out["traced"] = _traced_fit(fed, params, label="rank")
        server = fed.serve(model, ServeConfig())
        t0 = time.perf_counter()
        got = server.serve(xte)
        out["serve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = server.serve(xte)
        out["serve2_s"] = time.perf_counter() - t0
        check(np.array_equal(got, want["served"]),
              "sharded served answers != phase 11's")
        t0 = time.perf_counter()
        pred = fed.predict(model, xte)
        out["predict_s"] = time.perf_counter() - t0
        check(np.array_equal(got, pred), "served answers != fed.predict")
        out["binds"] = server.compile_count

        # (h) hist_subtraction on the ranks, alone and with a multi-pass
        # frontier: the plain fit's forest (integer counts subtract exactly)
        out["hist_sub"] = []
        for cap in (0, 64):
            hp = dataclasses.replace(params, hist_subtraction=True,
                                     frontier_cap=cap)
            l0 = _rank_counts(fed, "kernels.histogram.launches")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hmodel = fed.fit(hp)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            bad = trees_equal(hmodel, want["trees"])
            check(not bad, f"hist_subtraction (frontier_cap={cap}) sharded "
                           f"forest != the plain forest on {bad}")
            out["hist_sub"].append({
                "frontier_cap": cap, "fit_s": fit_s,
                "launches": [b - a for a, b in zip(
                    l0, _rank_counts(fed, "kernels.histogram.launches"))]})
        # (h) the classical predict on the ranks: one party sum per level
        r0 = _rank_counts(fed, "sharded.rounds")
        t0 = time.perf_counter()
        cls = model.predict_classical(xte)
        out["classical_s"] = time.perf_counter() - t0
        out["classical_rounds"] = [b - a for a, b in zip(
            r0, _rank_counts(fed, "sharded.rounds"))]
        check(np.array_equal(cls, want["served"]),
              "sharded predict_classical != predict (phase 11's answers)")
        check(out["classical_rounds"] == [params.max_depth] * 2,
              f"classical predict rounds {out['classical_rounds']}, not "
              f"{params.max_depth} a rank")

        # (c, F-LR) on the same ranks: labels equal the simulated F-LR's
        xl, yl = make_classification(4000, 20, 2, seed=3)
        lp = LinearParams(steps=400)
        flr = Federation(parties=2, substrate=fed.substrate)
        flr.ingest(xl, yl)
        t0 = time.perf_counter()
        lmodel = flr.fit(lp)
        out["flr_fit_s"] = time.perf_counter() - t0
        sim = Federation(parties=2)
        sim.ingest(xl, yl)
        lref = sim.fit(lp)
        check(np.array_equal(flr.predict(lmodel, xl), sim.predict(lref, xl)),
              "sharded F-LR labels != simulated F-LR labels")
        out["flr_w_diff"] = float((lmodel._w - lref._w).abs().max())
    finally:
        fed.close()

    lap("a")
    # (b) the trees axis: four gloo ranks on the one card
    fed = Federation(parties=2, substrate="sharded", n_bins=params.n_bins,
                     mesh=make_forest_mesh(trees=2, parties=2,
                                           backend="gloo"))
    try:
        t0 = time.perf_counter()
        fed.substrate.coordinator
        out["start22_s"] = time.perf_counter() - t0
        l0 = _rank_counts(fed, "kernels.histogram.launches")
        r0 = _rank_counts(fed, "sharded.rounds")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = fed.fit(params, partition=part, y=want["labels"])
        torch.cuda.synchronize()
        out["fit22_s"] = time.perf_counter() - t0
        out["launches22"] = [b - a for a, b in zip(
            l0, _rank_counts(fed, "kernels.histogram.launches"))]
        out["rounds22"] = [b - a for a, b in zip(
            r0, _rank_counts(fed, "sharded.rounds"))]
        check(out["launches22"] == [dense // 2] * 4,
              f"(2, 2) rank launches {out['launches22']}, not {dense // 2}")
        bad = trees_equal(model, want["trees"])
        check(not bad, f"(2, 2) forest != (1, 2) forest on {bad}")
        check(np.array_equal(fed.predict(model, xte[:4096]),
                             want["served"][:4096]),
              "(2, 2) predictions != phase 11's answers")
        hp = dataclasses.replace(params, hist_subtraction=True)
        bad = trees_equal(fed.fit(hp, partition=part, y=want["labels"]),
                          want["trees"])
        check(not bad, f"(2, 2) hist_subtraction forest != (1, 2) forest on "
                       f"{bad}")
        check(np.array_equal(model.predict_classical(xte[:4096]),
                             want["served"][:4096]),
              "(2, 2) predict_classical != phase 11's answers")
    finally:
        fed.close()

    lap("b")
    # (c) boosting on a (2, 1) mesh, per-round args not tree-sharded
    xb_, yb_ = make_regression(200, 6, seed=0)
    bp = BoostParams(n_rounds=2, max_depth=2, n_bins=8)
    fed = Federation(parties=1, substrate="sharded", n_bins=8,
                     mesh=make_forest_mesh(trees=2, parties=1,
                                           backend="gloo"))
    try:
        fed.ingest(xb_, yb_)
        bm = fed.fit(bp)
        bpred = fed.predict(bm, xb_[:32])
        check(bpred.shape == (32,), f"boosting predict shape {bpred.shape}")
        sim = Federation(parties=1, n_bins=8)
        sim.ingest(xb_, yb_)
        bref = sim.fit(bp)
        for i, (a, b) in enumerate(zip(bm.trees_, bref.trees_)):
            ta, tb = (convert.party_trees_to_numpy(t) for t in (a, b))
            bad = [f for f in ta if not np.array_equal(ta[f], tb[f])]
            check(not bad, f"boosting round {i} != simulated on {bad}")
        check(np.array_equal(fed.predict(bm, xb_), sim.predict(bref, xb_)),
              "sharded boosting predictions != simulated")
        # served in float32 in the program, as the simulated server serves
        # (predict sums the rounds in float64 on the host)
        config = ServeConfig(buckets=(256,))
        check(np.array_equal(fed.serve(bm, config).serve(xb_),
                             sim.serve(bref, config).serve(xb_)),
              "sharded boosting served != the simulated server's answers")
    finally:
        fed.close()

    lap("c")
    # (d) NCCL: one rank on the card; two only with two cards
    xq, yq = make_classification(8000, 95, 2, n_informative=24, seed=0)
    xqt, yqt, xqe, _ = train_test_split(xq, yq, 0.25, seed=1)
    runs = [1] + ([2] if torch.cuda.device_count() >= 2 else [])
    out["nccl"] = []
    for m in runs:
        fed = Federation(parties=m, substrate="sharded",
                         n_bins=params.n_bins,
                         mesh=make_forest_mesh(trees=1, parties=m,
                                               backend="nccl"))
        try:
            t0 = time.perf_counter()
            fed.substrate.coordinator            # spawn, join the world
            start_s = time.perf_counter() - t0
            fed.ingest(xqt, yqt)
            t0 = time.perf_counter()
            nmodel = fed.fit(params)
            fit_s = time.perf_counter() - t0
            sim = Federation(parties=m, n_bins=params.n_bins)
            sim.ingest(xqt, yqt)
            nref = sim.fit(params)
            bad = trees_equal(nmodel,
                              convert.party_trees_to_numpy(nref.trees_))
            check(not bad, f"NCCL ({m} rank) forest != simulated FF({m}) "
                           f"on {bad}")
            check(np.array_equal(fed.predict(nmodel, xqe),
                                 sim.predict(nref, xqe)),
                  f"NCCL ({m} rank) predictions != simulated FF({m})")
            out["nccl"].append({"ranks": m, "start_s": start_s,
                                "fit_s": fit_s,
                                "devices": list(fed.mesh.devices)})
        finally:
            fed.close()

    lap("d")
    # (e) Parquet streaming: phase 8's extracts, 16,384-row chunks
    paths = []
    t0 = time.perf_counter()
    for b in blocks:
        paths.append(_block_to_parquet(
            b, os.path.join(work, f"{b.name}.parquet")))
    out["parquet_write_s"] = time.perf_counter() - t0
    out["parquet_bytes"] = sum(os.path.getsize(p) for p in paths)
    fed = Federation(parties=2, n_bins=params.n_bins)
    crypto._HASH_CACHE.clear()
    t0 = time.perf_counter()
    ppart = fed.ingest([ChunkedParquetSource(p, name=b.name)
                        for p, b in zip(paths, blocks)], chunk_rows=16384,
                       sketch_capacity=max(b.n_samples for b in blocks))
    out["parquet_ingest_s"] = time.perf_counter() - t0
    check(all(st.merged_scan().sketches.exact
              for st in fed._stream["streams"]), "the sketch compacted")
    check(_same_partition(ppart, want["partition"], np)
          and np.array_equal(fed.labels_, want["labels"])
          and np.array_equal(crypto.hash_ids(fed.aligned_ids_),
                             want["hashed_ids"]),
          "Parquet-streamed partition, labels or IDs != in-memory ingest")
    bad = trees_equal(fed.fit(params), want["trees"])
    check(not bad, f"Parquet-streamed forest != in-memory forest on {bad}")

    lap("e")
    # (f) the train CLI, synthetic at the paper's size, then party CSVs
    args = ["repro_torch.launch.train", "--arch", "federated-forest",
            "--rows", "156198", "--features", "95", "--parties", "2",
            "--trees", "8", "--depth", "6"]
    t0 = time.perf_counter()
    code, stdout, err = _cli(args, 300)
    out["cli_s"] = time.perf_counter() - t0
    check(code == 0, f"train CLI exited {code}: {err[-2000:]}")
    xs, ys = make_classification(156198, 95, 2, n_informative=31, seed=0)
    xs_tr, ys_tr, xs_te, ys_te = train_test_split(xs, ys, 0.25, seed=0)
    sp = ForestParams(n_estimators=8, max_depth=6, n_bins=16, seed=0)
    sim = Federation(parties=2, n_bins=16)
    sim.ingest(xs_tr, ys_tr)
    acc = accuracy(ys_te, sim.predict(sim.fit(sp), xs_te))
    out["cli_acc"] = _printed_accuracy(stdout, "acc")
    check(out["cli_acc"] == f"{acc:.3f}",
          f"train CLI accuracy {out['cli_acc']} != the session's {acc:.3f}")
    out["cli_line"] = stdout.strip().splitlines()[-1]

    ckpt = os.path.join(work, "cli_ckpt")
    cargs = ["repro_torch.launch.train", "--arch", "federated-forest",
             "--ckpt-dir", ckpt]
    for b, p in zip(blocks, pf["csv_paths"]):
        cargs += ["--party-csv", f"{b.name}={p}"]
    run = _train_kill_rerun(cargs, ckpt, 600)
    out["cli_rerun_s"] = run["rerun_s"]
    out["cli_killed_with"] = sorted(run["kept"])
    check(len(run["kept"]) < 4,
          f"the train CLI was killed only after {sorted(run['kept'])}")
    check(all(run["after"].get(k) == v for k, v in run["kept"].items())
          and sorted(run["after"]) == [f"step_{s:08d}" for s in (2, 4, 6, 8)],
          f"the rerun did not resume: before {run['kept']}, after "
          f"{run['after']}")
    cp = ForestParams(n_estimators=8, max_depth=6, n_bins=16, seed=0)
    sim = Federation(parties=2, n_bins=16)
    spart = sim.ingest(blocks)
    cacc = accuracy(sim.labels_, sim.predict(sim.fit(cp), spart.dense_raw()))
    out["cli_csv_acc"] = _printed_accuracy(run["stdout"], "train-acc")
    check(out["cli_csv_acc"] == f"{cacc:.3f}",
          f"party-CSV train CLI accuracy {out['cli_csv_acc']} != the "
          f"session's {cacc:.3f}")
    check(f"aligned {spart.n_samples} common samples" in run["stdout"],
          "the train CLI aligned another row count")

    lap("f")
    # (g) the trace CLI over phase 11's exported span file
    chrome = os.path.join(work, "chrome.json")
    code, stdout, err = _cli(["repro_torch.launch.trace_report",
                              dl["span_file"], "--chrome", chrome], 120)
    check(code == 0, f"trace CLI exited {code}: {err[-2000:]}")
    for section in ("self-time by category", "self-time by process",
                    "slowest spans", "chrome trace written"):
        check(section in stdout, f"trace report lacks {section!r}")
    with open(chrome, encoding="utf-8") as fh:
        events = _json.load(fh)["traceEvents"]
    check(len(events) > 0, "the Chrome trace is empty")
    out["trace_events"] = len(events)
    code, _, _ = _cli(["repro_torch.launch.trace_report",
                       os.path.join(work, "missing.jsonl")], 120)
    check(code == 1, f"trace CLI on a missing file exited {code}, not 1")
    lap("g")
    return out


def _rel_err(got, want) -> float:
    """Largest |got - want| over want's largest magnitude."""
    want = want.detach().float().cpu()
    err = float((got.detach().float().cpu() - want).abs().max())
    return err / max(float(want.abs().max()), 1e-30)


def _leaf_err(got: dict, want: dict) -> tuple[float, str]:
    """The largest per-leaf error over the leaf's largest magnitude, and
    its leaf."""
    return max(((_rel_err(got[k], w), k) for k, w in want.items()),
               default=(0.0, ""))


def _step_err(got: dict, want: dict, grads: dict, lr: float) -> dict:
    """Parameters after one AdamW step against a reference, by the rule of
    tests/test_torch_train.py: where the reference gradient is at least
    1e-2 of its leaf's largest magnitude, within 1e-3·lr; elsewhere Adam's
    first step g / (|g| + eps) turns rounding differences in a near-zero
    gradient into up to a whole step, so only the step's range (2·lr)
    holds there.  Returns the worst conditioned error over lr, the largest
    error over lr, the elements beyond 0.1·lr, and the conditioned share."""
    worst_c, worst, loose, n_c, n = 0.0, 0.0, 0, 0, 0
    for k, w in want.items():
        diff = (got[k].detach().float() - w.detach().float()).abs()
        g = grads[k].float().abs()
        cond = g >= 1e-2 * g.max()
        worst_c = max(worst_c, float(diff[cond].max()) if cond.any() else 0.0)
        worst = max(worst, float(diff.max()))
        loose += int((diff[~cond] > 0.1 * lr).sum())
        n_c, n = n_c + int(cond.sum()), n + diff.numel()
    return {"cond_err_over_lr": worst_c / lr, "max_err_over_lr": worst / lr,
            "beyond_tenth_lr": loose, "conditioned_share": n_c / n}


def _one_step(torch, model, tokens, lr, extras=None) -> dict:
    """Loss, gradients and the parameters after one AdamW step (the body of
    ``make_train_step`` at one microbatch), all on the CPU for comparing;
    ``extras`` are the batch's frames or patches."""
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train import adamw_init, adamw_update

    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss, (ce, _) = lm_loss(model, {"tokens": tokens, **(extras or {})})
    grads = torch.autograd.grad(loss, params)
    state = adamw_update(model, dict(zip(names, grads)), adamw_init(model),
                         lr=lr)
    cpu = {n: g.detach().cpu() for n, g in zip(names, grads)}
    return {"loss": float(loss.detach()), "ce": float(ce.detach()),
            "grads": cpu,
            "mu": {n: m.cpu() for n, m in state["mu"].items()},
            "params": {n: p.detach().cpu() for n, p in zip(names, params)}}


def _card_vs_cpu_step(torch, attn, cfg, toks, extras, lr, check, label):
    """One float32 training step (TF32 off) of ``cfg`` from the same
    weights on the card and on the CPU, with phase 14 (a)'s bounds; no
    flash launch."""
    import copy

    from repro_torch.models import transformer
    cpu_model = transformer.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    t0 = time.perf_counter()
    want = _one_step(torch, cpu_model, toks, lr, extras)
    cpu_s = time.perf_counter() - t0
    attn.flash_attention.launches = 0
    got = _one_step(torch, gpu_model, toks.cuda(), lr,
                    {k: v.cuda() for k, v in extras.items()})
    check(attn.flash_attention.launches == 0,
          f"{label}: a training step launched the flash kernel")
    check(abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]),
          f"{label}: card loss {got['loss']} != CPU loss {want['loss']} "
          f"(rtol 1e-5)")
    ge = _leaf_err(got["grads"], want["grads"])
    check(ge[0] <= 1e-3, f"{label}: gradient leaf {ge[1]}: {ge[0]:.3g} of "
                         f"its largest magnitude > 1e-3")
    se = _step_err(got["params"], want["params"], want["grads"], lr)
    check(se["cond_err_over_lr"] <= 1e-3 and se["max_err_over_lr"] <= 2.0,
          f"{label}: parameters after one AdamW step: {se}")
    print(f"({label}) one training step, {cfg.name} full width, "
          f"{cfg.n_layers} layers" + (f" + {cfg.enc_layers} encoder layers"
                                      if cfg.enc_layers else "")
          + f", float32, batch {tuple(toks.shape)}"
          + "".join(f", {k} {tuple(v.shape)}" for k, v in extras.items())
          + f": loss card {got['loss']:.7f} vs CPU {want['loss']:.7f} (rtol "
          f"1e-5); largest gradient error {ge[0]:.3g} of its leaf's largest "
          f"magnitude ({ge[1]}; bound 1e-3); after one AdamW step at lr "
          f"{lr:g}: conditioned elements ({se['conditioned_share']:.1%}) "
          f"within {se['cond_err_over_lr']:.3g}·lr (bound 1e-3·lr), all "
          f"within {se['max_err_over_lr']:.3g}·lr (bound 2·lr), "
          f"{se['beyond_tenth_lr']} beyond 0.1·lr; CPU step {cpu_s:.1f} s; "
          f"flash launches 0", flush=True)
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return {"loss": (got["loss"], want["loss"]), "grad_err": ge,
            "step_err": se, "cpu_step_s": cpu_s}


def _train_run(torch, attn, cfg, batch, seq, steps, micro_batch, lr, seed,
               trace: bool = False, one_batch: bool = False) -> dict:
    """``steps`` training steps of ``cfg`` at full width on the card from a
    seeded initialisation, on ``synthetic_lm_batches`` (with ``one_batch``,
    its first batch every step); CE a step, ms a step (host clock around a
    step that ends in reading its CE), tokens/s, 6·N·tokens/s over the
    bf16 peak, peak memory, flash launches; with ``trace``, one more step
    under ``torch.profiler``."""
    import statistics

    from repro_torch.data import lm
    from repro_torch.models import transformer
    from repro_torch.train import adamw_init, make_train_step

    model = transformer.init_params(cfg, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, micro_batch=micro_batch, lr=lr)
    opt = adamw_init(model)
    data = lm.synthetic_lm_batches(cfg, batch, seq, seed=seed,
                                   device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.flash_attention.launches = 0
    ces, secs = [], []
    first = next(data)
    for i in range(steps):
        b = first if one_batch or i == 0 else next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b)
        ces.append(float(m["ce"]))
        secs.append(time.perf_counter() - t0)
    out = {"params": n_params, "ce": ces, "step_s": secs,
           "launches": attn.flash_attention.launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    ms = statistics.median(secs[1:]) * 1e3
    out["ms_step"] = ms
    out["tok_s"] = batch * seq / (ms / 1e3)
    out["mfu"] = 6 * n_params * out["tok_s"] / _rl().BF16_FLOPS
    if trace:
        b = next(data)
        _, out["traced"] = _profile(torch, lambda: step(model, opt, b))
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def phase_train_moe(torch, attn) -> dict:
    """LM training and the MoE family on the card.  Raises on any
    disagreement; returns the numbers."""
    import copy
    import math

    import numpy as np

    from repro_torch import configs
    from repro_torch.data import lm
    from repro_torch.launch import serve
    from repro_torch.models import layers, transformer
    from repro_torch.train import adamw_init, make_train_step

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 14: {what}")

    out: dict = {}
    lap = _Lap("14")
    lr = 3e-4

    # (a) one training step, card == CPU: internlm2-1.8b's full width,
    # 2 layers, float32 (TF32 off), batch 2 x 128 (cut from 256 to keep
    # the script within its time limit), the same weights
    cfg = configs.get("internlm2-1.8b").with_(n_layers=2, dtype="float32")
    toks = torch.as_tensor(lm._markov_tokens(np.random.default_rng(2),
                                             cfg.vocab, (2, 128)),
                           dtype=torch.int64)
    out.update(_card_vs_cpu_step(torch, attn, cfg, toks, {}, lr, check,
                                 "a"))

    lap("a")
    # (b) microbatching on the card: micro_batch 2 (four microbatches,
    # float32 sums) against 8 (one backward), the same weights and batch
    base = transformer.init_params(cfg, seed=1)
    batch = {"tokens": torch.as_tensor(lm._markov_tokens(
        np.random.default_rng(3), cfg.vocab, (8, 256)), dtype=torch.int64,
        device="cuda")}
    runs = {}
    for mb in (8, 2):
        model = copy.deepcopy(base)
        model, opt, m = make_train_step(cfg, micro_batch=mb, lr=lr)(
            model, adamw_init(model), batch)
        runs[mb] = {"loss": float(m["loss"]), "mu": opt["mu"],
                    "params": dict(model.named_parameters())}
    out["micro_loss"] = (runs[2]["loss"], runs[8]["loss"])
    check(abs(runs[2]["loss"] - runs[8]["loss"])
          <= 1e-5 * abs(runs[8]["loss"]),
          f"micro_batch 2 loss {runs[2]['loss']} != micro_batch 8 loss "
          f"{runs[8]['loss']} (rtol 1e-5)")
    out["micro_grad_err"] = _leaf_err(runs[2]["mu"], runs[8]["mu"])
    check(out["micro_grad_err"][0] <= 1e-3,
          f"micro_batch 2 vs 8: first moment (0.1 x gradient) of "
          f"{out['micro_grad_err'][1]} off by {out['micro_grad_err'][0]:.3g}")
    out["micro_step_err"] = _step_err(runs[2]["params"], runs[8]["params"],
                                      runs[8]["mu"], lr)
    check(out["micro_step_err"]["cond_err_over_lr"] <= 1e-3
          and out["micro_step_err"]["max_err_over_lr"] <= 2.0,
          f"micro_batch 2 vs 8 parameters: {out['micro_step_err']}")
    me = out["micro_step_err"]
    print(f"(b) micro_batch 2 vs 8 on the card (batch 8 x 256): loss "
          f"{runs[2]['loss']:.7f} vs {runs[8]['loss']:.7f}; first moment "
          f"within {out['micro_grad_err'][0]:.3g} of its leaf's largest; "
          f"parameters: conditioned within {me['cond_err_over_lr']:.3g}·lr, "
          f"all within {me['max_err_over_lr']:.3g}·lr, "
          f"{me['beyond_tenth_lr']} beyond 0.1·lr", flush=True)
    del base, runs, model, opt
    torch.cuda.empty_cache()

    lap("b")
    # (c) internlm2-1.8b at full width and depth: bf16, remat "unit",
    # batch 8 x 2048, micro_batch 2, 10 steps at lr 3e-4 (fresh batches:
    # at 5 steps the CE's fall is within its spread)
    cfg = configs.get("internlm2-1.8b")
    tr = _train_run(torch, attn, cfg, 8, 2048, 10, 2, lr, 0, trace=True)
    MEASURED["train"] = {"peak_bytes": tr["peak_gib"] * 2**30,
                         "step_s": tr["ms_step"] / 1e3}
    out["train"] = tr
    print(f"(c) internlm2-1.8b full width and depth, bf16, remat unit, "
          f"batch 8 x 2048, micro_batch 2, lr {lr:g}, {len(tr['ce'])} "
          f"steps: {tr['params'] / 1e9:.3f} B params; {tr['ms_step']:.1f} ms "
          f"a step (median after the first; first "
          f"{tr['step_s'][0] * 1e3:.1f} ms) = {tr['tok_s']:.0f} tokens/s; "
          f"6·N·tokens/s = {tr['mfu']:.1%} of the 989 TFLOP/s bf16 peak; "
          f"peak memory {tr['peak_gib']:.2f} GiB; flash launches "
          f"{tr['launches']}")
    print("(c) CE by step: " + " ".join(f"{c:.4f}" for c in tr["ce"])
          + f" (ln V = {math.log(cfg.vocab):.4f})")
    print("(c) traced step:", json.dumps(tr["traced"]), flush=True)
    check(tr["launches"] == 0, "training launched the flash kernel")
    check(all(math.isfinite(c) for c in tr["ce"]), f"CE {tr['ce']}")
    check(abs(tr["ce"][0] - math.log(cfg.vocab)) < 2.0,
          f"CE at step 0 {tr['ce'][0]} is not within 2 of ln V")
    check(tr["ce"][-1] < tr["ce"][0], f"CE did not fall: {tr['ce']}")

    lap("c")
    # (d) the MoE layer, card == CPU: qwen2-moe-a2.7b's full width (60
    # experts, top 4, d_expert 1408, shared 5632) in float32
    mcfg = configs.get("qwen2-moe-a2.7b").with_(dtype="float32")
    p_cpu = layers.init_moe(torch.Generator().manual_seed(0), mcfg, "cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(2, 256, mcfg.d_model)).astype(np.float32))
    t, k = 512, mcfg.top_k
    cap = int(math.ceil(t * k / mcfg.n_experts * mcfg.moe_capacity))
    res = {}
    with torch.no_grad():
        for name, p, xx in (("cpu", p_cpu, x), ("cuda", p_gpu, x.cuda())):
            probs = torch.softmax((xx.reshape(t, -1) @ p.router).float(), -1)
            top, idx = layers._top_k(probs, k + 1)
            slots = layers.moe_slots(idx[:, :k], mcfg.n_experts,
                                     p.we_gate.shape[0], cap)
            y, aux = layers.moe(p, xx, mcfg)
            res[name] = {"slots": slots.cpu(), "y": y.cpu(),
                         "aux": float(aux), "gap": float(
                             (top[:, k - 1] - top[:, k]).min())}
    c, g = res["cpu"], res["cuda"]
    out["moe"] = {"cap": cap, "min_gap": c["gap"],
                  "kept": int((c["slots"] < t * k).sum()),
                  "y_err": float((g["y"] - c["y"]).abs().max()),
                  "y_max": float(c["y"].abs().max()),
                  "aux": (g["aux"], c["aux"])}
    check(torch.equal(g["slots"], c["slots"]),
          f"MoE kept slots differ between card and CPU (smallest gap "
          f"between a token's k-th and (k+1)-th router probability "
          f"{c['gap']:.3g})")
    check(out["moe"]["y_err"] <= 1e-4 * out["moe"]["y_max"],
          f"MoE y: card vs CPU {out['moe']['y_err']:.3g} > 1e-4 of "
          f"{out['moe']['y_max']:.3g}")
    check(abs(g["aux"] - c["aux"]) <= 1e-6,
          f"MoE aux {g['aux']} vs {c['aux']}")
    mo = out["moe"]
    print(f"(d) MoE layer, qwen2-moe-a2.7b full width, float32, {t} tokens "
          f"(capacity {cap}): kept slots card == CPU ({mo['kept']} kept; "
          f"smallest k-th vs (k+1)-th router gap {mo['min_gap']:.3g}); y max "
          f"|diff| {mo['y_err']:.3g} of {mo['y_max']:.3g} (bound 1e-4 of "
          f"it); aux {g['aux']:.8f} vs {c['aux']:.8f} (bound 1e-6)",
          flush=True)
    del p_cpu, p_gpu, res, c, g

    lap("d")
    # (e) serving qwen2-moe-a2.7b at full width and depth, bf16
    mcfg = configs.get("qwen2-moe-a2.7b")
    batch_n, prompt_len, max_new = 8, 2048, 32
    t0 = time.perf_counter()
    model = transformer.init_params(mcfg, seed=0)
    torch.cuda.synchronize()
    out["moe_init_s"] = time.perf_counter() - t0
    out["moe_params"] = sum(p.numel() for p in model.parameters())
    data = lm.synthetic_lm_batches(mcfg, batch_n, prompt_len, seed=0,
                                   device="cpu")
    torch.cuda.reset_peak_memory_stats()
    launches = 0
    for wave in range(2):
        prompts = next(data)["tokens"].numpy()
        attn.flash_attention.launches = 0
        toks_out, stats = serve.serve_batch(mcfg, model, prompts, max_new,
                                            cache_len=prompt_len + max_new)
        n = attn.flash_attention.launches
        launches += n
        check(n == mcfg.n_layers, f"qwen2-moe wave {wave}: {n} flash "
                                  f"launches, not {mcfg.n_layers}")
        check(toks_out.shape == (batch_n, max_new) and toks_out.min() >= 0
              and toks_out.max() < mcfg.vocab and stats["logits_finite"],
              f"qwen2-moe wave {wave}: tokens {toks_out.shape} in "
              f"[{toks_out.min()}, {toks_out.max()}], logits finite "
              f"{stats['logits_finite']}")
        print(f"(e) qwen2-moe-a2.7b serve wave {wave}, full width and "
              f"depth, bf16, {batch_n} x {prompt_len} + {max_new}: prefill "
              f"{stats['prefill_s']:.4f} s = "
              f"{batch_n * prompt_len / stats['prefill_s']:.0f} tok/s; "
              f"decode {stats['decode_s']:.4f} s = "
              f"{stats['decode_tok_s']:.1f} tok/s; flash launches {n}",
              flush=True)
    out["moe_launches"] = launches
    out["moe_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    tokens = torch.as_tensor(next(data)["tokens"], device="cuda")
    _, out["moe_traced_prefill"] = _profile(
        torch, lambda: model.prefill(tokens, cache_len=prompt_len + max_new),
        match="attn_")
    with torch.inference_mode():
        xb = torch.randn((batch_n, prompt_len, mcfg.d_model),
                         dtype=layers.torch_dtype(mcfg), device="cuda")
        out["moe_layer_ms"] = _time_ms(
            lambda: layers.moe(model.blocks[0].ffn, xb, mcfg), torch, reps=5)
    print(f"(e) {out['moe_params'] / 1e9:.3f} B params drawn in "
          f"{out['moe_init_s']:.2f} s; flash launches {launches} over two "
          f"waves; peak memory {out['moe_peak_gib']:.2f} GiB; the MoE layer "
          f"at the prefill shape ({batch_n * prompt_len} tokens) "
          f"{out['moe_layer_ms']:.3f} ms")
    print("(e) traced prefill:", json.dumps(out["moe_traced_prefill"]),
          flush=True)
    del model, xb
    torch.cuda.empty_cache()

    lap("e")
    # (f) training qwen2-moe-a2.7b at full width: 2 layers, bf16, 10 steps
    # on one batch (the JAX package's test_train_step_reduces_loss regime:
    # on fresh batches at this lr the CE of 10 steps moves by less than
    # its batch-to-batch spread)
    mt = _train_run(torch, attn, mcfg.with_(n_layers=2), 8, 512, 10, 0, lr,
                    0, one_batch=True)
    out["moe_train"] = mt
    print(f"(f) qwen2-moe-a2.7b full width, 2 layers, bf16, one batch of 8 x "
          f"512, {len(mt['ce'])} steps at lr {lr:g}: {mt['params'] / 1e9:.3f} "
          f"B params; {mt['ms_step']:.1f} ms a step = {mt['tok_s']:.0f} "
          f"tokens/s; peak memory {mt['peak_gib']:.2f} GiB; flash launches "
          f"{mt['launches']}; CE " + " ".join(f"{c:.4f}" for c in mt["ce"])
          + f" (ln V = {math.log(mcfg.vocab):.4f})", flush=True)
    check(mt["launches"] == 0, "MoE training launched the flash kernel")
    check(all(math.isfinite(c) for c in mt["ce"]), f"MoE CE {mt['ce']}")
    check(abs(mt["ce"][0] - math.log(mcfg.vocab)) < 2.0,
          f"MoE CE at step 0 {mt['ce'][0]} is not within 2 of ln V")
    check(mt["ce"][-1] < mt["ce"][0], f"MoE CE did not fall: {mt['ce']}")
    lap("f")
    return out


def _naive_ssd(torch, a, xin, bk, cq, h0):
    """The recurrence of ``chunked_ssd`` step by step in float64:
    h_t = a_t h_{t-1} + xin_t ⊗ bk_t, y_t = h_t · cq_t."""
    f64 = torch.float64
    a, xin, bk, cq = (t.to(f64) for t in (a, xin, bk, cq))
    h, ys = h0.to(f64), []
    for t in range(xin.shape[1]):
        h = (h * a[:, t, :, None, None]
             + xin[:, t, :, :, None] * bk[:, t, :, None, :])
        ys.append((h @ cq[:, t, :, :, None])[..., 0])
    return torch.stack(ys, 1), h


def _serve_waves(torch, attn, cfg, model, data, batch_n, prompt_len,
                 max_new, check, label) -> dict:
    """Two serving waves through ``serve_batch``, each batch's frames or
    patches as its extras; flash launches a wave."""
    from repro_torch.launch import serve
    out = {"waves": []}
    torch.cuda.reset_peak_memory_stats()
    for wave in range(2):
        batch = next(data)
        prompts = batch.pop("tokens").numpy()
        before = attn.flash_attention.launches
        toks, stats = serve.serve_batch(cfg, model, prompts, max_new,
                                        cache_len=prompt_len + max_new,
                                        extras=batch)
        n = attn.flash_attention.launches - before
        check(toks.shape == (batch_n, max_new) and toks.min() >= 0
              and toks.max() < cfg.vocab and stats["logits_finite"],
              f"{label} wave {wave}: tokens {toks.shape} in [{toks.min()}, "
              f"{toks.max()}], logits finite {stats['logits_finite']}")
        w = {"prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
             "prefill_tok_s": batch_n * prompt_len / stats["prefill_s"],
             "decode_tok_s": stats["decode_tok_s"], "flash_launches": n}
        out["waves"].append(w)
        print(f"({label}) serve wave {wave}, {batch_n} x {prompt_len} + "
              f"{max_new}: prefill {w['prefill_s']:.4f} s = "
              f"{w['prefill_tok_s']:.0f} tok/s; decode {w['decode_s']:.4f} s "
              f"= {w['decode_tok_s']:.1f} tok/s; flash launches {n}",
              flush=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _prefill_vs_decode(torch, cfg, s, check, label) -> dict:
    """float32 at ``cfg``'s width and depth: the last logits of
    prefill(S+1) against prefill(S) + decode_step(S), within 2e-3, argmax
    equal (phase 7's check); an encoder-decoder's frames and a VLM's
    patches go to both prefills."""
    import numpy as np

    from repro_torch.data import lm
    from repro_torch.models import transformer
    model = transformer.init_params(cfg, seed=0)
    toks = torch.as_tensor(lm._markov_tokens(np.random.default_rng(1),
                                             cfg.vocab, (2, s + 1)),
                           dtype=torch.int64, device="cuda")
    rng = np.random.default_rng(4)
    extras = {}
    if cfg.enc_layers:
        extras["frames"] = lm._stub(rng, (2, cfg.enc_frames, cfg.d_model),
                                    torch.float32, "cuda")
    if cfg.n_patches:
        extras["patches"] = lm._stub(rng, (2, cfg.n_patches, cfg.d_model),
                                     torch.float32, "cuda")
    la, _ = model.prefill(toks, extras=extras)
    _, cache = model.prefill(toks[:, :s], cache_len=s + 1, extras=extras)
    lb, _ = model.decode_step(cache, toks[:, s:], s)
    err = float((la - lb).abs().max())
    top = la.topk(2, dim=-1).values
    gap = float((top[:, 0] - top[:, 1]).min())
    print(f"({label}) float32, {cfg.n_layers} layers, S={s}, batch 2: "
          f"prefill(S+1) vs prefill(S) + decode_step(S): max |logit diff| "
          f"{err:.3g} (logits up to {float(la.abs().max()):.3g}); smallest "
          f"top-2 gap {gap:.3g}", flush=True)
    check(err <= 2e-3, f"{label}: prefill/decode logits differ by {err} > "
                       f"2e-3")
    check(torch.equal(la.argmax(-1), lb.argmax(-1)),
          f"{label}: prefill/decode argmax tokens differ")
    del model, cache
    torch.cuda.empty_cache()
    return {"err": err, "gap": gap}


def phase_ssm_hybrid(torch, attn, ref) -> dict:
    """The SSM, xLSTM and hybrid blocks on the card: xlstm-350m and
    zamba2-7b served and trained, the flash kernel at head dim 112.  Raises
    on any disagreement; returns the numbers."""
    import copy
    import math

    import numpy as np

    from repro_torch import configs
    from repro_torch.data import lm
    from repro_torch.models import ssm, transformer

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 15: {what}")

    out: dict = {}
    lap = _Lap("15")
    zcfg, xcfg = configs.get("zamba2-7b"), configs.get("xlstm-350m")

    # (a) each block at its config's full width in float32, card against
    # CPU from one set of weights: 300 tokens (chunk 256, a ragged second
    # chunk) from no cache, then one decode step from that cache
    rng = np.random.default_rng(5)
    out["blocks"] = {}
    for kind, cfg in (("mamba2", zcfg), ("mlstm", xcfg), ("slstm", xcfg)):
        cfg = cfg.with_(dtype="float32")
        core = ssm.INITS[kind](torch.Generator().manual_seed(1), cfg, "cpu")
        core_gpu = copy.deepcopy(core).to("cuda")
        x = torch.as_tensor(rng.normal(size=(2, 301, cfg.d_model)).astype(
            np.float32))
        res = []
        with torch.inference_mode():
            for c, xx in ((core, x), (core_gpu, x.cuda())):
                y, cache = ssm.BLOCKS[kind](c, xx[:, :300], cfg)
                y1, cache1 = ssm.BLOCKS[kind](c, xx[:, 300:], cfg,
                                              cache=cache)
                res.append({"y": y, "y decode": y1, **cache,
                            **{f"{k} decode": v for k, v in cache1.items()}})
        errs = {k: _rel_err(res[1][k], v) for k, v in res[0].items()}
        worst = max(errs.items(), key=lambda kv: kv[1])
        out["blocks"][kind] = errs
        print(f"(a) {kind} block, {cfg.name} width (d_model {cfg.d_model}, "
              f"d_inner {cfg.d_inner}, {cfg.n_ssm_heads} heads), float32, 2 x "
              f"300 + 1 decode: card vs CPU, largest error {worst[1]:.3g} of "
              f"its leaf's largest magnitude ({worst[0]}; bound 1e-4); "
              + ", ".join(f"{k} {v:.2g}" for k, v in errs.items()),
              flush=True)
        check(worst[1] <= 1e-4, f"{kind} block card vs CPU: {worst}")
        del core, core_gpu, res
    # chunked_ssd at zamba2-7b's head shape against the float64 recurrence
    h, p, n = zcfg.n_ssm_heads, zcfg.ssm_head_dim, zcfg.ssm_state
    s = 300
    g = torch.Generator(device="cuda").manual_seed(3)
    a = 0.6 + 0.4 * torch.rand((1, s, h), generator=g, device="cuda")
    xin, bk, cq = (torch.randn((1, s, h, m), generator=g, device="cuda")
                   for m in (p, n, n))
    h0 = torch.randn((1, h, p, n), generator=g, device="cuda")
    y, hf = ssm.chunked_ssd(a, xin, bk, cq, h0, zcfg.ssm_chunk)
    wy, wh = _naive_ssd(torch, a, xin, bk, cq, h0)
    ok = (torch.allclose(y.double(), wy, rtol=2e-4, atol=2e-4)
          and torch.allclose(hf.double(), wh, rtol=2e-4, atol=2e-4))
    out["ssd_err"] = (float((y.double() - wy).abs().max()),
                      float((hf.double() - wh).abs().max()))
    print(f"(a) chunked_ssd at zamba2-7b's head shape (H {h}, P {p}, N {n}, "
          f"chunk {zcfg.ssm_chunk}), S {s}: y max |diff| "
          f"{out['ssd_err'][0]:.3g} (values up to {float(wy.abs().max()):.3g}),"
          f" h {out['ssd_err'][1]:.3g} (up to {float(wh.abs().max()):.3g}) "
          f"against the float64 recurrence (rtol = atol = 2e-4)", flush=True)
    check(ok, f"chunked_ssd vs the recurrence: {out['ssd_err']}")
    del a, xin, bk, cq, h0, y, hf, wy, wh
    lap("a")

    # (b) phase 6's check at D = 112, zamba2-7b's shared attention
    out["attention"] = phase_attention(torch, attn, ref, cases=[
        ("D=112 window 16 f32", 1, 2, 96, 160, 112, torch.float32, False, 16,
         False),
        ("D=112 ragged causal Sq=200 > Sk=72 bf16", 1, 2, 200, 72, 112,
         torch.bfloat16, True, None, False),
        ("D=112 Sq=Sk=1000 bf16", 2, 2, 1000, 1000, 112, torch.bfloat16,
         True, None, False),
        # zamba2-7b's prefill: batch 8, 32 heads, 2048 tokens
        ("zamba2 prefill bf16 D=112", 8, 32, 2048, 2048, 112,
         torch.bfloat16, True, None, True),
        ("zamba2 prefill f32 D=112 B=1", 1, 32, 2048, 2048, 112,
         torch.float32, True, None, True)])
    lap("b")

    # (c) zamba2-7b served at full width and depth, bf16
    batch_n, prompt_len, max_new = 8, 2048, 32
    t0 = time.perf_counter()
    model = transformer.init_params(zcfg, seed=0)
    torch.cuda.synchronize()
    out["zamba_init_s"] = time.perf_counter() - t0
    out["zamba_params"] = sum(q.numel() for q in model.parameters())
    uses = transformer.layer_kinds(zcfg).count("attn_shared")
    print(f"(c) zamba2-7b: {zcfg.n_layers} layers ({zcfg.n_units} units of "
          f"{len(zcfg.pattern)} + {len(zcfg.tail_blocks)} tail), d_model "
          f"{zcfg.d_model}, {zcfg.n_ssm_heads} SSM heads, shared attention "
          f"{zcfg.n_heads} heads of {zcfg.head_dim}, d_ff {zcfg.d_ff}, vocab "
          f"{zcfg.vocab}, bf16; {out['zamba_params'] / 1e9:.3f} B params "
          f"(numel; ArchConfig.param_count says "
          f"{zcfg.param_count() / 1e9:.3f} B) drawn in "
          f"{out['zamba_init_s']:.2f} s", flush=True)
    data = lm.synthetic_lm_batches(zcfg, batch_n, prompt_len, seed=0,
                                   device="cpu")
    sv = _serve_waves(torch, attn, zcfg, model, data, batch_n, prompt_len,
                      max_new, check, "c")
    for w in sv["waves"]:
        check(w["flash_launches"] == uses, f"zamba2 wave: "
              f"{w['flash_launches']} flash launches, not {uses} (one a "
              f"shared-attention use)")
    out["zamba_serve"] = sv
    out["zamba_launches"] = sum(w["flash_launches"] for w in sv["waves"])
    tokens = torch.as_tensor(next(data)["tokens"], device="cuda")
    _, out["zamba_traced_prefill"] = _profile(
        torch, lambda: model.prefill(tokens, cache_len=prompt_len + max_new),
        match="attn_")
    print(f"(c) flash launches {out['zamba_launches']} over two waves "
          f"({uses} a prefill); peak memory {sv['peak_gib']:.2f} GiB")
    print("(c) traced prefill:", json.dumps(out["zamba_traced_prefill"]),
          flush=True)
    del model, tokens
    torch.cuda.empty_cache()
    out["zamba_consistency"] = _prefill_vs_decode(
        torch, zcfg.with_(n_layers=9, dtype="float32"), 512, check, "c")
    lap("c")

    # (d) xlstm-350m served at full width and depth, bf16: no attention
    t0 = time.perf_counter()
    model = transformer.init_params(xcfg, seed=0)
    torch.cuda.synchronize()
    out["xlstm_params"] = sum(q.numel() for q in model.parameters())
    print(f"(d) xlstm-350m: {xcfg.n_layers} layers (mLSTM, sLSTM), d_model "
          f"{xcfg.d_model}, {xcfg.n_ssm_heads} heads, vocab {xcfg.vocab}, "
          f"bf16; {out['xlstm_params'] / 1e9:.3f} B params drawn in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    data = lm.synthetic_lm_batches(xcfg, batch_n, prompt_len, seed=0,
                                   device="cpu")
    sv = _serve_waves(torch, attn, xcfg, model, data, batch_n, prompt_len,
                      max_new, check, "d")
    check(all(w["flash_launches"] == 0 for w in sv["waves"]),
          "xlstm-350m launched the flash kernel")
    out["xlstm_serve"] = sv
    print(f"(d) peak memory {sv['peak_gib']:.2f} GiB; flash launches 0")
    del model
    torch.cuda.empty_cache()
    out["xlstm_consistency"] = _prefill_vs_decode(
        torch, xcfg.with_(n_layers=4, dtype="float32"), 512, check, "d")
    lap("d")

    # (e) training.  A float32 step, card == CPU, at zamba2-7b's full width
    # and 6 layers (one unit: five Mamba2 blocks and a shared-block use),
    # batch 1 x 64 (cut from 128 to keep the script within its time
    # limit), with phase 14 (a)'s bounds
    lr = 3e-4
    cfg = zcfg.with_(n_layers=6, dtype="float32")
    toks = torch.as_tensor(lm._markov_tokens(np.random.default_rng(2),
                                             cfg.vocab, (1, 64)),
                           dtype=torch.int64)
    out.update(_card_vs_cpu_step(torch, attn, cfg, toks, {}, lr, check,
                                 "e"))
    lap("e, zamba2 step card vs CPU")

    # bf16, remat "unit" on one batch (phase 14 (f)'s regime), 2 steps of
    # xlstm-350m (4.6 s each) and 6 of zamba2-7b (cut from 3 and 10 to
    # keep the script within its time limit):
    # xlstm-350m at full width and depth (sequences of 128: sLSTM's step
    # loop runs under autograd, ~1,000 kernels a position), zamba2-7b at
    # full width and 6 layers (at 81 layers AdamW's float32 moments alone
    # are ~46 GB for its ~5.7 B parameters, beside 11.5 GB of bf16 weights
    # and their gradients)
    # xlstm-350m's step is not traced: the profiler's summary of its ~139k
    # kernels took ~60 s (PRs 22-24 traced it: 93-94 % idle, sLSTM's loop)
    for name, cfg, batch, seq, steps, trace in (
            ("xlstm-350m", xcfg, 8, 128, 2, False),
            ("zamba2-7b", zcfg.with_(n_layers=6), 8, 512, 6, True)):
        tr = _train_run(torch, attn, cfg, batch, seq, steps, 0, lr, 0,
                        trace=trace, one_batch=True)
        out[f"train {name}"] = tr
        print(f"(e) {name} full width, {cfg.n_layers} layers, bf16, remat "
              f"unit, one batch of {batch} x {seq}, {len(tr['ce'])} steps at "
              f"lr {lr:g}: {tr['params'] / 1e9:.3f} B params (numel); "
              f"{tr['ms_step']:.1f} ms a step (median after the first; first "
              f"{tr['step_s'][0] * 1e3:.1f} ms) = {tr['tok_s']:.0f} tokens/s; "
              f"6·N·tokens/s = {tr['mfu']:.1%} of the 989 TFLOP/s bf16 peak; "
              f"peak memory {tr['peak_gib']:.2f} GiB; flash launches "
              f"{tr['launches']}; CE " + " ".join(f"{c:.4f}" for c in tr["ce"])
              + f" (ln V = {math.log(cfg.vocab):.4f})"
              + ("" if name != "zamba2-7b"
                 else f"; {cfg.n_layers} of {zcfg.n_layers} layers: at full "
                      f"depth AdamW's float32 moments alone would be "
                      f"{out['zamba_params'] * 8 / 1e9:.1f} GB"), flush=True)
        if trace:
            print(f"(e) {name} traced step:", json.dumps(tr["traced"]),
                  flush=True)
        check(tr["launches"] == 0, f"{name} training launched the flash "
                                   f"kernel")
        check(all(math.isfinite(c) for c in tr["ce"]), f"{name} CE "
                                                       f"{tr['ce']}")
        check(abs(tr["ce"][0] - math.log(cfg.vocab)) < 2.0,
              f"{name} CE at step 0 {tr['ce'][0]} is not within 2 of ln V")
        check(tr["ce"][-1] < tr["ce"][0], f"{name} CE did not fall: "
                                          f"{tr['ce']}")
        lap(f"e, {name} trained")
    return out


def phase_encdec_vlm(torch, attn, ref) -> dict:
    """The encoder-decoder and VLM families on the card: the flash kernel
    on whisper-large-v3's bidirectional and cross-attention shapes,
    whisper-large-v3 and qwen2-vl-2b served and trained.  Raises on any
    disagreement; returns the numbers."""
    import math

    import numpy as np

    from repro_torch import configs
    from repro_torch.data import lm
    from repro_torch.models import transformer

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 16: {what}")

    out: dict = {}
    lap = _Lap("16")
    f32, bf16 = torch.float32, torch.bfloat16
    wcfg, qcfg = configs.get("whisper-large-v3"), configs.get("qwen2-vl-2b")
    b8, frames, h, dh = 8, wcfg.enc_frames, wcfg.n_heads, wcfg.head_dim

    # (a) phase 6's check on every shape (b) and (c) give the kernel: the
    # encoder's bidirectional self-attention (a ragged last key tile of 92
    # rows, no causal mask), the cross-attention (416 decoder rows on the
    # 1500 frames), the decoder's causal self-attention (416 rows: a ragged
    # causal last tile at D 64) and qwen2-vl's prefill (12 heads, the GQA
    # repeat done, D 128)
    qh, qd = qcfg.n_heads, qcfg.head_dim
    out["attention"] = phase_attention(torch, attn, ref, cases=[
        ("whisper encoder bf16", b8, h, frames, frames, dh, bf16, False,
         None, True),
        ("whisper cross bf16", b8, h, 416, frames, dh, bf16, False, None,
         True),
        ("whisper encoder f32", b8, h, frames, frames, dh, f32, False, None,
         False),
        ("whisper cross f32", b8, h, 416, frames, dh, f32, False, None,
         False),
        ("whisper decoder self bf16", b8, h, 416, 416, dh, bf16, True, None,
         False),
        ("whisper decoder self f32", b8, h, 416, 416, dh, f32, True, None,
         False),
        ("qwen2-vl prefill bf16", b8, qh, 2048, 2048, qd, bf16, True, None,
         False)])

    lap("a")
    # (b) whisper-large-v3 served at full width and depth, bf16: two waves
    # of 8 prompts of 416 tokens with 8 x 1500 x 1280 frames, 32 greedy
    # tokens (416 + 32 = 448, its decoder context)
    prompt_len, max_new = 416, 32
    t0 = time.perf_counter()
    model = transformer.init_params(wcfg, seed=0)
    torch.cuda.synchronize()
    out["whisper_params"] = sum(q.numel() for q in model.parameters())
    print(f"(b) whisper-large-v3: {wcfg.enc_layers} encoder + "
          f"{wcfg.n_layers} decoder layers, d_model {wcfg.d_model}, "
          f"{wcfg.n_heads} heads of {wcfg.head_dim}, d_ff {wcfg.d_ff}, vocab "
          f"{wcfg.vocab}, {frames} frames, bf16; "
          f"{out['whisper_params'] / 1e9:.3f} B params (numel; "
          f"ArchConfig.param_count says {wcfg.param_count() / 1e9:.3f} B) "
          f"drawn in {time.perf_counter() - t0:.2f} s", flush=True)
    per_prefill = 3 * wcfg.n_layers     # encoder, self, cross
    data = lm.synthetic_lm_batches(wcfg, b8, prompt_len, seed=0,
                                   device="cpu")
    sv = _serve_waves(torch, attn, wcfg, model, data, b8, prompt_len,
                      max_new, check, "b")
    for w in sv["waves"]:
        check(w["flash_launches"] == per_prefill,
              f"whisper wave: {w['flash_launches']} flash launches, not "
              f"{per_prefill} (encoder, decoder self- and cross-attention)")
        w["frames_s"] = b8 * frames / w["prefill_s"]
    out["whisper_serve"] = sv
    out["whisper_launches"] = sum(w["flash_launches"] for w in sv["waves"])
    batch = next(data)
    prompts = batch.pop("tokens").numpy()
    from repro_torch.launch import serve
    (_, stats), out["whisper_traced"] = _profile(
        torch, lambda: serve.serve_batch(wcfg, model, prompts, max_new,
                                         prompt_len + max_new, extras=batch),
        match="attn_")
    tr = out["whisper_traced"]
    print(f"(b) flash launches {out['whisper_launches']} over two waves "
          f"({per_prefill} a prefill); frames/s a prefill "
          + ", ".join(f"{w['frames_s']:.0f}" for w in sv["waves"])
          + f"; peak memory {sv['peak_gib']:.2f} GiB")
    print("(b) traced wave:", json.dumps(tr), flush=True)
    print(f"(b) traced wave: flash {tr['match_ms']:.3f} ms of device time "
          f"over {tr['match_count']} launches = "
          f"{tr['match_ms'] / 1e3 / stats['prefill_s']:.1%} of the traced "
          f"prefill's {stats['prefill_s']:.4f} s", flush=True)
    del model, batch
    torch.cuda.empty_cache()

    lap("b")
    # (c) qwen2-vl-2b served at full width and depth, bf16: phase 7's two
    # waves, the first 256 positions of each prompt its patches
    prompt_len = 2048
    t0 = time.perf_counter()
    model = transformer.init_params(qcfg, seed=0)
    torch.cuda.synchronize()
    out["qwen_params"] = sum(q.numel() for q in model.parameters())
    print(f"(c) qwen2-vl-2b: {qcfg.n_layers} layers, d_model {qcfg.d_model},"
          f" {qcfg.n_heads} heads (kv {qcfg.n_kv_heads}) of {qcfg.head_dim}, "
          f"M-RoPE {qcfg.mrope_sections}, d_ff {qcfg.d_ff}, vocab "
          f"{qcfg.vocab}, {qcfg.n_patches} patches, bf16; "
          f"{out['qwen_params'] / 1e9:.3f} B params drawn in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    data = lm.synthetic_lm_batches(qcfg, b8, prompt_len, seed=0,
                                   device="cpu")
    sv = _serve_waves(torch, attn, qcfg, model, data, b8, prompt_len,
                      max_new, check, "c")
    for w in sv["waves"]:
        check(w["flash_launches"] == qcfg.n_layers,
              f"qwen2-vl wave: {w['flash_launches']} flash launches, not "
              f"{qcfg.n_layers}")
    out["qwen_serve"] = sv
    out["qwen_launches"] = sum(w["flash_launches"] for w in sv["waves"])
    print(f"(c) flash launches {out['qwen_launches']} over two waves "
          f"({qcfg.n_layers} a prefill); peak memory {sv['peak_gib']:.2f} "
          f"GiB", flush=True)
    del model
    torch.cuda.empty_cache()

    lap("c")
    # (d) float32 at full width, 2 layers: prefill(S+1) against prefill(S)
    # + decode, then a training step card == CPU (phase 14 (a)'s bounds)
    w2 = wcfg.with_(n_layers=2, enc_layers=2, dtype="float32")
    q2 = qcfg.with_(n_layers=2, dtype="float32")
    out["whisper_consistency"] = _prefill_vs_decode(torch, w2, 416, check,
                                                    "d")
    out["qwen_consistency"] = _prefill_vs_decode(torch, q2, 512, check, "d")
    lr = 3e-4
    rng = np.random.default_rng(2)
    for name, cfg, seq in (("whisper", w2, 128), ("qwen", q2, 320)):
        toks = torch.as_tensor(lm._markov_tokens(rng, cfg.vocab, (1, seq)),
                               dtype=torch.int64)
        extras = {}
        if cfg.enc_layers:
            extras["frames"] = lm._stub(rng, (1, frames, cfg.d_model), f32,
                                        "cpu")
        if cfg.n_patches:
            extras["patches"] = lm._stub(rng, (1, cfg.n_patches,
                                               cfg.d_model), f32, "cpu")
        out[f"{name}_step"] = _card_vs_cpu_step(torch, attn, cfg, toks,
                                                extras, lr, check, "d")

    lap("d")
    # (e) training at full width, 8 layers (whisper: 8 + 8; cut from full
    # depth to keep the script within its time limit, as the steps were cut
    # from 10 to 3), bf16, remat "unit", 3 steps at lr 3e-4 on one
    # batch (phase 14 (f)'s regime: each batch of
    # synthetic_lm_batches draws its own Markov chain, and whisper's CE over
    # 10 fresh batches stayed within their spread): whisper on 8 x 448
    # tokens with 8 x 1500 frames, qwen2-vl on 8 x 2048 (256 patches) in
    # microbatches of 2
    wtrain = wcfg.with_(n_layers=8, enc_layers=8)
    d = wcfg.d_model
    enc_n = wtrain.enc_layers * (2 * d + 3 * d * wcfg.d_ff + d * dh * (
        2 * h + 2 * wcfg.n_kv_heads))
    for name, cfg, seq, mb in (("whisper-large-v3", wtrain, 448, 0),
                               ("qwen2-vl-2b", qcfg.with_(n_layers=8), 2048,
                                2)):
        tr = _train_run(torch, attn, cfg, b8, seq, 3, mb, lr, 0,
                        trace=True, one_batch=True)
        if cfg.enc_layers:    # the encoder's weights see the frames
            tr["mfu"] = 6 * (enc_n * b8 * frames + (tr["params"] - enc_n)
                             * b8 * seq) / (tr["ms_step"] / 1e3) \
                / _rl().BF16_FLOPS
        out[f"train {name}"] = tr
        print(f"(e) {name} full width, {cfg.n_layers} layers"
              + (f" + {cfg.enc_layers} encoder" if cfg.enc_layers else "")
              + ", bf16, remat unit, "
              f"{b8} x {seq}" + (f" + {b8} x {frames} frames"
                                 if cfg.enc_layers else "")
              + f", micro_batch {mb or b8}, {len(tr['ce'])} steps at lr "
              f"{lr:g} on one batch: {tr['params'] / 1e9:.3f} B params "
              f"(numel); "
              f"{tr['ms_step']:.1f} ms a step (median after the first; first "
              f"{tr['step_s'][0] * 1e3:.1f} ms) = {tr['tok_s']:.0f} "
              f"{'decoder ' if cfg.enc_layers else ''}tokens/s; "
              + ("6·(N_enc·frames + N_dec·tokens)/s" if cfg.enc_layers
                 else "6·N·tokens/s")
              + f" = {tr['mfu']:.1%} of the 989 TFLOP/s bf16 peak; peak "
              f"memory {tr['peak_gib']:.2f} GiB; flash "
              f"launches {tr['launches']}; CE "
              + " ".join(f"{c:.4f}" for c in tr["ce"])
              + f" (ln V = {math.log(cfg.vocab):.4f})", flush=True)
        print(f"(e) {name} traced step:", json.dumps(tr["traced"]),
              flush=True)
        check(tr["launches"] == 0, f"{name} training launched the flash "
                                   f"kernel")
        check(all(math.isfinite(c) for c in tr["ce"]), f"{name} CE "
                                                       f"{tr['ce']}")
        check(abs(tr["ce"][0] - math.log(cfg.vocab)) < 2.0,
              f"{name} CE at step 0 {tr['ce'][0]} is not within 2 of ln V")
        check(tr["ce"][-1] < tr["ce"][0], f"{name} CE did not fall: "
                                          f"{tr['ce']}")
    lap("e")
    return out


def phase_sharded_lm(torch, attn, ref) -> dict:
    """The LM tensor- and expert-parallel on ranks sharing the one card
    (``models/parallel.py::ShardedLM``), the bf16 attention levers' decode
    card against CPU, and the flash kernel at a model-axis rank's prefill
    shape.  Raises on any disagreement; returns the numbers."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import lm
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import parallel, transformer

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 17: {what}")

    out: dict = {}
    f32, bf16 = torch.float32, torch.bfloat16
    pcfg = configs.get("phi3.5-moe-42b-a6.6b")

    # (c) the flash kernel at a rank's prefill shape on four cards: batch
    # 8, phi3.5-moe's 32 q heads / 4 = 8 (its 2 kv heads repeated), 2048
    # tokens, D 128, causal; a float32 twin at B 1 untimed
    h_rank, dh = pcfg.n_heads // 4, pcfg.head_dim
    out["attention"] = phase_attention(torch, attn, ref, cases=[
        ("phi3.5-moe rank prefill bf16", 8, h_rank, 2048, 2048, dh, bf16,
         True, None, True),
        ("phi3.5-moe rank prefill f32 B=1", 1, h_rank, 2048, 2048, dh, f32,
         True, None, False)])

    # (a) float32 phi3.5-moe at full width and 2 layers: the unsharded model
    # on the card, then (data, model) = (1, 1) on one NCCL rank (bit for
    # bit: every collective is over a group of one) and (1, 2) on two gloo
    # ranks sharing the card (within 2e-3, argmax equal)
    # The consistency check runs at a capacity that drops nothing (8.0 =
    # E / top_k, as reduced() sets it): at the config's 1.25 a decode step's
    # 4 tokens and a prefill's 1028 are routed under different capacities
    cfg = pcfg.with_(n_layers=2, dtype="float32")
    nodrop = cfg.with_(moe_capacity=8.0)
    b, s, max_new = 4, 256, 8
    toks = lm._markov_tokens(np.random.default_rng(3), cfg.vocab,
                             (b, s + 1))
    prompts = toks[:, :s]
    model = transformer.init_params(cfg, seed=0)
    want, _ = model.prefill(torch.as_tensor(prompts, device="cuda"))
    want = want.cpu().numpy()
    want_tokens, _ = serve.serve_batch(cfg, model, prompts, max_new,
                                       s + max_new)
    whole = transformer.Transformer(nodrop)
    whole.load_state_dict(model.state_dict())
    del model
    want_next, _ = whole.prefill(torch.as_tensor(toks, device="cuda"))
    want_next = want_next.cpu().numpy()
    del whole
    torch.cuda.empty_cache()
    scale = float(np.abs(want).max())
    for mesh, label in ((make_lm_mesh(data=1, model=1, backend="nccl",
                                      devices="cuda:0"), "(1, 1) nccl"),
                        (make_lm_mesh(data=1, model=2, backend="gloo",
                                      devices="cuda:0"), "(1, 2) gloo")):
        t0 = time.perf_counter()
        with parallel.ShardedLM(cfg, mesh) as slm:
            up_s = time.perf_counter() - t0
            got, per = slm.prefill(prompts)
            tokens, stats = slm.serve(prompts, max_new, s + max_new)
            built = slm.built
            slm.build(nodrop)
            slm.prefill(prompts, cache_len=s + 1)
            got_next = slm.decode(toks[:, s:], s)
        err = float(np.abs(got - want).max())
        step_err = float(np.abs(got_next - want_next).max())
        r = {"up_s": up_s, "err": err, "decode_err": step_err,
             "bit_equal": bool(np.array_equal(got, want)),
             "tokens_equal": bool(np.array_equal(tokens, want_tokens)),
             "launches": [per[q]["flash_launches"] for q in sorted(per)],
             "rounds": [per[q]["rounds"] for q in sorted(per)],
             "staged_bytes": [per[q]["staged_bytes"] for q in sorted(per)],
             "params": [built[q]["params"] for q in sorted(built)],
             "build_s": [built[q]["build_s"] for q in sorted(built)],
             "serve": {k: stats[k] for k in ("prefill_s", "decode_s",
                                             "decode_tok_s",
                                             "flash_launches")}}
        out[label] = r
        print(f"(a) {label}: ranks up in {up_s:.2f} s, built "
              f"{r['params']} params a rank in {r['build_s']} s; prefill "
              f"{b} x {s}: max |logit diff| vs unsharded {err:.3g} (logits "
              f"up to {scale:.3g}), bit-equal {r['bit_equal']}; decode "
              f"step vs unsharded prefill(S+1) (capacity 8.0) "
              f"{step_err:.3g}; {max_new} "
              f"greedy tokens equal {r['tokens_equal']}; flash launches a "
              f"prefill a rank {r['launches']}; collective rounds "
              f"{r['rounds']}, staged bytes {r['staged_bytes']}", flush=True)
        check(r["launches"] == [cfg.n_layers] * mesh.size,
              f"{label}: flash launches a prefill {r['launches']}")
        check(np.array_equal(got.argmax(-1), want.argmax(-1)),
              f"{label}: argmax differs from the unsharded model's")
        check(step_err <= 2e-3, f"{label}: prefill(S) + decode differs by "
                                f"{step_err} from the unsharded "
                                f"prefill(S+1)")
        if mesh.size == 1:
            check(r["bit_equal"] and r["tokens_equal"],
                  f"{label}: not bit-equal to the unsharded model")
        else:
            check(err <= 2e-3, f"{label}: logits differ by {err}")
            check(all(x > 0 for x in r["staged_bytes"]),
                  f"{label}: no bytes staged through host buffers")

    # (b) the bf16 levers at decode, card against CPU: internlm2-1.8b at
    # full width, 2 layers, float32 weights (the levers cast the attention's
    # scores or probabilities); four teacher-forced steps after a prefill
    icfg = configs.get("internlm2-1.8b").with_(n_layers=2, dtype="float32")
    cpu = transformer.init_params(icfg, seed=0, device="cpu")
    card = transformer.Transformer(icfg)
    card.load_state_dict(cpu.state_dict())
    itoks = lm._markov_tokens(np.random.default_rng(5), icfg.vocab, (2, 68))
    out["levers"] = {}
    for lever in ("attn_probs_bf16", "attn_scores_bf16"):
        lcfg = icfg.with_(**{lever: True})
        runs = {}
        for dev in ("cpu", "cuda"):
            m = transformer.Transformer(lcfg, dev)
            m.load_state_dict(cpu.state_dict())
            _, cache = m.prefill(torch.as_tensor(itoks[:, :64], device=dev),
                                 cache_len=68)
            runs[dev] = [m.decode_step(cache, torch.as_tensor(
                itoks[:, 64 + t:65 + t], device=dev), 64 + t)[0].cpu()
                for t in range(4)]
            del m, cache
        _, cache = card.prefill(torch.as_tensor(itoks[:, :64], device="cuda"),
                                cache_len=68)
        plain = [card.decode_step(cache, torch.as_tensor(
            itoks[:, 64 + t:65 + t], device="cuda"), 64 + t)[0].cpu()
            for t in range(4)]
        err = max(float((a - c).abs().max()) for a, c in
                  zip(runs["cuda"], runs["cpu"]))
        moved = max(float((a - c).abs().max()) for a, c in
                    zip(runs["cuda"], plain))
        out["levers"][lever] = {"card_vs_cpu": err, "lever_vs_plain": moved}
        print(f"(b) {lever}: internlm2-1.8b, 2 layers, float32 weights, 4 "
              f"decode steps: card vs CPU max |logit diff| {err:.3g}; the "
              f"lever moves the card's logits by {moved:.3g}", flush=True)
        check(all(torch.allclose(a, c, rtol=2e-2, atol=2e-2)
                  for a, c in zip(runs["cuda"], runs["cpu"])),
              f"{lever}: decode on the card differs from the CPU's by {err}")
        check(moved > 0, f"{lever}: the lever changed nothing at decode")
    del cpu, card, cache
    torch.cuda.empty_cache()
    return out


def _rank_grad_err(cfg, mesh, per, ref, scale, stride,
                   expert_data=False):
    """Every rank's sampled gradient slices (each ``stride``-th element,
    ``ShardedLM.grads``) against the unsharded gradients ``ref`` (host
    tensors): the largest error over its leaf's largest magnitude
    (``scale``), that leaf, and whether every slice is bit-equal."""
    import numpy as np

    from repro_torch.models import parallel
    worst, where, equal = 0.0, None, True
    for r in sorted(per):
        parts = parallel.rank_slices(cfg, mesh, r, expert_data=expert_data)
        for n, got in per[r]["grads"].items():
            w = ref[n][parts[n]].reshape(-1)[::stride].numpy()
            equal &= bool(np.array_equal(got, w))
            err = float(np.abs(got - w).max(initial=0.0)) / max(scale[n],
                                                                 1e-30)
            if err > worst:
                worst, where = err, n
    return worst, where, equal


def phase_sharded_train(torch) -> dict:
    """The LM trained FSDP × tensor-parallel on ranks sharing the one card
    (``models/parallel.py::ShardedLM(..., mode="train")``), and one bf16
    step under each remat policy.  Raises on any disagreement; returns the
    numbers."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import lm
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import parallel, transformer
    from repro_torch.train.step import accumulate_grads

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 18: {what}")

    out: dict = {}
    lap = _Lap("18")
    stride = 97                    # every 97th element of a gradient slice
    pcfg = configs.get("phi3.5-moe-42b-a6.6b")

    # (a) float32 phi3.5-moe at full width and 1 layer: the unsharded step
    # on the card (its gradients moved to the host, the model freed), then
    # (data, model) = (1, 1) on one NCCL rank (bit for bit), (2, 1) and
    # (1, 2) on two gloo ranks sharing the card (loss, CE, aux within rtol
    # 1e-5, every leaf's gradient slice within 1e-3 of the leaf's largest
    # magnitude: phase 14 (a)'s bounds).  No remat here: a gloo rank's
    # FSDP gathers go through host buffers, and remat "unit" would add a
    # third gather of each expert stack (1.68 GB) a step
    cfg = pcfg.with_(n_layers=1, dtype="float32", remat="none")
    toks = lm._markov_tokens(np.random.default_rng(6), cfg.vocab, (4, 128))
    model = transformer.init_params(cfg, seed=0)
    names, grads, metrics = accumulate_grads(
        model, {"tokens": torch.as_tensor(toks, device="cuda")})
    want = {k: float(v) for k, v in metrics.items()}
    ref = {n: g.detach().cpu() for n, g in zip(names, grads)}
    scale = {n: float(g.abs().max()) for n, g in ref.items()}
    del model, grads
    torch.cuda.empty_cache()
    lap("a, unsharded")
    bcfg = pcfg.with_(n_layers=2)
    btoks = lm._markov_tokens(np.random.default_rng(7), bcfg.vocab, (8, 1024))
    for (d, m), backend in (((1, 1), "nccl"), ((2, 1), "gloo"),
                            ((1, 2), "gloo")):
        label = f"({d}, {m}) {backend}"
        mesh = make_lm_mesh(data=d, model=m, backend=backend,
                            devices="cuda:0")
        t0 = time.perf_counter()
        with parallel.ShardedLM(cfg, mesh, mode="train") as slm:
            up_s = time.perf_counter() - t0
            slm.train_init()
            st, per = slm.grads(toks, stride=stride)
            if mesh.size == 1:     # (b): bf16 steps under each policy
                out["remat"] = {}
                for policy in ("unit", "dots", "attn_out"):
                    slm.build(bcfg.with_(remat=policy))
                    slm.train_init(lr=3e-4)
                    slm.train_step(btoks)          # the first: warm-up
                    bst, _ = slm.train_step(btoks)
                    out["remat"][policy] = {
                        "step_s": bst["step_s"], "ce": bst["ce"],
                        "peak_gib": bst["peak_bytes"][0] / 2**30,
                        "flash_launches": bst["flash_launches"][0]}
        worst, where, equal = _rank_grad_err(cfg, mesh, per, ref, scale,
                                              stride)
        loss_err = max(abs(st[k] - want[k]) / max(abs(want[k]), 1e-30)
                       for k in ("loss", "ce", "aux"))
        r = {"up_s": up_s, "step_s": st["step_s"], "loss": st["loss"],
             "loss_rel_err": loss_err, "grad_err": worst, "grad_leaf": where,
             "bit_equal": equal and all(st[k] == want[k]
                                        for k in ("loss", "ce", "aux")),
             "rounds": st["rounds"], "staged_bytes": st["staged_bytes"],
             "gathered_peak_bytes": st["gathered_peak_bytes"],
             "peak_gib": [x / 2**30 for x in st["peak_bytes"]],
             "flash_launches": st["flash_launches"]}
        out[label] = r
        print(f"(a) {label}: ranks up in {up_s:.2f} s; float32 step, 1 "
              f"layer, no remat, 4 x 128: loss {st['loss']:.7f} CE {st['ce']:.7f} aux "
              f"{st['aux']:.7f} vs unsharded {want['loss']:.7f} / "
              f"{want['ce']:.7f} / {want['aux']:.7f} (rtol 1e-5); every "
              f"leaf's gradient slice (each {stride}th element) within "
              f"{worst:.3g} of the leaf's largest magnitude ({where}; bound "
              f"1e-3); bit-equal {r['bit_equal']}; step {st['step_s']:.3f} s "
              f"(the slowest rank); peak GiB a rank "
              f"{[round(x, 2) for x in r['peak_gib']]}; gathered weights at "
              f"most {r['gathered_peak_bytes']} bytes a rank; collective "
              f"rounds {r['rounds']}, staged bytes {r['staged_bytes']}",
              flush=True)
        check(loss_err <= 1e-5, f"{label}: loss, CE or aux off by "
                                f"{loss_err:.3g} (rtol 1e-5)")
        check(worst <= 1e-3, f"{label}: gradient leaf {where} off by "
                             f"{worst:.3g} of its largest magnitude")
        check(r["flash_launches"] == [0] * mesh.size,
              f"{label}: training launched the flash kernel")
        if mesh.size == 1:
            check(r["bit_equal"], f"{label}: not bit-equal to the "
                                  f"unsharded step")
        else:
            check(all(x > 0 for x in r["staged_bytes"]),
                  f"{label}: no bytes staged through host buffers")
        if d > 1:
            check(all(0 < x for x in r["gathered_peak_bytes"]),
                  f"{label}: no FSDP gather")
        lap(f"a, {label}")
    for policy, q in out["remat"].items():
        print(f"(b) (1, 1) nccl: phi3.5-moe full width, 2 layers, bf16, the "
              f"second step on 8 x 1024 under remat {policy!r}: "
              f"{q['step_s']:.3f} s,"
              f" peak {q['peak_gib']:.2f} GiB, CE {q['ce']:.4f}, flash "
              f"launches {q['flash_launches']}", flush=True)
        check(np.isfinite(q["ce"]) and q["flash_launches"] == 0,
              f"remat {policy}: CE {q['ce']}, flash launches "
              f"{q['flash_launches']}")
    return out


def phase_sharded_layouts(torch, attn, ref, st18) -> dict:
    """The layouts of the sharded LM that phases 17–18 do not run, on
    gloo ranks sharing the one card, each against the unsharded model on
    the card: glm4-9b's kv heads replicated over the model ranks that
    share them, served and trained at (1, 4); phi3.5-moe's expert stacks
    split over "data" (``expert_data``), trained at (2, 1) and (2, 2) and
    served at (2, 2), its step beside phase 18's default layout
    (``st18``); whisper-large-v3 and qwen2-vl-2b served and trained with
    their stubs, and zamba2-7b and xlstm-350m (the recurrent cores split
    by heads), on the (1, 4) and (2, 2) worlds, rebuilt in place, and the
    flash kernel at their model-rank shapes.  Raises on any disagreement;
    returns the numbers."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import lm
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import parallel, transformer
    from repro_torch.train.step import accumulate_grads

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 19: {what}")

    out: dict = {}
    lap = _Lap("19")
    stride = 97
    stacks = {"we_gate", "we_up", "we_down"}

    def card(stubs) -> dict:
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in (stubs or {}).items()}

    def reference(cfg, prompts, toks, stubs=None, tstubs=None) -> dict:
        """The unsharded model on the card: the last logits of a prefill of
        each of ``prompts`` (with the modality stubs ``stubs``), and a
        step's loss, CE, aux and gradients on ``toks`` (with ``tstubs``),
        moved to the host; the model freed."""
        model = transformer.init_params(cfg, seed=0)
        ref = {"logits": [model.prefill(torch.as_tensor(
            p, device="cuda"), extras=card(stubs))[0].cpu().numpy()
            for p in prompts]}
        names, grads, metrics = accumulate_grads(
            model, {"tokens": torch.as_tensor(toks, device="cuda"),
                    **card(tstubs)})
        ref["metrics"] = {k: float(v) for k, v in metrics.items()}
        ref["grads"] = {n: g.detach().cpu() for n, g in zip(names, grads)}
        ref["scale"] = {n: float(g.abs().max())
                        for n, g in ref["grads"].items()}
        del model, grads
        torch.cuda.empty_cache()
        return ref

    def step_checks(label, cfg, mesh, st, per, ref, expert_data=False):
        worst, where, _ = _rank_grad_err(cfg, mesh, per, ref["grads"],
                                         ref["scale"], stride, expert_data)
        want = ref["metrics"]
        loss_err = max(abs(st[k] - want[k]) / max(abs(want[k]), 1e-30)
                       for k in ("loss", "ce", "aux"))
        print(f"{label}: float32 step: loss {st['loss']:.7f} CE "
              f"{st['ce']:.7f} aux {st['aux']:.7f} vs unsharded "
              f"{want['loss']:.7f} / {want['ce']:.7f} / {want['aux']:.7f} "
              f"(rtol 1e-5); every leaf's gradient slice (each {stride}th "
              f"element) within {worst:.3g} of the leaf's largest "
              f"({where}; bound 1e-3); step {st['step_s']:.3f} s (the "
              f"slowest rank); peak GiB a rank "
              f"{[round(x / 2**30, 2) for x in st['peak_bytes']]}; "
              f"gathered {st['gathered_leaves']} at most "
              f"{st['gathered_peak_bytes']} bytes a rank; rounds "
              f"{st['rounds']}, staged bytes {st['staged_bytes']}",
              flush=True)
        check(loss_err <= 1e-5, f"{label}: loss, CE or aux off by "
                                f"{loss_err:.3g} (rtol 1e-5)")
        check(worst <= 1e-3, f"{label}: gradient leaf {where} off by "
                             f"{worst:.3g} of its largest magnitude")
        check(st["flash_launches"] == [0] * mesh.size,
              f"{label}: training launched the flash kernel")
        return {"step_s": st["step_s"], "loss": st["loss"],
                "loss_rel_err": loss_err, "grad_err": worst,
                "grad_leaf": where, "rounds": st["rounds"],
                "staged_bytes": st["staged_bytes"],
                "gathered_leaves": st["gathered_leaves"],
                "peak_gib": [x / 2**30 for x in st["peak_bytes"]]}

    def serve_checks(label, got, per, want, mesh, attentions=1):
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        launches = [per[q]["flash_launches"] for q in sorted(per)]
        print(f"{label}: prefill: max |logit diff| vs unsharded {err:.3g} "
              f"(logits up to {scale:.3g}); flash launches a prefill a "
              f"rank {launches}", flush=True)
        check(err <= 2e-3 * scale, f"{label}: logits differ by {err}")
        check(np.array_equal(got.argmax(-1), want.argmax(-1)),
              f"{label}: argmax differs from the unsharded model's")
        check(launches == [attentions] * mesh.size,
              f"{label}: flash launches a prefill {launches}")
        return {"err": err, "launches": launches}

    # (c) the flash kernel at a model rank's shapes at model = 4:
    # whisper-large-v3's 20 heads / 4 = 5 (encoder 1500 x 1500
    # bidirectional with a ragged last key tile, cross 416 on 1500,
    # decoder 416 causal, D 64), qwen2-vl-2b's 12 q heads / 4 = 3 on its
    # one kv head, repeated (2048 causal, D 128); bf16 timed, float32
    # twins untimed
    f32, bf16 = torch.float32, torch.bfloat16
    wcfg, qcfg = configs.get("whisper-large-v3"), configs.get("qwen2-vl-2b")
    zcfg, xcfg = configs.get("zamba2-7b"), configs.get("xlstm-350m")
    wh, qh, zh = wcfg.n_heads // 4, qcfg.n_heads // 4, zcfg.n_heads // 4
    zd = zcfg.head_dim
    nf, wd, qd = wcfg.enc_frames, wcfg.head_dim, qcfg.head_dim
    out["attention"] = phase_attention(torch, attn, ref, cases=[
        ("whisper rank encoder bf16", 8, wh, nf, nf, wd, bf16, False, None,
         True),
        ("whisper rank cross bf16", 8, wh, 416, nf, wd, bf16, False, None,
         True),
        ("whisper rank decoder bf16", 8, wh, 416, 416, wd, bf16, True, None,
         True),
        ("whisper rank encoder f32", 8, wh, nf, nf, wd, f32, False, None,
         False),
        ("whisper rank cross f32", 8, wh, 416, nf, wd, f32, False, None,
         False),
        ("whisper rank decoder f32", 8, wh, 416, 416, wd, f32, True, None,
         False),
        ("qwen2-vl rank prefill bf16", 8, qh, 2048, 2048, qd, bf16, True,
         None, True),
        ("qwen2-vl rank prefill f32 B=1", 1, qh, 2048, 2048, qd, f32, True,
         None, False),
        # (d) zamba2-7b's shared attention at model = 4: 8 of 32 heads
        ("zamba2 rank prefill bf16", 8, zh, 2048, 2048, zd, bf16, True, None,
         True),
        ("zamba2 rank prefill f32 B=1", 1, zh, 2048, 2048, zd, f32, True,
         None, False)])
    lap("c, d, flash at the rank shapes")

    # (c) whisper-large-v3 with 1 encoder and 1 decoder layer over its
    # 1500 frames, and qwen2-vl-2b with 1 layer and its 256 patches, in
    # float32: the unsharded model's prefill, prefill(S + 1) and step on
    # the card, then each on the (1, 4) world of (a) and the (2, 2) world
    # of (b), rebuilt in place; the stubs drawn from a seed (host arrays)
    stubbed = {}
    for name, cfg, b, s, ts in (
            ("whisper-large-v3", wcfg.with_(n_layers=1, enc_layers=1), 4,
             128, 64),
            ("qwen2-vl-2b", qcfg.with_(n_layers=1), 4, 320, 288)):
        cfg = cfg.with_(dtype="float32", remat="none")
        rng = np.random.default_rng(12)
        ptoks = lm._markov_tokens(rng, cfg.vocab, (b, s + 1))
        stubs = {k: v.numpy() for k, v in lm.stubs(cfg, rng, b).items()}
        toks = lm._markov_tokens(rng, cfg.vocab, (2, ts))
        tstubs = {k: v.numpy() for k, v in lm.stubs(cfg, rng, 2).items()}
        stubbed[name] = ("(c)", cfg, ptoks, stubs, toks, tstubs, reference(
            cfg, (ptoks[:, :s], ptoks), toks, stubs, tstubs))
    lap("c, unsharded")

    # (d) zamba2-7b with one pattern unit (5 Mamba2 layers, one use of the
    # shared block) and xlstm-350m with its mLSTM and sLSTM layer, float32,
    # full width: each rank holds its heads (28 of 112 Mamba2 heads at
    # model = 4, xlstm's one of 4), Mamba2's B / C and mLSTM's xi columns
    # whole; the unsharded model's prefill, prefill(S + 1) and step first
    for name, cfg, b, s, ts in (
            ("zamba2-7b", zcfg.with_(n_layers=len(zcfg.pattern)), 4, 128, 64),
            ("xlstm-350m", xcfg.with_(n_layers=2), 4, 128, 64)):
        cfg = cfg.with_(dtype="float32", remat="none")
        rng = np.random.default_rng(14)
        ptoks = lm._markov_tokens(rng, cfg.vocab, (b, s + 1))
        toks = lm._markov_tokens(rng, cfg.vocab, (2, ts))
        stubbed[name] = ("(d)", cfg, ptoks, None, toks, None, reference(
            cfg, (ptoks[:, :s], ptoks), toks))
    lap("d, unsharded")

    def flash_per_prefill(cfg) -> int:
        """Flash launches a prefill a rank: one a self-attention (a shared
        block's use too), a cross-attention and an encoder layer."""
        attn = sum(k in ("attn", "attn_shared")
                   for k in transformer.layer_kinds(cfg))
        return attn * (2 if cfg.cross_attention else 1) + cfg.enc_layers

    def stubbed_runs(slm, mesh, where) -> None:
        """(c) and (d) on a running world: each config built in place,
        served (prefill, prefill(S) + decode) and a step's gradients."""
        for name, (part, cfg, ptoks, stubs, toks, tstubs,
                   want) in stubbed.items():
            label = f"{part} {name} {where} gloo"
            s = ptoks.shape[1] - 1
            slm.build(cfg, mode="serve", expert_data=False)
            got, per = slm.prefill(ptoks[:, :s], extras=stubs)
            slm.prefill(ptoks[:, :s], cache_len=s + 1, extras=stubs)
            got_next = slm.decode(ptoks[:, s:], s)
            slm.build(cfg, mode="train", expert_data=False)
            slm.train_init()
            st, gper = slm.grads(toks, stride=stride, extras=tstubs)
            r = out[f"{name} {where}"] = serve_checks(
                label, got, per, want["logits"][0], mesh,
                attentions=flash_per_prefill(cfg))
            if part == "(d)" and mesh.axis_size("data") == 1:
                rounds = [per[q]["rounds"] for q in sorted(per)]
                expect = 2 * cfg.n_layers + 2
                print(f"{label}: collective rounds a prefill a rank {rounds} "
                      f"(2 a layer — out_norm's statistic and out_proj's "
                      f"sum, or wo's and wd's — the lookup and the "
                      f"logits' gather: {expect})", flush=True)
                check(rounds == [expect] * mesh.size,
                      f"{label}: rounds a prefill {rounds}, expected "
                      f"{expect}")
                r["rounds"] = rounds
            step_err = float(np.abs(got_next - want["logits"][1]).max())
            print(f"{label}: decode step vs unsharded prefill(S+1) "
                  f"{step_err:.3g}", flush=True)
            check(step_err <= 2e-3, f"{label}: prefill(S) + decode differs "
                                    f"by {step_err} from the unsharded "
                                    f"prefill(S+1)")
            r.update(decode_err=step_err,
                     train=step_checks(label, cfg, mesh, st, gper, want))
            lap(f"{part[1]}, {name} {where}")

    # (a) glm4-9b, 1 layer: 32 q heads on 2 kv heads at model = 4, rank j
    # holding q heads [8j, 8j + 8) and kv head j // 2
    gcfg = configs.get("glm4-9b").with_(n_layers=1, dtype="float32",
                                        remat="none")
    s = 128
    ptoks = lm._markov_tokens(np.random.default_rng(8), gcfg.vocab, (4, s + 1))
    toks = lm._markov_tokens(np.random.default_rng(9), gcfg.vocab, (4, 64))
    base = reference(gcfg, (ptoks[:, :s], ptoks), toks)
    lap("a, unsharded")
    mesh = make_lm_mesh(data=1, model=4, backend="gloo", devices="cuda:0")
    label = "(a) glm4-9b (1, 4) gloo"
    t0 = time.perf_counter()
    with parallel.ShardedLM(gcfg, mesh) as slm:
        up_s = time.perf_counter() - t0
        got, per = slm.prefill(ptoks[:, :s])
        slm.prefill(ptoks[:, :s], cache_len=s + 1)
        got_next = slm.decode(ptoks[:, s:], s)
        slm.build(gcfg, mode="train")
        slm.train_init()
        st, gper = slm.grads(toks, stride=stride)
        stubbed_runs(slm, mesh, "(1, 4)")
    r = out["glm4-9b (1, 4)"] = serve_checks(label, got, per,
                                             base["logits"][0], mesh)
    step_err = float(np.abs(got_next - base["logits"][1]).max())
    print(f"{label}: ranks up in {up_s:.2f} s; decode step vs unsharded "
          f"prefill(S+1) {step_err:.3g}", flush=True)
    check(step_err <= 2e-3, f"{label}: prefill(S) + decode differs by "
                            f"{step_err} from the unsharded prefill(S+1)")
    r.update(up_s=up_s, decode_err=step_err,
             train=step_checks(label, gcfg, mesh, st, gper, base))
    shared = [f"blocks.0.attn.{w}" for w in ("wk", "wv")]
    same = all(np.array_equal(gper[a]["grads"][n], gper[b]["grads"][n])
               for a, b in ((0, 1), (2, 3)) for n in shared)
    print(f"{label}: the shared kv heads' gradients (wk, wv) bit-equal on "
          f"ranks 0 = 1 and 2 = 3: {same}", flush=True)
    check(same, f"{label}: a shared kv head's gradient differs between "
                f"its ranks")
    lap("a, (1, 4)")

    # (b) phi3.5-moe, 1 layer, experts split over "data": phase 18's step
    pcfg = configs.get("phi3.5-moe-42b-a6.6b").with_(
        n_layers=1, dtype="float32", remat="none")
    toks = lm._markov_tokens(np.random.default_rng(6), pcfg.vocab, (4, 128))
    base = reference(pcfg, (toks,), toks)
    lap("b, unsharded")
    default = st18["(2, 1) gloo"]
    for d, m in ((2, 1), (2, 2)):
        mesh = make_lm_mesh(data=d, model=m, backend="gloo", devices="cuda:0")
        label = f"(b) phi3.5-moe expert_data ({d}, {m}) gloo"
        t0 = time.perf_counter()
        with parallel.ShardedLM(pcfg, mesh, mode="train",
                                expert_data=True) as slm:
            up_s = time.perf_counter() - t0
            slm.train_init()
            st, gper = slm.grads(toks, stride=stride)
            if m > 1:
                slm.build(pcfg, mode="serve")
                got, per = slm.prefill(toks)
                stubbed_runs(slm, mesh, f"({d}, {m})")
        r = out[f"phi3.5-moe expert_data ({d}, {m})"] = step_checks(
            label, pcfg, mesh, st, gper, base, expert_data=True)
        r["up_s"] = up_s
        if m > 1:
            r["serve"] = serve_checks(label, got, per, base["logits"][0],
                                      mesh)
        gathered = {n for names in st["gathered_leaves"] for n in names}
        print(f"{label}: ranks up in {up_s:.2f} s; step {st['step_s']:.3f} s "
              f"beside phase 18's default layout at (2, 1) "
              f"{default['step_s']:.3f} s (loss {default['loss']:.7f}); no "
              f"expert stack gathered: {not gathered & stacks}", flush=True)
        check(not gathered & stacks,
              f"{label}: expert stacks gathered over 'data': {gathered}")
        check(abs(st["loss"] - default["loss"]) <= 1e-5 * abs(default["loss"]),
              f"{label}: loss {st['loss']} vs the default layout's "
              f"{default['loss']}")
        lap(f"b, ({d}, {m})")
    return out


def phase_dry_run(torch, attn) -> dict:
    """(a) The dry run (``launch/cases.py``: one rank's step on fake tensors,
    counted) of the runs phases 7 and 14 (c) made — internlm2-1.8b served
    in bf16, 8 x 2048 + 32, and trained in bf16, 8 x 2048 at micro_batch 2,
    at (1, 1) — held against what they measured: the predicted peak within
    15 % of ``max_memory_allocated``, the roofline's least time no greater
    than the measured time, 24 flash launches counted a prefill.  (b) The
    head split that the model axis does not divide, on 8 gloo ranks
    sharing the card at (1, 8): whisper-large-v3 (1 + 1 layers, its 1500
    frames; 20 q heads in runs of 2 and 3), qwen2-vl-2b (1 layer, 256
    patches; 12 q heads in runs of 1 and 2 on 2 kv heads, a run that
    straddles both holding both) and xlstm-350m (an mLSTM and an sLSTM
    layer; 4 SSM heads, half the ranks holding none), float32, full width,
    served and trained against the unsharded model on the card at phase 19
    (a)'s bounds, each rank's flash launches counted.  Raises on any
    disagreement; returns the numbers."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import lm
    from repro_torch.launch import cases
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import parallel, transformer
    from repro_torch.train.step import accumulate_grads

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 20: {what}")

    out: dict = {}
    lap = _Lap("20")
    # (a) the prediction, on the host
    cfg = configs.get("internlm2-1.8b")
    one = make_lm_mesh(data=1, model=1, devices="cuda:0")
    t0 = time.perf_counter()
    runs = {
        "prefill": cases.Case(cfg.name, cases.InputShape(
            "wave", "prefill", 2048, 8), cfg, one, "serve", cache_len=2080),
        "wave": cases.Case(cfg.name, cases.InputShape(
            "wave", "prefill", 2048, 8), cfg, one, "serve", cache_len=2080,
            decode_steps=32),
        "decode": cases.Case(cfg.name, cases.InputShape(
            "decode", "decode", 2080, 8), cfg, one, "serve"),
        "train": cases.Case(cfg.name, cases.InputShape(
            "train", "train", 2048, 8), cfg, one, "train", micro_batch=2)}
    got = {k: c.run(0) for k, c in runs.items()}
    count_s = time.perf_counter() - t0
    m7, m14 = MEASURED["serve"], MEASURED["train"]
    rows = {"prefill": (got["prefill"], m7["prefill_s"], None),
            "decode step": (got["decode"], m7["decode_step_s"], None),
            "serve wave": (got["wave"], None, m7["peak_bytes"]),
            "train step": (got["train"], m14["step_s"], m14["peak_bytes"])}
    for what, (run, secs, peak) in rows.items():
        ro = run.roofline
        row = {"least_s": ro.least_s, "bound": ro.bottleneck,
               "t_compute_s": ro.t_compute, "t_memory_s": ro.t_memory,
               "predicted_peak_gib": ro.per_device_memory / 2**30}
        text = (f"(a) {what}: least {ro.least_s * 1e3:.3f} ms "
                f"({ro.bottleneck}; compute {ro.t_compute * 1e3:.3f}, "
                f"memory {ro.t_memory * 1e3:.3f} ms)")
        if secs is not None:
            row.update(measured_s=secs, share=ro.least_s / secs)
            text += (f", measured {secs * 1e3:.3f} ms: the whole step "
                     f"reaches {ro.least_s / secs:.1%} of its "
                     f"{ro.bottleneck} bound")
            check(ro.least_s <= secs, f"{what}: least time {ro.least_s} s "
                                      f"over the measured {secs} s")
        if peak is not None:
            gap = ro.per_device_memory / peak - 1
            row.update(measured_peak_gib=peak / 2**30, peak_gap=gap)
            text += (f"; peak predicted {ro.per_device_memory / 2**30:.3f} "
                     f"GiB, measured {peak / 2**30:.3f} GiB: {gap:+.1%}")
            check(abs(gap) <= 0.15, f"{what}: predicted peak off by "
                                    f"{gap:.1%} (bound 15 %)")
        print(text, flush=True)
        out[what] = row
    calls = got["prefill"].count("kernel:").get(
        "repro_torch::flash_attention", 0)
    print(f"(a) flash launches counted a prefill: {calls:g} (phase 7 "
          f"launched {m7['launches']}); counted on the host in "
          f"{count_s:.1f} s", flush=True)
    check(calls == cfg.n_layers == m7["launches"],
          f"flash launches counted {calls}, launched {m7['launches']}")
    out["count_s"] = count_s
    lap("a")

    # (b) uneven head runs at (1, 8)
    stride = 97
    wcfg = configs.get("whisper-large-v3").with_(n_layers=1, enc_layers=1)
    qcfg = configs.get("qwen2-vl-2b").with_(n_layers=1)
    xcfg = configs.get("xlstm-350m").with_(n_layers=2)
    todo = []
    for name, c, b, s, ts in (("whisper-large-v3", wcfg, 4, 128, 64),
                              ("qwen2-vl-2b", qcfg, 4, 320, 288),
                              ("xlstm-350m", xcfg, 4, 128, 64)):
        c = c.with_(dtype="float32", remat="none")
        rng = np.random.default_rng(20)
        ptoks = lm._markov_tokens(rng, c.vocab, (b, s + 1))
        stubs = {k: v.numpy() for k, v in lm.stubs(c, rng, b).items()}
        toks = lm._markov_tokens(rng, c.vocab, (2, ts))
        tstubs = {k: v.numpy() for k, v in lm.stubs(c, rng, 2).items()}
        model = transformer.init_params(c, seed=0)
        dev = {k: torch.as_tensor(v, device="cuda") for k, v in stubs.items()}
        want = [model.prefill(torch.as_tensor(p, device="cuda"),
                              extras=dev)[0].cpu().numpy()
                for p in (ptoks[:, :s], ptoks)]
        names, grads, metrics = accumulate_grads(
            model, {"tokens": torch.as_tensor(toks, device="cuda"),
                    **{k: torch.as_tensor(v, device="cuda")
                       for k, v in tstubs.items()}})
        ref_grads = {n: g.detach().cpu() for n, g in zip(names, grads)}
        todo.append((name, c, ptoks, stubs, toks, tstubs, want, {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": ref_grads,
            "scale": {n: float(g.abs().max()) for n, g in ref_grads.items()}
        }))
        del model, grads
        torch.cuda.empty_cache()
    lap("b, unsharded")
    mesh = make_lm_mesh(data=1, model=8, backend="gloo", devices="cuda:0")
    t0 = time.perf_counter()
    with parallel.ShardedLM(todo[0][1], mesh) as slm:
        up_s = time.perf_counter() - t0
        for name, c, ptoks, stubs, toks, tstubs, want, ref in todo:
            label = f"(b) {name} (1, 8) gloo"
            s = ptoks.shape[1] - 1
            slm.build(c, mode="serve")
            logits, per = slm.prefill(ptoks[:, :s], extras=stubs)
            slm.prefill(ptoks[:, :s], cache_len=s + 1, extras=stubs)
            nxt = slm.decode(ptoks[:, s:], s)
            slm.build(c, mode="train")
            slm.train_init()
            st, gper = slm.grads(toks, stride=stride, extras=tstubs)
            err = float(np.abs(logits - want[0]).max())
            scale = float(np.abs(want[0]).max())
            step_err = float(np.abs(nxt - want[1]).max())
            launches = [per[q]["flash_launches"] for q in sorted(per)]
            heads = [parallel.head_run(c.n_ssm_heads if c.pattern[0] != "attn"
                                       else c.n_heads, j, 8) for j in
                     range(8)]
            expect = (c.n_layers * (2 if c.cross_attention else 1)
                      + c.enc_layers if c.has_attention else 0)
            worst, where, _ = _rank_grad_err(c, mesh, gper, ref["grads"],
                                             ref["scale"], stride, False)
            loss_err = max(abs(st[k] - ref["metrics"][k])
                           / max(abs(ref["metrics"][k]), 1e-30)
                           for k in ("loss", "ce", "aux"))
            print(f"{label}: heads a rank {[hi - lo for lo, hi in heads]}; "
                  f"prefill max |logit diff| vs unsharded {err:.3g} (logits "
                  f"up to {scale:.3g}); decode step {step_err:.3g}; flash "
                  f"launches a prefill a rank {launches}; loss "
                  f"{st['loss']:.7f} vs {ref['metrics']['loss']:.7f} (rel "
                  f"{loss_err:.3g}); every gradient slice (each {stride}th "
                  f"element) within {worst:.3g} of its leaf's largest "
                  f"({where}); step {st['step_s']:.3f} s", flush=True)
            check(err <= 2e-3 * scale, f"{label}: logits differ by {err}")
            check(np.array_equal(logits.argmax(-1), want[0].argmax(-1)),
                  f"{label}: argmax differs from the unsharded model's")
            check(step_err <= 2e-3, f"{label}: decode step off by "
                                    f"{step_err}")
            check(launches == [expect] * 8,
                  f"{label}: flash launches {launches}, expected {expect}")
            check(loss_err <= 1e-5, f"{label}: loss off by {loss_err:.3g}")
            check(worst <= 1e-3, f"{label}: gradient {where} off by "
                                 f"{worst:.3g}")
            out[f"{name} (1, 8)"] = {
                "err": err, "decode_err": step_err, "launches": launches,
                "loss_rel_err": loss_err, "grad_err": worst,
                "step_s": st["step_s"]}
            lap(f"b, {name}")
    out["up_s"] = up_s
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import atexit
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import convert
    from repro_torch.core import ForestParams
    from repro_torch.data import (accuracy, make_classification,
                                  make_regression, rmse, train_test_split)
    from repro_torch.federation import Federation
    from repro_torch.kernels import attention as attn
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import build_all

    # full float32 in every float32 product: TF32 would break the 2e-3
    # float32 tolerances of phases 6 and 7
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    t0 = _phase("1 build")
    build_all([hist.LIBRARY, attn.LIBRARY])
    print(f"kernel builds, in parallel: phase {time.perf_counter() - t0:.2f} s")
    for lib in (hist.LIBRARY, attn.LIBRARY):
        print(f"  {lib.source.name}: {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    card = _card()
    print(f"card: {card}", flush=True)

    t0 = _phase("2 kernel vs plain")
    rows = phase_kernel(torch, hist, ref, ops)
    signed = phase_kernel_signed(torch, hist, ref, ops)
    rows.append(signed)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("3 main path: target marketing 156198 x 95, two parties")
    x, y = make_classification(156198, 95, 2, n_informative=24, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    params = ForestParams(task="classification", n_estimators=20, max_depth=8,
                          n_bins=32, seed=42)
    hist.histogram_cuda.launches = 0
    fed, model, pred, fit_s, pred_s = _fit_predict(
        Federation, 2, xtr, ytr, xte, params, torch)
    launches = hist.histogram_cuda.launches
    acc = accuracy(yte, pred)
    print(f"train {len(ytr)} rows, test {len(yte)} rows; fit {fit_s:.3f} s, "
          f"predict {pred_s:.3f} s = {len(yte) / pred_s:.0f} rows/s, "
          f"accuracy {acc:.4f}, histogram launches {launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the main path launched the histogram kernel "
                             "no time")
    if pred.shape != yte.shape or not 0.7 < acc <= 1.0:
        raise AssertionError(f"predictions look wrong: shape {pred.shape}, "
                             f"accuracy {acc}")
    if not np.array_equal(model.predict(xte), pred):
        raise AssertionError("dense prediction != leaf-compacted prediction")
    _, _, pred1, fit1_s, _ = _fit_predict(
        Federation, 1, xtr, ytr, xte, params, torch)
    if not np.array_equal(pred1, pred):
        raise AssertionError("losslessness violated: FF(1) != FF(2)")
    print(f"centralized (parties=1) fit {fit1_s:.3f} s; "
          f"centralized forest == federated forest: True")
    fed3, forest3, xte3 = fed, model, xte
    traced, prof = _profile(torch, lambda: fed.fit(params))
    print("traced fit:", json.dumps(prof))
    _, predict_prof3 = _profile(torch, lambda: fed.predict(traced, xte))
    print("traced predict:", json.dumps(predict_prof3), flush=True)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("4 regression frontier: superconduct 21263 x 81, depth 10")
    x, y = make_regression(21263, 81, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    rparams = ForestParams(task="regression", n_estimators=10, max_depth=10,
                           n_bins=64, seed=0)
    hist.histogram_cuda.launches = 0
    _, rmodel2, rpred2, rfit2_s, _ = _fit_predict(
        Federation, 2, xtr, ytr, xte, rparams, torch)
    rlaunches = hist.histogram_cuda.launches
    _, rmodel1, rpred1, _, _ = _fit_predict(
        Federation, 1, xtr, ytr, xte, rparams, torch)
    t2 = convert.party_trees_to_numpy(rmodel2.trees_)
    t1 = convert.party_trees_to_numpy(rmodel1.trees_)
    for f in ("is_leaf", "leaf_stats", "split_gid"):
        if not np.array_equal(t2[f][0], t1[f][0]):
            raise AssertionError(f"regression FF(2) != FF(1) on {f}")
    if not np.array_equal(rpred2, rpred1) or not np.isfinite(rpred2).all():
        raise AssertionError("regression predictions: FF(2) != FF(1)")
    err = rmse(yte, rpred2)
    if not err < np.std(yte):
        raise AssertionError(f"regression rmse {err} is no better than the "
                             f"test targets' spread {np.std(yte)}")
    print(f"train {len(ytr)} rows; fit {rfit2_s:.3f} s, histogram launches "
          f"{rlaunches}, rmse {err:.4f} (targets' std {np.std(yte):.4f}); "
          f"FF(2) == FF(1) bit for bit: True", flush=True)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("5 card vs cpu: quickstart 8000 x 95")
    x, y = make_classification(8000, 95, 2, n_informative=24, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    _, gmodel, gpred, _, _ = _fit_predict(
        Federation, 2, xtr, ytr, xte, params, torch)
    _, cmodel, cpred, cfit_s, _ = _fit_predict(
        Federation, 2, xtr, ytr, xte, params, torch,
        device="cpu")
    g, c = (convert.party_trees_to_numpy(gmodel.trees_),
            convert.party_trees_to_numpy(cmodel.trees_))
    bad = [f for f in g if not np.array_equal(g[f], c[f])]
    if bad or not np.array_equal(gpred, cpred):
        raise AssertionError(f"card fit != cpu fit on {bad or 'predictions'}")
    print(f"cpu fit {cfit_s:.3f} s; PartyTree fitted on cuda == cpu, all "
          f"seven fields, and predictions equal: True")
    # regression: float sums associate differently on the card, so this
    # fixture is one whose trees meet no near-tie (tests/test_torch_tree.py)
    x, y = make_regression(1200, 13, seed=2)
    for cap in (0, 3):
        rp = ForestParams(task="regression", n_estimators=3, max_depth=5,
                          n_bins=16, seed=7, frontier_cap=cap)
        _, gmodel, gpred, _, _ = _fit_predict(
            Federation, 2, x, y, x[:300], rp, torch)
        _, cmodel, cpred, _, _ = _fit_predict(
            Federation, 2, x, y, x[:300], rp, torch, device="cpu")
        g, c = (convert.party_trees_to_numpy(gmodel.trees_),
                convert.party_trees_to_numpy(cmodel.trees_))
        bad = [f for f in SPLIT_FIELDS if not np.array_equal(g[f], c[f])]
        if bad:
            raise AssertionError(f"regression frontier_cap={cap}: card "
                                 f"splits != cpu splits on {bad}")
        if not (np.allclose(g["leaf_stats"], c["leaf_stats"], rtol=1e-5,
                            atol=0)
                and np.allclose(gpred, cpred, rtol=1e-5, atol=1e-6)):
            raise AssertionError(f"regression frontier_cap={cap}: leaf "
                                 f"stats or predictions beyond rtol 1e-5")
        lerr = float(np.max(np.abs(g["leaf_stats"] - c["leaf_stats"])))
        print(f"regression 1200 x 13, frontier_cap={cap}: card splits == "
              f"cpu splits: True; leaf stats max abs diff {lerr:.3g}")
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("6 attention kernel vs plain")
    print("constant from PERF.md, not measured here: PR 12's largest bf16 "
          "max_abs_err in this phase 0.0078125")
    arows = phase_attention(torch, attn, ref)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("7 serve: internlm2-1.8b, full width and depth, bf16")
    attn_launches = phase_serve(torch, attn)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("8 party-first, streamed and resumable: target marketing "
                "156198 x 95, two parties")
    x, y = make_classification(156198, 95, 2, n_informative=24, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    hist.histogram_cuda.launches = 0
    # phase 8's CSV extracts and phase 11's span file, kept for phase 13
    work = tempfile.mkdtemp(prefix="ff_smoke_")
    atexit.register(shutil.rmtree, work, True)
    pf = phase_party_first(torch, hist, xtr, ytr, xte, params, csv_dir=work)
    print(f"card: {card}")
    print(f"party extracts {pf['rows']} rows, {pf['common_rows']} common; "
          f"host s (every ingest hashes its IDs cold): in-memory ingest "
          f"{pf['ingest_memory_s']:.3f}, CSV write {pf['csv_write_s']:.3f} "
          f"({pf['csv_bytes']} bytes), streamed scan + bin "
          f"{pf['ingest_stream_s']:.3f}, version 1 ingest "
          f"{pf['ingest_v1_s']:.3f} ({pf['v1_rows']} rows), append "
          f"{pf['append_s']:.3f}")
    print(f"fit_resumable {pf['fit_resumable_s']:.3f} s (4 chunks of 5 "
          f"trees) vs fit {pf['fit_s']:.3f} s; in turn, fit / fit_resumable "
          f"s: " + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in zip(
              pf["alt_fit_s"], pf["alt_resumable_s"]))
          + f"; forest checkpoint "
          f"{pf['chunk_ckpt_bytes']} bytes; save {pf['save_ms']:.2f} ms "
          f"({pf['save_bytes']} bytes, {pf['save_files']}), restore "
          f"{pf['restore_ms']:.2f} ms")
    print(f"histogram launches: fit 20 trees {pf['launches_fit20']}, 10 "
          f"trees {pf['launches_fit10']}, 10 -> 20 rerun "
          f"{pf['launches_extend']}, rerun after the crash "
          f"{pf['launches_crash']} (15 trees {pf['launches_fit15']}), "
          f"restart after the append {pf['launches_restart']}; phase "
          f"{pf['launches']}")
    print("party-first == pre-aligned, CSV-streamed == in-memory, append == "
          "whole stream, resumed == extended == restarted == from scratch, "
          "load == fit: True")
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("9 boosting, F-LR and classical prediction: target marketing "
                "156198 x 95 and superconduct 21263 x 81, two parties")
    bo = phase_boosting(torch, hist, forest3, xte3)
    rounds = 50
    print(f"card: {card}")
    print(f"binary boosting, 117148 rows, 50 rounds, depth 6: fit "
          f"{bo['fit_s']:.3f} s = {bo['fit_s'] / rounds * 1e3:.2f} ms a round "
          f"(centralized fit {bo['fit1_s']:.3f} s); histogram launches "
          f"{bo['launches']} = {bo['launches'] / rounds:.1f} a round; predict "
          f"{len(yte)} rows in {bo['predict_s']:.3f} s = "
          f"{len(yte) / bo['predict_s']:.0f} rows/s; accuracy "
          f"{bo['accuracy']:.4f}; FB(2) == FB(1) bit for bit: True; "
          f"save {bo['save_ms']:.2f} ms ({bo['save_bytes']} bytes), load == "
          f"fit: True", flush=True)
    print("traced boosting fit:", json.dumps(bo["traced"]))
    print(f"traced boosting fit: histogram {bo['traced']['match_ms']:.3f} ms "
          f"of device time over {bo['traced']['match_count']} launches = "
          f"{bo['traced']['match_ms'] / 1e3 / bo['traced']['device_busy_s']:.1%}"
          f" of the device's busy time; idle "
          f"{bo['traced']['device_idle_share']:.1%}")
    print("training log-loss by round: "
          + " ".join(f"{v:.5f}" for v in bo["log_loss"]))
    print(f"regression boosting, 15947 rows, 50 rounds, depth 6: fit "
          f"{bo['reg_fit_s']:.3f} s = {bo['reg_fit_s'] / rounds * 1e3:.2f} ms "
          f"a round; histogram launches {bo['reg_launches']}; rmse "
          f"{bo['rmse']:.4f} (targets' std {bo['reg_std']:.4f}); FB(2) == "
          f"FB(1) bit for bit: True")
    print("training mse by round: " + " ".join(f"{v:.4f}" for v in bo["mse"]))
    print(f"card vs cpu, each round from the card's margin (8 rounds, 450 "
          f"rows): same splits; largest leaf-stat err/bound regression "
          f"{bo['cpu_reg'][0]:.3g}, binary {bo['cpu_bin'][0]:.3g}; largest "
          f"decision-function diff {bo['cpu_reg'][1]:.3g} / "
          f"{bo['cpu_bin'][1]:.3g}")
    print(f"F-LR, 400 steps: fit {bo['flr_fit_s']:.3f} s on the card, "
          f"{bo['flr_cpu_fit_s']:.3f} s on the cpu; accuracy "
          f"{bo['flr_accuracy']:.4f}; card weights - cpu weights: max "
          f"{bo['flr_w_diff']:.3g} (weights up to {bo['flr_w_max']:.3g})")
    print(f"phase 3's forest over {bo['rows']} rows: one-round "
          f"{bo['oneround_s']:.3f} s = {bo['rows'] / bo['oneround_s']:.0f} "
          f"rows/s, {bo['rounds'][0]} round; classical "
          f"{bo['classical_s']:.3f} s = {bo['rows'] / bo['classical_s']:.0f} "
          f"rows/s, {bo['rounds'][1]} rounds; predict_classical == predict "
          f"bit for bit: True")
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("10 serve: phase 3's forest, phase 9's boosting and F-LR "
                "models, 39050 rows, buckets 32/256/2048")
    hist.histogram_cuda.launches = 0
    attn.flash_attention.launches = 0
    sv = phase_serving(torch, fed3, forest3, xte3, bo["serve"])
    print(f"card: {card}")
    print(f"hand-written kernels launched by the serving path: histogram "
          f"{hist.histogram_cuda.launches}, flash_attention "
          f"{attn.flash_attention.launches} (none is on it)")
    print(f"warmup: 3 buckets, 3 CUDA graphs captured in "
          f"{sv['warmup_s']:.3f} s; serve(39050 rows) = 19 waves of 2048 + "
          f"1 of 256, == fed.predict bit for bit, compact == dense; no "
          f"capture after warmup: True")
    print(f"host binning (NumPy): {len(xte3)} rows {sv['bin_s']:.4f} s, "
          f"2048 rows {sv['bin_2048_s'] * 1e3:.2f} ms")
    print("device ms a wave, graph replay vs the same program eager "
          "(replay == eager bit for bit): " + ", ".join(
              f"bucket {b}: {sv['replay_ms'][b]:.3f} vs {sv['eager_ms'][b]:.3f}"
              for b in sv["replay_ms"]))
    print(f"in turn over {len(xte3)} rows, s (rows/s): " + "; ".join(
        f"{k} " + " / ".join(f"{v:.4f} ({len(xte3) / v:.0f})" for v in vals)
        for k, vals in sv["turns"].items()))
    print(f"party-sum bytes a 2048-row wave: compact {sv['comm_bytes'][0]}, "
          f"dense {sv['comm_bytes'][1]}")
    for name, runs in sv["drains"].items():
        for r in runs:
            print(f"queue, 400 requests of 1-99 rows ({sv['traffic_rows']} "
                  f"rows), max_inflight {4 if name == 'async' else 1} "
                  f"(deepest {r['inflight']}): drain {r['drain_s']:.4f} s = "
                  f"{r['req_rows_per_s']:.0f} rows/s; {r['waves']} waves, "
                  f"wave p50 {r['p50_ms']:.3f} / p95 {r['p95_ms']:.3f} / "
                  f"p99 {r['p99_ms']:.3f} ms, {r['rows_per_s']:.0f} rows/s "
                  f"busy, comm_bytes_total {r['comm_bytes_total']}")
    print("sync == async bit for bit, every request == predict: True")
    print("traced drain (async):", json.dumps(sv["traced"]))
    print(f"traced drain idle {sv['traced']['device_idle_share']:.1%} "
          f"(busy {sv['traced']['device_busy_s']:.4f} s of "
          f"{sv['traced']['host_s']:.4f} s); phase 3's traced predict idle "
          f"{predict_prof3['device_idle_share']:.1%} (busy "
          f"{predict_prof3['device_busy_s']:.4f} s of "
          f"{predict_prof3['host_s']:.4f} s)")
    print(f"boosting (50 rounds) and F-LR served == predict over "
          f"{len(bo['serve']['xte'])} rows: True; F-LR largest logit "
          f"difference served vs predict {sv['logit_diff']:.3g} (smallest "
          f"|logit| {sv['logit_min']:.3g})")
    print("ForestServer.from_checkpoint == predict: True")
    fm = sv["fleet"]
    print(f"fleet, 4 cells on one card: first drain {sv['fleet_drain_s']:.4f}"
          f" s ({sv['fleet_captures']} graphs captured lazily in the "
          f"drains), == the single server; warm drain (threads) "
          f"{sv['fleet_warm_s']:.4f} s; the 4 queues drained in turn on one "
          f"thread {sv['fleet_sequential_s']:.4f} s; kill_cell with "
          f"{sv['pending_on_victim']} requests pending: {sv['moved']} "
          f"re-routed, 0 lost, 0 dead-lettered")
    print(f"FleetMetrics (the kill run): waves {fm.waves}, rows {fm.rows}, p50 "
          f"{fm.p50_ms:.3f} / p95 {fm.p95_ms:.3f} / p99 {fm.p99_ms:.3f} ms, "
          f"{fm.rows_per_s:.0f} rows/s busy, accepted {fm.accepted}, "
          f"rerouted {fm.rerouted}, cells up {fm.cells_up} / down "
          f"{fm.cells_down}, comm_bytes {fm.comm_bytes}, compiles "
          + str([c.compile_count for c in fm.cells]))
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("11 distributed: two party processes on the card, target "
                "marketing 156198 x 95")
    x, y = make_classification(156198, 95, 2, n_informative=24, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    dl = phase_distributed(torch, hist, xtr, ytr, xte, params,
                           span_file=os.path.join(work, "phase11.jsonl"))
    print(f"card: {card}")
    print(f"workers up in {dl['start_s']:.3f} s; party-first ingest of "
          f"{dl['rows']} common rows through the workers "
          f"{dl['ingest_s']:.3f} s (in process {dl['ingest_sim_s']:.3f} s); "
          f"partition, labels and hashed IDs == in-process: True")
    print(f"fit, 20 trees depth 8: distributed {dl['fit_s']:.3f} s, "
          f"simulated on the same partition {dl['sim_fit_s']:.3f} s, phase "
          f"3's simulated fit {fit_s:.3f} s; PartyTree == simulated, all "
          f"seven fields: True")
    print(f"histogram launches: each worker {dl['launches']}, the simulated "
          f"fit {dl['sim_launches']}, the session process 0")
    print(f"wire per fit (frames, session side): sent {dl['wire_sent']} B, "
          f"received {dl['wire_received']} B; protocol payload reckoned "
          f"from the level loop {dl['reckoned_bytes']} B; collective rounds "
          f"{dl['rounds']} (reckoned {dl['reckoned_rounds']}) + 1 run")
    tr = dl["traced"]
    print(f"traced distributed fit {tr['wall_s']:.3f} s: session relaying "
          f"rounds {tr['session_rounds_s']:.3f} s; " + "; ".join(
              f"party {p}: body {tr[f'party{p}']['fit_s']:.3f} s = own "
              f"compute {tr[f'party{p}']['compute_s']:.3f} + collective "
              f"waits {tr[f'party{p}']['collective_s']:.3f}"
              for p in range(2)))
    wv = dl["waves"]
    print(f"serve {len(xte)} rows through the workers: {dl['serve_s']:.4f} s "
          f"then {dl['serve2_s']:.4f} s = {len(xte) / dl['serve2_s']:.0f} "
          f"rows/s; waves (second call) p50 {wv['p50_ms']:.3f} / p95 "
          f"{wv['p95_ms']:.3f} ms; {dl['binds']} buckets bound; mask bytes "
          f"a wave per party {dl['mask_bytes']}; == predict: True; "
          f"fed.predict on 2048 rows {dl['predict_2048_s']:.4f} s, == "
          f"predict: True")
    print(f"faults (3 parties, 160 x 9, depth 3): party {dl['victim']} "
          f"killed, degraded answers from {dl['survivors'][dl['victim']]}/10 "
          f"surviving trees == their forest: True; refused without "
          f"allow_degraded: True")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("12 privacy guard: phase 11's distributed path, guarded, on "
                "the card")
    pv = phase_privacy(torch, hist, xtr, ytr, xte, params, dl)
    print(f"card: {card}")
    print(f"linter over src/repro_torch and chip_smoke.py: {pv['findings']} "
          f"findings in {pv['lint_s']:.2f} s")
    print(f"guarded: workers up in {pv['start_s']:.3f} s; ingest "
          f"{pv['ingest_s']:.3f} s (phase 11 {dl['ingest_s']:.3f} s); "
          f"partition, labels and hashed IDs == phase 11's: True")
    print(f"guarded fit {pv['fit_s']:.3f} s (phase 11 {dl['fit_s']:.3f} s); "
          f"PartyTree == phase 11's, all seven fields: True; histogram "
          f"launches each worker {pv['launches']}; messages checked in the "
          f"session per fit {pv['checked_per_fit']}, in "
          f"{pv['check_s'] * 1e3:.3f} ms of host time")
    print(f"guarded serve {len(xte)} rows {pv['serve_s']:.4f} s then "
          f"{pv['serve2_s']:.4f} s (phase 11 {dl['serve_s']:.4f} s then "
          f"{dl['serve2_s']:.4f} s); == phase 11's answers: True")
    print("planted raw sends refused with their key paths (x, column view, "
          "torch.from_numpy, tensor slice, ids); hashed IDs round-trip: True")
    print("privacy phase:", json.dumps(pv))
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("13 sharded substrate, train and trace CLIs, Parquet: "
                "target marketing 156198 x 95 on the card")
    sh = phase_sharded(torch, hist, xtr, ytr, xte, params, dl, pf, work)
    print(f"card: {card}")
    print(f"(a) (trees=1, parties=2) gloo mesh, two ranks on the card: up in "
          f"{sh['start_s']:.3f} s; fit 20 trees depth 8: sharded "
          f"{sh['fit_s']:.3f} s then {sh['fit2_s']:.3f} s, distributed "
          f"(phase 11) {dl['fit_s']:.3f} s, simulated (phase 11) "
          f"{dl['sim_fit_s']:.3f} s; PartyTree == simulated == distributed, "
          f"all seven fields: True")
    print(f"(a) histogram launches each rank {sh['launches']}, the session "
          f"process 0; collective rounds each rank {sh['rounds']} (relayed "
          f"by the session: 0); bytes per fit each rank sent "
          f"{sh['bytes_sent']}, received {sh['bytes_received']}, staged "
          f"through host buffers {sh['staged_bytes']}")
    tr = sh["traced"]
    print(f"(a) traced sharded fit {tr['wall_s']:.3f} s, the session "
          f"waiting on the run {tr['session_rounds_s']:.3f} s (no round "
          f"relayed); " + "; ".join(
              f"rank {r}: body {tr[f'rank{r}']['fit_s']:.3f} s = own "
              f"compute {tr[f'rank{r}']['compute_s']:.3f} + collective "
              f"waits {tr[f'rank{r}']['collective_s']:.3f}"
              for r in range(2)))
    print(f"(a) serve {len(xte)} rows: {sh['serve_s']:.4f} s then "
          f"{sh['serve2_s']:.4f} s = {len(xte) / sh['serve2_s']:.0f} rows/s "
          f"({sh['binds']} buckets bound); fed.predict {sh['predict_s']:.4f} "
          f"s; served == fed.predict == phase 11's answers: True")
    print(f"(b) (trees=2, parties=2) gloo mesh, four ranks on the card: up "
          f"in {sh['start22_s']:.3f} s; fit {sh['fit22_s']:.3f} s; launches "
          f"each rank {sh['launches22']}, rounds each rank "
          f"{sh['rounds22']}; PartyTree == (a): True; hist_subtraction "
          f"forest == (a): True; predict_classical == (a)'s answers: True")
    print("(h) hist_subtraction on (a)'s ranks: " + "; ".join(
        f"frontier_cap={h['frontier_cap']}: fit {h['fit_s']:.3f} s, "
        f"launches each rank {h['launches']}" for h in sh["hist_sub"])
        + "; PartyTree == the plain fit's, all seven fields: True")
    print(f"(h) predict_classical on (a)'s ranks, {len(xte)} rows: "
          f"{sh['classical_s']:.4f} s = {len(xte) / sh['classical_s']:.0f} "
          f"rows/s, rounds each rank {sh['classical_rounds']} (one-round: "
          f"1); == predict: True")
    print(f"(c) boosting on a (trees=2, parties=1) mesh, tree_sharded=False: "
          f"rounds, predictions and served answers == simulated: True; F-LR "
          f"(400 steps) on (a)'s ranks fit {sh['flr_fit_s']:.3f} s, labels == "
          f"simulated: True (weights differ by at most "
          f"{sh['flr_w_diff']:.3g})")
    ran = ", ".join(f"{r['ranks']} rank(s) on {r['devices']} up in "
                    f"{r['start_s']:.3f} s, fit (the first: the "
                    f"communicator is made at the first collective) "
                    f"{r['fit_s']:.3f} s" for r in sh["nccl"])
    print(f"(d) NCCL: {ran}; == simulated FF(M) and its predictions: True"
          + ("" if len(sh["nccl"]) > 1 else
             f"; two NCCL ranks not run ({torch.cuda.device_count()} card)"))
    print(f"(e) Parquet: write {sh['parquet_write_s']:.3f} s "
          f"({sh['parquet_bytes']} bytes), streamed ingest (16384-row "
          f"chunks) {sh['parquet_ingest_s']:.3f} s; phase 8's CSV write "
          f"{pf['csv_write_s']:.3f} s ({pf['csv_bytes']} bytes), CSV-streamed "
          f"ingest {pf['ingest_stream_s']:.3f} s; partition, labels, IDs and "
          f"forest == in-memory ingest: True")
    print(f"(f) train CLI at the paper's size: {sh['cli_s']:.1f} s, "
          f"'{sh['cli_line']}', accuracy == the session's: True; with phase "
          f"8's --party-csv and --ckpt-dir: killed with "
          f"{sh['cli_killed_with']} written, rerun {sh['cli_rerun_s']:.1f} s "
          f"kept them and wrote the rest, train-acc {sh['cli_csv_acc']} == "
          f"the session's: True")
    print(f"(g) repro-torch-trace over phase 11's span file: exit 0, every "
          f"section present, {sh['trace_events']} Chrome events written; a "
          f"missing file exits 1")
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("14 train and MoE: internlm2-1.8b training, qwen2-moe-a2.7b "
                "serving and training, full width")
    tm = phase_train_moe(torch, attn)
    print(f"card: {card}")
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("15 SSM, xLSTM and hybrid: xlstm-350m and zamba2-7b served "
                "and trained, flash attention at head dim 112")
    sm = phase_ssm_hybrid(torch, attn, ref)
    print(f"card: {card}")
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("16 encoder-decoder and VLM: whisper-large-v3 and "
                "qwen2-vl-2b served and trained, flash attention "
                "bidirectional and cross")
    ev = phase_encdec_vlm(torch, attn, ref)
    print(f"card: {card}")
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("17 sharded LM: phi3.5-moe-42b-a6.6b tensor- and "
                "expert-parallel on ranks sharing the card, the bf16 "
                "levers, flash at a model rank's prefill shape")
    sl = phase_sharded_lm(torch, attn, ref)
    print(f"card: {card}")
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("18 sharded training: phi3.5-moe-42b-a6.6b FSDP x "
                "tensor-parallel on ranks sharing the card, the remat "
                "policies")
    st = phase_sharded_train(torch)
    print(f"card: {card}")
    print(f"phase 18: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("19 sharded layouts: glm4-9b's kv heads replicated at (1, "
                "4), phi3.5-moe's experts over 'data' at (2, 1) and (2, 2), "
                "whisper-large-v3, qwen2-vl-2b, zamba2-7b and xlstm-350m "
                "at (1, 4) and (2, 2), on ranks sharing the card")
    sx = phase_sharded_layouts(torch, attn, ref, st)
    print(f"card: {card}")
    print(f"phase 19: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("20 the dry run against phases 7 and 14 (c), and head "
                "counts the model axis does not divide: whisper-large-v3, "
                "qwen2-vl-2b and xlstm-350m at (1, 8) on ranks sharing the "
                "card")
    dr = phase_dry_run(torch, attn)
    print("dry run:", json.dumps(dr))
    print(f"card: {card}")
    print(f"phase 20: {time.perf_counter() - t0:.1f} s", flush=True)

    main_row = next(r for r in rows if r["what"] == "classification depth 7")
    kernel = {"name": "histogram", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/histogram.cu",
              "replaces": "src/repro/kernels/histogram.py:70",
              "launches": launches,
              "max_abs_err": max(r["max_abs_err"] for r in rows),
              "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
              "bound_ms": main_row["bound_ms"],
              "bound_by": main_row["bound_by"],
              "library_ms": main_row["library_ms"],
              "shape": main_row["shape"],
              "launches_by_path": {"3 forest fit": launches,
                                   "8 party-first": pf["launches"],
                                   "9 boosting fit": bo["launches"],
                                   "11 distributed fit": sum(dl["launches"]),
                                   "11 distributed fit, per worker":
                                       dl["launches"],
                                   "12 guarded distributed fit, per worker":
                                       pv["launches"],
                                   "13 sharded fit (1, 2), per rank":
                                       sh["launches"],
                                   "13 sharded fit (2, 2), per rank":
                                       sh["launches22"]},
              "boosting_shape": {k: signed[k] for k in (
                  "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_by", "max_abs_err", "err_over_bound")}}
    amain = next(r for r in arows if r["what"] == "prefill bf16")
    a112 = next(r for r in sm["attention"]
                if r["what"] == "zamba2 prefill bf16 D=112")
    a_enc, a_cross = (next(r for r in ev["attention"] if r["what"] == w)
                      for w in ("whisper encoder bf16", "whisper cross bf16"))
    a_rank = next(r for r in sl["attention"]
                  if r["what"] == "phi3.5-moe rank prefill bf16")
    a_stub = {w: next(r for r in sx["attention"] if r["what"] == w)
              for w in ("whisper rank encoder bf16", "whisper rank cross bf16",
                        "whisper rank decoder bf16",
                        "qwen2-vl rank prefill bf16")}
    a_zamba = next(r for r in sx["attention"]
                   if r["what"] == "zamba2 rank prefill bf16")
    shape_keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_by", "max_abs_err", "err_over_bound")
    attention = {"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:76",
                 "launches": attn_launches,
                 "max_abs_err": max(r["max_abs_err"] for r in arows
                                    + sm["attention"] + ev["attention"]
                                    + sl["attention"] + sx["attention"]),
                 "ms": amain["ms"], "plain_ms": amain["plain_ms"],
                 "bound_ms": amain["bound_ms"], "bound_by": amain["bound_by"],
                 "library_ms": amain["library_ms"], "shape": amain["shape"],
                 "launches_by_path": {
                     "7 internlm2-1.8b serve, two waves": attn_launches,
                     "14 qwen2-moe-a2.7b serve, two waves":
                         tm["moe_launches"],
                     "14 training (internlm2-1.8b, qwen2-moe-a2.7b)":
                         tm["train"]["launches"]
                         + tm["moe_train"]["launches"],
                     "15 zamba2-7b serve, two waves": sm["zamba_launches"],
                     "15 xlstm-350m serve, two waves": sum(
                         w["flash_launches"]
                         for w in sm["xlstm_serve"]["waves"]),
                     "15 training (xlstm-350m, zamba2-7b)": sum(
                         sm[f"train {n}"]["launches"]
                         for n in ("xlstm-350m", "zamba2-7b")),
                     "16 whisper-large-v3 serve, two waves":
                         ev["whisper_launches"],
                     "16 qwen2-vl-2b serve, two waves": ev["qwen_launches"],
                     "16 training (whisper-large-v3, qwen2-vl-2b)": sum(
                         ev[f"train {n}"]["launches"]
                         for n in ("whisper-large-v3", "qwen2-vl-2b")),
                     "17 phi3.5-moe (2 layers) prefill on (1, 1), per rank":
                         sl["(1, 1) nccl"]["launches"],
                     "17 phi3.5-moe (2 layers) prefill on (1, 2), per rank":
                         sl["(1, 2) gloo"]["launches"],
                     "18 sharded training (1, 1), (2, 1), (1, 2), per rank":
                         [st[k]["flash_launches"] for k in (
                             "(1, 1) nccl", "(2, 1) gloo", "(1, 2) gloo")],
                     "19 glm4-9b (1 layer) prefill on (1, 4), per rank":
                         sx["glm4-9b (1, 4)"]["launches"],
                     "19 phi3.5-moe expert_data (1 layer) prefill on "
                     "(2, 2), per rank":
                         sx["phi3.5-moe expert_data (2, 2)"]["serve"][
                             "launches"],
                     **{f"19 {name} ({layers}) prefill on {where}, per "
                        f"rank": sx[f"{name} {where}"]["launches"]
                        for name, layers in (
                            ("whisper-large-v3", "1 + 1 layers"),
                            ("qwen2-vl-2b", "1 layer"),
                            ("zamba2-7b", "6 layers"),
                            ("xlstm-350m", "2 layers"))
                        for where in ("(1, 4)", "(2, 2)")},
                     **{f"20 {name} prefill on (1, 8), per rank":
                        dr[f"{name} (1, 8)"]["launches"]
                        for name in ("whisper-large-v3", "qwen2-vl-2b",
                                     "xlstm-350m")}},
                 "head_dim_112_shape": {k: a112[k] for k in shape_keys},
                 "encoder_shape": {k: a_enc[k] for k in shape_keys},
                 "cross_shape": {k: a_cross[k] for k in shape_keys},
                 "model_rank_shape": {k: a_rank[k] for k in shape_keys},
                 "stubbed_model_rank_shapes": {
                     w: {k: r[k] for k in shape_keys}
                     for w, r in a_stub.items()},
                 "zamba2_model_rank_shape": {k: a_zamba[k]
                                             for k in shape_keys}}
    print("phase seconds:", json.dumps(_phase_seconds(time.perf_counter())))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [kernel, attention]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
