"""Open-loop serving: requests arrive on a schedule fixed in the mix,
whatever the server does, into a ``RequestQueue`` over the forest's
``ForestServer``; one pump thread submits what is due and drains.

Mix parameters (the traffic file): ``rate_per_s`` (requests a second),
``rows`` ([least, most] rows a request, each count equally often),
``buckets``, ``max_inflight``, ``check_requests`` (how many answered
requests the reference judges), ``trace_seconds`` (the profiled
sub-window of a ``--trace 1`` run).

Every seed gets the same work: one sequence of request sizes (each count
equally often) and inter-arrival gaps (the exponential's quantiles at the
mix's rate, so the arrivals are Poisson in distribution), shuffled once
by the mix's ``pattern_seed`` and rotated by the run's seed.
Rows are raw held-out features, taken in turn.  A request is timed from
when it was due to when its answer is back in the pump's hands; one that
fails or never comes counts in ``failed``.
"""
from __future__ import annotations

import time

import numpy as np

from bench.drivers.common import Session, forest_of, reference_inputs
from bench.reference import forest as ref


def schedule(mix: dict, seconds: float, seed: int, n_test: int):
    """(due seconds, row starts, row counts) of the window's requests.

    One pattern of (gap, size) pairs a rate and length, drawn from the
    mix's ``pattern_seed``; ``seed`` rotates it, so every seed meets the
    same bursts, in another order."""
    rate = float(mix["rate_per_s"])
    lo, hi = (int(v) for v in mix["rows"])
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([int(mix.get("pattern_seed", 0)), 29])
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    sizes = rng.permutation(lo + np.arange(n) % (hi - lo + 1))
    shift = int(seed) % n
    gaps, sizes = np.roll(gaps, -shift), np.roll(sizes, -shift)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    starts = np.zeros(n, dtype=np.int64)
    at = 0
    for i, k in enumerate(sizes):
        if at + k > n_test:
            at = 0
        starts[i] = at
        at += k
    return due, starts, sizes


class Driver:
    kind = "serve"
    reports = ("serve_p95_ms", "serve_rows_per_s")   # what ``window`` returns

    def __init__(self, ctx):
        self.ctx = ctx
        self.requests = None

    def setup(self) -> None:
        from repro_torch.serving import RequestQueue, ServeConfig
        mix = self.ctx.mix
        self.s = Session(self.ctx, test=True)
        model = self.s.fit()
        cfg = ServeConfig(buckets=tuple(int(b) for b in mix["buckets"]),
                          compact=True, max_inflight=int(mix["max_inflight"]))
        self.server = self.s.fed.serve(model, cfg)
        self.server.warmup()
        self.queue = RequestQueue(self.server)
        # one wave of each bucket through the pump: its ring slots, stream
        # and pinned buffers exist before the window opens
        xt = self.s.x_test
        for b in self.server.buckets:
            self.queue.submit(xt[:b])
            self.queue.drain()

    def _serve(self, seconds: float, seed: int):
        """Run one schedule; returns (due, sizes, rids, done, failed)."""
        from repro_torch.serving.queue import PoisonedWaveError
        xt = self.s.x_test
        due, starts, sizes = schedule(self.ctx.mix, seconds, seed, len(xt))
        n = len(due)
        rids = np.full(n, -1, dtype=np.int64)
        done: dict[int, float] = {}
        answers: dict[int, np.ndarray] = {}
        failed = set()
        q = self.queue
        i = 0
        lag = 0.0
        t0 = time.perf_counter()
        while i < n or q.pending_requests():
            now = time.perf_counter() - t0
            while i < n and due[i] <= now:
                lag = max(lag, now - due[i])
                rids[i] = q.submit(xt[starts[i]:starts[i] + sizes[i]])
                i += 1
            if q.pending_requests():
                try:
                    res = q.drain()
                except PoisonedWaveError as err:
                    res = err.partial
                    for rid in err.rids:
                        q.evict(rid)
                        failed.add(rid)
                back = time.perf_counter() - t0
                for rid, out in res.items():
                    answers[rid] = out
                    done[rid] = back
            elif i < n:
                wait = due[i] - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(wait)
        self.ctx.spans["submit_lag_s"] = max(
            self.ctx.spans.get("submit_lag_s", 0.0), lag)
        return due, starts, sizes, rids, done, answers, failed

    def window(self, seconds: float) -> dict:
        from repro_torch.observability import registry as telemetry
        waves = telemetry.REGISTRY.counter("serving.waves")
        rows = telemetry.REGISTRY.counter("serving.rows")
        w0, r0 = waves.value, rows.value
        due, starts, sizes, rids, done, answers, failed = self._serve(
            seconds, self.ctx.seed)
        self.ctx.counters["waves"] = waves.value - w0
        self.ctx.counters["rows"] = rows.value - r0
        self.requests = (starts, sizes, rids, answers)
        ok = np.array([rid in done for rid in rids])
        self.n_failed = int((~ok).sum())
        last = max([seconds, *done.values()])
        # a failed request misses every limit: it counts as waiting to
        # the end of the run
        lat = np.array([done.get(rid, last) - d for rid, d in zip(rids, due)])
        answered_rows = int(sizes[ok].sum())
        self.ctx.spans["window_s"] = last
        p95 = float(np.percentile(lat, 95)) * 1e3
        return {"serve_p95_ms": p95,
                "serve_rows_per_s": answered_rows / last}

    def attempted(self) -> tuple[int, int]:
        _, sizes, _, _ = self.requests
        return len(sizes), self.n_failed

    def traced_unit(self):
        """What a ``--trace 1`` run profiles: ``trace_seconds`` more of the
        same arrivals (another order)."""
        from repro_torch.observability import registry as telemetry
        secs = float(self.ctx.mix.get("trace_seconds", 3))

        def run():
            rows = telemetry.REGISTRY.counter("serving.rows")
            r0 = rows.value
            self._serve(secs, self.ctx.seed + 1)
            self.ctx.counters["traced_rows"] = rows.value - r0
        return run

    def release(self) -> None:
        self.server = None
        self.queue = None
        self.s.close()

    def judge(self) -> dict:
        """Rows whose served answer differs from the reference forest's, in
        a sample of the window's requests drawn from the seed (the longest
        request always among them); a request answered with the wrong
        number of rows counts all its rows."""
        starts, sizes, rids, answers = self.requests
        cfg, mix = self.ctx.config, self.ctx.mix
        p = forest_of(cfg, self.ctx.seed)
        edges, xb, _ = reference_inputs(self.ctx, self.s.x, self.s.y, p)
        trees = ref.grow_forest(xb, self.s.y, p)
        del xb
        n = len(sizes)
        rng = np.random.default_rng([self.ctx.seed, 31])
        k = min(n, int(mix.get("check_requests", 2000)))
        pick = np.union1d(rng.choice(n, size=k, replace=False),
                          [int(np.argmax(sizes))])
        pick = pick[rids[pick] >= 0]
        rows = np.concatenate([np.arange(starts[i], starts[i] + sizes[i])
                               for i in pick])
        want = ref.predict(trees, ref.bin_rows(self.s.x_test[rows], edges,
                                               self.ctx.device), p)
        differ, at = 0, 0
        for i in pick:
            k = int(sizes[i])
            got = answers.get(int(rids[i]))
            exp = want[at:at + k]
            at += k
            if got is None:
                continue            # never answered: counted in ``failed``
            got = np.asarray(got)
            if got.shape != exp.shape:
                differ += k
            else:
                differ += int((got != exp).sum())
        self.ctx.counts["checked_rows"] = int(len(rows))
        return {"answers_differ": differ}
