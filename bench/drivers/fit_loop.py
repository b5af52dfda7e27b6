"""Closed-loop fits: one caller runs ``Federation.fit`` back to back on the
ingested partition, with the same parameters each time.

Mix parameters (the traffic file): ``warmup_units`` fits in set-up,
``trace_units`` fits under the profiler in a ``--trace 1`` run.

End to end: ``fit_s``, the window's seconds over the fits it completed,
each ending in a device sync.  Judged: every tree index once, each from a
fit of the window drawn from the seed, replayed by the reference
(``split_regret``, ``stat_err``, ``bad_nodes``).
"""
from __future__ import annotations

import time

import numpy as np

from bench.drivers.common import (Session, forest_of, party_groups,
                                  reference_inputs, tree_fields)
from bench.reference import forest as ref


class Driver:
    kind = "fit"
    reports = ("fit_s",)        # the end-to-end metrics ``window`` returns

    def __init__(self, ctx):
        self.ctx = ctx
        self.fits: list = []
        self.judged: list | None = None

    def setup(self) -> None:
        self.s = Session(self.ctx, test=False)
        for _ in range(int(self.ctx.mix.get("warmup_units", 1))):
            self.s.fit()

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        marks = [0.0]
        while True:
            self.fits.append(self.s.fit().trees_)
            elapsed = time.perf_counter() - t0
            marks.append(elapsed)
            if elapsed >= seconds:
                break
        self.ctx.spans["window_s"] = elapsed
        self.ctx.spans["unit_s"] = [round(b - a, 4)
                                    for a, b in zip(marks, marks[1:])]
        self.ctx.counters["fits"] = len(self.fits)
        return {"fit_s": elapsed / len(self.fits)}

    def attempted(self) -> tuple[int, int]:
        return len(self.fits), 0

    def traced_unit(self):
        """What a ``--trace 1`` run profiles: ``trace_units`` whole fits."""
        from repro_torch.kernels import histogram as hist
        n = int(self.ctx.mix.get("trace_units", 2))

        def run():
            before = hist.histogram_cuda.launches
            t0 = time.perf_counter()
            for _ in range(n):
                self.s.fit()
            self.ctx.spans["traced_fit_s"] = (time.perf_counter() - t0) / n
            self.ctx.counters["hist_launches_per_fit"] = \
                (hist.histogram_cuda.launches - before) / n
            self.ctx.counters["traced_fits"] = n
        return run

    def release(self) -> None:
        """Copy the judged trees to the host and free the program."""
        rng = np.random.default_rng([self.ctx.seed, 17])
        t_count = int(self.ctx.config["forest"]["n_estimators"])
        pick = rng.integers(0, len(self.fits), size=t_count)
        self.judged = [tree_fields(self.fits[f], t)
                       for t, f in enumerate(pick)]
        self.fits = []
        self.s.close()

    def judge(self) -> dict:
        cfg = self.ctx.config
        p = forest_of(cfg, self.ctx.seed)
        x, y = self.s.x, self.s.y
        _, xb, stats = reference_inputs(self.ctx, x, y, p)
        groups = party_groups(cfg)
        n, f = xb.shape
        total = ref.Reading()
        view_bad = 0
        for t, fields in enumerate(self.judged):
            tree, bad = ref.master_view(fields, groups, f)
            view_bad += bad
            w, sel = ref.master_draws(p, n, f, t)
            total = total.merge(ref.replay_tree(tree, xb, stats, w, sel, p))
        self.ctx.counts["trees"] = total.counts
        return {"split_regret": total.split_regret,
                "stat_err": total.stat_err,
                "bad_nodes": total.bad_nodes + view_bad}
