"""What both drivers do alike: the table, the session and ingest, the
forest's parameters, and the reference's view of the same inputs."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import datagen
from bench.reference import forest as ref


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forest_of(cfg: dict, seed: int) -> ref.Forest:
    """The reference's reading of the configuration's forest."""
    fp = cfg["forest"]
    return ref.Forest(
        task=cfg["task"], n_classes=int(cfg.get("n_classes", 0)),
        n_estimators=int(fp["n_estimators"]), max_depth=int(fp["max_depth"]),
        n_bins=int(fp["n_bins"]), bootstrap=bool(fp["bootstrap"]),
        max_features=float(fp["max_features"]),
        min_samples_split=int(fp["min_samples_split"]),
        min_samples_leaf=int(fp["min_samples_leaf"]),
        min_impurity_decrease=float(fp["min_impurity_decrease"]),
        seed=int(seed))


def party_groups(cfg: dict) -> list[np.ndarray]:
    """Each party's global features: contiguous runs, the first parties
    one wider where F does not divide."""
    if cfg["split"] != "contiguous":
        raise ValueError(f"unknown party split {cfg['split']!r}")
    return [np.asarray(g) for g in np.array_split(
        np.arange(int(cfg["n_features"])), int(cfg["parties"]))]


class Session:
    """The program under test for one run: the table made from the seed,
    a ``Federation`` that ingested its training rows, and the forest's
    parameters."""

    def __init__(self, ctx, *, test: bool):
        self.ctx = ctx
        cfg, dev = ctx.config, ctx.device
        self.x, self.y, self.x_test, self.y_test = datagen.make_table(
            cfg, ctx.seed, dev, test=test)
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        from repro_torch.core import ForestParams
        from repro_torch.federation import Federation
        fp = cfg["forest"]
        self.fed = Federation(parties=int(cfg["parties"]),
                              n_bins=int(fp["n_bins"]), seed=0, device=dev)
        t0 = time.perf_counter()
        self.fed.ingest(self.x, self.y)
        ctx.spans["ingest_s"] = time.perf_counter() - t0
        self.params = ForestParams(
            task=cfg["task"], n_classes=int(cfg.get("n_classes", 2)),
            n_estimators=int(fp["n_estimators"]),
            max_depth=int(fp["max_depth"]), n_bins=int(fp["n_bins"]),
            bootstrap=bool(fp["bootstrap"]),
            max_features=float(fp["max_features"]),
            min_samples_split=int(fp["min_samples_split"]),
            min_samples_leaf=int(fp["min_samples_leaf"]),
            min_impurity_decrease=float(fp["min_impurity_decrease"]),
            frontier_cap=fp["frontier_cap"],
            hist_subtraction=bool(fp["hist_subtraction"]),
            seed=int(ctx.seed))

    def fit(self):
        model = self.fed.fit(self.params)
        sync(self.ctx.device)
        return model

    def close(self) -> None:
        """Drop the program's state and give its device memory back."""
        self.fed = None
        gc.collect()
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()


def reference_inputs(ctx, x: np.ndarray, y: np.ndarray, p: ref.Forest):
    """The reference's own bins and label stats of the training rows, on
    the run's device, and its bin edges."""
    edges = ref.quantile_edges(x, p.n_bins)
    xb = ref.bin_rows(x, edges, ctx.device)
    return edges, xb, ref.label_stats(y, p, ctx.device)


def tree_fields(trees, t: int) -> dict:
    """Tree ``t`` of a program PartyTree stack ((M, T, ...) fields) as host
    arrays, (M, nn, ...) each."""
    return {name: getattr(trees, name)[:, t].detach().cpu().numpy()
            for name in trees._fields}
