"""Training CLI: language models and the federated forest on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \
        --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch federated-forest
    PYTHONPATH=src python -m repro_torch.launch.train --arch federated-forest \
        --rows 156198 --features 95 --parties 2 --trees 20 --depth 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch federated-forest \
        --party-csv bank=/data/bank.csv --party-csv shop=/data/shop.csv \
        --ckpt-dir /tmp/ff            # party-first, break-point recoverable

Two arms share one CLI, as in the JAX package's train CLI:
  * the LM architectures (default; all ten, the audio and VLM ones with
    their frames or patches stubs): training at the reduced size
    (``--reduced`` is on and, as in the JAX CLI, cannot be turned off)
    on synthetic Markov tokens, printing the CE as it falls;
  * ``--arch federated-forest``: the Federation session API (ingest -> fit
    -> one-round predict), with an optional ``--ckpt-dir``
    break-point-recoverable fit (paper §4.1): a rerun after a crash resumes
    after the last complete chunk of trees.
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partyblock import CSVSource


def train_loop(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
               lr: float = 1e-3, micro_batch: int = 0, seed: int = 0,
               log_every: int = 10, device=None):
    """Train a freshly initialised model (seed ``seed``) on
    ``synthetic_lm_batches`` for ``steps`` steps on ``device`` (default:
    the CUDA card), printing as the JAX package's ``train_loop`` prints.
    Returns the model and the logged CEs."""
    from repro_torch.data.lm import synthetic_lm_batches
    from repro_torch.models import transformer
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    model = transformer.init_params(cfg, seed=seed, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M")
    opt = optim.adamw_init(model)
    step_fn = make_train_step(cfg, micro_batch=micro_batch, lr=lr)

    losses = []
    t0 = time.time()
    for i, b in enumerate(synthetic_lm_batches(cfg, batch, seq, seed=seed,
                                               device=model.device)):
        if i >= steps:
            break
        model, opt, metrics = step_fn(model, opt, b)
        if i % log_every == 0 or i == steps - 1:
            ce = float(metrics["ce"])
            losses.append(ce)
            tok_s = batch * seq * (i + 1) / (time.time() - t0)
            print(f"step {i:4d}  ce={ce:.4f}  tok/s={tok_s:,.0f}")
    return model, losses


def parse_party_csvs(specs, id_column: str, label_column: str) -> list:
    """``NAME=PATH`` (or bare PATH) CLI specs -> CSVSource list.

    Split at the FIRST ``=`` — party names cannot contain one, but paths
    can (``bank=/data/run=3/bank.csv``).  A spec whose pre-``=`` part
    contains a path separator is a bare path (``/data/run=3/bank.csv``);
    a bare *relative* path with ``=`` before any separator needs an
    explicit ``NAME=``."""
    sources = []
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep or "/" in name or os.sep in name:
            name, path = None, spec
        sources.append(CSVSource(path, name=name or None,
                                 id_column=id_column,
                                 label_column=label_column))
    return sources


def forest_train(args) -> None:
    """Federated-forest training through the Federation session API, on
    ``--device`` (default: the CUDA card).

    Two ingest shapes: synthetic raw-matrix data (default), or party-first
    per-party CSV extracts (``--party-csv name=path``, repeated) — rows
    keyed by ``--id-column``, aligned on hashed IDs, labels taken from
    whichever party's CSV carries ``--label-column``."""
    from repro_torch.core import ForestParams
    from repro_torch.data import (accuracy, make_classification,
                                  train_test_split)
    from repro_torch.federation import Federation

    p = ForestParams(n_estimators=args.trees, max_depth=args.depth,
                     n_bins=16, seed=args.seed)
    if args.party_csv:
        sources = parse_party_csvs(args.party_csv, args.id_column,
                                   args.label_column)
        fed = Federation(parties=len(sources), n_bins=p.n_bins,
                         device=args.device)
        part = fed.ingest(sources)
        print(f"aligned {part.n_samples} common samples across "
              f"{part.n_parties} parties {list(part.party_names)}")
        t0 = time.time()
        model = fed.fit_resumable(p, args.ckpt_dir) if args.ckpt_dir \
            else fed.fit(p)
        t_fit = time.time() - t0
        acc = accuracy(fed.labels_, fed.predict(model, part.dense_raw()))
        print(f"federated-forest: {args.trees} trees x depth {args.depth} "
              f"over {part.n_parties} parties in {t_fit:.1f}s  "
              f"train-acc={acc:.3f}")
        return
    x, y = make_classification(args.rows, args.features, 2,
                               n_informative=max(4, args.features // 3),
                               seed=args.seed)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=args.seed)

    fed = Federation(parties=args.parties, n_bins=p.n_bins,
                     device=args.device)
    fed.ingest(xtr, ytr)
    t0 = time.time()
    if args.ckpt_dir:
        model = fed.fit_resumable(p, args.ckpt_dir)
    else:
        model = fed.fit(p)
    t_fit = time.time() - t0
    acc = accuracy(yte, fed.predict(model, xte))
    print(f"federated-forest: {args.trees} trees x depth {args.depth} over "
          f"{args.parties} parties in {t_fit:.1f}s  acc={acc:.3f}")
    if not acc > 0.5:
        raise RuntimeError(f"federated fit degenerated: accuracy {acc}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    # federated-forest arm
    ap.add_argument("--parties", type=int, default=3)
    ap.add_argument("--trees", type=int, default=8)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--features", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="forest arm: break-point-recoverable fit directory")
    ap.add_argument("--party-csv", action="append", default=None,
                    metavar="NAME=PATH",
                    help="forest arm: per-party CSV extract (repeat once "
                         "per party); rows are aligned on hashed "
                         "--id-column values, the one CSV carrying "
                         "--label-column holds the labels")
    ap.add_argument("--id-column", default="id")
    ap.add_argument("--label-column", default="label")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.arch == "federated-forest":
        forest_train(args)
        return
    from repro_torch.configs import registry
    from repro_torch.configs.base import reduced
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    _, losses = train_loop(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, lr=args.lr, device=args.device)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training diverged: ce {losses}")
    print(f"done: ce {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
