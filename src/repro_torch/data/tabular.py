"""Tabular data: synthetic analogues of the paper's benchmark suite.

The same generators as the JAX package's ``repro.data.tabular`` (NumPy,
bit-identical from the same seed): blob+rotation classification (an
informative low-rank subspace mixed across every column, plus noise) and a
nonlinear regression, with the (n_samples, n_features) signatures of the
paper's Table 2 (:data:`DATASETS`, :func:`load_dataset`); and
:func:`make_party_views`, which cuts a dense table
into the shuffled, partially overlapping per-party extracts of party-first
ingest.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import crypto
from repro_torch.core.party import assign_features
from repro_torch.core.partyblock import PartyBlock


def make_classification(n: int, f: int, n_classes: int = 2, *,
                        n_informative: int | None = None, class_sep: float = 1.2,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ni = n_informative or max(2, f // 4)
    ni = min(ni, f)
    centers = rng.normal(scale=class_sep, size=(n_classes, ni))
    y = rng.integers(0, n_classes, size=n)
    xi = centers[y] + rng.normal(size=(n, ni))
    mix = rng.normal(size=(ni, f)) / np.sqrt(ni)  # spread info across columns
    x = xi @ mix + 0.5 * rng.normal(size=(n, f))
    return x.astype(np.float64), y.astype(np.int64)


def make_regression(n: int, f: int, *, n_informative: int | None = None,
                    noise: float = 0.5, nonlinear: bool = True, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ni = n_informative or max(2, f // 4)
    ni = min(ni, f)
    x = rng.normal(size=(n, f))
    w = rng.normal(size=ni)
    y = x[:, :ni] @ w
    if nonlinear:
        y = y + np.sin(2.0 * x[:, 0]) * np.abs(w).sum() * 0.3 + 0.5 * x[:, 1] * x[:, 2 % f]
    y = y + noise * rng.normal(size=n)
    return x.astype(np.float64), y.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    task: str
    n: int          # scaled down where the paper's set is huge
    f: int
    n_classes: int = 2
    paper_n: int | None = None   # the paper's Table 2 size, for the record


# the paper's Table 2, at the JAX package's CPU-tractable sizes (synthetic
# values from the generators above: nothing is downloaded)
DATASETS: dict[str, DatasetSpec] = {
    "target_marketing": DatasetSpec("target_marketing", "classification", 8000, 95, 2, 156198),
    "ionosphere":       DatasetSpec("ionosphere", "classification", 351, 34, 2),
    "spambase":         DatasetSpec("spambase", "classification", 4601, 57, 2),
    "parkinson":        DatasetSpec("parkinson", "classification", 756, 754, 2),
    "kdd_cup_99":       DatasetSpec("kdd_cup_99", "classification", 8000, 41, 2, 4_000_000),
    "waveform":         DatasetSpec("waveform", "classification", 5000, 21, 3),
    "gene":             DatasetSpec("gene", "classification", 801, 2000, 5, None),
    "year_prediction":  DatasetSpec("year_prediction", "regression", 8000, 90, 0, 515_345),
    "superconduct":     DatasetSpec("superconduct", "regression", 8000, 81, 0, 21_263),
}


def load_dataset(name: str, seed: int = 0):
    spec = DATASETS[name]
    if spec.task == "classification":
        x, y = make_classification(spec.n, spec.f, spec.n_classes, seed=seed)
    else:
        x, y = make_regression(spec.n, spec.f, seed=seed)
    return x, y, spec


def make_party_views(x, y=None, n_parties: int = 3, *, overlap: float = 0.75,
                     contiguous: bool = True, shuffle: bool = True,
                     label_party: int = 0, seed: int = 0,
                     salt: str | None = None):
    """Fabricate realistic per-party views of a dense dataset: shuffled,
    partially-overlapping regional extracts for party-first ingestion tests
    and benchmarks.

    Every party receives its own feature columns for (a) a common core of
    ``overlap * n`` samples shared by all parties and (b) a disjoint slice
    of the remaining samples only it holds — so the M-party ID intersection
    is exactly the core.  Each party's rows are independently shuffled and
    keyed by string sample IDs; ``label_party`` carries the labels.

    Returns ``(blocks, x_aligned, y_aligned)`` where the aligned pair is
    the **equivalent centrally pre-aligned dataset**: the core rows in
    canonical order (sorted by hashed ID — exactly the ordering
    party-block ingestion aligns to).  Fitting from ``blocks`` is
    bit-identical to fitting from ``Federation(seed=seed).ingest(x_aligned,
    y_aligned, contiguous=contiguous)``: blocks carry ``feature_ids`` from the same ``assign_features``
    draw the raw-matrix adapter makes with this ``seed``.
    """
    x = np.asarray(x)
    n, f = x.shape
    if not 0.0 < overlap <= 1.0:
        raise ValueError(f"overlap must be in (0, 1], got {overlap}")
    groups = assign_features(f, n_parties, contiguous=contiguous,
                             rng=np.random.default_rng(seed))
    rng = np.random.default_rng([seed, 104729])  # own stream: never collides
    perm = rng.permutation(n)                    # with the features draw
    core = perm[: max(1, int(round(overlap * n)))]
    extras = np.array_split(perm[len(core):], n_parties)
    ids = np.array([f"u{i:07d}" for i in range(n)])
    blocks = []
    for i, g in enumerate(groups):
        rows = np.concatenate([core, extras[i]])
        if shuffle:
            rows = rows[np.random.default_rng([seed, i, 7])
                        .permutation(len(rows))]
        blocks.append(PartyBlock(
            name=f"party{i:03d}", x=x[rows][:, g], ids=ids[rows],
            y=None if y is None or i != label_party else np.asarray(y)[rows],
            feature_ids=g))
    salt = crypto.DEFAULT_SALT if salt is None else salt
    aligned = core[np.argsort(crypto.hash_ids(ids[core], salt=salt))]
    return blocks, x[aligned], (None if y is None
                                else np.asarray(y)[aligned])


def train_test_split(x, y, test_frac: float = 0.25, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(y)
    perm = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr, te = perm[:cut], perm[cut:]
    return x[tr], y[tr], x[te], y[te]
