"""Privacy layer (paper §4.3) — simulation-grade, same trust model as the paper.

The same mechanisms as the JAX package, host-side NumPy:

  * sample IDs: salted SHA-256 — alignment happens on hashed IDs only;
  * labels: class-id permutation "encoding" for classification (training is
    invariant to it), affine masking for regression targets (variance-based
    split gains are invariant to affine maps of y).

None of this is semantically-secure MPC — neither is the paper's.  The point
is that the *information flow* matches §4.3: raw features never leave a
party; the master sees only encoded ids and masked statistics.
"""
from __future__ import annotations

import hashlib

import numpy as np

DEFAULT_SALT = "repro-ff"


def hash_ids(ids, salt: str = DEFAULT_SALT) -> np.ndarray:
    """Irreversible sample-ID encryption for alignment (paper: MD5)."""
    return np.asarray([hashlib.sha256(f"{salt}:{i}".encode()).hexdigest()
                       for i in ids])


def align_ids(*hashed_parties: np.ndarray,
              check_unique: bool = True) -> tuple[np.ndarray, ...]:
    """Private-set-intersection stand-in, generalized to M parties.

    Returns one int64 position array per party; gathering party i's rows at
    ``positions[i]`` puts every party on the same canonical common ordering
    — the lexicographic sort of the common hashed IDs.

    Raises ValueError on duplicate hashed IDs within a party (alignment
    would be ambiguous) and on an empty intersection (no shared samples).
    """
    if not hashed_parties:
        raise ValueError("align_ids needs at least one party's hashed IDs")
    hs = [np.asarray(h).reshape(-1) for h in hashed_parties]
    if check_unique:
        for i, h in enumerate(hs):
            if np.unique(h).size != h.size:
                raise ValueError(
                    f"party {i} has duplicate sample IDs: alignment on "
                    f"hashed IDs is ambiguous — deduplicate before ingest")
    common = np.sort(hs[0])
    for h in hs[1:]:
        common = np.intersect1d(common, h, assume_unique=True)
    if common.size == 0:
        raise ValueError(
            f"empty hashed-ID intersection across {len(hs)} parties: the "
            f"parties share no samples (same salt on every party?)")
    out = []
    for h in hs:
        order = np.argsort(h)
        out.append(order[np.searchsorted(h, common, sorter=order)]
                   .astype(np.int64))
    return tuple(out)


def encode_labels(y: np.ndarray, n_classes: int, seed: int = 0):
    """Permute class ids: clients train on encoded labels (classification is
    invariant); only the label owner can decode. Returns (y_enc, decode)."""
    perm = np.random.default_rng(seed).permutation(n_classes)
    return perm[y.astype(np.int64)], label_decoder(n_classes, seed)


def label_decoder(n_classes: int, seed: int = 0):
    """Reconstruct encode_labels' decode from (n_classes, seed) alone."""
    inv = np.argsort(np.random.default_rng(seed).permutation(n_classes))
    return lambda y_enc: inv[np.asarray(y_enc, dtype=np.int64)]


def mask_regression_targets(y: np.ndarray, seed: int = 0):
    """Affine mask a*y + b (a>0): SSE split gains scale by a^2, so the argmax
    split — hence the tree — is unchanged; leaf values decode affinely."""
    a, b = _regression_mask(seed)
    return a * y + b, regression_unmasker(seed)


def _regression_mask(seed: int) -> tuple[float, float]:
    rng = np.random.default_rng(seed)
    return float(rng.uniform(0.5, 2.0)), float(rng.normal())


def regression_unmasker(seed: int = 0):
    """Reconstruct mask_regression_targets' decode from the seed alone."""
    a, b = _regression_mask(seed)
    return lambda p: (np.asarray(p) - b) / a
