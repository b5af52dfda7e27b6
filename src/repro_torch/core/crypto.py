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

# preimage "salt:id" -> hexdigest.  Party-first ingest hashes every party's
# IDs, and a streamed re-ingest or an append revisits the same ID universe,
# so the sha256 loop is memoized.  Bounded: when full it is cleared
# wholesale rather than growing one entry per distinct ID forever.
_HASH_CACHE: dict[str, str] = {}
_HASH_CACHE_MAX = 1 << 20


def hash_ids(ids, salt: str = DEFAULT_SALT) -> np.ndarray:
    """Irreversible sample-ID encryption for alignment (paper: MD5).

    Memoized per (salt, id) preimage; bit-identical to the uncached digest
    by construction (the cache stores the digest itself)."""
    cache, sha256 = _HASH_CACHE, hashlib.sha256
    if len(cache) > _HASH_CACHE_MAX:
        cache.clear()
    out = []
    for i in ids:
        key = f"{salt}:{i}"
        h = cache.get(key)
        if h is None:
            h = sha256(key.encode()).hexdigest()
            cache[key] = h
        out.append(h)
    return np.asarray(out)


def align_ids(*hashed_parties: np.ndarray,
              check_unique: bool = True) -> tuple[np.ndarray, ...]:
    """Private-set-intersection stand-in, generalized to M parties.

    Iterated hashed-ID intersection (paper §4.3: alignment sees hashed IDs
    only).  Returns one int64 position array per party; gathering party
    i's rows at ``positions[i]`` puts every party on the same canonical
    common ordering — the lexicographic sort of the common hashed IDs.

    Raises ValueError on duplicate hashed IDs within a party (alignment
    would be ambiguous) and on an empty intersection (no shared samples).
    Callers that already validated per-party uniqueness with the party's
    name attached pass ``check_unique=False`` to skip the second sort.
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


def align_hashed(hashes, names, *, check_unique: bool = True,
                 identity_fast_path: bool = True):
    """Align M parties' already-hashed ID arrays with the loud-error contract.

    Validates per-party uniqueness with the party *name* attached, takes the
    pre-aligned identity fast path when all arrays are equal (preserving the
    caller's row order bit-for-bit), and otherwise runs :func:`align_ids`
    onto the canonical sorted-hash common ordering — rewording the
    empty-intersection error with the party names.

    Callers that decide the fast path on *raw* IDs themselves (the streaming
    plane, mirroring align_party_blocks exactly) pass
    ``identity_fast_path=False`` so equal hashes of unequal raw IDs cannot
    skip the canonical reordering.

    Returns ``(positions, common_hashed)``: one int64 position array per
    party and the common hashed IDs in the aligned order.
    """
    hs = [np.asarray(h).reshape(-1) for h in hashes]
    if check_unique:
        for h, name in zip(hs, names):
            if np.unique(h).size != h.size:
                raise ValueError(
                    f"party {name!r} has duplicate sample IDs: alignment "
                    f"would be ambiguous — deduplicate before ingest")
    first = hs[0]
    if identity_fast_path and all(h.shape == first.shape
                                  and np.array_equal(h, first)
                                  for h in hs[1:]):
        if first.size == 0:     # the fast path must keep the loud-error
            raise ValueError(   # contract, not fall through to binning
                f"empty hashed-ID intersection across parties "
                f"{list(names)}: no shared samples to align")
        pos = np.arange(len(first), dtype=np.int64)
        return [pos.copy() for _ in hs], first.copy()
    try:
        positions = list(align_ids(*hs, check_unique=False))
    except ValueError as e:
        if "intersection" not in str(e):
            raise
        raise ValueError(
            f"empty hashed-ID intersection across parties "
            f"{list(names)}: no shared samples to align "
            f"(same ID space and salt on every party?)") from e
    return positions, hs[0][positions[0]]


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


def encode_feature_names(names: list[str], seed: int = 0) -> dict[str, int]:
    """Random integer encoding of feature names (master sees only these)."""
    perm = np.random.default_rng(seed).permutation(len(names))
    return {n: int(e) for n, e in zip(names, perm)}


def pairwise_cancelling_masks(n_parties: int, shape, seed: int = 0) -> np.ndarray:
    """(M, *shape) float32 masks with sum_i mask_i == 0: adding mask_i to party
    i's message hides it point-to-point while the party sum recovers the
    exact sum."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n_parties, *shape)).astype(np.float32)
    m[-1] = -m[:-1].sum(0)
    return m
