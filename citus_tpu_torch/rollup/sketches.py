"""Serializable sketch states: the value codec behind SKETCH columns.

Each sketch kind has ONE in-memory state shape (a single ndarray), one
wire/storage word format, and one merge law.  The word is
self-describing — ``"<kind>:<version>:<base64 payload>"`` — so a stored
sketch can be merged or finalized without consulting the table schema:

=====  ==================  ===========================  ================
kind   state               merge                        documented error
=====  ==================  ===========================  ================
hll    int32[128]          elementwise max              ±9% (1.04/√128)
ddsk   int64[2048]         elementwise sum              ~2.7% relative
topk   int64[2048]         counts sum | registers max   count-min bound
tdg    float64[128]        centroid concat + compress   ~1/δ ≈ 2% rank
=====  ==================  ===========================  ================

The hll/ddsk/topk shapes are exactly the partial vectors the scan
aggregates already combine across shards (planner/aggregates.py), so a
stored sketch merged with a fresh delta partial is indistinguishable
from having scanned both row sets at once — the property that makes
rollups re-mergeable.  t-digest (the reference's
planner/tdigest_extension.c backend) has no fixed-shape device partial;
its state is a fixed-slot centroid list built and compressed host-side.

Payloads are little-endian and versioned.  The dense hll/tdg states
serialize whole; ddsk/topk serialize sparsely (occupied buckets only),
since a fresh rollup group touches a handful of buckets and a dense
int64[2048] word would bloat every dictionary entry to ~22 KB.
"""

from __future__ import annotations

import base64
import math

import numpy as np

from citus_tpu_torch.errors import AnalysisError
from citus_tpu_torch.planner.aggregates import (
    DDSK_M, HLL_M, TOPK_M, TOPK_SENTINEL, ddsk_bucket_values, hll_estimate,
)

SKETCH_VERSION = 1

#: t-digest centroid slots / k1 compression factor (quantile error ~1/δ)
TDG_K = 64
TDG_DELTA = 48.0

_KINDS = ("hll", "ddsk", "topk", "tdg")


# ------------------------------------------------------------- states


def empty_state(kind: str) -> np.ndarray:
    if kind == "hll":
        return np.zeros(HLL_M, np.int32)
    if kind == "ddsk":
        return np.zeros(DDSK_M, np.int64)
    if kind == "topk":
        s = np.zeros(2 * TOPK_M, np.int64)
        s[TOPK_M:] = TOPK_SENTINEL
        return s
    if kind == "tdg":
        return np.zeros(2 * TDG_K, np.float64)
    raise AnalysisError(f"unknown sketch kind: {kind!r}")


def merge_states(kind: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Two states -> merged state; commutative and associative, so any
    merge tree over any partition of the input rows agrees."""
    if kind == "hll":
        return np.maximum(a, b)
    if kind == "ddsk":
        return a + b
    if kind == "topk":
        out = np.empty_like(a)
        out[:TOPK_M] = a[:TOPK_M] + b[:TOPK_M]
        out[TOPK_M:] = np.maximum(a[TOPK_M:], b[TOPK_M:])
        return out
    if kind == "tdg":
        return _tdg_compress(
            np.concatenate([a[:TDG_K], b[:TDG_K]]),
            np.concatenate([a[TDG_K:], b[TDG_K:]]))
    raise AnalysisError(f"unknown sketch kind: {kind!r}")


# -------------------------------------------------------------- codec


def encode_sketch(kind: str, state: np.ndarray) -> str:
    """State -> self-describing word ``"<kind>:<version>:<b64>"``."""
    if kind == "hll":
        raw = np.ascontiguousarray(state, "<i4").tobytes()
    elif kind == "ddsk":
        idx = np.nonzero(np.asarray(state, np.int64))[0]
        raw = (np.asarray(idx, "<i4").tobytes()
               + np.asarray(state, "<i8")[idx].tobytes())
    elif kind == "topk":
        counts = np.asarray(state[:TOPK_M], np.int64)
        idx = np.nonzero(counts)[0]
        raw = (np.asarray(idx, "<i4").tobytes()
               + counts[idx].astype("<i8").tobytes()
               + np.asarray(state[TOPK_M:], np.int64)[idx]
               .astype("<i8").tobytes())
    elif kind == "tdg":
        raw = np.ascontiguousarray(state, "<f8").tobytes()
    else:
        raise AnalysisError(f"unknown sketch kind: {kind!r}")
    return (f"{kind}:{SKETCH_VERSION}:"
            + base64.b64encode(raw).decode("ascii"))


def decode_sketch(word: str) -> tuple[str, np.ndarray]:
    """Word -> (kind, state); validates the envelope and payload size."""
    parts = str(word).split(":", 2)
    if len(parts) != 3 or parts[0] not in _KINDS:
        raise AnalysisError(f"malformed sketch word: {word[:40]!r}")
    kind, ver, payload = parts
    if not ver.isdigit() or int(ver) != SKETCH_VERSION:
        raise AnalysisError(f"unsupported sketch version: {ver!r}")
    try:
        raw = base64.b64decode(payload, validate=True)
    except (ValueError, TypeError):
        raise AnalysisError(f"undecodable sketch payload ({kind})")
    if kind == "hll":
        if len(raw) != HLL_M * 4:
            raise AnalysisError("hll sketch payload has wrong size")
        return kind, np.frombuffer(raw, "<i4").astype(np.int32)
    if kind == "ddsk":
        if len(raw) % 12:
            raise AnalysisError("ddsk sketch payload has wrong size")
        n = len(raw) // 12
        idx = np.frombuffer(raw, "<i4", count=n)
        if n and not (0 <= int(idx.min()) and int(idx.max()) < DDSK_M):
            raise AnalysisError("ddsk sketch bucket index out of range")
        state = np.zeros(DDSK_M, np.int64)
        state[idx] = np.frombuffer(raw, "<i8", count=n, offset=4 * n)
        return kind, state
    if kind == "topk":
        if len(raw) % 20:
            raise AnalysisError("topk sketch payload has wrong size")
        n = len(raw) // 20
        idx = np.frombuffer(raw, "<i4", count=n)
        if n and not (0 <= int(idx.min()) and int(idx.max()) < TOPK_M):
            raise AnalysisError("topk sketch bucket index out of range")
        state = empty_state("topk")
        state[idx] = np.frombuffer(raw, "<i8", count=n, offset=4 * n)
        state[TOPK_M + idx] = np.frombuffer(raw, "<i8", count=n,
                                            offset=12 * n)
        return kind, state
    # tdg
    if len(raw) != 2 * TDG_K * 8:
        raise AnalysisError("tdg sketch payload has wrong size")
    return kind, np.frombuffer(raw, "<f8").astype(np.float64)


def merge_sketch_words(a: str, b: str) -> str:
    """The ``sketch_merge(col, excluded.col)`` law the upsert path
    applies: decode both, merge states, re-encode."""
    ka, sa = decode_sketch(a)
    kb, sb = decode_sketch(b)
    if ka != kb:
        raise AnalysisError(
            f"cannot merge sketch kinds {ka!r} and {kb!r}")
    return encode_sketch(ka, merge_states(ka, sa, sb))


# ----------------------------------------------------------- t-digest


def _tdg_k(q: float) -> float:
    """k1 scale function — fine near the tails, coarse in the middle."""
    return TDG_DELTA / (2.0 * math.pi) * math.asin(2.0 * q - 1.0)


def _tdg_compress(means: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Centroid soup -> fixed-slot state (<= TDG_K live centroids).
    Greedy merge in mean order, admitting a merge while the combined
    centroid's k1-span stays <= 1; a hard pass then guarantees the slot
    bound by folding the lightest adjacent pairs."""
    live = weights > 0
    means, weights = means[live], weights[live]
    out = np.zeros(2 * TDG_K, np.float64)
    if means.size == 0:
        return out
    order = np.argsort(means, kind="stable")
    means, weights = means[order], weights[order]
    total = float(weights.sum())
    om, ow = [], []
    cur_m, cur_w, q_left = float(means[0]), float(weights[0]), 0.0
    for m, w in zip(means[1:], weights[1:]):
        q0 = q_left / total
        q1 = min((q_left + cur_w + float(w)) / total, 1.0)
        if _tdg_k(q1) - _tdg_k(max(q0, 0.0)) <= 1.0:
            cur_m = (cur_m * cur_w + float(m) * float(w)) \
                / (cur_w + float(w))
            cur_w += float(w)
        else:
            om.append(cur_m)
            ow.append(cur_w)
            q_left += cur_w
            cur_m, cur_w = float(m), float(w)
    om.append(cur_m)
    ow.append(cur_w)
    while len(om) > TDG_K:
        pair = min(range(len(om) - 1), key=lambda i: ow[i] + ow[i + 1])
        w = ow[pair] + ow[pair + 1]
        om[pair] = (om[pair] * ow[pair] + om[pair + 1] * ow[pair + 1]) / w
        ow[pair] = w
        del om[pair + 1], ow[pair + 1]
    out[:len(om)] = om
    out[TDG_K:TDG_K + len(ow)] = ow
    return out


def tdg_from_values(values: np.ndarray) -> np.ndarray:
    """Raw values -> t-digest state (the host-side delta function: no
    fixed-shape device partial exists for this backend)."""
    v = np.asarray(values, np.float64)
    return _tdg_compress(v, np.ones(v.shape, np.float64))


def _tdg_quantile(state: np.ndarray, frac: float) -> tuple[float, bool]:
    means, weights = state[:TDG_K], state[TDG_K:]
    live = weights > 0
    means, weights = means[live], weights[live]
    if means.size == 0:
        return 0.0, False
    total = float(weights.sum())
    if means.size == 1 or total <= weights[0]:
        return float(means[0]), True
    # cumulative weight at centroid midpoints, interpolated between
    mid = np.cumsum(weights) - weights / 2.0
    target = frac * total
    if target <= mid[0]:
        return float(means[0]), True
    if target >= mid[-1]:
        return float(means[-1]), True
    hi = int(np.searchsorted(mid, target, side="left"))
    lo = hi - 1
    t = (target - mid[lo]) / (mid[hi] - mid[lo])
    return float(means[lo] + t * (means[hi] - means[lo])), True


# ----------------------------------------------------------- finalize


def finalize_sketch(kind: str, state: np.ndarray, param=None):
    """Stored state -> the user-facing aggregate value.  ``param`` is
    the query-time knob: percentile fraction (ddsk/tdg), k (topk)."""
    if kind == "hll":
        return hll_estimate(state), True
    if kind == "ddsk":
        total = int(state.sum())
        if total == 0:
            return 0.0, False
        rank = int(math.floor(float(param) * (total - 1)))
        cum = np.cumsum(state)
        vals = ddsk_bucket_values()
        return float(vals[int(np.searchsorted(cum, rank + 1,
                                              side="left"))]), True
    if kind == "topk":
        import json as _json
        counts, values = state[:TOPK_M], state[TOPK_M:]
        hot = np.nonzero(counts > 0)[0]
        if hot.size == 0:
            return None, False
        order = sorted(hot, key=lambda b: (-int(counts[b]),
                                           int(values[b])))
        k = int(param)
        return _json.dumps(
            [{"value": int(values[b]), "count": int(counts[b])}
             for b in order[:k]]), True
    if kind == "tdg":
        return _tdg_quantile(state, float(param))
    raise AnalysisError(f"unknown sketch kind: {kind!r}")
