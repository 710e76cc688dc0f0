"""Host-side exact group accumulator.

Shared by the hash_host GROUP BY strategy and the join executor: groups
are identified by the exact bit patterns of their key values (+ null
flags), so accumulation is exact for any key type and cardinality.  This
is the coordinator-merge half of the reference's two-stage aggregation
when pushdown isn't possible.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from citus_tpu_torch.planner.physical import PartialOp
from citus_tpu_torch.ops.scan_agg import _sentinel


def _canon_float_keys(kv_np: list) -> list:
    """Canonicalize float KEY values before their bit patterns become
    group identity: ``-0.0`` → ``0.0`` and every NaN payload → the
    canonical quiet NaN, matching the device path's ``_canon_keys``
    (ops/hash_agg.py) so both paths land SQL-equal values in ONE group."""
    out = []
    for v, m in kv_np:
        if np.issubdtype(v.dtype, np.floating):
            dt = v.dtype
            v = np.where(v == dt.type(0), dt.type(0.0), v)
            v = np.where(np.isnan(v), dt.type(np.nan), v)
        out.append((v, m))
    return out


class HostGroupAccumulator:
    def __init__(self, n_keys: int, partial_ops: list[PartialOp]):
        self.n_keys = n_keys
        self.partial_ops = partial_ops
        self._groups: dict[bytes, int] = {}
        self._key_vals: list[list] = []
        self._accs: list[list] = []

    def _new_group(self, kvs) -> int:
        idx = len(self._key_vals)
        self._key_vals.append(kvs)
        row = []
        for op in self.partial_ops:
            if op.kind in ("distinct", "collect_set"):
                row.append(set())
                continue
            if op.kind == "collect":
                row.append([])
                continue
            if op.kind == "hll":
                from citus_tpu_torch.planner.aggregates import HLL_M
                row.append(np.zeros(HLL_M, np.int32))
                continue
            if op.kind == "ddsk":
                from citus_tpu_torch.planner.aggregates import DDSK_M
                row.append(np.zeros(DDSK_M, np.int64))
                continue
            if op.kind == "topk":
                from citus_tpu_torch.planner.aggregates import TOPK_M
                row.append(np.zeros(TOPK_M, np.int64))
                continue
            if op.kind == "topkv":
                from citus_tpu_torch.planner.aggregates import (
                    TOPK_M, TOPK_SENTINEL,
                )
                row.append(np.full(TOPK_M, TOPK_SENTINEL, np.int64))
                continue
            dt = np.dtype(op.dtype)
            if op.kind in ("min", "max"):
                row.append(dt.type(_sentinel(op.kind, dt)))
            else:
                row.append(dt.type(0))
        self._accs.append(row)
        return idx

    def add_batch(self, mask: np.ndarray, keys: list, args: list) -> None:
        """mask: bool [n]; keys/args: [(values, valid)] with valid either a
        bool array or a python bool."""
        sel = np.nonzero(np.asarray(mask))[0]
        if sel.size == 0:
            return
        n_keys = self.n_keys

        def norm(v, valid):
            v = np.asarray(v)
            if v.ndim == 0:
                v = np.broadcast_to(v, (len(mask),))
            v = v[sel]
            if valid is True:
                m = np.ones(sel.size, bool)
            elif valid is False:
                m = np.zeros(sel.size, bool)
            else:
                m = np.asarray(valid)
                if m.ndim == 0:
                    m = np.broadcast_to(m, (len(mask),))
                m = m[sel]
            return v, m

        kv_np = _canon_float_keys([norm(v, m) for v, m in keys])
        arg_np = [norm(v, m) for v, m in args]

        if n_keys:
            enc = np.empty((sel.size, 2 * n_keys), np.int64)
            for ki, (kv, kvalid) in enumerate(kv_np):
                bits = kv.astype(np.float64).view(np.int64) \
                    if np.issubdtype(kv.dtype, np.floating) else kv.astype(np.int64)
                enc[:, 2 * ki] = np.where(kvalid, bits, 0)
                enc[:, 2 * ki + 1] = kvalid.astype(np.int64)
            uniq_rows, first_idx, inverse = np.unique(
                enc, axis=0, return_index=True, return_inverse=True)
        else:
            uniq_rows = np.zeros((1, 0), np.int64)
            first_idx = np.zeros(1, np.int64)
            inverse = np.zeros(sel.size, np.int64)

        L = uniq_rows.shape[0]
        local = []
        for op in self.partial_ops:
            dt = np.dtype(op.dtype)
            if op.kind in ("distinct", "collect_set"):
                v, ok = arg_np[op.arg_index]
                sets = [set() for _ in range(L)]
                for r in np.nonzero(ok)[0]:
                    sets[inverse[r]].add(v[r].item())
                local.append(sets)
                continue
            if op.kind == "hll":
                from citus_tpu_torch.planner.aggregates import (
                    HLL_M, hll_rho_buckets,
                )
                v, ok = arg_np[op.arg_index]
                v = np.asarray(v)
                bits = v.astype(np.float64).view(np.int64) \
                    if np.issubdtype(v.dtype, np.floating) else v.astype(np.int64)
                bucket, rho = hll_rho_buckets(np, bits, ok)
                flat = np.zeros(L * HLL_M, np.int32)
                nz = np.nonzero(ok)[0]
                if nz.size:
                    idx = inverse[nz].astype(np.int64) * HLL_M + bucket[nz]
                    np.maximum.at(flat, idx, rho[nz])
                local.append([flat[g * HLL_M:(g + 1) * HLL_M]
                              for g in range(L)])
                continue
            if op.kind == "ddsk":
                from citus_tpu_torch.planner.aggregates import (
                    DDSK_M, ddsk_bucket_indexes,
                )
                v, ok = arg_np[op.arg_index]
                bucket = ddsk_bucket_indexes(np, np.asarray(v))
                flat = np.zeros(L * DDSK_M, np.int64)
                nz = np.nonzero(ok)[0]
                if nz.size:
                    idx = inverse[nz].astype(np.int64) * DDSK_M + bucket[nz]
                    np.add.at(flat, idx, 1)
                local.append([flat[g * DDSK_M:(g + 1) * DDSK_M]
                              for g in range(L)])
                continue
            if op.kind in ("topk", "topkv"):
                from citus_tpu_torch.planner.aggregates import (
                    TOPK_M, TOPK_SENTINEL, topk_buckets,
                )
                v, ok = arg_np[op.arg_index]
                v64 = np.asarray(v).astype(np.int64)
                bucket = topk_buckets(np, v64)
                nz = np.nonzero(ok)[0]
                if op.kind == "topk":
                    flat = np.zeros(L * TOPK_M, np.int64)
                    if nz.size:
                        idx = inverse[nz].astype(np.int64) * TOPK_M \
                            + bucket[nz]
                        np.add.at(flat, idx, 1)
                else:
                    flat = np.full(L * TOPK_M, TOPK_SENTINEL, np.int64)
                    if nz.size:
                        idx = inverse[nz].astype(np.int64) * TOPK_M \
                            + bucket[nz]
                        np.maximum.at(flat, idx, v64[nz])
                local.append([flat[g * TOPK_M:(g + 1) * TOPK_M]
                              for g in range(L)])
                continue
            if op.kind == "collect":
                v, ok = arg_np[op.arg_index]
                lists = [[] for _ in range(L)]
                if op.extra_args:
                    extras = [arg_np[ei] for ei in op.extra_args]
                    for r in np.nonzero(ok)[0]:  # scan order preserved
                        item = (v[r].item(),) + tuple(
                            ev[r].item() if em[r] else None
                            for ev, em in extras)
                        lists[inverse[r]].append(item)
                else:
                    for r in np.nonzero(ok)[0]:
                        lists[inverse[r]].append(v[r].item())
                local.append(lists)
                continue
            if op.kind == "count":
                a = np.zeros(L, np.int64)
                ok = arg_np[op.arg_index][1] if op.arg_index >= 0 else np.ones(sel.size, bool)
                np.add.at(a, inverse, ok.astype(np.int64))
            elif op.kind == "sum":
                a = np.zeros(L, dt)
                v, ok = arg_np[op.arg_index]
                np.add.at(a, inverse, np.where(ok, v, 0).astype(dt))
            else:
                sent = dt.type(_sentinel(op.kind, dt))
                a = np.full(L, sent, dt)
                v, ok = arg_np[op.arg_index]
                upd = np.where(ok, v, sent).astype(dt)
                (np.minimum if op.kind == "min" else np.maximum).at(a, inverse, upd)
            local.append(a)

        if n_keys and self._bulk_merge_applies(local):
            # the batch's groups, one entry each, folded as arrays
            self._merge_bulk(uniq_rows, [(kv[first_idx], kvalid[first_idx])
                                         for kv, kvalid in kv_np], local)
            return
        for li in range(L):
            kb = uniq_rows[li].tobytes()
            gi = self._groups.get(kb)
            if gi is None:
                fi = first_idx[li]
                kvs = [(kv[fi], bool(kvalid[fi])) for kv, kvalid in kv_np]
                gi = self._new_group(kvs)
                self._groups[kb] = gi
            for pi, op in enumerate(self.partial_ops):
                if op.kind in ("distinct", "collect_set"):
                    self._accs[gi][pi] |= local[pi][li]
                elif op.kind in ("hll", "topkv"):
                    np.maximum(self._accs[gi][pi], local[pi][li],
                               out=self._accs[gi][pi])
                elif op.kind in ("ddsk", "topk"):
                    self._accs[gi][pi] += local[pi][li]
                elif op.kind == "collect":
                    self._accs[gi][pi].extend(local[pi][li])
                elif op.kind in ("sum", "count"):
                    self._accs[gi][pi] += local[pi][li]
                elif op.kind == "min":
                    self._accs[gi][pi] = min(self._accs[gi][pi], local[pi][li])
                else:
                    self._accs[gi][pi] = max(self._accs[gi][pi], local[pi][li])

    def merge_partials(self, mask: np.ndarray, keys: list,
                       partial_values: list, rows: np.ndarray) -> None:
        """Merge pre-aggregated per-group partial states (e.g. a device
        hash table) into the accumulator.  ``mask`` marks occupied slots;
        ``partial_values[i]`` aligns with ``self.partial_ops[i]``."""
        sel = np.nonzero(np.asarray(mask))[0]
        if sel.size == 0:
            return
        n_keys = self.n_keys
        kv_np = _canon_float_keys(
            [(np.asarray(v)[sel],
              np.asarray(m)[sel] if not isinstance(m, bool)
              else np.full(sel.size, m)) for v, m in keys])
        if n_keys:
            enc = np.empty((sel.size, 2 * n_keys), np.int64)
            for ki, (kv, kvalid) in enumerate(kv_np):
                bits = kv.astype(np.float64).view(np.int64) \
                    if np.issubdtype(kv.dtype, np.floating) else kv.astype(np.int64)
                enc[:, 2 * ki] = np.where(kvalid, bits, 0)
                enc[:, 2 * ki + 1] = kvalid.astype(np.int64)
        else:
            enc = np.zeros((sel.size, 0), np.int64)
        pv = [np.asarray(p)[sel] for p in partial_values]
        if n_keys and self._bulk_merge_applies(pv):
            self._merge_bulk(enc, kv_np, pv)
            return
        for r in range(sel.size):
            kb = enc[r].tobytes()
            gi = self._groups.get(kb)
            if gi is None:
                kvs = [(kv[r], bool(kvalid[r])) for kv, kvalid in kv_np]
                gi = self._new_group(kvs)
                self._groups[kb] = gi
            for pi, op in enumerate(self.partial_ops):
                val = pv[pi][r]
                if op.kind in ("sum", "count"):
                    self._accs[gi][pi] += val
                elif op.kind == "min":
                    self._accs[gi][pi] = min(self._accs[gi][pi], val)
                else:
                    self._accs[gi][pi] = max(self._accs[gi][pi], val)

    def _bulk_merge_applies(self, pv: list) -> bool:
        """The entries' states fold by array operations, bit for bit as
        the loops of ``merge_partials`` and ``add_batch`` fold them one
        entry at a time: sums and counts in the accumulator's dtype
        (``np.add.at`` adds in entry order), min / max of integers (no
        NaN, no signed zero)."""
        for op, v in zip(self.partial_ops, pv):
            dt = np.dtype(op.dtype)
            if op.kind not in ("sum", "count", "min", "max") \
                    or v.dtype != dt:
                return False
            if op.kind in ("min", "max") and dt.kind not in "iu":
                return False
        return True

    def _merge_bulk(self, enc: np.ndarray, kv_np: list, pv: list) -> None:
        """``merge_partials`` for entries ``_bulk_merge_applies`` accepts:
        one dictionary probe an entry (new groups numbered in order of
        first appearance, as the loop numbers them), then each state
        folded for every touched group at once."""
        kbs = np.ascontiguousarray(enc).view(
            np.dtype((np.void, enc.shape[1] * 8))).ravel().tolist()
        groups = self._groups
        base = len(self._key_vals)
        # new keys numbered in order of first appearance
        fresh = dict.fromkeys(kb for kb in kbs if kb not in groups)
        groups.update(zip(fresh, range(base, base + len(fresh))))
        touched, first, loc = np.unique(
            np.asarray([groups[kb] for kb in kbs], np.int64),
            return_index=True, return_inverse=True)
        old = touched[touched < base].tolist()
        new = first[touched >= base]  # each new group's first entry
        n_new = len(new)
        cols = []
        for pi, op in enumerate(self.partial_ops):
            dt = np.dtype(op.dtype)
            start = 0 if op.kind in ("sum", "count") \
                else _sentinel(op.kind, dt)
            acc = np.full(touched.size, start, dt)
            acc[:len(old)] = [self._accs[g][pi] for g in old]
            if op.kind in ("sum", "count"):
                np.add.at(acc, loc, pv[pi])
            else:
                (np.minimum if op.kind == "min" else np.maximum).at(
                    acc, loc, pv[pi])
            for j, g in enumerate(old):
                self._accs[g][pi] = acc[j]
            cols.append(acc[len(old):])
        if n_new:
            # keys as Python scalars: ``finalize`` builds them back into
            # arrays of the key's dtype, the same values and bits
            nr = new
            self._key_vals.extend(
                [list(kv) for kv in zip(*[
                    list(zip(kv[nr].tolist(), kvalid[nr].tolist()))
                    for kv, kvalid in kv_np])])
            self._accs.extend([list(row) for row in zip(*cols)]
                              if cols else [[] for _ in range(n_new)])

    def finalize(self, key_types: list, scalar: bool = False):
        """-> (key_arrays [(values, valid)], partials tuple).  ``scalar``
        forces one group even with zero input rows (global aggregates)."""
        G = len(self._key_vals)
        if G == 0:
            if not scalar:
                return [], None
            self._new_group([])
            G = 1
        key_arrays = []
        for ki, kt in enumerate(key_types):
            dt = kt.device_dtype
            vals = np.array([kvs[ki][0] for kvs in self._key_vals], dtype=dt)
            valid = np.array([kvs[ki][1] for kvs in self._key_vals], dtype=bool)
            key_arrays.append((vals, valid))
        partials = []
        for pi, op in enumerate(self.partial_ops):
            if op.kind in ("collect", "collect_set"):
                a = np.empty(G, object)
                for g in range(G):
                    a[g] = self._accs[g][pi]
                partials.append(a)
            elif op.kind in ("hll", "ddsk", "topk", "topkv"):
                partials.append(np.stack(
                    [self._accs[g][pi] for g in range(G)]))
            elif op.kind == "distinct":
                partials.append(np.array(
                    [len(self._accs[g][pi]) for g in range(G)], np.int64))
            else:
                partials.append(np.array(
                    [self._accs[g][pi] for g in range(G)],
                    dtype=np.dtype(op.dtype)))
        return key_arrays, tuple(partials)
