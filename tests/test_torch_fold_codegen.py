"""The generated row source of the fold and hash-insert kernels
(``ops/expr_codegen.py generate_fold_row``) held against the JAX package.

- Each plan's row source -- its WHERE's pass bit and each group key's
  and aggregate argument's (value, valid) -- compiles with g++ (the
  native codec's compiler) into a host harness through its
  ``fold_row_host`` entry, and is held against the reference's
  ``compile_expr``/``predicate_mask`` under ``jax.jit`` on the CPU over
  numpy-seeded columns with nulls, NaN, +-inf, +-0.0, zero divisors,
  INT64_MIN/MAX and float-to-int overflow.  Direct-mode keys are the
  reference's ``astype(int64)``, hash keys its ``_eval_keys`` (cast to
  the key dtype, canonical; the generated key is the cast, made
  canonical by the insert's ``key_bits``, which ``_canonical`` mirrors
  here).  Pass bits, validity and key values must be
  identical, and argument values where valid.  The exceptions are the
  float operations XLA's jit rewrites.  The generated code rounds every
  operation on its own, as numpy, JAX without jit and the port's torch
  namespace do (nvcc --fmad=false, g++ -ffp-contract=off): it divides a
  decimal by its scale's power of ten, or a float by a constant, where
  the jit multiplies by the reciprocal (1 ulp at most), and rounds a float product before a sum
  where the jit fuses them into one multiply-add (any distance near
  cancellation).  An argument holding either must equal the reference
  evaluated without jit bit for bit.  Its transcendental functions are
  XLA's own, with or without jit: the C library's (g++ here, CUDA's on
  the card) are held to 2 ulps of them, where XLA does not flush a
  subnormal result to 0.  The largest distances are printed.
- The plans: bench.py's Q1 and Q6, S1, H1, H2 and bench.py's hash
  GROUP BY, every variant of the Q1, Q6 and H families of chip_smoke.py
  phase 5 (one source each: parameters are launch arguments), and
  synthetic hash, direct and scalar plans whose keys and arguments hold
  every bound node kind of ROADMAP.md C1's predicate.
- Every SELECT of the port's differential tests that reaches a fold or
  an insert (test_torch_slice, _hash_agg, _megabatch, _sketch, _net) is
  accepted by the generator and its source compiles with g++: no query
  the card answered before the generator starts to raise.
- The generated kernels themselves are held against their plain
  versions on the card by test_torch_fold_card.py, which imports no JAX.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import citus_tpu as ct
import jax
import jax.numpy as jnp
import torch

import citus_tpu_torch as ctt
from citus_tpu.executor.executor import _hash_key_dtypes as ref_key_dtypes
from citus_tpu.executor.executor import encode_params as ref_encode
from citus_tpu.ops import hash_agg as ref_hash
from citus_tpu.planner import parse_sql as ref_parse
from citus_tpu.planner.auto_param import auto_parameterize as ref_auto_param
from citus_tpu.planner.bind import bind_select as ref_bind
from citus_tpu.planner.bound import _as_mask as ref_as_mask
from citus_tpu.planner.bound import compile_expr as ref_compile
from citus_tpu.planner.bound import param_env_names as ref_param_names
from citus_tpu.planner.bound import predicate_mask as ref_predicate_mask
from citus_tpu.planner.physical import plan_select as ref_plan_select
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor.executor import (
    _hash_key_dtypes, _param_dtypes, _params_env,
)
from citus_tpu_torch.ops import cuda_build
from citus_tpu_torch.ops import scan_agg_fold as saf
from citus_tpu_torch.ops.expr_codegen import generate_fold_row
from citus_tpu_torch.ops.filter_mask import _FmParams, _param_bits
from citus_tpu_torch.ops.hash_agg_insert import (
    insert_batched_plain, insert_plain,
)
from citus_tpu_torch.planner.bound import (
    BBinOp, BCast, BLiteral, BMathFunc, BScale, walk,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from torch_fold_cases import (  # noqa: E402
    N, PLANS, columns as _columns, load_data, port_plan, row_mask as _row_mask,
)

#: chip_smoke.py phase 5's families whose variants share one source
FAMILIES = {"Q1": ("lineitem", None), "Q6": ("lineitem", None),
            "H": ("lineitem", 100)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    """One data directory per data set, written by citus_tpu and opened
    by the port (one dictionary for both): bench.py's lineitem, the
    sketch table of chip_smoke.py, the predicate table of
    test_torch_projection.  -> {name: (reference, port)}."""
    out = {}
    for name in ("lineitem", "sketch", "t"):
        d = str(tmp_path_factory.mktemp(name))
        ref = ct.Cluster(d)
        load_data(name, ref)
        out[name] = (ref, ctt.Cluster(d, device="cpu"))
    yield out
    for ref, port in out.values():
        port.close()
        ref.close()


def _plan(ref_side: bool, cat, sql: str, direct_limit):
    """-> (plan, encoded parameters) as Cluster.execute plans ``sql``."""
    if not ref_side:
        return port_plan(cat, sql, direct_limit)
    bound = ref_bind(cat, ref_parse(sql)[0])
    values = None
    ap = ref_auto_param(bound)
    if ap is not None:
        bound, values = ap
    plan = ref_plan_select(cat, bound, direct_limit=direct_limit or 65536)
    return plan, ref_encode(cat, bound, values)


def _reference(rplan, key_dtypes, jit: bool):
    """The reference's filter, keys and used arguments of one plan as
    one function of (cols, valids, row_mask) -- params ride as trailing
    0-d columns, as its fused worker takes them."""
    e = rplan.bound
    ffn = None if e.filter is None else ref_compile(e.filter, jnp)
    kfns = [ref_compile(k, jnp) for k in e.group_keys]
    used = sorted({op.arg_index for op in rplan.partial_ops
                   if op.arg_index >= 0})
    afns = [ref_compile(rplan.agg_args[i], jnp) for i in used]
    names = rplan.scan_columns + ref_param_names(e.param_specs)

    def full(x, n):
        return jnp.broadcast_to(jnp.asarray(x), (n,))

    def run(cols, valids, row_mask):
        n = row_mask.shape[0]
        env = {k: (c, v) for k, c, v in zip(names, cols, valids)}
        mask = row_mask if ffn is None else \
            row_mask & ref_predicate_mask(jnp, ffn, env, row_mask)
        if key_dtypes is None:
            keys = []
            for kf in kfns:
                kv, kvalid = kf(env)
                kv = full(kv, n).astype(jnp.int64)
                keys.append((kv, full(ref_as_mask(jnp, kvalid, kv), n)))
        else:
            keys = [(full(kv, n), full(kvm, n)) for kv, kvm in
                    ref_hash._eval_keys(jnp, kfns, key_dtypes, env, (n,))]
        args = []
        for af in afns:
            v, valid = af(env)
            v = full(v, n)
            args.append((v, full(ref_as_mask(jnp, valid, v), n)))
        return full(mask, n), keys, args

    return jax.jit(run) if jit else run


class _Case:
    """One plan through both packages: the port's program and the
    reference's plan, functions and inputs per parameter set."""

    def __init__(self, catalogs, data: str, sql: str, direct_limit):
        ref, port = catalogs[data]
        self.rplan, rparams = _plan(True, ref.catalog, sql, direct_limit)
        self.pplan, pparams = _plan(False, port.catalog, sql, direct_limit)
        hashed = self.pplan.group_mode.kind == "hash_host"
        self.key_dtypes = _hash_key_dtypes(
            self.pplan, _params_env(self.pplan, pparams)) if hashed else None
        rkd = ref_key_dtypes(self.rplan, {}) if hashed else None
        self.prog = saf.FoldProgram.of_plan(
            self.pplan, _param_dtypes(self.pplan, pparams), self.key_dtypes)
        self.ref_jit = _reference(self.rplan, rkd, jit=True)
        self.ref_eager = _reference(self.rplan, rkd, jit=False)
        self.params = [(rparams, pparams)]


def _ref_outputs(case, fn, rparams, cols, valids, row_mask):
    names = case.rplan.scan_columns
    c = tuple(jnp.asarray(cols[n]) for n in names) + tuple(
        jnp.asarray(p) for p in rparams[0])
    v = tuple(jnp.asarray(valids[n]) for n in names) + tuple(
        jnp.asarray(p) for p in rparams[1])
    mask, keys, args = fn(c, v, jnp.asarray(row_mask))
    return (np.asarray(mask), [(np.asarray(a), np.asarray(b)) for a, b in keys],
            [(np.asarray(a), np.asarray(b)) for a, b in args])


@pytest.fixture(scope="module")
def cases(catalogs):
    out = {name: _Case(catalogs, *spec) for name, spec in PLANS.items()}
    for fam, (data, limit) in FAMILIES.items():
        variants = [sql for sql, _ in cs.families()[fam][1]]
        case = _Case(catalogs, data, variants[0], limit)
        ref, port = catalogs[data]
        for sql in variants[1:]:
            rp, rparams = _plan(True, ref.catalog, sql, limit)
            pp, pparams = _plan(False, port.catalog, sql, limit)
            other = saf.FoldProgram.of_plan(
                pp, _param_dtypes(pp, pparams), case.key_dtypes)
            # one generated source (one build) serves the whole family
            assert other.row.source == case.prog.row.source, fam
            case.params.append((rparams, pparams))
        out[f"family_{fam}"] = case
    return out


def _harness(sources: dict, d) -> ctypes.CDLL:
    """Every generated source, compiled by g++ into one host library
    with its ``fold_row_host`` renamed ``fold_row_host_<name>``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ (the native codec's compiler) on this machine")
    parts = ['#include "expr.cuh"']
    for name, src in sources.items():
        (d / f"{name}.inc").write_text(src)
        parts.append(f"#define fold_row_host fold_row_host_{name}\n"
                     f"namespace {name} {{\n#include \"{name}.inc\"\n}}\n"
                     "#undef fold_row_host\n")
    (d / "harness.cpp").write_text("\n".join(parts))
    so = d / "libharness.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", cuda_build.CSRC, "-I", str(d), "-o",
                    str(so), str(d / "harness.cpp")], check=True, timeout=600)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def harness(cases, tmp_path_factory):
    return _harness({name: c.prog.row.source for name, c in cases.items()},
                    tmp_path_factory.mktemp("fold_harness"))


def _host_run(lib, name, prog, cols, valids, penv, row_mask):
    """The g++-compiled row over numpy columns: -> (pass, [(key, valid)],
    [(argument, valid)])."""
    row = prog.row
    keep = []
    p = _FmParams()
    p.n = N
    p.row_mask = row_mask.ctypes.data
    for j, c in enumerate(row.columns):
        v = np.ascontiguousarray(cols[c])
        m = np.ascontiguousarray(valids[c])
        keep += [v, m]
        p.cols[j], p.valids[j] = v.ctypes.data, m.ctypes.data
    for j, t in enumerate(row.tables):
        a = np.ascontiguousarray(t)
        keep.append(a)
        p.tables[j], p.table_len[j] = a.ctypes.data, a.size
    for j, pname in enumerate(row.params):
        v, ok = penv[pname]
        p.params[j] = _param_bits(v, prog.param_dtypes[pname])
        p.param_valid[j] = 1 if bool(ok) else 0
    passed = np.zeros(N, np.uint8)
    keys = [(np.zeros(N, dt), np.zeros(N, np.uint8)) for dt in row.key_dtypes]
    args = [(np.zeros(N, dt), np.zeros(N, np.uint8)) for dt in row.arg_dtypes]

    def ptrs(arrays, ctype):
        return (ctype * max(1, len(arrays)))(*[a.ctypes.data for a in arrays])
    fn = getattr(lib, f"fold_row_host_{name}")
    fn.restype = None
    fn(ctypes.byref(p), passed.ctypes.data_as(ctypes.c_void_p),
       ptrs([k for k, _ in keys], ctypes.c_void_p),
       ptrs([m for _, m in keys], ctypes.c_void_p),
       ptrs([a for a, _ in args], ctypes.c_void_p),
       ptrs([m for _, m in args], ctypes.c_void_p))
    return (passed.astype(bool), [(k, m.astype(bool)) for k, m in keys],
            [(a, m.astype(bool)) for a, m in args])


def _canonical(v: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """A hash key as the insert's ``key_bits`` (csrc/hash_probe.cuh)
    stores it: NULL -> 0, -0.0 -> 0.0, every NaN -> the one quiet NaN."""
    v = np.where(valid, v, np.zeros((), v.dtype))
    if v.dtype.kind == "f":
        v = np.where(v == 0, np.zeros((), v.dtype), v)
        v = np.where(np.isnan(v), np.full((), np.nan, v.dtype), v)
    return v


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64 if a.itemsize == 8 else np.int32) \
        if a.dtype.kind == "f" else a.astype(np.int64)


#: transcendental functions: XLA computes them its own way (log2,
#: log10 and power within 2 ulps of the C library's, and results below
#: the smallest normal float flushed to 0)
_LIBM = ("exp", "ln", "log10", "log2", "power")
_LIBM_ULPS = 2


def _rewrite(n):
    """How XLA's jit departs, at node ``n``, from rounding each operation
    as the C library does, or None: "cast", a decimal-to-float cast (a
    division by a power of ten, which XLA turns into a product with its
    reciprocal) or another float division by a constant (as round(x, d)
    of a float divides by 10^d); "fma", a float product feeding a sum or
    difference (which XLA's CPU code fuses into one multiply-add, rounded
    once); "libm", a transcendental function."""
    if isinstance(n, BMathFunc):
        if n.name in _LIBM:
            return "libm"
        if n.name in ("round", "floor", "ceil", "trunc") \
                and n.operands[0].type.is_float and n.param[1]:
            return "cast"
    if isinstance(n, BCast) and n.operand.type.is_decimal \
            and n.type.is_float:
        return "cast"
    if isinstance(n, BBinOp) and n.type.is_float:
        if n.op == "/" and all(isinstance(x, (BLiteral, BCast, BScale))
                               for x in walk(n.right)):
            return "cast"
        if n.op in "+-" and any(isinstance(o, BBinOp) and o.op == "*"
                                and o.type.is_float
                                for o in (n.left, n.right)):
            return "fma"
    return None


def _xla_rewrites(e) -> set:
    return {r for r in map(_rewrite, walk(e)) if r is not None}


@pytest.mark.parametrize("name", list(PLANS) + [f"family_{f}"
                                                for f in FAMILIES])
def test_generated_fold_row_on_host_matches_jax(cases, harness, name):
    case = cases[name]
    prog = case.prog
    cols, valids = _columns(case.pplan, 7)
    row_mask = _row_mask()
    max_ulp = {}
    for rparams, pparams in case.params:
        penv = _params_env(case.pplan, pparams)
        got_pass, got_keys, got_args = _host_run(
            harness, name, prog, cols, valids, penv, row_mask)
        want_pass, want_keys, want_args = _ref_outputs(
            case, case.ref_jit, rparams, cols, valids, row_mask)
        eager = None
        np.testing.assert_array_equal(got_pass, want_pass)
        assert 0 < got_pass.sum() or name.startswith("family")
        for j, ((gv, gm), (wv, wm)) in enumerate(zip(got_keys, want_keys)):
            assert gv.dtype == wv.dtype, (j, gv.dtype, wv.dtype)
            np.testing.assert_array_equal(gm, wm, err_msg=f"key {j} valid")
            if prog.key_dtypes is None:
                at = wm
            else:
                at, gv = np.ones(N, bool), _canonical(gv, gm)
            np.testing.assert_array_equal(_bits(gv)[at], _bits(wv)[at],
                                          err_msg=f"key {j}")
        for j, ((gv, gm), (wv, wm)) in enumerate(zip(got_args, want_args)):
            assert gv.dtype == wv.dtype, (j, gv.dtype, wv.dtype)
            np.testing.assert_array_equal(gm, wm, err_msg=f"arg {j} valid")
            g, w = _bits(gv)[wm], _bits(wv)[wm]
            if np.array_equal(g, w):
                continue
            # the stated exceptions, where XLA departs from rounding
            # each operation as the C library does
            rewrites = _xla_rewrites(prog.exprs.args[j])
            assert rewrites, (j, prog.exprs.args[j])
            if "libm" not in rewrites:   # exact without jit
                if eager is None:
                    eager = _ref_outputs(case, case.ref_eager, rparams,
                                         cols, valids, row_mask)
                np.testing.assert_array_equal(g, _bits(eager[2][j][0])[wm])
            dist = np.abs(g - w)
            ulp = int(dist.max())
            if rewrites == {"cast"} and _rewrite(prog.exprs.args[j]):
                assert ulp <= 1, (j, ulp)   # the rewrite is the last step
            elif "fma" not in rewrites:
                flushed = (wv[wm] == 0) & (np.abs(gv[wm]) < np.finfo(
                    gv.dtype).tiny)
                assert ((dist <= _LIBM_ULPS) | flushed).all(), (j, ulp)
                ulp = int(dist[~flushed].max(initial=0))
            key = "+".join(sorted(rewrites))
            max_ulp[key] = max(max_ulp.get(key, 0), ulp)
    # the largest distance from jax.jit by kind of rewrite, for the
    # record (pytest -s)
    print(f"{name}: largest ulp distance from jax.jit {max_ulp}")


def test_literals_and_parameters_in_the_source(cases):
    """A literal argument and a validity of True/False are constants of
    the source, not [1] vectors; parameters are launch arguments, so a
    literal family shares one source; no column, parameter or table the
    row does not read is in its block."""
    src = cases["syn_scalar"].prog.row.source
    # sum(1): a literal argument, valid everywhere
    assert "= ((int64_t)0x0000000000000001ull);" in src
    assert "= true;" in src
    q6 = cases["family_Q6"].prog.row
    assert q6.params and len(cases["family_Q6"].params) == cs.Q_BATCH
    assert "0x0000000000000018ull" not in q6.source  # no quantity literal
    assert set(q6.columns) == {"l_shipdate", "l_discount", "l_quantity",
                               "l_extendedprice"}
    h = cases["h2"].prog.row
    assert h.hashed and h.key_dtypes == (np.dtype(np.int64),)
    # a hash key is the bare cast to its key dtype: the insert's key_bits
    # (csrc/hash_probe.cuh) alone makes it canonical
    syn = cases["syn_hash"].prog.row
    assert np.dtype(np.float64) in syn.key_dtypes
    for row in (h, syn):
        assert "?" not in "".join(line for line in row.source.splitlines()
                                  if line.lstrip().startswith("o.k"))
        assert all(f"::key_bits(v.k{j}, v.kv{j})" in row.source
                   for j in range(len(row.key_dtypes)))


def test_fold_row_states_its_key_count(cases):
    """The row source gives the fold its group keys as a constant
    (``FoldRow::kKeys``: with none, csrc/fold.cuh compiles no group id
    and no segment match), one per key the row evaluates."""
    counts = set()
    for name, case in cases.items():
        row = case.prog.row
        n = len(row.key_dtypes)
        assert f"static constexpr int kKeys = {n};" in row.source, name
        assert all(f"v.kv{j}" in row.source for j in range(n)), name
        counts.add(n)
    assert cases["family_Q6"].prog.row.source.count("kKeys = 0;") == 1
    assert 0 in counts and max(counts) > 1


def test_unsupported_value_raises_naming_b10(cases):
    """A dtype the generator has no C type for raises on the card's path;
    the kernel never falls back to eager tensor code there."""
    prog = cases["syn_direct"].prog
    bad = saf.FoldProgram(prog.exprs, prog.ops,
                          {**prog.col_dtypes, "b": np.uint8},
                          prog.param_dtypes,
                          domains=prog.domains, n_groups=prog.n_groups)
    with pytest.raises(UnsupportedFeatureError, match="B10"):
        bad.row
    h1 = cases["h1"].prog
    with pytest.raises(UnsupportedFeatureError, match="B10"):
        generate_fold_row(cases["h1"].pplan, h1.col_dtypes, h1.param_dtypes,
                          (np.uint16,))


# ---------------------- every fold and insert of the differential tests


def _recorded_sources(monkeypatch) -> dict:
    """Patch the plain versions of the fold and insert (what a CPU batch
    runs) to generate and record the source of every program they are
    given; -> the record (source -> program)."""
    from citus_tpu_torch.ops import hash_agg_insert as hai
    seen = {}

    def recording(module, name):
        plain = getattr(module, name)

        def record(prog, *args):
            seen[prog.row.source] = prog
            return plain(prog, *args)
        monkeypatch.setattr(module, name, record)
    for module, name in ((saf, "fold_plain"), (saf, "fold_batched_plain"),
                         (hai, "insert_plain"), (hai, "insert_batched_plain")):
        recording(module, name)
    return seen


def _differential_selects(module: str):
    """(loader, SELECTs) of one differential test module: its own table
    loaders and its module-level SELECT lists."""
    import importlib
    m = importlib.import_module(module)
    sqls = []
    for v in vars(m).values():
        items = v.values() if isinstance(v, dict) else \
            v if isinstance(v, (list, tuple)) else [v]
        for x in items:
            x = x[0] if isinstance(x, tuple) and x and isinstance(x[0], str) \
                else x
            if isinstance(x, str) and x.lstrip().upper().startswith("SELECT") \
                    and "citus_" not in x and "create_" not in x:
                sqls.append(x)
    return m, list(dict.fromkeys(sqls))


def _load_for(module: str, m, cl):
    """The tables ``module``'s differential tests query, through its own
    loaders."""
    if module == "test_torch_slice":
        m._load_lineitem(cl, 3000)
        m._load_events(cl)
    elif module == "test_torch_hash_agg":
        m._fill_groups(cl, 3000, 700)
        import test_torch_slice
        test_torch_slice._load_lineitem(cl, 3000)
        cl.execute("SET citus.direct_gid_limit = 100")
    elif module == "test_torch_megabatch":
        m._fill(cl)
    elif module == "test_torch_sketch":
        m._fill(cl, 3000)
    else:  # test_torch_net
        rng = np.random.default_rng(5)
        n = 3000
        m._load(cl, {"k": np.arange(n), "g": rng.integers(0, 50, n),
                     "v": rng.integers(0, 100, n),
                     "c": np.array(["w1", "w2", "w3"])[rng.integers(0, 3, n)],
                     "f": rng.normal(0, 1, n)})
        import test_torch_slice
        test_torch_slice._load_lineitem(cl, 3000)


@pytest.mark.parametrize("module", [
    "test_torch_slice", "test_torch_hash_agg", "test_torch_megabatch",
    "test_torch_sketch", "test_torch_net"])
def test_every_differential_fold_and_insert_select_generates(
        module, monkeypatch, tmp_path):
    """Each SELECT of ``module`` that reaches a fold or an insert runs on
    the port (CPU) with every program it builds generated; every source
    compiles with g++.  A SELECT the port refuses on the CPU is not one
    the card answered, and is skipped here."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    m, sqls = _differential_selects(module)
    seen = _recorded_sources(monkeypatch)
    cl = ctt.Cluster(str(tmp_path / "db"), device="cpu")
    try:
        _load_for(module, m, cl)
        ran = 0
        for sql in sqls:
            try:
                cl.execute(sql)
                ran += 1
            except UnsupportedFeatureError as e:
                assert "B10" not in str(e), (sql, e)
            except Exception as e:  # noqa: BLE001 - other tables' SQL
                if "B10" in str(e):
                    raise
    finally:
        cl.close()
    assert ran > 0 and seen, module
    _harness({f"s{i}": src for i, src in enumerate(seen)}, tmp_path)


def test_chip_smoke_fold_helpers_rehearse_on_cpu(tmp_path):
    """chip_smoke.py's phase-2 list of generated programs and its phase-3
    fold cases at a tiny size on the CPU, with the plain version on both
    sides: the main path's Q6 and Q1 calls (parameters in the block),
    the global-atomics case and the signed sums near cancellation held
    to their sum of magnitudes."""
    plans = cs.smoke_plans("cpu", str(tmp_path), n=4096)
    splans = cs.sketch_plans("cpu", str(tmp_path), n=4096)
    progs = cs.generated_programs(plans, splans, str(tmp_path))
    assert {p.hashed for p in progs} == {False, True}
    assert all("FoldRow" in p.row.source for p in progs)
    q6 = plans["fold_calls"]["q6"]
    assert q6[0].row.params and set(q6[4]) >= set(q6[0].row.params)
    cancel = cs.cancellation_case("cpu", 5003, 64, 3)
    cases = [(q6, False), (plans["fold_calls"]["q1"], False),
             (cs.synthetic_global_case("cpu", 5003, 4096, 2, False), False),
             (cancel, True)]
    for call, abs_sums in cases:
        assert cs.compare_fold("rehearsal", call, saf.scan_agg_fold,
                               saf.fold_plain, abs_sums) == 0.0
        assert cs.fold_bytes(call) > cs.fold_masks(call).numel()
        assert cs.fold_ops(call) > cs.fold_masks(call).numel()
    # a sum near cancellation is small against its sum of magnitudes
    regs = cs.clone_call(cancel)[1]
    saf.fold_plain(cancel[0], regs, cancel[2].clone(), *cancel[3:])
    mags = cs.fold_abs_sums(cancel)
    assert mags[0] is None
    assert (regs[1].abs()[1:] < 1e-3 * mags[1][1:]).all()


def _sector_bytes_numpy(a: np.ndarray, rows: np.ndarray) -> int:
    per = max(1, 32 // a.itemsize)
    hit = len(np.unique(np.flatnonzero(rows) // per))
    return min(a.nbytes, 32 * hit)


def test_chip_smoke_bounds_charge_the_sectors_the_rows_read(tmp_path):
    """chip_smoke.py's bounds charge of a column the WHERE reads the
    32-byte sectors holding a row whose WHERE the kernel evaluates, of
    every other column the sectors holding a row whose keys and
    arguments it evaluates (one that passes, or that some query's mask
    passes): Q6's price column only where its WHERE passes, and in the
    batched fold no column the WHERE alone reads."""
    rows = torch.zeros(40, dtype=torch.bool)
    rows[[0, 5, 39]] = True
    assert cs.sector_bytes(torch.zeros(40, dtype=torch.int64), rows) == 96
    assert cs.sector_bytes(torch.zeros(40, dtype=torch.bool), rows) == 40
    assert cs.sector_bytes(torch.zeros(40, dtype=torch.int32),
                           torch.zeros(40, dtype=torch.bool)) == 0
    plans = cs.smoke_plans("cpu", str(tmp_path), n=4096)
    prog, _, _, cols, params, mask = plans["fold_calls"]["q6"]
    passed = prog.plain_eval(cols, params, mask)[0].numpy()
    assert 0 < passed.sum() < 0.2 * len(passed)
    where = cs._column_names((prog.exprs.filter,))
    assert where == {"l_shipdate", "l_discount", "l_quantity"}
    want, full = 0, 0
    for c in prog.row.columns:
        for t in cols[c]:
            if t is not None:
                rows = mask.numpy() if c in where else passed
                want += _sector_bytes_numpy(t.numpy(), rows)
                full += t.numel() * t.element_size()
    got = cs.column_bytes(prog, cols, params, mask)
    assert got == want < full
    # the batched fold: Q6's keys and arguments read only l_extendedprice
    # and l_discount, where some query's mask is set
    bprog, _, _, bcols, masks = cs.batched_fold_call("cpu", plans, "Q6")
    anyq = masks.any(dim=0).numpy()
    want = sum(_sector_bytes_numpy(t.numpy(), anyq)
               for c in ("l_extendedprice", "l_discount")
               for t in bcols[c] if t is not None)
    assert cs.column_bytes(bprog, bcols, {}, masks) == want


def test_chip_smoke_hash_comparisons_rehearse_on_cpu():
    """chip_smoke.py's insert comparisons on the CPU with the plain
    version on both sides: the merged groups of table and spill, the
    float sums held to their groups' sums of magnitudes, for one table
    and for Q tables; the bound counts masks, spill and read sectors."""
    call = cs.adversarial_hash_call("cpu", 5003, 1000, 31, False)
    prog, table, cols, params, mask = call
    assert cs.compare_hash("rehearsal", call, insert_plain, insert_plain,
                           abs_sums=True) == 0.0
    assert cs.hash_bytes(call, 0) >= 2 * mask.numel()
    masks = torch.stack([mask, ~mask]).contiguous()
    from citus_tpu_torch.ops.hash_agg import record_views
    # two copies of the table, the records of a slot side by side
    tables = record_views(table.records.unsqueeze(1).repeat(1, 2, 1),
                          [v.dtype for v in table.key_values],
                          [p.dtype for p in table.partials])
    bcall = (prog, tables, cols, masks)
    err, kt, ks = cs.compare_hash_batched(
        "rehearsal", bcall, insert_batched_plain, insert_batched_plain,
        abs_sums=True)
    assert err == 0.0
    assert (kt.rows.sum(dim=1) + ks.sum(dim=1)).tolist() == \
        masks.sum(dim=1).tolist()
    assert cs.hash_bytes(bcall, 0) >= 2 * masks.numel()


@pytest.mark.parametrize("records, tries", [
    ([(4, 0, 6, {}, 4, "")], 1),
    ([(0, 0, 0, {}, 4, ""), (0, 0, 6, {}, 4, ""), (2, 0, 6, {}, 4, ""),
      (4, 1, 6, {"k": 1}, 4, "")], 4),
    ([(0, 0, 0, {}, 4, "")] * cs.PROFILE_TRIES, None),
])
def test_chip_smoke_profiled_runs_retry_lost_records(monkeypatch, records,
                                                     tries):
    """chip_smoke.py phase 4 measures a warm query's device kernels from
    the first profiled run whose record holds every kernel of the port
    its wrappers launched: a run with none (nothing recorded, or copies
    alone) or some of them is run again in a session idling longer at
    each end, and the phase fails when no run of PROFILE_TRIES has them
    all.  A complete record is returned with its other kernels, which
    the phase then refuses."""
    left = list(records)
    pauses, said = [], []

    def fake(cl, sql, pause):
        pauses.append(pause)
        return left.pop(0)
    monkeypatch.setattr(cs, "device_kernels", fake)
    monkeypatch.setattr(cs, "say", lambda *parts: said.append(parts))
    if tries is None:
        with pytest.raises(AssertionError, match="not measured"):
            cs.profiled_kernels(None, "S1", "SELECT 1")
    else:
        got = cs.profiled_kernels(None, "S1", "SELECT 1")
        assert got == records[-1][:4] + (tries, "")
    assert not left
    # every lost run is printed; the first session is short, the rest long
    assert len(said) == len(records) - (tries is not None)
    assert pauses == [cs.PROFILE_PAUSE_S] + \
        [cs.PROFILE_RETRY_PAUSE_S] * (len(records) - 1)
    assert cs.PROFILE_RETRY_PAUSE_S > cs.PROFILE_PAUSE_S
