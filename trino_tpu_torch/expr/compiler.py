"""Expression compiler: RowExpression trees -> one eager torch page program.

Reference analog: ``sql/gen/ExpressionCompiler.java`` + ``PageFunctionCompiler``
producing a fused filter+project ``PageProcessor``
(``operator/project/PageProcessor.java``). There the kernel is runtime JVM
bytecode; in the JAX engine a jitted trace; here a tree of closures that
runs torch ops eagerly on the page's device (the JAX engine's planning,
LUT and dictionary logic, unchanged).

TPU-first string strategy: device lanes only ever hold int32 dictionary
codes. Any operation that needs string *values* (comparisons, LIKE,
substr, length, casts) is planned at construction time into a **LUT slot**:
a host-computed per-code lookup table, gathered on device. Rank LUTs give
total order for string comparisons (both sides ranked in a merged value
space), so <,=,> compile to integer compares on device.

Null semantics: every value is (raw, null-mask); functions default to
RETURN_NULL_ON_NULL; AND/OR implement three-valued logic; CASE/IF/COALESCE
evaluate all branches (vector select) — SQL-visible behavior matches lazy
evaluation because kernels never trap (div-by-zero lanes are masked). A
``None`` null mask means "no NULLs".

Template parameters (``ParamRef``) and the batched (vmapped) path are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..block import DevicePage, Dictionary, padded_size, storage_dtype
from ..types import TrinoError, TypeError_
from . import functions as F
from .ir import Call, InputRef, Literal, ParamRef, RowExpression


def param_raw(t: T.Type, v):
    """Python literal value -> raw numpy scalar under type ``t`` (the
    JAX engine's literal lowering, so both engines see the same bits)."""
    if t.is_decimal:
        return np.int64(t.to_raw(v))
    if t == T.BOOLEAN:
        return np.bool_(v)
    return np.asarray(v, dtype=t.storage)[()]


def pad_lut(raw: np.ndarray, minimum: int = 8) -> np.ndarray:
    """Pad a host LUT to a power-of-two length (at least ``minimum``), as
    the JAX engine does: an empty pool still yields a LUT every code-0
    gather can read."""
    cap = padded_size(max(len(raw), 1), minimum=minimum)
    arr = np.zeros(cap, dtype=raw.dtype)
    arr[:len(raw)] = raw
    return arr


def _is_string(t: T.Type) -> bool:
    return t.is_string


def _is_pooled(t: T.Type) -> bool:
    """Strings AND arrays: device codes into a host value pool."""
    return getattr(t, "is_pooled", False)


class _StrView:
    """Plan-time view of a string-valued expression: codes come from one
    input channel (or a literal), values are a host transform chain over
    that channel's dictionary."""

    __slots__ = ("channel", "transform", "literal")

    def __init__(self, channel=None, transform=None, literal=None):
        self.channel = channel            # int | None
        self.transform = transform        # Callable[[str|None], str|None] | None
        self.literal = literal            # str | None (literal value)

    def values(self, dicts) -> List[Optional[str]]:
        if self.channel is None:
            return [self.literal]
        d = dicts[self.channel]
        vals = d.values if d is not None else []
        if self.transform is None:
            return list(vals)
        return [None if v is None else self.transform(v) for v in vals]


class _Slot:
    """A LUT input to the page program: fill(dicts) -> np array."""

    __slots__ = ("fill", "dtype")

    def __init__(self, fill, dtype):
        self.fill = fill
        self.dtype = dtype


class PageProcessor:
    """Compiled filter+projections over a fixed input-channel layout."""

    def __init__(self, input_types: List[T.Type],
                 projections: List[RowExpression],
                 filter_expr: Optional[RowExpression] = None):
        self.input_types = list(input_types)
        self.projections = list(projections)
        self.filter_expr = filter_expr
        self.slots: List[_Slot] = []
        #: (slot, pool uids, pool sizes, device) -> uploaded LUT tensor
        self._lut_cache: Dict = {}
        self._dict_cache: Dict = {}
        # id(projection expr) -> dicts->Dictionary, for string-valued
        # expressions whose output pool is built per process() call
        # (string CASE/COALESCE merge branch pools)
        self._out_dict_resolvers: Dict[int, object] = {}
        exprs = ([filter_expr] if filter_expr is not None else []) \
            + self.projections
        # plan every expression once (assigns slots deterministically)
        self._plans = [self._plan(e) for e in exprs]
        if filter_expr is not None:
            self._filter_plan = self._plans[0]
            self._proj_plans = self._plans[1:]
        else:
            self._filter_plan = None
            self._proj_plans = self._plans

    @property
    def output_types(self) -> List[T.Type]:
        return [p.type for p in self.projections]

    # ------------------------------------------------------------------
    # planning: turn the IR into a tree of eval closures + LUT slots

    def _new_slot(self, fill, dtype) -> int:
        self.slots.append(_Slot(fill, dtype))
        return len(self.slots) - 1

    def _str_view(self, e: RowExpression) -> _StrView:
        """Build the host-value view of a string expression."""
        if isinstance(e, InputRef):
            return _StrView(channel=e.channel)
        if isinstance(e, Literal):
            return _StrView(literal=e.value)
        if isinstance(e, Call):
            if e.name == "$cast" and _is_pooled(e.args[0].type):
                base = self._str_view(e.args[0])
                if isinstance(e.type, T.CharType):
                    # CHAR(n) semantics: fixed length, space padded —
                    # comparisons then naturally ignore trailing-space
                    # differences between CHARs of equal length
                    n = e.type.length
                    prev = base.transform

                    def pad(s, _n=n, _prev=prev):
                        if s is None:
                            return None
                        if _prev is not None:
                            s = _prev(s)
                            if s is None:
                                return None
                        return s[:_n].ljust(_n)

                    if base.channel is None:
                        return _StrView(literal=pad(base.literal))
                    return _StrView(channel=base.channel, transform=pad)
                return base  # varchar(n) <-> varchar: code passthrough
            fn = F.get_function(e.name)
            if fn.str_transform is None:
                raise TypeError_(
                    f"string function {e.name} not usable on device path")
            base = None
            extra: List = []
            for a in e.args:
                if _is_pooled(a.type):
                    if base is not None:
                        # two string columns: only literal second arg works
                        v = self._str_view(a)
                        if v.channel is not None:
                            raise TypeError_(
                                f"{e.name} over two string columns "
                                "not supported on device yet")
                        extra.append(("lit", v.literal))
                    else:
                        base = self._str_view(a)
                        extra.append(("base", None))
                elif isinstance(a, Literal):
                    extra.append(("lit", a.value))
                else:
                    raise TypeError_(
                        f"{e.name}: non-literal argument {a!r} requires "
                        "per-row host work")
            if base is None:  # all-literal string expr
                args = [v for k, v in extra if k == "lit"]
                return _StrView(literal=fn.str_transform(*args))
            prev = base.transform

            def chained(s, _fn=fn.str_transform, _extra=tuple(extra), _prev=prev):
                if s is None:
                    return None
                if _prev is not None:
                    s = _prev(s)
                    if s is None:
                        return None
                args = [s if k == "base" else v for k, v in _extra]
                return _fn(*args)

            if base.channel is None:
                # literal base with extra args: fold on the host now
                return _StrView(literal=chained(base.literal))
            return _StrView(channel=base.channel, transform=chained)
        raise TypeError_(f"unsupported string expression {e!r}")

    def _string_nulls_plan(self, e: RowExpression):
        """Null mask of a string expression = nulls of its base channel."""
        v = self._str_view(e)
        if v.channel is None:
            is_null = v.literal is None
            return lambda env: (env["true"] if is_null else None)
        ch = v.channel
        return lambda env: env["nulls"][ch]

    def _plan_str_codes(self, e: RowExpression):
        """Device codes of a string expression (transform-invariant)."""
        v = self._str_view(e)
        if v.channel is None:
            return lambda env: _scalar(env, np.int32(0))
        ch = v.channel
        return lambda env: env["cols"][ch]

    def _plan_rank_pair(self, a: RowExpression, b: RowExpression):
        """Rank LUT slots for comparing two string expressions in a merged
        value space."""
        va, vb = self._str_view(a), self._str_view(b)

        def fill_pair(dicts):
            from ..block import _rank_sort_key

            xs = va.values(dicts)
            ys = vb.values(dicts)
            # None-totalizing key: composite pool entries may hold
            # nested NULLs that plain comparison cannot order
            merged = sorted(set(v for v in xs + ys if v is not None),
                            key=_rank_sort_key)
            rank = {v: i for i, v in enumerate(merged)}
            ra = np.asarray([rank.get(v, -1) for v in xs], dtype=np.int32)
            rb = np.asarray([rank.get(v, -1) for v in ys], dtype=np.int32)
            return ra, rb

        sa = self._new_slot(lambda dicts: fill_pair(dicts)[0], np.int32)
        sb = self._new_slot(lambda dicts: fill_pair(dicts)[1], np.int32)
        return sa, sb

    def _plan(self, e: RowExpression) -> Callable:
        """Returns eval(env) -> (raw, null|None). env has cols/nulls/luts."""
        if isinstance(e, InputRef):
            ch = e.channel
            return lambda env: (env["cols"][ch], env["nulls"][ch])

        if isinstance(e, Literal):
            t = e.type
            if e.value is None:
                z = np.zeros((), dtype=t.storage if t.storage is not None
                             else np.bool_)
                return lambda env: (_scalar(env, z), env["true"])
            if _is_pooled(t):
                # projected pooled literal (string/array): code 0 into
                # the one-entry dictionary process() resolves via
                # _str_view
                return lambda env: (_scalar(env, np.int32(0)), None)
            raw = self._literal_raw(e)
            return lambda env: (_scalar(env, raw), None)

        if isinstance(e, ParamRef):
            raise TrinoError("template parameters are not ported to the "
                             "torch engine yet", "NOT_SUPPORTED")

        assert isinstance(e, Call), e
        name = e.name

        if name in ("$and", "$or"):
            plans = [self._plan(a) for a in e.args]
            is_and = name == "$and"

            def ev(env):
                raws, nulls = [], []
                for p in plans:
                    r, n = p(env)
                    raws.append(r)
                    nulls.append(n)
                acc_r, acc_n = raws[0], nulls[0]
                for r, n in zip(raws[1:], nulls[1:]):
                    if is_and:
                        new_r = acc_r & r
                        # null unless any operand is definitively false
                        a_false = _def_false(acc_r, acc_n)
                        b_false = _def_false(r, n)
                        new_n = _or_null(acc_n, n, a_false | b_false)
                    else:
                        new_r = acc_r | r
                        a_true = _def_true(acc_r, acc_n)
                        b_true = _def_true(r, n)
                        new_n = _or_null(acc_n, n, a_true | b_true)
                    acc_r, acc_n = new_r, new_n
                return acc_r, acc_n

            return ev

        if name == "$not":
            p = self._plan(e.args[0])
            return lambda env: ((lambda rn: (~rn[0], rn[1]))(p(env)))

        if name == "$is_null":
            arg = e.args[0]
            if _is_pooled(arg.type):
                if isinstance(arg, Call) and arg.name in (
                        "$if", "$case", "$coalesce"):
                    # nested string select: its own plan computes nulls
                    p = self._plan(arg)
                    return lambda env: (_nz(env, p(env)[1]), None)
                np_ = self._string_nulls_plan(arg)
                return lambda env: (_nz(env, np_(env)), None)
            p = self._plan(arg)

            def ev(env):
                _, n = p(env)
                return _nz(env, n), None

            return ev

        if name == "$coalesce":
            rt = e.type
            if _is_pooled(rt):
                # coalesce = first-non-null CASE over the branch views
                conds = [Call(T.BOOLEAN, "$not",
                              (Call(T.BOOLEAN, "$is_null", (a,)),))
                         for a in e.args[:-1]]
                return self._plan_string_select(e, conds,
                                                list(e.args[:-1]),
                                                e.args[-1])
            plans = [self._plan(a) for a in e.args]

            def ev(env):
                r_acc, n_acc = plans[0](env)
                r_acc = F.coerce_raw(r_acc, e.args[0].type, rt)
                n_acc = _nz(env, n_acc)
                for p, a in zip(plans[1:], e.args[1:]):
                    r, n = p(env)
                    r = F.coerce_raw(r, a.type, rt)
                    r_acc = torch.where(n_acc, r, r_acc)
                    n_acc = n_acc & _nz(env, n)
                return r_acc, n_acc

            return ev

        if name in ("$if", "$case"):
            return self._plan_case(e)

        if name == "$in":
            return self._plan_in(e)

        if name == "$between":
            x, lo, hi = e.args
            desugared = Call(T.BOOLEAN, "$and", (
                Call(T.BOOLEAN, "ge", (x, lo)),
                Call(T.BOOLEAN, "le", (x, hi))))
            return self._plan(desugared)

        if name == "$like":
            return self._plan_like(e)

        if name == "$cast":
            return self._plan_cast(e)

        if name.startswith("$extract_"):
            fn = F.get_function(name)
            return self._plan_default_call(e, fn)

        fn = F.get_function(name)

        # pooled-value comparisons (strings, arrays) -> rank LUTs
        if name in ("eq", "ne", "lt", "le", "gt", "ge") and \
                any(_is_pooled(a.type) for a in e.args):
            return self._plan_string_cmp(e)

        # host pool functions -> LUT gather. Pooled OUTPUT dispatches on
        # str_transform first: a function registered with both (array
        # subscript) is a transform when its result is pooled, a scalar
        # LUT otherwise.
        if fn.str_transform is not None and _is_pooled(e.type):
            # pool-valued: consumed by an outer pool op or projection;
            # evaluation happens via _str_view there. Standalone eval
            # means a projection — handled in process(); return codes.
            codes = self._plan_str_codes(e)
            nulls = self._string_nulls_plan(e)
            return lambda env: (codes(env), _nz(env, nulls(env)))
        if fn.str_scalar is not None and _is_pooled(e.args[0].type):
            return self._plan_str_scalar(e, fn)

        return self._plan_default_call(e, fn)

    # -- helpers -------------------------------------------------------

    def _literal_raw(self, e: Literal):
        return param_raw(e.type, e.value)

    def _plan_default_call(self, e: Call, fn: F.ScalarFunction):
        plans = [self._plan(a) for a in e.args]
        arg_types = [a.type for a in e.args]
        rt = e.type
        kern = fn.kernel
        if kern is None:
            raise TypeError_(f"function {fn.name} has no device kernel")

        def ev(env):
            raws, nulls = [], []
            for p in plans:
                r, n = p(env)
                raws.append(r)
                nulls.append(n)
            out = kern(raws, arg_types, rt)
            null = None
            for n in nulls:
                if n is not None:
                    null = n if null is None else (null | n)
            return out, null

        return ev

    def _plan_string_cmp(self, e: Call):
        a, b = e.args
        sa, sb = self._plan_rank_pair(a, b)
        ca = self._plan_str_codes(a)
        cb = self._plan_str_codes(b)
        na = self._string_nulls_plan(a)
        nb = self._string_nulls_plan(b)
        op = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
              "le": torch.le, "gt": torch.gt, "ge": torch.ge}[e.name]

        def ev(env):
            ra = env["luts"][sa][ca(env)]
            rb = env["luts"][sb][cb(env)]
            raw = op(ra, rb)
            null = _merge_nulls(na(env), nb(env))
            return raw, null

        return ev

    def _plan_str_scalar(self, e: Call, fn: F.ScalarFunction):
        base = e.args[0]
        view = self._str_view(base)
        lit_args = []
        for a in e.args[1:]:
            if not isinstance(a, Literal):
                raise TypeError_(
                    f"{e.name}: non-literal extra args unsupported")
            lit_args.append(a.value)
        rt = e.type

        memo: Dict = {}

        def results(dicts):
            # ONE host pass shared by both slots (value + None mask)
            d0 = dicts[view.channel] if view.channel is not None else None
            key = (d0.uid if d0 is not None else 0, len(d0 or ())) \
                if view.channel is not None else ("lit",)
            hit = memo.get(key)
            if hit is None:
                vals = view.values(dicts)
                hit = [None if v is None
                       else fn.str_scalar(v, *lit_args) for v in vals]
                memo.clear()
                memo[key] = hit
            return hit

        def fill(dicts):
            res = results(dicts)
            out = np.zeros(len(res), dtype=rt.storage)
            for i, r in enumerate(res):
                if r is not None:
                    out[i] = r
            return out

        def fill_none(dicts):
            # a None RESULT on a non-null input is SQL NULL (e.g. array
            # subscript out of range)
            return np.asarray([r is None for r in results(dicts)],
                              dtype=np.bool_)

        slot = self._new_slot(fill, rt.storage)
        none_slot = self._new_slot(fill_none, np.bool_)
        codes = self._plan_str_codes(base)
        nulls = self._string_nulls_plan(base)

        def ev(env):
            c = codes(env)
            null = _merge_nulls(nulls(env), env["luts"][none_slot][c])
            return env["luts"][slot][c], null

        return ev

    def _plan_like(self, e: Call):
        base, pattern = e.args[0], e.args[1]
        escape = e.args[2].value if len(e.args) > 2 else None
        if not isinstance(pattern, Literal):
            raise TypeError_("LIKE pattern must be a literal")
        rx = F.like_to_regex(pattern.value, escape)
        view = self._str_view(base)

        def fill(dicts):
            vals = view.values(dicts)
            return np.asarray(
                [v is not None and rx.match(v) is not None for v in vals],
                dtype=np.bool_)

        slot = self._new_slot(fill, np.bool_)
        codes = self._plan_str_codes(base)
        nulls = self._string_nulls_plan(base)

        def ev(env):
            return env["luts"][slot][codes(env)], _nz_opt(nulls(env))

        return ev

    def _plan_in(self, e: Call):
        value, items = e.args[0], e.args[1:]
        if _is_string(value.type):
            lits = []
            for it in items:
                if not isinstance(it, Literal):
                    raise TypeError_("string IN list must be literals")
                lits.append(it.value)
            view = self._str_view(value)
            # SQL three-valued IN: a NULL list item makes non-matches
            # NULL (never FALSE) — so NOT IN over a list with NULL keeps
            # nothing
            has_null_item = any(v is None for v in lits)
            lit_set = set(v for v in lits if v is not None)

            def fill(dicts):
                vals = view.values(dicts)
                return np.asarray([v in lit_set for v in vals],
                                  dtype=np.bool_)

            slot = self._new_slot(fill, np.bool_)
            codes = self._plan_str_codes(value)
            nulls = self._string_nulls_plan(value)

            def ev(env):
                matched = env["luts"][slot][codes(env)]
                null = _nz_opt(nulls(env))
                if has_null_item:
                    null = _nz(env, null) | ~matched
                return matched, null

            return ev

        ors = Call(T.BOOLEAN, "$or", tuple(
            Call(T.BOOLEAN, "eq", (value, it)) for it in items))
        return self._plan(ors if len(items) > 1
                          else Call(T.BOOLEAN, "eq", (value, items[0])))

    def _plan_case(self, e: Call):
        """$if(cond, then, else) / $case(c1, v1, c2, v2, ..., default)."""
        args = list(e.args)
        if e.name == "$if":
            conds, vals = [args[0]], [args[1]]
            default = args[2] if len(args) > 2 else Literal(e.type, None)
        else:
            pairs, default = args[:-1], args[-1]
            conds = pairs[0::2]
            vals = pairs[1::2]
        rt = e.type
        if _is_pooled(rt):
            return self._plan_string_select(e, conds, vals, default)
        cond_plans = [self._plan(c) for c in conds]
        val_plans = [self._plan(v) for v in vals]
        def_plan = self._plan(default)
        val_types = [v.type for v in vals] + [default.type]

        def ev(env):
            out_r, out_n = def_plan(env)
            out_r = F.coerce_raw(out_r, val_types[-1], rt)
            out_n = _nz(env, out_n)
            # first-match-wins: walk branches in order with a 'taken' mask
            out = None
            out_null = None
            taken = env["false"]
            for cp, vp, vt in zip(cond_plans, val_plans, val_types[:-1]):
                cr, cn = cp(env)
                fires = cr & ~_nz(env, cn) & ~taken
                vr, vn = vp(env)
                vr = F.coerce_raw(vr, vt, rt)
                if out is None:
                    out = torch.where(fires, vr, out_r)
                    out_null = torch.where(fires, _nz(env, vn), out_n)
                else:
                    out = torch.where(fires, vr, out)
                    out_null = torch.where(fires, _nz(env, vn), out_null)
                taken = taken | fires
            if out is None:
                return out_r, out_n
            return out, out_null

        return ev

    def _plan_string_select(self, e: Call, conds, vals, default):
        """String-valued CASE/IF/COALESCE: branch values come from
        different channels (different code pools), so each branch gets a
        per-process remap LUT into ONE merged output pool, and the
        select itself is plain code arithmetic on device. The merged
        pool is append-only and cached per input-pool state, so codes
        stay stable across pages."""
        def decompose(expr: Call):
            args = list(expr.args)
            if expr.name == "$if":
                return ([args[0]], [args[1]],
                        args[2] if len(args) > 2
                        else Literal(expr.type, None))
            if expr.name == "$coalesce":
                cs = [Call(T.BOOLEAN, "$not",
                           (Call(T.BOOLEAN, "$is_null", (a,)),))
                      for a in args[:-1]]
                return cs, args[:-1], args[-1]
            pairs, dflt = args[:-1], args[-1]
            return pairs[0::2], pairs[1::2], dflt

        def collect_views(expr, out):
            """Leaf _StrViews of a possibly-nested select tree."""
            if isinstance(expr, Call) and expr.name in ("$if", "$case",
                                                        "$coalesce"):
                cs, vs, dflt = decompose(expr)
                for v in vs:
                    collect_views(v, out)
                collect_views(dflt, out)
            else:
                out.append(self._str_view(expr))
            return out

        all_views: List[_StrView] = []
        for v in vals:
            collect_views(v, all_views)
        collect_views(default, all_views)
        key_channels = tuple(sorted({v.channel for v in all_views
                                     if v.channel is not None}))
        token = ("strsel", len(self._out_dict_resolvers), id(e))

        def merged_dict(dicts) -> Dictionary:
            key = (token,) + tuple(
                (dicts[c].uid if dicts[c] is not None else 0,
                 len(dicts[c]) if dicts[c] is not None
                 else 0) for c in key_channels)
            d = self._dict_cache.get(key)
            if d is None:
                d = Dictionary()
                self._dict_cache[key] = d
            return d

        self._out_dict_resolvers[id(e)] = merged_dict

        from ..block import null_pool_value as _npv

        null_pool_value = _npv(e.type)

        def code_slot(view: _StrView) -> int:
            if view.channel is None:
                def fill_lit(dicts, _v=view.literal):
                    m = merged_dict(dicts)
                    code = m.code(null_pool_value if _v is None else _v)
                    return np.asarray([code], dtype=np.int32)

                return self._new_slot(fill_lit, np.int32)

            def fill(dicts, _view=view):
                m = merged_dict(dicts)
                vals_ = _view.values(dicts)
                arr = [m.code(null_pool_value if v is None else v)
                       for v in vals_]
                # empty input pool: one dead entry keeps the gather legal
                return np.asarray(arr or [m.code(null_pool_value)],
                                  dtype=np.int32)

            return self._new_slot(fill, np.int32)

        def plan_branch(expr):
            """eval(env) -> (merged-pool code, null mask) for one branch
            value — recursing through nested selects into the SAME
            merged pool."""
            if isinstance(expr, Call) and expr.name in ("$if", "$case",
                                                        "$coalesce"):
                cs, vs, dflt = decompose(expr)
                cond_ps = [self._plan(c) for c in cs]
                val_ps = [plan_branch(v) for v in vs]
                dflt_p = plan_branch(dflt)

                def sel_ev(env, _c=cond_ps, _v=val_ps, _d=dflt_p):
                    out, out_null = _d(env)
                    taken = env["false"]
                    for cp, vp in zip(_c, _v):
                        cr, cn = cp(env)
                        fires = cr & ~_nz(env, cn) & ~taken
                        vr, vn = vp(env)
                        out = torch.where(fires, vr, out)
                        out_null = torch.where(fires, vn, out_null)
                        taken = taken | fires
                    return out, out_null

                return sel_ev
            view = self._str_view(expr)
            slot = code_slot(view)
            if view.channel is None:
                is_null = view.literal is None

                def lit_ev(env, _s=slot, _n=is_null):
                    return env["luts"][_s][0], \
                        env["true"] if _n else env["false"]

                return lit_ev
            codes = self._plan_str_codes(expr)
            nulls = self._string_nulls_plan(expr)

            def col_ev(env, _s=slot, _c=codes, _n=nulls):
                return env["luts"][_s][_c(env)], _nz(env, _n(env))

            return col_ev

        cond_plans = [self._plan(c) for c in conds]
        branch_plans = [plan_branch(v) for v in vals]
        default_plan = plan_branch(default)

        def ev(env):
            out, out_null = default_plan(env)
            taken = env["false"]
            for cp, vp in zip(cond_plans, branch_plans):
                cr, cn = cp(env)
                fires = cr & ~_nz(env, cn) & ~taken
                vr, vn = vp(env)
                out = torch.where(fires, vr, out)
                out_null = torch.where(fires, vn, out_null)
                taken = taken | fires
            return out, out_null

        return ev

    def _plan_cast(self, e: Call):
        src = e.args[0]
        st, rt = src.type, e.type
        if _is_pooled(st) and _is_pooled(rt):
            codes = self._plan_str_codes(src)
            nulls = self._string_nulls_plan(src)
            return lambda env: (codes(env), _nz_opt(nulls(env)))
        if _is_string(st):
            # varchar -> fixed width via parse LUT
            view = self._str_view(src)

            def parse(v):
                if rt == T.DATE:
                    from datetime import date
                    y, m, d = v.split("-")
                    return (date(int(y), int(m), int(d)) -
                            __import__("datetime").date(1970, 1, 1)).days
                if rt.is_decimal:
                    return rt.to_raw(v)
                if rt == T.BOOLEAN:
                    return v.strip().lower() in ("true", "t", "1")
                return rt.storage.type(v.strip())

            def fill(dicts):
                vals = view.values(dicts)
                out = np.zeros(len(vals), dtype=rt.storage)
                for i, v in enumerate(vals):
                    if v is not None:
                        out[i] = parse(v)
                return out

            slot = self._new_slot(fill, rt.storage)
            codes = self._plan_str_codes(src)
            nulls = self._string_nulls_plan(src)
            return lambda env: (env["luts"][slot][codes(env)],
                                _nz_opt(nulls(env)))
        if _is_string(rt):
            raise TypeError_("cast to varchar needs host materialization")
        p = self._plan(src)

        day_us = 86_400_000_000

        def days(micros):
            return torch.div(micros, day_us,
                             rounding_mode="floor").to(torch.int32)

        def ev(env):
            r, n = p(env)
            if st.is_timestamp_tz or rt.is_timestamp_tz:
                from .tz import device_utc_to_wall, device_wall_to_utc

                if st.is_timestamp_tz and rt.is_timestamp_tz:
                    return r, n  # same instant; zone is type metadata
                if st.is_timestamp_tz and rt == T.TIMESTAMP:
                    return device_utc_to_wall(r, st.zone), n
                if st.is_timestamp_tz and rt == T.DATE:
                    return days(device_utc_to_wall(r, st.zone)), n
                if st == T.TIMESTAMP and rt.is_timestamp_tz:
                    # wall clock interpreted in the target's zone
                    return device_wall_to_utc(r, rt.zone), n
                if st == T.DATE and rt.is_timestamp_tz:
                    wall = r.to(torch.int64) * day_us
                    return device_wall_to_utc(wall, rt.zone), n
            if st == T.DATE and rt == T.TIMESTAMP:
                return r.to(torch.int64) * day_us, n
            if st == T.TIMESTAMP and rt == T.DATE:
                return days(r), n
            if st == T.BOOLEAN and rt != T.BOOLEAN:
                return r.to(storage_dtype(rt)), n
            return F.coerce_raw(r, st, rt), n

        return ev

    # ------------------------------------------------------------------
    # runtime

    def _fill_luts(self, dicts, device) -> Tuple:
        # keys use Dictionary.uid, never id(): a freed pool's ADDRESS can
        # be reused by a new same-length pool — uid cannot alias
        luts = []
        for i, slot in enumerate(self.slots):
            key = (i, tuple(d.uid for d in dicts if d is not None),
                   tuple(len(d) for d in dicts if d is not None), device)
            lut = self._lut_cache.get(key)
            if lut is None:
                lut = torch.from_numpy(pad_lut(slot.fill(dicts))).to(device)
                self._lut_cache[key] = lut
                if len(self._lut_cache) > 256:
                    self._lut_cache.clear()
            luts.append(lut)
        return tuple(luts)

    def _run(self, cols, nulls, valid, luts):
        device = valid.device
        env = {"cols": cols, "nulls": nulls, "luts": luts, "device": device,
               "true": torch.tensor(True, device=device),
               "false": torch.tensor(False, device=device)}
        new_valid = valid
        if self._filter_plan is not None:
            r, n = self._filter_plan(env)
            keep = r & ~_nz(env, n)
            new_valid = valid & keep
        out_cols, out_nulls = [], []
        for plan, proj in zip(self._proj_plans, self.projections):
            r, n = plan(env)
            out_cols.append(_lanes(r.to(storage_dtype(proj.type)), valid))
            out_nulls.append(_lanes(_nz(env, n), valid))
        return out_cols, out_nulls, new_valid

    def process(self, dpage: DevicePage) -> DevicePage:
        dicts = dpage.dictionaries
        luts = self._fill_luts(dicts, dpage.device)
        cols, nulls, valid = self._run(dpage.cols, dpage.nulls, dpage.valid,
                                       luts)
        return DevicePage(self.output_types, cols, nulls, valid,
                          self._resolve_out_dicts(dicts))

    def _resolve_out_dicts(self, dicts) -> List[Optional[Dictionary]]:
        """Output dictionary per projection (pool identity must be
        stable across pages)."""
        out_dicts = []
        for j, proj in enumerate(self.projections):
            if _is_pooled(proj.type):
                resolver = self._out_dict_resolvers.get(id(proj))
                if resolver is not None:
                    out_dicts.append(resolver(dicts))
                    continue
                view = self._str_view(proj)
                if view.channel is None:
                    key = (j, "lit")
                    d = self._dict_cache.get(key)
                    if d is None:
                        d = Dictionary([view.literal])
                        self._dict_cache[key] = d
                    out_dicts.append(d)
                elif view.transform is None:
                    # plain column passthrough: SAME pool object, so code
                    # spaces stay stable across pages (group-by/join
                    # correctness depends on pool identity)
                    out_dicts.append(dicts[view.channel])
                else:
                    base = dicts[view.channel]
                    key = (j, base.uid, len(base))
                    d = self._dict_cache.get(key)
                    if d is None:
                        from ..block import null_pool_value as _npv_fn

                        vals = view.values(dicts)
                        npv = _npv_fn(proj.type)
                        # pool must stay code-aligned with the input pool
                        # (derived values may repeat), so no dedup here
                        d = Dictionary.aligned(
                            [npv if v is None else v for v in vals])
                        self._dict_cache[key] = d
                    out_dicts.append(d)
            else:
                out_dicts.append(None)
        return out_dicts


# ---------------------------------------------------------------------------
# small helpers


def _scalar(env, v) -> torch.Tensor:
    """A numpy scalar as a 0-d tensor on the page's device."""
    return torch.as_tensor(v, device=env["device"])


def _lanes(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``x`` as one contiguous lane per row (a 0-d literal broadcasts)."""
    if x.shape == valid.shape:
        return x
    return x.expand(valid.shape).contiguous()


def _nz(env, n):
    return env["false"] if n is None else n


def _nz_opt(n):
    return None if n is None else n


def _merge_nulls(a, b):
    a, b = _nz_opt(a), _nz_opt(b)
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _def_false(r, n):
    return ~r if n is None else ~r & ~n


def _def_true(r, n):
    return r if n is None else r & ~n


def _or_null(na, nb, definitive):
    n = _merge_nulls(na, nb)
    return None if n is None else n & ~definitive
