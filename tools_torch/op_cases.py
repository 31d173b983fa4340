"""Seeded cases of Paddle's top-level op surface, one or more per public
op of the JAX op table (``PUBLIC_OPS["paddle_tpu"]``), for two callers:

* ``tests/test_torch_ops.py`` runs each case through the JAX package
  and through the port on the CPU and compares them;
* ``chip_smoke.py``'s `ops_card` phase runs each through the port on
  the card and on the CPU and compares those.

numpy only: a case makes its arguments from a `RandomState`, as numpy
arrays (a list of arrays where the op takes a list), numbers, strings
and shapes; each caller turns the arrays into its tensors.

A case is ``Case(name, op, make, kind, tol, check, written)``:

* `op` the top-level name it calls (a name may carry several cases,
  ``"scatter#dup"``);
* `kind`: ``"value"`` (outputs compared within `tol`), ``"random"``
  (outputs compared by shape and held to `check`, a support test on the
  port's own draw, and to the case's law in `LAWS`: `moment_z`),
  ``"decomp"`` (a decomposition with sign or order freedom: `check`
  returns the error of its invariants, such as the reconstruction,
  which must be within `tol`);
* `written`: for an in-place form, the index of the argument it writes
  into and must return.

A random case's law (`LAWS`, `moment_z`): the case's parameters
repeated `DRAWS` times (or its call made `CALLS` times), and the sample
mean and variance of every drawn element against the law's, within
`Z_LIMIT` standard errors (the variance's from the law's fourth central
moment); where the law has no moments (Cauchy) or the draw is a choice
(multinomial, nucleus sampling), the frequency of each outcome.
"""
from __future__ import annotations

import collections

import numpy as np

Case = collections.namedtuple(
    "Case", "name op make kind tol check written")

TOL = 1e-5


def _f(rs, *shape, lo=None, hi=None):
    if lo is None:
        return rs.randn(*shape).astype(np.float32)
    return rs.uniform(lo, hi, shape).astype(np.float32)


def _i(rs, lo, hi, *shape):
    return rs.randint(lo, hi, shape).astype(np.int64)


def _b(rs, *shape):
    return rs.rand(*shape) > 0.5


def _spd(rs, n):
    a = rs.randn(n, n).astype(np.float32)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _cond(rs, n):
    return (rs.randn(n, n) * 0.3 + 2 * np.eye(n)).astype(np.float32)


def _ties(rs, *shape):
    return rs.randint(0, 4, shape).astype(np.float32)


def _with_nan(rs, *shape):
    x = _f(rs, *shape)
    x.flat[::4] = np.nan
    return x


def _cplx(rs, *shape):
    return (rs.randn(*shape) + 1j * rs.randn(*shape)).astype(np.complex64)


UNARY = {   # op: the input's range (None: N(0, 1))
    "abs": None, "ceil": None, "cos": None, "cosh": None, "deg2rad": None,
    "erf": None, "exp": None, "expm1": None, "floor": None, "frac": None,
    "i0": None, "i0e": None, "i1": None, "i1e": None, "neg": None,
    "rad2deg": None, "round": None, "sgn": None, "sigmoid": None,
    "sign": None, "signbit": None, "sin": None, "sinh": None,
    "square": None, "tan": (-1.2, 1.2), "tanh": None, "trunc": None,
    "atan": None, "asinh": None, "stanh": None, "angle": None,
    "real": None, "isfinite": None, "isinf": None, "isnan": None,
    "log": (0.2, 3), "log10": (0.2, 3), "log1p": (0.2, 3),
    "log2": (0.2, 3), "rsqrt": (0.2, 3), "sqrt": (0.2, 3),
    "reciprocal": (0.2, 3), "digamma": (0.5, 3), "lgamma": (0.5, 3),
    "gammaln": (0.5, 3), "acos": (-0.9, 0.9), "asin": (-0.9, 0.9),
    "atanh": (-0.9, 0.9), "erfinv": (-0.9, 0.9), "acosh": (1.1, 3),
    "logit": (0.05, 0.95),
}

BINARY = {  # op: (x range, y range)
    "add": (None, None), "subtract": (None, None),
    "multiply": (None, None), "divide": (None, (0.5, 2)),
    "maximum": (None, None), "minimum": (None, None), "fmax": (None, None),
    "fmin": (None, None), "atan2": (None, None), "hypot": (None, None),
    "logaddexp": (None, None), "nextafter": (None, None),
    "pow": ((0.2, 3), (-1, 2)), "floor_divide": (None, (0.5, 2)),
    "mod": (None, (0.5, 2)), "remainder": (None, (0.5, 2)),
    "floor_mod": (None, (0.5, 2)),
}

COMPARE = ("equal", "not_equal", "greater_equal", "greater_than",
           "less_equal", "less_than")
LOGICAL = ("logical_and", "logical_or", "logical_xor")
BITWISE = ("bitwise_and", "bitwise_or", "bitwise_xor")


def _range(rs, spec, *shape):
    return _f(rs, *shape) if spec is None else _f(rs, *shape, lo=spec[0],
                                                  hi=spec[1])


# ----------------------------------------------------------- checks
def _np(x):
    return np.asarray(x)


def _support(pred):
    """A random case's check: 0 when `pred(out, args)` holds, else 1."""
    def check(out, args, ref):
        return 0.0 if pred(out, args) else 1.0
    return check


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _qr_check(out, args, ref):
    q, r = (_np(o) for o in out)
    x = args[0]
    return max(_rel(q @ r, x), _rel(q.T @ q, np.eye(q.shape[1])),
               _rel(np.abs(r), np.abs(_np(ref[1]))))


def _svd_check(out, args, ref):
    u, s, v = (_np(o) for o in out)
    return max(_rel((u * s) @ v.T, args[0]), _rel(s, _np(ref[1])))


def _eigh_check(out, args, ref):
    w, v = (_np(o) for o in out)
    return max(_rel(w, _np(ref[0])), _rel(args[0] @ v, v * w))


def _eig_check(out, args, ref):
    w, v = (_np(o) for o in out)
    return max(_rel(np.sort_complex(w), np.sort_complex(_np(ref[0]))),
               _rel(args[0] @ v, v * w))


def _eigvals_check(out, args, ref):
    return _rel(np.sort_complex(_np(out)), np.sort_complex(_np(ref)))


def _pca_check(out, args, ref):
    u, s, v = (_np(o) for o in out)
    return max(_rel(s, _np(ref[1])), _rel(np.abs(u), np.abs(_np(ref[0]))),
               _rel(np.abs(v), np.abs(_np(ref[2]))))


def _is_perm(out, args):
    return sorted(_np(out).tolist()) == list(range(args[0]))


def _top_p(out, args):
    probs, ids = _np(out[0]), _np(out[1])
    x = args[0]
    picked = np.take_along_axis(x, ids, -1)
    return np.allclose(probs, picked) and (ids >= 0).all() \
        and (ids < x.shape[-1]).all()


# ----------------------------------------------------------- laws
DRAWS = 20000      # draws of each parameter in a law check
CALLS = 2000       # calls, for an op whose draw is its whole output
Z_LIMIT = 5.0


def _z(x, mean, var, mu4=None):
    """Largest |z| of the sample mean of `x` (draws along axis 0) against
    the law's `mean`, and, where the law's fourth central moment `mu4` is
    given, of the mean square deviation from `mean` against `var`.  A
    statistic whose law has no spread must equal its mean exactly."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    mean, var = np.asarray(mean, np.float64), np.asarray(var, np.float64)
    stats = [(x.mean(0), mean, var / n)]
    if mu4 is not None:
        stats.append((((x - mean) ** 2).mean(0), var,
                      (np.asarray(mu4, np.float64) - var ** 2) / n))
    z = 0.0
    for got, want, v in stats:
        d = np.abs(got - want)
        with np.errstate(divide="ignore", invalid="ignore"):
            zs = np.where(v > 0, d / np.sqrt(np.maximum(v, 1e-300)),
                          np.where(d == 0, 0.0, np.inf))
        z = max(z, float(zs.max()))
    return z


def _freq_z(choice, q):
    """`choice` [n, ...] drawn outcomes, `q` [..., K] their law: the
    largest |z| of each outcome's frequency."""
    return max(_z(choice == k, q[..., k], q[..., k] * (1 - q[..., k]))
               for k in range(q.shape[-1]))


def _uniform(x, lo, hi):
    w = hi - lo
    return _z(x, (lo + hi) / 2, w * w / 12, w ** 4 / 80)


def _normal(x, mean, std):
    return _z(x, mean, std ** 2, 3 * std ** 4)


def _ints(x, k):
    """Uniform on 0 .. k-1."""
    return _z(x, (k - 1) / 2, (k * k - 1) / 12,
              (k * k - 1) * (3 * k * k - 7) / 240)


def _bernoulli(x, p):
    q = p * (1 - p)
    return _z(x, p, q, q * (1 - 3 * q))


def _binomial(x, n, p):
    q = n * p * (1 - p)
    return _z(x, n * p, q, q * (1 + 3 * (n - 2) * p * (1 - p)))


def _gamma(x, a):
    return _z(x, a, a, 3 * a * (a + 2))


def _dirichlet(x, alpha):
    """Each coordinate is Beta(a, a0 - a)."""
    a = alpha.astype(np.float64)
    a0 = a.sum(-1, keepdims=True)
    b = a0 - a
    var = a * b / (a0 ** 2 * (a0 + 1))
    kurt = 6 * ((a - b) ** 2 * (a0 + 1) - a * b * (a0 + 2)) / (
        a * b * (a0 + 2) * (a0 + 3))
    return _z(x, a / a0, var, var ** 2 * (3 + kurt))


def _without_replacement(probs):
    """The law of the first and second draw without replacement
    proportional to `probs` [..., K]: [2, ..., K]."""
    p = probs.astype(np.float64) / probs.sum(-1, keepdims=True)
    second = p * (p[..., :, None] / (1 - p[..., :, None]) * (
        1 - np.eye(p.shape[-1]))).sum(-2)
    return p, second


def _nucleus(x, ps):
    """Nucleus sampling's law: the smallest prefix of descending values
    whose mass before the token is under p (the top token always),
    renormalised."""
    x = x.astype(np.float64)
    order = np.argsort(-x, -1, kind="stable")
    sp = np.take_along_axis(x, order, -1)
    keep = np.cumsum(sp, -1) - sp < ps.reshape(-1, 1)
    keep[..., 0] = True
    q = np.zeros_like(x)
    np.put_along_axis(q, order, np.where(keep, sp, 0.0), -1)
    return q / q.sum(-1, keepdims=True)


def _tile(a, n):
    return np.broadcast_to(a, (n,) + np.shape(a)).copy()


def _tiled(*idx):
    """A draw that repeats the arguments at `idx` along a new axis 0."""
    def draw(args, kw, n):
        return tuple(_tile(a, n) if i in idx else a
                     for i, a in enumerate(args)), kw, 1
    return draw


def _rows(args, kw, n):
    """A draw for ops that take 2-D inputs: the rows of `args[0]` (and
    of a per-row `args[1]`) repeated n times, [n * rows, K]."""
    x = _tile(args[0], n).reshape(-1, args[0].shape[-1])
    rest = tuple(_tile(a, n).reshape(-1) for a in args[1:])
    return (x,) + rest, kw, 1


def _shape_n(i):
    """A draw for creation ops: shape argument `i` gains a leading n."""
    def draw(args, kw, n):
        args = list(args)
        args[i] = [n] + list(args[i])
        return tuple(args), kw, 1
    return draw


def _calls(args, kw, n):
    return args, kw, CALLS


def _wide(args, kw, n):
    """`create_parameter`: the trailing axis n times wider (its fan-in,
    the first axis, unchanged)."""
    shape = list(args[0])
    return ([shape[0]] + [shape[1] * n],) + tuple(args[1:]), kw, 1


LAWS = {   # case name: (draw, law(out, args, kw))
    "bernoulli": (_tiled(0), lambda o, a, kw: _bernoulli(o[0], a[0])),
    "binomial": (_tiled(0, 1),
                 lambda o, a, kw: _binomial(o[0], a[0], a[1])),
    "dirichlet": (_tiled(0), lambda o, a, kw: _dirichlet(o[0], a[0])),
    "multinomial": (_rows, lambda o, a, kw: max(
        _freq_z(o[0].reshape((-1,) + a[0].shape[:-1] + (2,))[..., c], q)
        for c, q in enumerate(_without_replacement(a[0])))),
    "poisson": (_tiled(0), lambda o, a, kw: _z(o[0], a[0], a[0],
                                               a[0] * (1 + 3 * a[0]))),
    "standard_gamma": (_tiled(0), lambda o, a, kw: _gamma(o[0], a[0])),
    "randint": (_shape_n(2), lambda o, a, kw: _ints(o[0] - a[0],
                                                    a[1] - a[0])),
    "randperm": (_calls, lambda o, a, kw: _ints(o[0], a[0])),
    "uniform": (_shape_n(0), lambda o, a, kw: _uniform(o[0], kw["min"],
                                                       kw["max"])),
    "gaussian": (_shape_n(0), lambda o, a, kw: _normal(o[0], kw["mean"],
                                                       kw["std"])),
    "create_parameter": (_wide, lambda o, a, kw: _uniform(
        o[0].reshape(-1), -np.sqrt(6 / a[0][0]), np.sqrt(6 / a[0][0]))),
    "top_p_sampling": (_rows, lambda o, a, kw: _freq_z(
        o[1].reshape((-1,) + a[0].shape[:-1]), _nucleus(a[0], a[1]))),
    "uniform_": (_tiled(0), lambda o, a, kw: _uniform(o[0], kw["min"],
                                                      kw["max"])),
    "normal_": (_tiled(0), lambda o, a, kw: _normal(o[0], kw["mean"],
                                                    kw["std"])),
    "exponential_": (_tiled(0), lambda o, a, kw: _z(
        o[0], 1 / kw["lam"], kw["lam"] ** -2.0, 9 * kw["lam"] ** -4.0)),
    "cauchy_": (_tiled(0), lambda o, a, kw: max(
        _z(o[0] < 0, 0.5, 0.25), _z(np.abs(o[0]) < 1, 0.5, 0.25))),
    "geometric_": (_tiled(0), lambda o, a, kw: _z(
        o[0], 1 / kw["probs"], (1 - kw["probs"]) / kw["probs"] ** 2,
        ((1 - kw["probs"]) / kw["probs"] ** 2) ** 2
        * (9 + kw["probs"] ** 2 / (1 - kw["probs"])))),
}


def moment_z(case, args, kw, call, n=DRAWS):
    """The random case's law check: `call(args, kw)` runs the op (on the
    caller's device) and returns its outputs as a list of numpy arrays;
    it runs on the case's parameters repeated `n` times, or `CALLS`
    times over, and the largest |z| of the law's statistics is
    returned."""
    draw, law = LAWS[case.name]
    big, bkw, calls = draw(args, kw, n)
    if calls == 1:
        out = call(big, bkw)
    else:
        outs = [call(big, bkw) for _ in range(calls)]
        out = [np.stack(o) for o in zip(*outs)]
    return law(out, args, kw)


# ----------------------------------------------------------- the table
def _table():
    T = {}

    def add(name, make, kind="value", tol=TOL, check=None, written=None,
            op=None):
        T[name] = (op or name.split("#")[0], make, kind, tol, check,
                   written)

    for n, spec in UNARY.items():
        add(n, lambda rs, s=spec: ((_range(rs, s, 3, 4),), {}))
    add("logit#eps", lambda rs: ((_f(rs, 3, 4, lo=0, hi=1),),
                                 dict(eps=0.1)), op="logit")
    for n, (sx, sy) in BINARY.items():
        add(n, lambda rs, a=sx, b=sy: ((_range(rs, a, 3, 4),
                                         _range(rs, b, 3, 4)), {}))
    add("add#bcast", lambda rs: ((_f(rs, 3, 4), _f(rs, 4)), {}), op="add")
    add("multiply#scalar", lambda rs: ((_f(rs, 3, 4), 2.5), {}),
        op="multiply")
    add("fmax#nan", lambda rs: ((_with_nan(rs, 3, 4), _f(rs, 3, 4)), {}),
        op="fmax")
    for n in COMPARE:
        add(n, lambda rs: ((_ties(rs, 3, 4), _ties(rs, 3, 4)), {}))
    for n in LOGICAL:
        add(n, lambda rs: ((_b(rs, 3, 4), _b(rs, 3, 4)), {}))
    add("logical_not", lambda rs: ((_b(rs, 3, 4),), {}))
    for n in BITWISE:
        add(n, lambda rs: ((_i(rs, -50, 50, 3, 4), _i(rs, -50, 50, 3, 4)),
                           {}))
    add("bitwise_not", lambda rs: ((_i(rs, -50, 50, 3, 4),), {}))
    add("gcd", lambda rs: ((_i(rs, 1, 60, 3, 4), _i(rs, 1, 60, 3, 4)), {}))
    add("lcm", lambda rs: ((_i(rs, 1, 30, 3, 4), _i(rs, 1, 30, 3, 4)), {}))
    add("heaviside", lambda rs: ((np.array([[-1, 0, 2.0], [0, 3, -2]],
                                           np.float32), _f(rs, 2, 3)), {}))
    add("ldexp", lambda rs: ((_f(rs, 3, 4), _i(rs, -3, 4, 3, 4)), {}))
    add("lerp", lambda rs: ((_f(rs, 3, 4), _f(rs, 3, 4), 0.3), {}))
    add("clip", lambda rs: ((_f(rs, 3, 4), -0.5, 0.7), {}))
    add("scale", lambda rs: ((_f(rs, 3, 4), 2.0, 1.0), {}))
    add("scale#before", lambda rs: ((_f(rs, 3, 4), 2.0, 1.0, False), {}),
        op="scale")
    add("nan_to_num", lambda rs: ((np.array([np.nan, np.inf, -np.inf, 1.5],
                                            np.float32),), dict(nan=0.5)))
    add("polygamma", lambda rs: ((_f(rs, 3, 4, lo=0.5, hi=3), 1), {}),
        tol=1e-4)
    add("multigammaln", lambda rs: ((_f(rs, 3, 4, lo=2, hi=4), 3), {}),
        tol=1e-4)
    add("frexp", lambda rs: ((_f(rs, 3, 4, lo=-50, hi=50),), {}))
    add("polar", lambda rs: ((_f(rs, 3, lo=0.5, hi=2), _f(rs, 3)), {}))
    add("conj", lambda rs: ((_cplx(rs, 3, 2),), {}))
    add("imag", lambda rs: ((_cplx(rs, 3, 2),), {}))
    add("complex", lambda rs: ((_f(rs, 3), _f(rs, 3)), {}))
    add("as_complex", lambda rs: ((_f(rs, 3, 2),), {}))
    add("as_real", lambda rs: ((_cplx(rs, 3),), {}))
    add("isclose", lambda rs: ((_ties(rs, 3, 4), _ties(rs, 3, 4)), {}))
    add("allclose", lambda rs: ((_ties(rs, 3, 4), _ties(rs, 3, 4)), {}))
    add("allclose#same", lambda rs: ((np.ones((2, 2), np.float32),
                                      np.ones((2, 2), np.float32)), {}),
        op="allclose")
    add("equal_all", lambda rs: ((_ties(rs, 2, 3), _ties(rs, 2, 3)), {}))
    add("is_empty", lambda rs: ((np.zeros((0, 3), np.float32),), {}))
    add("is_complex", lambda rs: ((_cplx(rs, 2),), {}))
    add("is_floating_point", lambda rs: ((_f(rs, 2),), {}))
    add("is_integer", lambda rs: ((_i(rs, 0, 3, 2),), {}))
    add("is_tensor", lambda rs: ((_f(rs, 2),), {}))
    # reductions
    x34 = lambda rs: _f(rs, 3, 4)  # noqa: E731
    for n in ("sum", "mean", "max", "min", "amax", "amin", "prod", "std",
              "var", "logsumexp"):
        add(n, lambda rs: ((x34(rs),), dict(axis=1)))
        add(n + "#all", lambda rs: ((x34(rs),), {}), op=n)
    add("sum#keep", lambda rs: ((_f(rs, 2, 3, 4),), dict(axis=[0, 2],
                                                         keepdim=True)),
        op="sum")
    add("sum#bool", lambda rs: ((_b(rs, 3, 4),), dict(axis=0)), op="sum")
    add("var#biased", lambda rs: ((x34(rs),), dict(axis=0, unbiased=False)),
        op="var")
    add("prod#axes", lambda rs: ((_f(rs, 2, 3, 4),), dict(axis=[0, 2])),
        op="prod")
    add("nansum", lambda rs: ((_with_nan(rs, 3, 4),), dict(axis=1)))
    add("nanmean", lambda rs: ((_with_nan(rs, 3, 4),), dict(axis=1)))
    add("nanmedian", lambda rs: ((_with_nan(rs, 3, 5),), dict(axis=1)))
    add("median", lambda rs: ((_f(rs, 3, 5),), dict(axis=1)))
    add("median#even", lambda rs: ((_f(rs, 3, 4),), {}), op="median")
    add("median#min", lambda rs: ((_f(rs, 3, 4),), dict(axis=1,
                                                        mode="min")),
        op="median")
    add("quantile", lambda rs: ((_f(rs, 3, 5), 0.3), dict(axis=1)))
    add("nanquantile", lambda rs: ((_with_nan(rs, 3, 5), 0.6),
                                   dict(axis=1)))
    add("all", lambda rs: ((_b(rs, 3, 4),), dict(axis=1)))
    add("any", lambda rs: ((_b(rs, 3, 4),), {}))
    add("argmax", lambda rs: ((_ties(rs, 3, 4),), dict(axis=1)))
    add("argmax#flat", lambda rs: ((_ties(rs, 3, 4),), {}), op="argmax")
    add("argmin", lambda rs: ((_ties(rs, 3, 4),), dict(axis=0,
                                                       keepdim=True)))
    add("count_nonzero", lambda rs: ((_ties(rs, 3, 4),), dict(axis=1)))
    add("mode", lambda rs: ((_ties(rs, 3, 7),), dict(axis=1)))
    add("kthvalue", lambda rs: ((_ties(rs, 3, 5), 2), dict(axis=1)))
    for n in ("cumsum", "logcumsumexp"):
        add(n, lambda rs: ((x34(rs),), dict(axis=1)))
    add("cumsum#flat", lambda rs: ((x34(rs),), {}), op="cumsum")
    add("cumprod", lambda rs: ((x34(rs),), dict(dim=1)))
    add("cummax", lambda rs: ((_ties(rs, 3, 5),), dict(axis=1)))
    add("cummin", lambda rs: ((_ties(rs, 3, 5),), dict(axis=0)))
    add("diff", lambda rs: ((x34(rs),), dict(axis=1)))
    add("trapezoid", lambda rs: ((x34(rs),), dict(dx=0.5)))
    add("cumulative_trapezoid", lambda rs: ((x34(rs),), dict(dx=0.5)))
    add("inner", lambda rs: ((x34(rs), _f(rs, 2, 4)), {}))
    add("outer", lambda rs: ((_f(rs, 3), _f(rs, 4)), {}))
    add("increment", lambda rs: ((_f(rs, 1), 2.0), {}))
    add("clip_by_norm", lambda rs: ((x34(rs), 1.0), {}))
    add("identity_loss", lambda rs: ((x34(rs),), dict(reduction="mean")))
    add("add_n", lambda rs: (([x34(rs), x34(rs), x34(rs)],), {}))
    add("accuracy", lambda rs: ((_ties(rs, 6, 4), _i(rs, 0, 4, 6, 1)),
                                dict(k=2)))
    add("auc", lambda rs: ((_f(rs, 8, 2, lo=0, hi=1), _i(rs, 0, 2, 8, 1)),
                           {}))
    add("renorm", lambda rs: ((x34(rs), 2.0, 0, 1.0), {}))
    # creation
    add("arange", lambda rs: ((0, 10, 3), {}))
    add("arange#float", lambda rs: ((1.0, 3.0, 0.5), {}), op="arange")
    add("linspace", lambda rs: ((0.0, 1.0, 5), {}))
    add("logspace", lambda rs: ((0.0, 2.0, 5), {}), tol=1e-4)
    add("eye", lambda rs: ((3, 4), {}))
    add("full", lambda rs: (([2, 3], 1.5), {}))
    add("full#int", lambda rs: (([2, 3], 4), {}), op="full")
    add("ones", lambda rs: (([2, 3],), {}))
    add("zeros", lambda rs: (([2, 3],), dict(dtype="int32")))
    add("empty", lambda rs: (([2, 3],), {}))
    for n in ("ones_like", "zeros_like", "empty_like"):
        add(n, lambda rs: ((x34(rs),), {}))
    add("full_like", lambda rs: ((x34(rs), 7.0), {}))
    add("tril_indices", lambda rs: ((4, 3, 0), {}))
    add("triu_indices", lambda rs: ((4, 5, 1), {}))
    add("create_tensor", lambda rs: (("float32",), {}))
    add("assign", lambda rs: ((x34(rs),), {}))
    add("diag", lambda rs: ((_f(rs, 3),), dict(offset=1)))
    add("diag#pad", lambda rs: ((_f(rs, 3),), dict(padding_value=2.0)),
        op="diag")
    add("diag#2d", lambda rs: ((x34(rs),), dict(offset=-1)), op="diag")
    add("diagflat", lambda rs: ((_f(rs, 2, 2),), dict(offset=1)))
    add("meshgrid", lambda rs: ((_f(rs, 3), _f(rs, 2)), {}))
    add("tril", lambda rs: ((x34(rs), -1), {}))
    add("triu", lambda rs: ((x34(rs), 1), {}))
    # manipulation
    add("cast", lambda rs: ((_f(rs, 3, 4, lo=-5, hi=5), "int32"), {}))
    add("reshape", lambda rs: ((x34(rs), [4, 3]), {}))
    add("view", lambda rs: ((x34(rs), [2, 6]), {}))
    add("view_as", lambda rs: ((x34(rs), _f(rs, 6, 2)), {}))
    add("transpose", lambda rs: ((_f(rs, 2, 3, 4), [1, 0, 2]), {}))
    add("t", lambda rs: ((x34(rs),), {}))
    add("moveaxis", lambda rs: ((_f(rs, 2, 3, 4), 0, 2), {}))
    add("concat", lambda rs: (([x34(rs), _f(rs, 3, 2)],), dict(axis=1)))
    add("stack", lambda rs: (([x34(rs), x34(rs)],), dict(axis=1)))
    add("split", lambda rs: ((_f(rs, 6, 4), [2, -1]), dict(axis=0)))
    add("split#n", lambda rs: ((_f(rs, 6, 4), 3), {}), op="split")
    add("tensor_split", lambda rs: ((_f(rs, 7, 2), 3), {}))
    add("chunk", lambda rs: ((_f(rs, 6, 4), 2), dict(axis=0)))
    add("vsplit", lambda rs: ((_f(rs, 4, 3), 2), {}))
    add("hsplit", lambda rs: ((_f(rs, 2, 6), [1, 3, 2]), {}))
    add("dsplit", lambda rs: ((_f(rs, 2, 3, 4), 2), {}))
    add("split_with_num", lambda rs: ((_f(rs, 6, 4), 2), {}))
    add("unbind", lambda rs: ((x34(rs),), dict(axis=1)))
    add("unstack", lambda rs: ((x34(rs),), {}))
    add("squeeze", lambda rs: ((_f(rs, 3, 1, 4),), dict(axis=1)))
    add("squeeze#list", lambda rs: ((_f(rs, 1, 3, 1),), dict(axis=[0, 1])),
        op="squeeze")
    add("unsqueeze", lambda rs: ((x34(rs), [0, 2]), {}))
    add("flatten", lambda rs: ((_f(rs, 2, 3, 4),), dict(start_axis=1)))
    add("unflatten", lambda rs: ((_f(rs, 2, 6), 1, [2, 3]), {}))
    add("expand", lambda rs: ((_f(rs, 1, 3), [4, -1]), {}))
    add("expand_as", lambda rs: ((_f(rs, 1, 3), _f(rs, 4, 3)), {}))
    add("broadcast_to", lambda rs: ((_f(rs, 1, 3), [4, 3]), {}))
    add("broadcast_tensors", lambda rs: (([_f(rs, 1, 3), _f(rs, 4, 1)],),
                                         {}))
    add("broadcast_shape", lambda rs: (([2, 1, 3], [4, 3]), {}))
    add("tile", lambda rs: ((_f(rs, 2, 3), [2, 1]), {}))
    add("flip", lambda rs: ((x34(rs), [0, 1]), {}))
    add("reverse", lambda rs: ((x34(rs), 0), {}))
    add("rot90", lambda rs: ((x34(rs),), {}))
    add("roll", lambda rs: ((x34(rs), 1), dict(axis=0)))
    add("roll#flat", lambda rs: ((x34(rs), 5), {}), op="roll")
    add("gather", lambda rs: ((_f(rs, 4, 3), np.array([3, 0, 3])),
                              dict(axis=0)))
    add("gather_nd", lambda rs: ((_f(rs, 3, 4, 5),
                                  np.array([[0, 1], [2, 3]])), {}))
    add("scatter", lambda rs: ((_f(rs, 5, 3), np.array([1, 3, 0]),
                                _f(rs, 3, 3)), {}))
    add("scatter#dup_drop", lambda rs: (
        (_f(rs, 5, 3), np.array([1, 7, 1, 4, -1]), _f(rs, 5, 3)), {}),
        op="scatter")
    add("scatter#add", lambda rs: ((_f(rs, 5, 3), np.array([1, 1, 2]),
                                    _f(rs, 3, 3)), dict(overwrite=False)),
        op="scatter")
    add("scatter_nd", lambda rs: ((np.array([[1], [3]]), _f(rs, 2, 3),
                                   [4, 3]), {}))
    add("scatter_nd_add", lambda rs: ((_f(rs, 4, 3), np.array([[1], [1]]),
                                       _f(rs, 2, 3)), {}))
    add("index_select", lambda rs: ((_f(rs, 4, 3), np.array([2, 0])),
                                    dict(axis=0)))
    add("index_sample", lambda rs: ((_f(rs, 3, 5), _i(rs, 0, 5, 3, 2)), {}))
    add("index_add", lambda rs: ((_f(rs, 4, 3), np.array([1, 3]), 0,
                                  _f(rs, 2, 3)), {}))
    add("index_fill", lambda rs: ((_f(rs, 4, 3), np.array([1, 3]), 0, 1.5),
                                  {}))
    add("index_put", lambda rs: ((_f(rs, 4, 3), (np.array([0, 2]),
                                                 np.array([1, 2])),
                                  _f(rs, 2)), {}))
    add("masked_select", lambda rs: ((x34(rs), _b(rs, 3, 4)), {}))
    add("masked_fill", lambda rs: ((x34(rs), _b(rs, 3, 4), 0.5), {}))
    add("masked_scatter", lambda rs: ((x34(rs), _b(rs, 3, 4),
                                       _f(rs, 12)), {}))
    add("where", lambda rs: ((_b(rs, 3, 4), x34(rs), x34(rs)), {}))
    add("nonzero", lambda rs: ((_ties(rs, 3, 4),), {}))
    add("take", lambda rs: ((x34(rs), np.array([[0, 11], [-1, 5]])), {}))
    add("take_along_axis", lambda rs: ((x34(rs), _i(rs, 0, 4, 3, 2), 1),
                                       {}))
    add("put_along_axis", lambda rs: ((x34(rs), np.array([[0], [3], [1]]),
                                       9.0, 1), {}))
    add("put_along_axis#add", lambda rs: (
        (x34(rs), np.array([[0], [3], [1]]), _f(rs, 3, 1), 1),
        dict(reduce="add")), op="put_along_axis")
    add("one_hot", lambda rs: ((_i(rs, 0, 5, 4), 5), {}))
    add("topk", lambda rs: ((_ties(rs, 3, 6), 3), dict(axis=1)))
    add("topk#small", lambda rs: ((_ties(rs, 3, 6), 2),
                                  dict(axis=0, largest=False)), op="topk")
    add("sort", lambda rs: ((_ties(rs, 3, 6),), dict(axis=1,
                                                     descending=True)))
    add("argsort", lambda rs: ((_ties(rs, 3, 6),), dict(axis=1)))
    add("argsort#desc", lambda rs: ((_ties(rs, 3, 6),),
                                    dict(axis=1, descending=True)),
        op="argsort")
    add("searchsorted", lambda rs: ((np.array([1, 3, 5, 7], np.float32),
                                     _ties(rs, 2, 3) * 2), {}))
    add("searchsorted#right", lambda rs: (
        (np.array([1, 3, 5, 7], np.float32), _ties(rs, 2, 3) * 2),
        dict(right=True)), op="searchsorted")
    add("bucketize", lambda rs: ((_ties(rs, 2, 3) * 2,
                                  np.array([1, 3, 5, 7], np.float32)), {}))
    add("unique", lambda rs: ((_i(rs, 0, 5, 9),), dict(
        return_index=True, return_inverse=True, return_counts=True)))
    add("unique#axis", lambda rs: ((_i(rs, 0, 2, 5, 2),), dict(axis=0)),
        op="unique")
    add("unique_consecutive", lambda rs: ((np.array([1, 1, 2, 2, 3, 1, 1]),),
                                          dict(return_inverse=True,
                                               return_counts=True)))
    add("slice", lambda rs: ((_f(rs, 4, 5), [0, 1], [1, 0], [3, -1]), {}))
    add("strided_slice", lambda rs: ((_f(rs, 6, 5), [0, 1], [5, 0], [0, 5],
                                      [-2, 2]), {}))
    add("crop", lambda rs: ((_f(rs, 4, 5),), dict(shape=[2, 3],
                                                  offsets=[1, 1])))
    add("pad", lambda rs: ((_f(rs, 1, 2, 3, 4), [1, 1, 2, 0]),
                           dict(mode="reflect")))
    add("pad#const", lambda rs: ((_f(rs, 2, 3), [1, 0, 2, 1]),
                                 dict(value=0.5)), op="pad")
    add("pad#circular", lambda rs: ((_f(rs, 1, 2, 4), [2, 1]),
                                    dict(mode="circular", data_format="NCL")),
        op="pad")
    add("repeat_interleave", lambda rs: ((_f(rs, 3), 2), {}))
    add("repeat_interleave#t", lambda rs: ((_f(rs, 3, 2), np.array([1, 0, 2])),
                                           dict(axis=0)),
        op="repeat_interleave")
    add("shard_index", lambda rs: ((_i(rs, 0, 20, 4, 1), 20, 2, 0), {}))
    add("atleast_1d", lambda rs: ((np.array(2.0, np.float32),), {}))
    add("atleast_2d", lambda rs: ((_f(rs, 3),), {}))
    add("atleast_3d", lambda rs: ((_f(rs, 3),), {}))
    add("tensordot", lambda rs: ((x34(rs), _f(rs, 4, 5)), dict(axes=1)))
    add("numel", lambda rs: ((x34(rs),), {}))
    add("rank", lambda rs: ((x34(rs),), {}))
    add("shape", lambda rs: ((_f(rs, 2, 3, 4),), {}))
    add("diagonal", lambda rs: ((x34(rs),), dict(offset=1)))
    add("trace", lambda rs: ((x34(rs),), {}))
    add("kron", lambda rs: ((_f(rs, 2, 2), _f(rs, 2, 3)), {}))
    add("diag_embed", lambda rs: ((_f(rs, 2, 3),), dict(offset=1)))
    add("diagonal_scatter", lambda rs: ((_f(rs, 3, 3), _f(rs, 3)), {}))
    add("fill", lambda rs: ((x34(rs), 2.5), {}))
    add("fill_diagonal", lambda rs: ((x34(rs), 9.0), dict(offset=1)))
    add("fill_diagonal_tensor", lambda rs: ((x34(rs), _f(rs, 3)), {}))
    add("multiplex", lambda rs: (([x34(rs), x34(rs)], _i(rs, 0, 2, 3, 1)),
                                 {}))
    add("select_scatter", lambda rs: ((x34(rs), _f(rs, 4), 0, 1), {}))
    add("slice_scatter", lambda rs: ((_f(rs, 4, 5), _f(rs, 2, 5)),
                                     dict(axes=[0], starts=[1], ends=[3],
                                          strides=[1])))
    add("as_strided", lambda rs: ((x34(rs), [2, 3], [4, 1], 1), {}))
    add("combinations", lambda rs: ((_f(rs, 5),), {}))
    add("temporal_shift", lambda rs: ((_f(rs, 4, 4, 2, 2), 2), {}))
    add("unfold", lambda rs: ((_f(rs, 2, 8), 1, 3, 2), {}))
    add("vander", lambda rs: ((_f(rs, 4), 3), {}))
    add("histogram", lambda rs: ((_f(rs, 20),), dict(bins=5, min=-2,
                                                     max=2)))
    add("histogram#auto", lambda rs: ((_f(rs, 20),), dict(bins=4)),
        op="histogram")
    add("histogramdd", lambda rs: ((_f(rs, 20, 2),), dict(bins=3)))
    add("bincount", lambda rs: ((_i(rs, 0, 6, 10),), dict(minlength=8)))
    add("bincount#w", lambda rs: ((_i(rs, 0, 6, 10), _f(rs, 10)), {}),
        op="bincount")
    add("edit_distance", lambda rs: ((_i(rs, 0, 4, 2, 5),
                                      _i(rs, 0, 4, 2, 4)),
                                     dict(normalized=False)))
    add("gather_tree", lambda rs: ((_i(rs, 0, 9, 4, 2, 3),
                                    _i(rs, 0, 3, 4, 2, 3)), {}))
    add("viterbi_decode", lambda rs: ((_f(rs, 2, 5, 4), _f(rs, 4, 4),
                                       np.array([5, 3])), {}))
    # linear algebra
    add("matmul", lambda rs: ((_f(rs, 2, 3, 4), _f(rs, 2, 4, 5)), {}))
    add("matmul#t", lambda rs: ((_f(rs, 4, 3), _f(rs, 5, 4)),
                                dict(transpose_x=True, transpose_y=True)),
        op="matmul")
    add("mm", lambda rs: ((x34(rs), _f(rs, 4, 2)), {}))
    add("bmm", lambda rs: ((_f(rs, 2, 3, 4), _f(rs, 2, 4, 5)), {}))
    add("mv", lambda rs: ((x34(rs), _f(rs, 4)), {}))
    add("dot", lambda rs: ((x34(rs), x34(rs)), {}))
    add("addmm", lambda rs: ((_f(rs, 3, 2), x34(rs), _f(rs, 4, 2)),
                             dict(beta=0.5, alpha=2.0)))
    add("einsum", lambda rs: (("ij,jk->ik", x34(rs), _f(rs, 4, 2)), {}))
    add("multi_dot", lambda rs: (([x34(rs), _f(rs, 4, 5), _f(rs, 5, 2)],),
                                 {}))
    add("norm", lambda rs: ((x34(rs),), dict(p=2, axis=1)))
    add("norm#fro", lambda rs: ((x34(rs),), {}), op="norm")
    add("norm#inf", lambda rs: ((x34(rs),), dict(p=float("inf"), axis=0)),
        op="norm")
    add("dist", lambda rs: ((x34(rs), x34(rs)), {}))
    add("dist#inf", lambda rs: ((x34(rs), x34(rs)), dict(p=float("inf"))),
        op="dist")
    add("cross", lambda rs: ((_f(rs, 4, 3), _f(rs, 4, 3)), {}))
    add("cdist", lambda rs: ((_f(rs, 5, 3), _f(rs, 4, 3)), {}))
    add("cov", lambda rs: ((_f(rs, 3, 6),), {}))
    add("corrcoef", lambda rs: ((_f(rs, 3, 6),), {}))
    add("cholesky", lambda rs: ((_spd(rs, 3),), {}), tol=1e-4)
    add("cholesky_solve", lambda rs: ((_f(rs, 3, 2),
                                       np.linalg.cholesky(_spd(rs, 3))
                                       .astype(np.float32)), {}), tol=1e-4)
    add("inverse", lambda rs: ((_cond(rs, 3),), {}), tol=1e-4)
    add("pinv", lambda rs: ((_f(rs, 4, 3),), {}), tol=1e-4)
    add("solve", lambda rs: ((_cond(rs, 3), _f(rs, 3, 2)), {}), tol=1e-4)
    add("triangular_solve", lambda rs: ((np.triu(_cond(rs, 3)),
                                         _f(rs, 3, 2)), {}), tol=1e-4)
    add("triangular_solve#lt", lambda rs: (
        (np.tril(_cond(rs, 3)), _f(rs, 3, 2)),
        dict(upper=False, transpose=True)), op="triangular_solve", tol=1e-4)
    add("lstsq", lambda rs: ((_f(rs, 5, 3), _f(rs, 5, 2)), {}), tol=1e-4)
    add("det", lambda rs: ((_cond(rs, 3),), {}), tol=1e-4)
    add("slogdet", lambda rs: ((_cond(rs, 3),), {}), tol=1e-4)
    add("matrix_power", lambda rs: ((_cond(rs, 3), 3), {}), tol=1e-4)
    add("matrix_rank", lambda rs: ((_f(rs, 4, 3) @ _f(rs, 3, 5),), {}))
    add("lu", lambda rs: ((_cond(rs, 3),), {}), tol=1e-4)
    add("lu_unpack", lambda rs: ((x34(rs)[:, :3].copy(),
                                  np.array([2, 3, 3], np.int32)), {}))
    add("householder_product", lambda rs: ((_f(rs, 4, 3), _f(rs, 3)), {}),
        tol=1e-4)
    add("qr", lambda rs: ((_f(rs, 4, 3),), {}), "decomp", 1e-4, _qr_check)
    add("svd", lambda rs: ((_f(rs, 4, 3),), {}), "decomp", 1e-4, _svd_check)
    add("eigh", lambda rs: ((_spd(rs, 4),), {}), "decomp", 1e-4,
        _eigh_check)
    add("eig", lambda rs: ((_cond(rs, 3),), {}), "decomp", 1e-4, _eig_check)
    add("eigvals", lambda rs: ((_cond(rs, 3),), {}), "decomp", 1e-4,
        _eigvals_check)
    add("eigvalsh", lambda rs: ((_spd(rs, 4),), {}), tol=1e-4)
    add("pca_lowrank", lambda rs: ((_f(rs, 6, 4),), dict(q=2)), "decomp",
        1e-4, _pca_check)
    # random ops: shape, dtype class and support (their laws: LAWS)
    add("bernoulli", lambda rs: ((_f(rs, 3, 4, lo=0, hi=1),), {}), "random",
        check=_support(lambda o, a: set(np.unique(_np(o))) <= {0.0, 1.0}))
    add("binomial", lambda rs: ((_i(rs, 1, 9, 3, 4),
                                 _f(rs, 3, 4, lo=0, hi=1)), {}), "random",
        check=_support(lambda o, a: ((_np(o) >= 0) & (_np(o) <= a[0]))
                       .all()))
    add("dirichlet", lambda rs: ((_f(rs, 3, 4, lo=0.5, hi=3),), {}),
        "random", check=_support(lambda o, a: np.allclose(
            _np(o).sum(-1), 1, atol=1e-5) and (_np(o) > 0).all()))
    add("multinomial", lambda rs: ((_f(rs, 3, 5, lo=0.1, hi=1),),
                                   dict(num_samples=2)), "random",
        check=_support(lambda o, a: ((_np(o) >= 0) & (_np(o) < 5)).all()
                       and all(len(set(r)) == 2 for r in _np(o).tolist())))
    add("poisson", lambda rs: ((_f(rs, 3, 4, lo=0.5, hi=4),), {}), "random",
        check=_support(lambda o, a: (_np(o) >= 0).all()
                       and np.array_equal(_np(o), np.round(_np(o)))))
    add("standard_gamma", lambda rs: ((_f(rs, 3, 4, lo=0.3, hi=3),), {}),
        "random", check=_support(lambda o, a: (_np(o) > 0).all()))
    add("randint", lambda rs: ((0, 5, [3, 4]), {}), "random",
        check=_support(lambda o, a: ((_np(o) >= 0) & (_np(o) < 5)).all()))
    add("randperm", lambda rs: ((6,), {}), "random",
        check=_support(_is_perm))
    add("uniform", lambda rs: (([3, 4],), dict(min=-2.0, max=2.0)),
        "random", check=_support(lambda o, a: (np.abs(_np(o)) <= 2).all()))
    add("gaussian", lambda rs: (([3, 4],), dict(mean=1.0, std=2.0)),
        "random", check=_support(lambda o, a: np.isfinite(_np(o)).all()))
    add("create_parameter", lambda rs: (([3, 4], "float32"), {}), "random",
        check=_support(lambda o, a: (np.abs(_np(o)) <= np.sqrt(2)).all()))
    add("top_p_sampling", lambda rs: ((_f(rs, 3, 6, lo=0.05, hi=1) / 3,
                                       np.full(3, 0.7, np.float32)), {}),
        "random", check=_support(_top_p))
    # in-place random fills (the argument written and returned)
    fills = {"uniform_": (dict(min=-1.0, max=1.0),
                          lambda o, a: (np.abs(_np(o)) <= 1).all()),
             "normal_": (dict(mean=0.0, std=1.0),
                         lambda o, a: np.isfinite(_np(o)).all()),
             "exponential_": (dict(lam=2.0), lambda o, a: (_np(o) >= 0).all()),
             "cauchy_": ({}, lambda o, a: np.isfinite(_np(o)).all()),
             "geometric_": (dict(probs=0.3), lambda o, a: (_np(o) >= 1).all()
                            and np.array_equal(_np(o), np.round(_np(o))))}
    for n, (kw, pred) in fills.items():
        add(n, lambda rs, kw=kw: ((x34(rs),), dict(kw)), "random",
            check=_support(pred), written=0)
    return T


def cases(public_ops, inplace_ops):
    """Every case: the table's, and one for each in-place twin of
    `public_ops` (the JAX ``PUBLIC_OPS["paddle_tpu"]``) and of
    `inplace_ops` that the top level resolves, run on the base op's
    case."""
    table = _table()
    out = []
    for name, (op, make, kind, tol, check, written) in sorted(table.items()):
        out.append(Case(name, op, make, kind, tol, check, written))
    twins = {n for n in public_ops if n.endswith("_")} | {
        n + "_" for n in inplace_ops}
    for twin in sorted(twins - set(table)):
        base = twin[:-1]
        if base not in table:
            continue
        op, make, kind, tol, check, _ = table[base]
        out.append(Case(twin, twin, make, kind, tol, check,
                        1 if base == "where" else 0))
    return out
