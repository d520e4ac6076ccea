"""The f32 transcendental functions of XLA's CPU backend, on PyTorch tensors.

The JAX package's simulator runs compiled by XLA.  On the CPU, XLA does not
call libm for ``log``, ``log1p``, ``exp`` or ``erf_inv``: it inlines its
own polynomial for each, as plain f32 multiplies and adds, and LLVM then
fuses a multiply into the add that is its only use (one FMA, one rounding).
A draw that passes through ``torch.log1p`` or CUDA's ``log1pf`` differs from
it in the last bit of a few percent of inputs, and one such bit moves a tick
of the simulated clock.  So the port writes each function as XLA's sequence
of f32 operations, with :func:`fma` exactly where the compiled code fuses,
and the kernel (``kernels/csrc/simstep.cu``) writes the same sequences under
``-fmad=false`` with ``fmaf`` in the same places.

XLA's CPU code flushes subnormal results to zero; these functions and the
kernel do not, so the two agree where the results are normal (``exp`` of
at least -87.33), as every draw of the simulator's is.

The constants are XLA's, as f32 bit patterns.  ``sin`` and ``pow`` are
the functions XLA leaves to libm (``sinf``, ``powf``).  :func:`sin` rounds
an f64 sine, which can differ from libm's in the last bit
(``tests/test_torch_draws.py`` measures how often).  :func:`powf` is
glibc's ``powf`` itself (the x86-64 FMA variant that glibc 2.36 selects on
a CPU with FMA): the same f64 operations, tables and fused multiply-adds,
each FMA exact through :func:`fma64`, so it is bit-identical
(``tests/test_torch_keys.py``).  ``floor`` is exact on both sides;
:func:`sqrt` is here because PyTorch's f32 ``sqrt`` on the CPU is not
correctly rounded.
"""

from __future__ import annotations

import math

import torch

_F32, _I32 = torch.float32, torch.int32


def f32(bits: int) -> float:
    """The f32 value of a 32-bit pattern, as a Python float (exact)."""
    return torch.tensor(bits, dtype=_I32).view(_F32).item() if bits < 2**31 \
        else torch.tensor(bits - 2**32, dtype=_I32).view(_F32).item()


# log: the mantissa's polynomial and the split ln 2.
_LOG_C = tuple(f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A,    # y1: c0 x + c1, then * x + c2
    0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,    # y2
    0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))   # y3
_LN2_LO = f32(0xB95E8083)                  # -2.12194440e-4
_LN2_HI = f32(0x3F318000)                  # 0.693359375
_SQRT_HALF = f32(0x3F3504F3)
_MIN_NORMAL = f32(0x00800000)
# log1p's rational approximation near 0: numerator P, denominator Q
# (Horner, highest power first), used where |x| < sqrt(2) - 1.
_LOG1P_Q = tuple(f32(b) for b in (
    0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
    0x42707982))
_LOG1P_P = tuple(f32(b) for b in (
    0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
    0x426473AD, 0x41A05101))
_LOG1P_SMALL = f32(0x3ED413CD)             # 0.41421357
# exp: the clamp, log2(e), the split ln 2 and the polynomial.
_EXP_LO, _EXP_HI = f32(0xC2AF999A), f32(0x42B1999A)   # -87.8, 88.8
_LOG2E = f32(0x3FB8AA3B)
_EXP_C = tuple(f32(b) for b in (
    0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA))
# erf_inv: two polynomials of 9 terms, for w < 5 and w >= 5.
_ERFINV_LT5 = tuple(f32(b) for b in (
    0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1, 0x396532DB,
    0xBAA45408, 0xBB88E4EF, 0x3E7C8F63, 0x3FC02E2F))
_ERFINV_GE5 = tuple(f32(b) for b in (
    0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7, 0x3BBC127B,
    0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB, 0x40354F7E))
#: log2 is XLA's log times this f32 (its divide by ln 2, folded).
LOG2_MUL = f32(0x3FB8AA3B)                 # 1.44269502
#: jax.random.normal's sqrt(2), in f32.
SQRT2 = f32(0x3FB504F3)
#: 2 pi as the f32 that ``2.0 * jnp.pi * x`` multiplies by.
TWO_PI = f32(0x40C90FDB)


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as ``fmaf`` gives it (f32
    tensors or Python floats that are f32 values).

    The f64 product of two f32 values is exact, and the f64 sum rounds
    to the same f32 as the exact sum unless it lands on an f32 midpoint
    (or below the normal range).  Only then is the sum rounded to odd
    (its exact error, from TwoSum, decides the last bit), which rounds to
    f32 exactly as the one-step fused operation would.  (On the CPU the
    check skips that step when no element needs it; on a card, where the
    check would stall the stream, it always runs.)"""
    p = _f64(a) * _f64(b)
    c = _f64(c)
    s = p + c
    bits = s.view(torch.int64)
    if s.device.type == "cpu" and not bool(
            (((bits & 0x1FFFFFFF) == 0x10000000)
             | (s.abs() < 2.0**-125)).any()):
        return s.float()
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = torch.nextafter(s, err * math.inf)
    return torch.where((err != 0) & ((bits & 1) == 0), odd, s).float()


def _special_log(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """XLA's special cases of log: -inf at 0, inf at inf, NaN below 0."""
    r = torch.where(x == math.inf, math.inf, r)
    r = torch.where(x == 0, -math.inf, r)
    return torch.where((x < 0) | torch.isnan(x), math.nan, r)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log``: a split of the mantissa m in [sqrt(1/2),
    sqrt(2)) and the exponent e, a polynomial in m - 1, plus e ln 2 in two
    parts."""
    x = x.to(_F32)
    xc = torch.where(x > _MIN_NORMAL, x, _MIN_NORMAL)
    bits = xc.view(_I32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)      # [0.5, 1)
    small = m < _SQRT_HALF
    e = e - small.to(_F32)
    v = (m - 1.0) + torch.where(small, m, 0.0)
    v2 = v * v
    v3 = v2 * v
    c = _LOG_C
    y1 = fma(fma(v, c[0], c[1]), v, c[2])
    y2 = fma(fma(v, c[3], c[4]), v, c[5])
    y3 = fma(fma(v, c[6], c[7]), v, c[8])
    y = fma(fma(y1, v3, y2), v3, y3)
    y = fma(y, v3, e * _LN2_LO)
    r = fma(e, _LN2_HI, (v - v2 * 0.5) + y)
    return _special_log(x, r)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p``: a rational approximation where |x| < sqrt(2) -
    1, else :func:`log` of ``1 + x``."""
    x = x.to(_F32)
    near = x.abs() < _LOG1P_SMALL
    cpu = x.device.type == "cpu"        # a branch no element takes is
    if cpu and not bool(near.any()):    # skipped (without a host sync)
        return log(x + 1.0)
    x2 = x * x
    q = 1.0 + x * 0.0
    for k in _LOG1P_Q:
        q = fma(q, x, k)
    p = _LOG1P_P[0] + x * 0.0
    for k in _LOG1P_P[1:]:
        p = fma(p, x, k)
    small = x + ((x * x2) * (p / q) + x2 * -0.5)
    if cpu and bool(near.all()):
        return small
    return torch.where(near, small, log(x + 1.0))


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``exp``: clamp, split x = n ln 2 + r (n = floor(x log2 e +
    1/2), the ln 2 in two parts), a polynomial in r, times 2^n."""
    x = x.to(_F32)
    x = torch.where(x >= _EXP_LO, x, _EXP_LO)           # NaN passes
    x = torch.where(x <= _EXP_HI, x, _EXP_HI)
    n = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma(-n, _LN2_LO, fma(-n, _LN2_HI, x))
    c = _EXP_C
    p = fma(r, c[0], c[1])
    for k in c[2:] + (0.5,):
        p = fma(p, r, k)
    y = 1.0 + fma(p, r * r, r)
    two_n = ((n.to(_I32) + 127) << 23).view(_F32)
    return y * two_n


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (Giles' single-precision approximation):
    w = -log1p(-x^2), a polynomial of 9 terms in w - 2.5 (w < 5) or
    sqrt(w) - 3, times x; +-inf at +-1."""
    x = x.to(_F32)
    lg = log1p(x * -x)                                  # -w
    lt5 = lg > -5.0
    z = torch.where(lt5, -2.5 - lg, sqrt(-lg) - 3.0)
    a, b = _ERFINV_LT5, _ERFINV_GE5
    p = fma(torch.where(lt5, a[0], b[0]), z, torch.where(lt5, a[1], b[1]))
    for ka, kb in zip(a[2:], b[2:]):
        p = fma(z, p, torch.where(lt5, ka, kb))
    p = torch.where(x.abs() == 1.0, math.inf, p)
    return x * p


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (IEEE ``sqrtf``, as XLA and
    CUDA's default ``sqrtf`` give it), through f64."""
    return torch.sqrt(x.to(_F32).double()).float()


def log2(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log2``: :func:`log` times ``LOG2_MUL`` (in a fused
    expression, the caller folds that multiply into its add)."""
    return log(x) * LOG2_MUL


# sin: fdlibm's kernels and pi/2 in two parts, in f64.
_INV_PIO2 = 6.36619772367581382433e-01
_PIO2_1, _PIO2_1T = 1.57079632673412561417e+00, 6.07710050650619224932e-11
_SIN_S = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
          -1.98412698298579493134e-04, 2.75573137070700676789e-06,
          -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_SIN_C = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
          2.48015872894767294178e-05, -2.75573143513906633035e-07,
          2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _horner(z, coefs):
    acc = z * coefs[-1]
    for k in coefs[-2::-1]:
        acc = z * (k + acc)
    return acc


def sin(x: torch.Tensor) -> torch.Tensor:
    """``sin`` of f32 values, computed in f64 and rounded once to f32: x
    reduced by the nearest multiple k of pi/2 (pi/2 in two parts), then
    fdlibm's sine or cosine polynomial by k mod 4.  The kernel runs the
    same f64 operations, so the two agree bit for bit.  XLA calls libm's
    ``sinf`` here, which is not always correctly rounded: the two differ
    in the last bit for about 1 % of inputs (level 3;
    ``tests/test_torch_draws.py``)."""
    x = x.to(_F32).double()
    k = torch.round(x * _INV_PIO2)
    r = (x - k * _PIO2_1) - k * _PIO2_1T
    z = r * r
    sin_r = r + (r * z) * (_SIN_S[0] + _horner(z, _SIN_S[1:]))
    cos_r = (1.0 - 0.5 * z) + (z * z) * (_SIN_C[0] + _horner(z, _SIN_C[1:]))
    q = k.to(torch.int64) & 3
    out = torch.where(q == 0, sin_r, torch.where(
        q == 1, cos_r, torch.where(q == 2, -sin_r, -cos_r)))
    return out.float()


# --------------------------------------------------------------------------
# powf: glibc's (sysdeps/ieee754/flt-32/e_powf.c), as its x86-64 FMA variant
# runs it: log2(x) through a 16-entry table and a polynomial in f64, times
# y, then exp2 through a 32-entry table and a polynomial in f64, rounded
# once to f32.  The tables and polynomials are the ones in that object's
# .rodata, and the FMAs are the ones its code makes (nine vfmadd).
# --------------------------------------------------------------------------

#: (1/c, log2(c)) of each of the 16 subintervals of [0x3f330000, 2 x).
_POWF_TAB = tuple(float.fromhex(h) for h in (
    "0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2",
    "0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2",
    "0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2",
    "0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2",
    "0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2",
    "0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3",
    "0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3",
    "0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4",
    "0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5",
    "0x1.0000000000000p+0", "0x0.0p+0",
    "0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4",
    "0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3",
    "0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3",
    "0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2",
    "0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2",
    "0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))
#: log2(1 + r) / r's polynomial, highest power first.
_POWF_A = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_POWF_OFF = 0x3F330000
#: exp2's table: the bits of 2^(j/32), less j << 47.
_EXP2F_T = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")      # round to k / 32
_EXP2F_C = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
#: y log2(x) above this overflows (|x^y| > 0x1.ffffffp127).
_POWF_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")
_F64, _I64 = torch.float64, torch.int64
_M32 = 0xFFFFFFFF


def _split(x):
    """Veltkamp's split of an f64 into two halves of 26 bits, x = hi + lo."""
    t = x * 134217729.0                 # 2^27 + 1
    hi = t - (t - x)
    return hi, x - hi


def fma64(a, b, c):
    """``a * b + c`` in f64 with one rounding, as an FMA instruction gives it
    (f64 tensors, or Python floats for ``b`` and ``c``), by error-free
    transformations: the product exactly as two f64 (Dekker), its sum with
    ``c`` as two (Knuth's TwoSum), the two low parts summed rounded to odd,
    and that added to the high part, rounded to nearest once (Boldo and
    Melquiond, "Emulation of FMA and correctly rounded sums: proved
    algorithms using rounding to odd", 2008).  Exact where no part
    overflows or falls below the normal range, as in :func:`powf`."""
    ah, al = _split(a)
    bh, bl = _split(b)
    uh = a * b
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th = uh + c
    bb = th - uh
    tl = (uh - (th - bb)) + (c - bb)
    s = tl + ul
    bb = s - tl
    e = (tl - (s - bb)) + (ul - bb)
    # s rounded to odd: where it is inexact and its last bit even, the
    # neighbour on the exact sum's side.
    even = (s.view(_I64) & 1) == 0
    odd = torch.nextafter(s, e * math.inf)
    return th + torch.where((e != 0) & even, odd, s)


def _table(vals, dtype, device) -> torch.Tensor:
    key = (vals, dtype, device)
    hit = _TABLES.get(key)
    if hit is None:
        hit = _TABLES[key] = torch.tensor(vals, dtype=dtype, device=device)
    return hit


_TABLES: dict = {}


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.view(_I32).to(_I64) & _M32


def _checkint(iy: torch.Tensor) -> torch.Tensor:
    """0: y is not an integer, 1: an odd integer, 2: an even one."""
    e = (iy >> 23) & 0xFF
    sh = torch.clamp(0x7F + 23 - e, 0, 31)
    frac = (iy & ((1 << sh) - 1)) != 0
    odd = (iy & (1 << sh)) != 0
    out = torch.where(frac, 0, torch.where(odd, 1, 2))
    out = torch.where(e > 0x7F + 23, 2, out)
    return torch.where(e < 0x7F, 0, out)


def powf(x, y) -> torch.Tensor:
    """glibc's f32 ``powf(x, y)`` (XLA's CPU code calls it for ``x ** y``),
    element-wise on broadcast f32 tensors, with the special cases of its
    C source, and its subnormal results flushed to zero as XLA's CPU
    runtime does (flush-to-zero set).  A subnormal ``x`` is taken as glibc
    takes it, not as XLA's denormals-are-zero would."""
    x, y = torch.broadcast_tensors(x.to(_F32), y.to(_F32))
    dev = x.device
    ix, iy = _u32(x), _u32(y)
    # Negative finite x: the sign of an odd integer y, NaN otherwise.
    yint = _checkint(iy)
    neg = (ix & 0x80000000) != 0
    sign = neg & (yint == 1)
    ax = torch.where(neg, ix & 0x7FFFFFFF, ix)
    # A subnormal |x|: normalised, its exponent made negative.
    sub = ax < 0x00800000
    if bool(sub.any()):
        xs = (x.abs() * 8388608.0).view(_I32).to(_I64) & 0x7FFFFFFF
        ax = torch.where(sub, xs - (23 << 23), ax)
    # log2(x) = log1p(z / c - 1) / ln 2 + log2(c) + k, x = 2^k z.
    tmp = (ax - _POWF_OFF) & _M32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ax - top) & _M32
    k = torch.where(top >= 2**31, top - 2**32, top) >> 23
    tab = _table(_POWF_TAB, _F64, dev)
    invc, logc = tab[2 * i], tab[2 * i + 1]
    z = iz.to(_I32).view(_F32).double()
    a = _POWF_A
    r = fma64(z, invc, -1.0)
    y0 = logc + k.double()
    r2 = r * r
    p1 = fma64(r, a[0], a[1])
    p2 = fma64(r, a[2], a[3])
    r4 = r2 * r2
    q = fma64(r, a[4], y0)
    q = fma64(r2, p2, q)
    logx = fma64(p1, r4, q)
    ylogx = y.double() * logx
    # exp2(ylogx) = 2^(k/32) 2^r, r in [-1/64, 1/64].
    kd = ylogx + _EXP2F_SHIFT
    kk = kd.view(_I64) - _bits64(_EXP2F_SHIFT)
    kd = kd - _EXP2F_SHIFT
    r = ylogx - kd
    tbits = _table(_EXP2F_T, _I64, dev)[kk & 31] + kk * (1 << 47)
    s = tbits.view(_F64)
    c = _EXP2F_C
    zz = fma64(r, c[0], c[1])
    r2 = r * r
    yy = fma64(r, c[2], 1.0)
    yy = fma64(zz, r2, yy) * s
    out = yy.float()
    out = torch.where(out.abs() < _MIN_NORMAL, 0.0, out)   # flush to zero
    out = torch.where(ylogx > _POWF_OFLOW, math.inf, out)
    out = torch.where(ylogx <= -150.0, 0.0, out)
    out = torch.where(sign, -out, out)
    out = torch.where(neg & (yint == 0), math.nan, out)
    # x zero, infinite or NaN: x^2 or 1 / x^2 with the sign of an odd y.
    x_zin = ((2 * ix - 1) & _M32) >= 2 * 0x7F800000 - 1
    x2 = x * x
    x2 = torch.where(neg & (yint == 1), -x2, x2)
    out = torch.where(x_zin, torch.where((iy & 0x80000000) != 0, 1.0 / x2,
                                         x2), out)
    # y zero, infinite or NaN.
    y_zin = ((2 * iy - 1) & _M32) >= 2 * 0x7F800000 - 1
    ix2, iy2 = (2 * ix) & _M32, (2 * iy) & _M32
    nan_in = (ix2 > 2 * 0x7F800000) | (iy2 > 2 * 0x7F800000)
    one_x = ix2 == 2 * 0x3F800000
    zero = (ix2 < 2 * 0x3F800000) == ((iy & 0x80000000) == 0)
    ys = torch.where(one_x, 1.0, torch.where(zero, 0.0, y * y))
    ys = torch.where(nan_in, x + y, ys)
    ys = torch.where(ix == 0x3F800000, 1.0, ys)
    ys = torch.where(iy2 == 0, 1.0, ys)
    return torch.where(y_zin, ys, out)


def _bits64(v: float) -> int:
    return int(torch.tensor(v, dtype=_F64).view(_I64))
