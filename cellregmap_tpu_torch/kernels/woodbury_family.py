"""K9: the Woodbury family evaluator of the effect sizes.

Per (variant, point): the weighted Gram of the variant's rotated columns
over the background eigenbasis, the bordered-Gram Cholesky and the REML (or
ML) lml, optionally with the GLS coefficients and the residual
(cellregmap_tpu/models/lmm.py:435-602 ``_family_eval_batch`` /
``_family_blocks_matrix``).  ``fit_delta_woodbury_family`` calls it once per
zoom round (f32 or f64) and once for the final fit with coefficients.

Both entries run in f32 too: the lml rounds of hybrid localization (f32
operands of an f64 context) and every call of the float32 context
(``ScanConfig(dtype="float32")``), whose final fit takes the coefficients
in f32 (the capacitance block ridged by 1e-6 and the lml masked as the
JAX engine's f32 ``_family_blocks_matrix``).  Float32 calls count in
``launches_f32`` too.

On a CUDA tensor :func:`family_eval` launches ``csrc/woodbury_family.cu``
(the Gram a tensor-core product a variant into a scratch, then a warp a
point for the factorization); on a CPU tensor it runs
:func:`family_eval_plain`, which is ``models.lmm._family_eval_batch`` on the
stacked columns.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..models.lmm import FamilyCols, _family_eval_batch, stack_cols

launches = 0
launches_f32 = 0  # of them, float32 calls

MAX_Q = 162     # columns [Ua | UB, g | y] the kernel takes
SCRATCH_BYTES = 256 << 20   # the Gram's scratch, a chunk of variants


def family_eval_plain(logits, rho, cols: FamilyCols, compS, Lam, C, n,
                      restricted, ld_xx, rcond, want_beta=False):
    """Plain torch version: :func:`models.lmm._family_eval_batch`."""
    return _family_eval_batch(logits, rho, stack_cols(cols), compS, Lam, C,
                              n, restricted, ld_xx, rcond, want_beta)


def lml_gaps(got, want) -> dict:
    """The kernel's lmls against the plain ones: ``rel``, the largest
    |got - want| / max(|want|, 1) where both are finite, and ``mask``, the
    number of points where one is finite and the other is not."""
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    both = fin_g & fin_w
    rel = ((got - want).abs() / want.abs().clamp(min=1.0))[both]
    return {"rel": float(rel.max()) if rel.numel() else 0.0,
            "mask": int((fin_g != fin_w).sum())}


def f32_gaps(got, args, kw) -> dict:
    """A float32 evaluation ``got`` of the call ``(args, kw)`` held to the
    plain float32 one through the plain f64 lml at the same points: the
    float32 rounds are ill-conditioned near the ends of the delta range
    (1/delta up to ~7e7), where both f32 versions are off the f64 value by
    up to a few percent, so they are not compared with each other directly.
    ``excess``: the largest (|got - f64| - 2 |plain - f64|) / max(|f64|, 1)
    where both are finite (<= 0 when the kernel is at most twice as far
    from f64 as the plain version); ``mask``: points where one is -inf and
    the other finite and within 1e-3 of f64 (a mask that differs where
    float32 cannot resolve the lml is allowed)."""
    c = lambda a: a.double() if isinstance(a, torch.Tensor) else a  # noqa
    plain = family_eval_plain(*args, **kw)
    exact = family_eval_plain(*(type(a)(*map(c, a)) if isinstance(a, tuple)
                                else c(a) for a in args), **kw)
    ref = exact.abs().clamp(min=1.0)
    eg, ep = (got - exact).abs() / ref, (plain - exact).abs() / ref
    fin_g, fin_p = torch.isfinite(got), torch.isfinite(plain)
    excess = (eg - 2 * ep)[fin_g & fin_p]
    bad = (fin_g != fin_p) & (torch.where(fin_g, eg, ep) <= 1e-3)
    return {"excess": float(excess.max()) if excess.numel() else 0.0,
            "mask": int(bad.sum())}


def _bind(lib):
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.crm_woodbury_family_f32, lib.crm_woodbury_family_f64):
        fn.restype = ci
        fn.argtypes = [vp] * 13 + [cd] + [ci] * 9 + [vp]


def family_eval(logits, rho, cols: FamilyCols, compS, Lam, C, n, restricted,
                ld_xx, rcond, want_beta=False):
    """lml (S, L) at the (logit, rho) points (S, L) of each variant, and
    with ``want_beta`` also (beta (S, L, pB + 1), rss (S, L)).  ``cols``:
    Ua (Rk, C, S), UB (Rk, pB), ug (Rk, S), uy (Rk,); compS (S, q, q), Lam
    (Rk,), ld_xx (S,); all float32 or all float64."""
    global launches, launches_f32
    if logits.device.type == "cpu":
        return family_eval_plain(logits, rho, cols, compS, Lam, C, n,
                                 restricted, ld_xx, rcond, want_beta)
    dt = logits.dtype
    Rk, C_, S = cols.Ua.shape
    pB = cols.UB.shape[1]
    q = C + pB + 2
    L = logits.shape[1]
    if C_ != C or C < 1:
        raise ValueError(f"family_eval: Ua has {C_} contexts, C = {C}")
    if q > MAX_Q:
        raise ValueError(f"family_eval: needs q = C + pB + 2 <= {MAX_Q} "
                         f"columns, got {q}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"family_eval: float32 or float64, got {dt}")
    for t, name, shape in ((logits, "logits", (S, L)), (rho, "rho", (S, L)),
                           (cols.Ua, "Ua", (Rk, C, S)),
                           (cols.UB, "UB", (Rk, pB)), (cols.ug, "ug", (Rk, S)),
                           (cols.uy, "uy", (Rk,)), (compS, "compS", (S, q, q)),
                           (Lam, "Lam", (Rk,)), (ld_xx, "ld_xx", (S,))):
        _build.require(t, f"family_eval: {name}", dt, shape)
    out = call(_build.load("woodbury_family", _bind), logits, rho, cols,
               compS, Lam, C, n, restricted, ld_xx, rcond, want_beta,
               _build.stream_ptr(logits.device))
    launches += 1
    launches_f32 += dt == torch.float32
    return out


def call(lib, logits, rho, cols: FamilyCols, compS, Lam, C, n, restricted,
         ld_xx, rcond, want_beta=False, stream=None):
    """Allocate the results and call ``lib``'s entry point (the card's
    library, or an emulation of it on CPU tensors)."""
    dt = logits.dtype
    Rk, _, S = cols.Ua.shape
    pB = cols.UB.shape[1]
    L = logits.shape[1]
    new = lambda *shape: torch.empty(shape, dtype=dt,  # noqa: E731
                                     device=logits.device)
    lml = new(S, L)
    beta, rss = (new(S, L, pB + 1), new(S, L)) if want_beta else (lml, lml)
    if lml.numel():
        fn = (lib.crm_woodbury_family_f64 if dt == torch.float64
              else lib.crm_woodbury_family_f32)
        # the Gram's sums of as many variants as the scratch holds
        per_variant = L * (C + pB + 2) * (C + pB + 3) // 2
        chunk = max(1, min(S, SCRATCH_BYTES // (per_variant
                                                * lml.element_size())))
        scratch = new(chunk * per_variant)
        _build.check(fn(*(_build.ptr(t) for t in (
            logits, rho, *cols, compS, Lam, ld_xx, lml, beta, rss, scratch)),
            float(rcond), n, S, L, Rk, C, pB, int(restricted),
            int(want_beta), chunk, stream), "woodbury_family")
    return (lml, beta, rss) if want_beta else lml
