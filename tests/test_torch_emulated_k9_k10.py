"""The tensor-core K10 (wide fits) and K9 (the effect sizes' family
evaluator) sources, run on the CPU under the emulator of
``tests/_cuda_emu.py``, against their plain torch versions, up to the
widths the card's envelope needs (p = 32 columns of W, C = 64 contexts:
rank[W, E] <= 96).

K10's wide kernels (p > 16: every evaluation one DMMA product over R and a
bordered Cholesky in shared memory) at p = 20 and p = 97, REML and ML, on
two rho points with R = 90 rows (past two 32-row chunks), an 8-point grid
and 12 golden-section steps, through ``null_fit.fit_gaps`` at 1e-10.

K9 (the Gram a DMMA product a variant into a scratch, then a warp a point)
at q = 23 (the headline's width) and q = 162 (the envelope's corner) on
the first f32 zoom round (through ``woodbury_family.f32_gaps``: excess <=
1e-5, masks equal), the first f64 round and the f64 fit with coefficients
(lml within 1e-10 of max(|lml|, 1) with the same non-finite points, beta
and rss within 1e-9 of their largest entry).

The datasets are sized so that these f64 problems are well conditioned:
with fewer cells than ~2 q (K9 at q = 162 on 120 cells, K10 at p = 97 on
160) some points reach cond(A) ~ 1e9, where the kernel and the plain
version each lie 3e-10 to 7e-10 (lml) and ~5e-9 (beta) from an
extended-precision evaluation, and no two f64 orderings agree to 1e-10.
"""
import pytest
import torch

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import betas_dataset, captured, fit_dataset
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import null_fit as k10
from cellregmap_tpu_torch.kernels import woodbury_family as k9


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_k9_k10")
    out = {}
    for name, mod in (("null_fit", k10), ("woodbury_family", k9)):
        out[name] = emulated(name, workdir)
        mod._bind(out[name])
    return out


def _contiguous(args):
    return tuple(type(a)(*(t.contiguous() for t in a))
                 if isinstance(a, tuple)
                 else a.contiguous() if isinstance(a, torch.Tensor) else a
                 for a in args)


# p mean columns: REML fits [W, g] (W of p - 1 columns), ML fits W (p)
@pytest.mark.parametrize("p", [20, 97])
@pytest.mark.parametrize("restricted", [False, True])
def test_null_fit_wide_source_matches_plain(libs, p, restricted):
    w = p - 1 if restricted else p
    ctx, G, n = fit_dataset(40 + p, p=w, nrho=2, n=220, donors=30)
    M = torch.cat([ctx.W, G[:, :1]], dim=1) if restricted else ctx.W
    calls = captured(lambda: engine._fit_over_rho(
        ctx, ctx.Z.T @ M, M.T @ M, M.T @ ctx.y, n, restricted,
        (-18.0, 18.0, 8, 12)), ["null_fit"])
    (args, kw), = calls["null_fit"]
    data = args[0]
    assert data.Xt.shape[2] == p and 64 < data.Xt.shape[1] <= 128
    fits = k10.call(libs["null_fit"], *args, **kw)
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args, **kw), data, n,
                        restricted)
    assert max(gaps.values()) <= 1e-10, gaps


def _family_close(lib, args, kw):
    got = k9.call(lib, *args, **kw)
    if args[0].dtype == torch.float32:
        gaps = k9.f32_gaps(got, args, kw)
        assert gaps["mask"] == 0 and gaps["excess"] <= 1e-5, gaps
        return
    want = k9.family_eval_plain(*args, **kw)
    if not kw.get("want_beta"):
        got, want = (got,), (want,)
    gaps = k9.lml_gaps(got[0], want[0])
    assert gaps["mask"] == 0 and gaps["rel"] <= 1e-10, gaps
    for g, w in zip(got[1:], want[1:]):
        err = float((g - w).abs().max())
        assert err <= 1e-9 * float(w.abs().max()), err


# (C, W columns, donors, cells, variants, q): q = C + rank[W, E] + 2
@pytest.mark.parametrize("C,p,donors,n,S,q", [(10, 1, 4, 90, 3, 23),
                                              (64, 32, 1, 400, 2, 162)])
def test_woodbury_family_source_at_the_envelope(libs, C, p, donors, n, S,
                                                q):
    bctx, G, norm, n = betas_dataset(70 + C, p=p, n=n, C=C, donors=donors,
                                     S=S)
    calls = captured(lambda: engine.predict_interaction_batch(
        bctx, G, norm, n, localize_f32=True), ["family_eval"])
    calls = [(_contiguous(a), kw) for a, kw in calls["family_eval"]]
    assert calls[0][0][3].shape[1] == q
    assert [a[0].dtype for a, _ in calls] == [torch.float32] * 5 \
        + [torch.float64] * 4
    # the first f32 round (the whole delta range), the first f64 round and
    # the fit with coefficients
    for args, kw in (calls[0], calls[5], calls[-1]):
        _family_close(libs["woodbury_family"], args, kw)
