"""K1 (``csrc/kr_contract.cu``) and the wide K3 localize
(``csrc/reml_newton.cu``) of this checkout against another checkout's, on
the same operands, on one card in one process:

* K1 on the three contractions of a headline interaction batch (2000
  cells, 10 contexts, 100 donors, 512 variants: T = Z^T (E0 o G), A^T A,
  A^T W), each call apart;
* K3's localize at ``covariates_24`` (the headline dataset with W = [1, 23
  columns of N(0, 1), rng 24], 21 rho points) and at p = 8 (the first 8
  columns of that W), both from the batch's own K2 brackets.

The operands come from this checkout's engine; the other checkout's
package is loaded under another name, builds its own kernels into its own
``build/``, and is called through its own wrappers (whose signatures are
the same).  Each call is held to this checkout's plain version (K1 within
1e-12 of max|plain|; the localize with k_best equal, x within rel 1e-9 and
lml within rel 1e-10), then timed by CUDA events (the median of 20 runs,
10 for the localize) in the order other, this, this, other, and profiled
with ``torch.profiler`` (device milliseconds a call in each kernel).
Prints one JSON line per call and one of the whole; ``--out`` also writes
that line to a file.

    python3 scripts/profile_kernel_ab.py --other <checkout> [--out FILE]
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402
from cellregmap_tpu_torch import engine  # noqa: E402
from cellregmap_tpu_torch.kernels import _build  # noqa: E402
from cellregmap_tpu_torch.kernels import kr_contract as k1  # noqa: E402
from cellregmap_tpu_torch.kernels import reml_newton as k3  # noqa: E402


def load_other(root: Path, name="other_crp"):
    """The package of the checkout at ``root``, imported as ``name``."""
    pkg = root / "cellregmap_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(f"{name}.kernels.kr_contract")
    importlib.import_module(f"{name}.kernels.reml_newton")
    return mod


def timed(fns, reps):
    """CUDA-event medians of each (label, fn) in the order given."""
    out = {}
    for label, fn in fns:
        out.setdefault(label, []).append(cs.cuda_ms(fn, reps=reps, warmup=2))
    return out


def compare(name, this_fn, other_fn, check, reps):
    for label, fn in (("this", this_fn), ("other", other_fn)):
        check(label, fn())
        torch.cuda.synchronize()
    ms = timed([("other", other_fn), ("this", this_fn), ("this", this_fn),
                ("other", other_fn)], reps)
    row = dict(call=name, ms=ms,
               profile={"this": cs.device_split(this_fn),
                        "other": cs.device_split(other_fn)})
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    opt = ap.parse_args()

    other = load_other(opt.other.resolve())
    ok1, ok3 = other.kernels.kr_contract, other.kernels.reml_newton
    _build.build_all(("kr_contract", "reml_newton"))
    other.kernels._build.build_all(("kr_contract", "reml_newton"))
    out = {"card": cs.card_line(), "other": str(opt.other), "calls": []}

    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    Ls = crp.get_L_values(d["hK"], d["E"])
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    calls = cs.capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx, G, G, n,
                                         delta_cfg=cs.DELTA_CFG),
        ["kr_contract"])["kr_contract"]
    for (args, _), name in zip(calls, cs.K1_CALLS):
        ref = k1.kr_contract_plain(*args)

        def check(label, got, ref=ref, name=name):
            rel = float((got - ref).abs().max() / ref.abs().max())
            assert rel <= 1e-12, f"K1 {name} ({label}): rel {rel}"

        out["calls"].append(compare(
            f"kr_contract ({name})", lambda a=args: k1.kr_contract(*a),
            lambda a=args: ok1.kr_contract(*a), check, reps=20))
        del ref

    rng = np.random.default_rng(cs.COVARIATES["seed"])
    W = np.concatenate([np.ones((n, 1)),
                        rng.normal(size=(n, cs.COVARIATES["p"] - 1))], axis=1)
    rho = np.linspace(0.0, 1.0, cs.COVARIATES["n_rho"])
    for p in (cs.COVARIATES["p"], 8):
        ctx_w = engine.build_null_context(d["y"], W[:, :p], d["E"], Ls=Ls,
                                          rho_grid=rho, device="cuda")
        (args, kw), = cs.capture_kernel_inputs(
            lambda: engine.interaction_batch(ctx_w, G, G, n,
                                             delta_cfg=cs.DELTA_CFG),
            ["reml_localize"])["reml_localize"]
        want = k3.reml_localize_plain(*args, **kw)

        def check(label, got, want=want, p=p):
            assert torch.equal(got[2], want[2]), f"K3 p={p} ({label}): k_best"
            assert cs._rel(got[0], want[0]) <= 1e-9, f"K3 p={p} ({label}): x"
            assert cs._rel(got[1], want[1]) <= 1e-10, \
                f"K3 p={p} ({label}): lml"

        out["calls"].append(compare(
            f"reml_localize (p = {p})",
            lambda a=args, k=kw: k3.reml_localize(*a, **k),
            lambda a=args, k=kw: ok3.reml_localize(*a, **k), check, reps=10))
        del want, ctx_w
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
