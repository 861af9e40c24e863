"""Streaming, checkpointed scans straight from PLINK filesets (the JAX
package's ``plink_scan``, on the port's ``CellRegMap``).

Variant blocks stream from the native .bed decoder (``utils/plink.py``),
are mean-imputed, MAF-filtered, donor->cell expanded and standardized on
the host, and run through the scanner's device batches; each completed
block is made durable in an optional checkpoint, so a stopped genome scan
resumes at its last durable block.

One-command usage (see :func:`main`)::

    python -m cellregmap_tpu_torch.plink_scan --bed cohort \\
        --data dataset.npz --out results.npz --checkpoint ckpt_dir \\
        [--device cpu]

where ``dataset.npz`` holds cell-level ``y``, ``E`` and optionally ``W``,
``hK``, and ``donor_to_cell`` (int indices mapping each cell to a .fam row)
or ``donor_ids`` (per-cell donor IIDs matched against the .fam).  Without
``--device`` the scan runs on the card, and fails where there is none.

Gene-batched cis mode: provide ``Y`` (n_cells x n_genes) and ``windows``
(n_genes x 2 [start, end) .bim row ranges) in the npz instead of ``y``:
gene tiles decode the union of their cis windows once and run every
(gene, variant) pair through the gene-batched scan
(:func:`scan_interaction_multigene_plink`).

Two departures from the JAX package: a variant is kept only where its
cell-level column varies (the JAX package filters on the donor-level
column but standardizes the cell-level one, so a variant constant on the
donors that have cells becomes a NaN column and a NaN p-value); and a
checkpoint resumes only under the same fileset (.bim, .fam and the .bed's
size), scanner inputs (y, W, E, E1, the background, the donor map), config
and filters.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np

from ._config import DEFAULT_CONFIG
from .api import (CellRegMap, _batch_starts, _resolve_device,
                  get_L_values)
from .parallel.checkpoint import ScanCheckpoint
from .utils.maf import compute_maf
from .utils.plink import PlinkReader

_INFO = ("rho1", "e2", "g2", "eps2", "Q")


def resolve_donor_to_cell(reader: PlinkReader, donor_to_cell=None,
                          donor_ids=None) -> np.ndarray:
    """Per-cell row indices into the .fam sample table."""
    if donor_to_cell is not None:
        idx = np.asarray(donor_to_cell, int)
        if idx.min() < 0 or idx.max() >= reader.n_samples:
            raise ValueError("donor_to_cell index out of .fam range")
        return idx
    if donor_ids is None:
        raise ValueError("need donor_to_cell or donor_ids")
    iid_to_row = {iid: i for i, (_, iid) in enumerate(reader.samples)}
    try:
        return np.asarray([iid_to_row[str(d)] for d in np.asarray(donor_ids)])
    except KeyError as e:
        raise ValueError(f"donor id {e} not present in {reader.prefix}.fam")


def _prepare_block(Gd, d2c, maf_min: float, standardize: bool):
    """Donor genotypes (n_donors, B) -> mean-impute -> donor->cell expand
    -> MAF / cell-level variance filter -> optional standardize.

    MAF and the imputed means are donor-level (every .fam row), the
    variance filter cell-level: a variant constant on the cells' donors is
    dropped.  A column is constant over the cells exactly where it is
    constant over their donors, so the test reads the donors, and only the
    kept columns are expanded.  Returns ``(Gc (n_cells, kept) or None,
    maf_kept, keep)``.
    """
    maf = np.asarray(compute_maf(Gd), float)
    miss = np.isnan(Gd)
    if miss.any():
        mu = np.nanmean(Gd, axis=0)
        Gd = np.where(miss, mu[None, :], Gd)
    varies = np.ptp(Gd[np.unique(d2c)], axis=0) > 0
    keep = (maf >= maf_min) & varies & np.isfinite(maf)
    if not keep.any():
        return None, maf[keep], keep
    Gc = Gd[:, keep][d2c]                         # cells x kept
    if standardize:
        Gc = (Gc - Gc.mean(0)) / Gc.std(0)
    return Gc, maf[keep], keep


def _decode_block(reader: PlinkReader, v0: int, v1: int, d2c,
                  maf_min: float, standardize: bool):
    """Decode .bim rows [v0, v1) and prepare them (:func:`_prepare_block`).

    Returns ``(Gc (n_cells, kept) or None, maf_kept, kept_idx)``.
    """
    Gc, maf_kept, keep = _prepare_block(reader.read(v0, v1), d2c, maf_min,
                                        standardize)
    return Gc, maf_kept, v0 + np.flatnonzero(keep)


def _stream(n_units, unit, checkpoint, meta, progress, desc, axes=None):
    """Run ``unit(u)`` (a dict of result arrays, possibly empty) for every
    unit and return the results concatenated key by key (along
    ``axes.get(key, 0)``).

    With a ``checkpoint`` directory each completed unit is durable before
    the next runs, and a call whose ``meta`` matches the stored one
    resumes at its cursor; any other call starts over.  The checkpoint is
    cleared at the end.
    """
    axes = axes or {}
    ckpt = None if checkpoint is None else ScanCheckpoint(checkpoint)
    start, acc = 0, {}
    if ckpt is not None:
        state = ckpt.load()
        if state is not None and all(state["meta"].get(k) == v
                                     for k, v in meta.items()):
            start = state["cursor"]
            acc = {k: [v] for k, v in state["results"].items()}

    def flat():
        return {k: np.concatenate(v, axis=axes.get(k, 0))
                for k, v in acc.items()}

    for u in _batch_starts(range(start, n_units), 1, progress, desc):
        for k, v in unit(u).items():
            acc.setdefault(k, []).append(np.asarray(v))
        if ckpt is not None:
            tables = flat()
            ckpt.save(u + 1, tables, meta)
            acc = {k: [v] for k, v in tables.items()}
    if ckpt is not None:
        ckpt.clear()
    return flat()


def _meta(crm: CellRegMap, reader: PlinkReader, checkpoint, scan: str,
          d2c, *arrays, **fields):
    """A driver's checkpoint meta: the scan, the fileset and its size, the
    filters, and (with a checkpoint) the fileset's and the scanner's
    fingerprints and the config."""
    meta = {"scan": scan, "prefix": reader.prefix,
            "n_variants": reader.n_variants, **fields}
    if checkpoint is not None:
        cfg = dataclasses.replace(crm._cfg, progress=False, trace=False)
        meta.update(fileset=reader.fingerprint(),
                    inputs_sha=crm._inputs_sha(d2c, *arrays),
                    config=repr(cfg))
    return meta


def _open(crm: CellRegMap, prefix, donor_to_cell, donor_ids):
    reader = PlinkReader(prefix)
    d2c = resolve_donor_to_cell(reader, donor_to_cell, donor_ids)
    if d2c.shape[0] != crm.n_samples:
        raise ValueError("donor map length != model's n_cells")
    return reader, d2c


def _block_scan(crm, prefix, scan, donor_to_cell, donor_ids, block_size,
                maf_min, standardize, checkpoint, progress, name, meta_extra,
                axes=None):
    """The single-gene drivers' loop: block b decodes .bim rows
    [b * block_size, (b + 1) * block_size), and ``scan(Gc, maf_kept)``
    maps its kept columns to result arrays."""
    reader, d2c = _open(crm, prefix, donor_to_cell, donor_ids)
    meta = _meta(crm, reader, checkpoint, name, d2c, block_size=block_size,
                 maf_min=maf_min, standardize=standardize, **meta_extra)

    def unit(b):
        v0 = b * block_size
        v1 = min(v0 + block_size, reader.n_variants)
        Gc, maf_kept, kept_idx = _decode_block(reader, v0, v1, d2c, maf_min,
                                               standardize)
        out = {} if Gc is None else dict(scan(Gc, maf_kept), maf=maf_kept)
        out["variant_index"] = kept_idx
        return out

    n_blocks = -(-reader.n_variants // block_size)
    return _stream(n_blocks, unit, checkpoint, meta, progress,
                   f"{name}_plink", axes)


def scan_interaction_plink(crm: CellRegMap, prefix: str, *,
                           donor_to_cell=None, donor_ids=None,
                           block_size: int = 2048, maf_min: float = 0.0,
                           standardize: bool = True,
                           checkpoint: Optional[str] = None,
                           progress: bool = False):
    """Checkpointed streaming interaction scan over a PLINK fileset.

    Per block: decode donor-level genotypes, mean-impute missing calls,
    expand donors to cells, drop variants with MAF < ``maf_min`` or no
    cell-level variance, (optionally) standardize the cell-level columns,
    and run ``crm.scan_interaction``.  Completed blocks are persisted to
    ``checkpoint`` (cursor + accumulated tables); a rerun with the same
    fileset, scanner, config, block size and filters resumes after the
    last durable block.

    Returns ``(pvalues, info, variant_index)`` where ``variant_index`` maps
    each result row to its .bim row (post-filter).
    """
    def scan(Gc, _):
        pv, info = crm.scan_interaction(Gc)
        return dict({k: info[k] for k in _INFO}, pvalues=pv)

    acc = _block_scan(crm, prefix, scan, donor_to_cell, donor_ids,
                      block_size, maf_min, standardize, checkpoint, progress,
                      "interaction", {})
    info = {k: acc[k] for k in _INFO + ("maf",) if k in acc}
    return (acc.get("pvalues", np.zeros(0)), info,
            acc.get("variant_index", np.zeros(0, int)))


def scan_interaction_screen_plink(crm: CellRegMap, prefix: str, *,
                                  donor_to_cell=None, donor_ids=None,
                                  significance: float = 5e-8,
                                  screen_margin: float = 100.0,
                                  block_size: int = 2048,
                                  maf_min: float = 0.0,
                                  standardize: bool = True,
                                  checkpoint: Optional[str] = None,
                                  progress: bool = False):
    """Genome-scale two-pass screen -> confirm scan over a PLINK fileset.

    Per block the float32 screen tests every variant and the float64
    Davies pass re-tests the candidate hits (see
    :meth:`CellRegMap.scan_interaction_screen` for the contract).
    Completed blocks are durable; a rerun resumes at the block cursor.

    Returns ``(pvalues, info, variant_index)`` where ``info`` carries
    ``confirmed`` / ``screen_pv`` per kept variant.
    """
    def scan(Gc, _):
        pv, info = crm.scan_interaction_screen(
            Gc, significance=significance, screen_margin=screen_margin)
        return dict({k: info[k] for k in _INFO + ("confirmed", "screen_pv")},
                    pvalues=pv)

    acc = _block_scan(crm, prefix, scan, donor_to_cell, donor_ids,
                      block_size, maf_min, standardize, checkpoint, progress,
                      "interaction_screen",
                      dict(significance=significance,
                           screen_margin=screen_margin))
    info = {k: acc[k] for k in _INFO + ("maf", "confirmed", "screen_pv")
            if k in acc}
    return (acc.get("pvalues", np.zeros(0)), info,
            acc.get("variant_index", np.zeros(0, int)))


def scan_association_plink(crm: CellRegMap, prefix: str, *,
                           donor_to_cell=None, donor_ids=None,
                           fast: bool = True, block_size: int = 2048,
                           maf_min: float = 0.0, standardize: bool = True,
                           checkpoint: Optional[str] = None,
                           progress: bool = False):
    """Checkpointed streaming association (LRT) scan over a PLINK fileset.

    ``fast=True`` runs the closed-form fast scanner per block (reference
    pattern _cellregmap.py:284-314), ``fast=False`` the per-variant ML
    refits (:246-281).  The covariate-only null fits once (the scanner
    keeps it), in the first block's scan.  Completed blocks are durable; a
    rerun resumes after the last checkpointed block.

    Returns ``(pvalues, info, variant_index)`` like
    :func:`scan_interaction_plink`, info holding the null fit's rho1, e2,
    g2, eps2 and the kept variants' maf.
    """
    run = crm.scan_association_fast if fast else crm.scan_association

    def scan(Gc, _):
        return {"pvalues": run(Gc)[0]}

    acc = _block_scan(crm, prefix, scan, donor_to_cell, donor_ids,
                      block_size, maf_min, standardize, checkpoint, progress,
                      "association_fast" if fast else "association", {})
    info = crm._assoc_info(*crm._fit_null_association())   # fitted once
    info["maf"] = acc.get("maf", np.zeros(0))
    return (acc.get("pvalues", np.zeros(0)), info,
            acc.get("variant_index", np.zeros(0, int)))


def estimate_betas_plink(crm: CellRegMap, prefix: str, *,
                         donor_to_cell=None, donor_ids=None,
                         block_size: int = 2048, maf_min: float = 0.0,
                         standardize: bool = False,
                         checkpoint: Optional[str] = None,
                         progress: bool = False):
    """Checkpointed streaming effect-size estimation over a PLINK fileset.

    Per block: decode, impute, expand and filter (``standardize`` defaults
    to False: the reference's ``estimate_betas`` takes raw 0/1/2 genotypes
    and normalizes by 1/sqrt(2 p (1-p)) itself, _cellregmap.py:640-682),
    then ``crm.predict_interaction`` with the block's donor-level MAF.
    The background factorization is built once, in the first block's
    call.  Durable per-block checkpoints.

    Returns ``(beta_g (V,), beta_gxe (n_cells, V), maf, variant_index)``.
    """
    def scan(Gc, maf_kept):
        bg, bgxe = crm.predict_interaction(Gc, maf_kept)
        return {"beta_g": bg, "beta_gxe": bgxe}

    acc = _block_scan(crm, prefix, scan, donor_to_cell, donor_ids,
                      block_size, maf_min, standardize, checkpoint, progress,
                      "betas", {}, axes={"beta_gxe": 1})
    return (acc.get("beta_g", np.zeros(0)),
            acc.get("beta_gxe", np.zeros((crm.n_samples, 0))),
            acc.get("maf", np.zeros(0)),
            acc.get("variant_index", np.zeros(0, int)))


def scan_interaction_multigene_plink(crm: CellRegMap, prefix: str, Y,
                                     windows, *, donor_to_cell=None,
                                     donor_ids=None, gene_batch: int = 16,
                                     maf_min: float = 0.0,
                                     standardize: bool = True,
                                     checkpoint: Optional[str] = None,
                                     progress: bool = False):
    """Gene-batched cis-window interaction scans from a PLINK fileset.

    The production eQTL workload: ``Y`` is (n_cells, n_genes) and
    ``windows`` is (n_genes, 2) with each gene's [start, end) .bim row
    range (e.g. TSS +- 1 Mb).  Genes are tiled in window order; each tile
    decodes the UNION of its members' windows once, runs every (gene,
    variant) pair through ``crm.scan_interaction_multigene`` (the
    genotype's contractions shared across the tile: adjacent cis windows
    overlap heavily), and keeps only pairs inside each gene's own window.
    Completed tiles are durable; a rerun resumes at the tile cursor.

    Returns a dict of flat arrays: ``gene`` (original Y column per row),
    ``variant_index`` (.bim row), ``pvalues``, ``maf``, ``rho1``, ``e2``,
    ``g2``, ``eps2``, ``Q``.
    """
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    windows = np.asarray(windows, int)
    if windows.shape != (Y.shape[1], 2):
        raise ValueError("windows must be (n_genes, 2) [start, end) rows")
    reader, d2c = _open(crm, prefix, donor_to_cell, donor_ids)
    if (windows[:, 0] < 0).any() or (windows[:, 1] > reader.n_variants).any():
        raise ValueError("window out of .bim range")

    order = np.argsort(windows[:, 0], kind="stable")
    tiles = [order[i : i + gene_batch]
             for i in range(0, len(order), gene_batch)]
    # Y and the windows are fingerprinted with the scanner's inputs:
    # resuming under others would splice incompatible tiles
    meta = _meta(crm, reader, checkpoint, "interaction_multigene", d2c, Y,
                 windows, n_genes=int(Y.shape[1]), gene_batch=gene_batch,
                 maf_min=maf_min, standardize=standardize)

    def unit(t):
        genes = tiles[t]
        v0 = int(windows[genes, 0].min())
        v1 = int(windows[genes, 1].max())
        Gc, maf_kept, kept_idx = _decode_block(reader, v0, v1, d2c, maf_min,
                                               standardize)
        out: dict = {}
        if Gc is None:
            return out
        pv, info = crm.scan_interaction_multigene(Y[:, genes], Gc,
                                                  gene_batch=len(genes))
        for gi, g in enumerate(genes):
            inwin = (kept_idx >= windows[g, 0]) & (kept_idx < windows[g, 1])
            for k, v in (("gene", np.full(int(inwin.sum()), g, int)),
                         ("variant_index", kept_idx[inwin]),
                         ("pvalues", pv[gi][inwin]),
                         ("maf", maf_kept[inwin]),
                         *((k, info[k][gi][inwin]) for k in _INFO)):
                out.setdefault(k, []).append(v)
        return {k: np.concatenate(v) for k, v in out.items()}

    acc = _stream(len(tiles), unit, checkpoint, meta, progress,
                  "interaction_multigene_plink")
    out = {"gene": acc.get("gene", np.zeros(0, int)),
           "variant_index": acc.get("variant_index", np.zeros(0, int))}
    for k in ("pvalues", "maf") + _INFO:
        out[k] = acc.get(k, np.zeros(0))
    return out


def main(argv=None):
    """CLI: checkpointed streaming scans from a .bed fileset."""
    ap = argparse.ArgumentParser(
        prog="python -m cellregmap_tpu_torch.plink_scan",
        description="Streaming checkpointed CellRegMap scans over a PLINK "
                    "fileset (PyTorch port: on the card unless --device cpu)")
    ap.add_argument("--bed", required=True,
                    help="PLINK prefix (prefix.bed/.bim/.fam)")
    ap.add_argument("--data", required=True,
                    help="npz with y, E[, W, hK, donor_to_cell|donor_ids]")
    ap.add_argument("--out", required=True, help="output npz path")
    ap.add_argument("--checkpoint", default=None, help="checkpoint dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "port on the CPU)")
    ap.add_argument("--block-size", type=int, default=2048)
    ap.add_argument("--maf-min", type=float, default=0.0)
    ap.add_argument("--snp-batch", type=int, default=None)
    ap.add_argument("--pvalue-method", default=None)
    ap.add_argument("--gene-batch", type=int, default=16,
                    help="gene tile size for multigene (Y + windows) scans")
    ap.add_argument("--mode", default="interaction",
                    choices=("interaction", "interaction-screen",
                             "association", "association-fast", "betas"),
                    help="scan type (multigene Y+windows data implies the "
                         "gene-batched interaction scan)")
    ap.add_argument("--significance", type=float, default=5e-8,
                    help="interaction-screen mode: genome-wide cutoff")
    ap.add_argument("--screen-margin", type=float, default=100.0,
                    help="interaction-screen mode: confirm-threshold "
                         "multiple over --significance")
    args = ap.parse_args(argv)
    try:
        device = _resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (--device cpu)")

    with np.load(args.data, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    overrides = {}
    if args.snp_batch is not None:
        overrides["snp_batch"] = args.snp_batch
    if args.pvalue_method is not None:
        overrides["pvalue_method"] = args.pvalue_method
    cfg = dataclasses.replace(DEFAULT_CONFIG, **overrides)

    E = d["E"]
    Ls = get_L_values(d["hK"], E) if "hK" in d else None
    multigene = "Y" in d and "windows" in d
    y0 = d["Y"][:, 0] if multigene else d["y"]
    crm = CellRegMap(y=y0, E=E, W=d.get("W"), Ls=Ls, config=cfg,
                     device=device)
    common = dict(donor_to_cell=d.get("donor_to_cell"),
                  donor_ids=d.get("donor_ids"), maf_min=args.maf_min,
                  checkpoint=args.checkpoint, progress=True)
    if multigene:
        res = scan_interaction_multigene_plink(
            crm, args.bed, d["Y"], d["windows"], gene_batch=args.gene_batch,
            **common)
        np.savez(args.out, **res)
        summary = {"n_tested": int(res["pvalues"].shape[0]),
                   "n_genes": int(d["Y"].shape[1])}
    elif args.mode == "betas":
        bg, bgxe, maf, vidx = estimate_betas_plink(
            crm, args.bed, block_size=args.block_size, **common)
        np.savez(args.out, beta_g=bg, beta_gxe=bgxe, maf=maf,
                 variant_index=vidx)
        summary = {"n_tested": int(bg.shape[0]),
                   "n_variants": int(vidx.shape[0])}
    elif args.mode == "interaction-screen":
        pv, info, vidx = scan_interaction_screen_plink(
            crm, args.bed, significance=args.significance,
            screen_margin=args.screen_margin, block_size=args.block_size,
            **common)
        np.savez(args.out, pvalues=pv, variant_index=vidx, **info)
        summary = {"n_tested": int(pv.shape[0]),
                   "n_confirmed": int(info["confirmed"].sum())
                   if "confirmed" in info else 0}
    elif args.mode in ("association", "association-fast"):
        pv, info, vidx = scan_association_plink(
            crm, args.bed, fast=args.mode == "association-fast",
            block_size=args.block_size, **common)
        np.savez(args.out, pvalues=pv, variant_index=vidx, maf=info["maf"])
        summary = {"n_tested": int(pv.shape[0]),
                   "n_variants": int(vidx.shape[0])}
    else:
        pv, info, vidx = scan_interaction_plink(
            crm, args.bed, block_size=args.block_size, **common)
        np.savez(args.out, pvalues=pv, variant_index=vidx, **info)
        summary = {"n_tested": int(pv.shape[0]),
                   "n_variants": int(vidx.shape[0])}
    print(json.dumps(dict(summary, device=str(crm.device), out=args.out)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
