"""PLINK 1.x fileset reader: native threaded .bed decode + bim/fam parsing.

The port's own copy of ``cellregmap_tpu.utils.plink`` (NumPy only): the
genotype IO layer of the streaming scans (``plink_scan``), which decode
variant blocks from a PLINK fileset on the host without materializing the
whole genotype matrix.

    bed = PlinkReader("cohort")           # cohort.bed/.bim/.fam
    for block, rows in bed.iter_blocks(512):
        pv, info = crm.scan_interaction(block[donor_to_cell, :])

The decoder is ``native/bedreader.cc``, built with g++ on first use
(``utils.native.build_bed``); without a toolchain :func:`_decode_python`
decodes the same bytes in NumPy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .native import _LOCK, build_bed

_BED_LIB = None
_BED_TRIED = False
_MAGIC = b"\x6c\x1b\x01"


def _get_bed_lib():
    """The loaded native decoder, built on first use; None without a
    toolchain."""
    global _BED_LIB, _BED_TRIED
    with _LOCK:
        if not _BED_TRIED:
            _BED_TRIED = True
            path = build_bed()
            if path is not None:
                lib = ctypes.CDLL(str(path))
                lib.bed_decode_range.restype = ctypes.c_int
                lib.bed_decode_range.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_double), ctypes.c_int]
                _BED_LIB = lib
        return _BED_LIB


# 2-bit code -> A1 allele count: 00 hom A1, 01 missing, 10 het, 11 hom A2
_LUT = np.array([2.0, np.nan, 1.0, 0.0])


def _decode_python(path, n_samples, v_start, v_end):
    """The decoder's plain NumPy version: variants [v_start, v_end) of a
    SNP-major .bed as (n_samples, n) float64 allele counts, NaN missing."""
    bpv = (n_samples + 3) // 4
    with open(path, "rb") as f:
        if f.read(3) != _MAGIC:
            raise ValueError("not a SNP-major PLINK .bed file")
        f.seek(3 + v_start * bpv)
        raw = np.frombuffer(f.read((v_end - v_start) * bpv), dtype=np.uint8)
    raw = raw.reshape(v_end - v_start, bpv)
    codes = np.empty((v_end - v_start, bpv * 4), dtype=np.uint8)
    for shift in range(4):
        codes[:, shift::4] = (raw >> (2 * shift)) & 0x3
    return _LUT[codes[:, :n_samples]].T.copy()


@dataclass
class PlinkVariant:
    chrom: str
    snp_id: str
    cm: float
    pos: int
    a1: str
    a2: str


class PlinkReader:
    """Reader for a PLINK 1.x fileset (prefix.bed / .bim / .fam)."""

    def __init__(self, prefix: str):
        self.prefix = str(prefix)
        self.bed_path = self.prefix + ".bed"
        self.samples = self._read_fam()
        self.variants = self._read_bim()
        self.n_samples = len(self.samples)
        self.n_variants = len(self.variants)
        if not Path(self.bed_path).exists():
            raise FileNotFoundError(self.bed_path)

    def _read_fam(self) -> List[Tuple[str, str]]:
        out = []
        with open(self.prefix + ".fam") as f:
            for line in f:
                parts = line.split()
                if parts:
                    out.append((parts[0], parts[1]))
        return out

    def _read_bim(self) -> List[PlinkVariant]:
        out = []
        with open(self.prefix + ".bim") as f:
            for line in f:
                p = line.split()
                if len(p) >= 6:
                    out.append(PlinkVariant(p[0], p[1], float(p[2]),
                                            int(p[3]), p[4], p[5]))
        return out

    def fingerprint(self) -> str:
        """Short digest of the fileset: the .bim's and .fam's bytes and the
        .bed's size (a checkpoint's resume key)."""
        h = hashlib.sha256()
        for ext in (".bim", ".fam"):
            h.update(Path(self.prefix + ext).read_bytes())
        h.update(str(os.path.getsize(self.bed_path)).encode())
        return h.hexdigest()[:16]

    def read(self, v_start: int = 0, v_end: Optional[int] = None,
             n_threads: int = 0) -> np.ndarray:
        """Decode variants [v_start, v_end) -> (n_samples, n) float64
        allele counts with NaN for missing."""
        v_end = self.n_variants if v_end is None else v_end
        if not 0 <= v_start <= v_end <= self.n_variants:
            raise ValueError(f"variant range [{v_start}, {v_end}) outside "
                             f"[0, {self.n_variants})")
        lib = _get_bed_lib()
        if lib is None:
            return _decode_python(self.bed_path, self.n_samples, v_start,
                                  v_end)
        out = np.empty((v_end - v_start, self.n_samples), dtype=np.float64)
        rc = lib.bed_decode_range(
            self.bed_path.encode(), self.n_samples, self.n_variants,
            v_start, v_end,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_threads)
        if rc != 0:
            raise IOError(f"bed decode failed (rc={rc}) for {self.bed_path}")
        return out.T.copy()

    def iter_blocks(self, block_size: int = 512
                    ) -> Iterator[Tuple[np.ndarray, slice]]:
        """Stream (genotype block, variant slice) pairs."""
        for start in range(0, self.n_variants, block_size):
            end = min(start + block_size, self.n_variants)
            yield self.read(start, end), slice(start, end)


def write_bed(prefix: str, G: np.ndarray, snp_ids=None, sample_ids=None):
    """Write a (n_samples x n_variants) allele-count matrix (0, 1, 2; NaN
    missing) as a PLINK fileset (a testing and interop helper)."""
    G = np.asarray(G, float)
    n, m = G.shape
    miss = np.isnan(G)
    ok = miss | (G == 0.0) | (G == 1.0) | (G == 2.0)
    if not ok.all():
        raise ValueError("write_bed takes allele counts 0, 1, 2 or NaN")
    bpv = (n + 3) // 4
    # the 2-bit codes, variant-major, the padding samples coded 00
    codes = np.zeros((m, bpv * 4), dtype=np.uint8)
    codes[:, :n] = np.select([miss.T, G.T == 2.0, G.T == 1.0], [1, 0, 2], 3)
    quads = codes.reshape(m, bpv, 4)
    packed = (quads[..., 0] | (quads[..., 1] << 2) | (quads[..., 2] << 4)
              | (quads[..., 3] << 6))
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC)
        f.write(packed.astype(np.uint8).tobytes())
    with open(prefix + ".bim", "w") as f:
        for v in range(m):
            sid = snp_ids[v] if snp_ids is not None else f"snp{v}"
            f.write(f"1\t{sid}\t0\t{v + 1}\tA\tC\n")
    with open(prefix + ".fam", "w") as f:
        for s in range(n):
            sid = sample_ids[s] if sample_ids is not None else f"iid{s}"
            f.write(f"fam{s}\t{sid}\t0\t0\t0\t-9\n")
