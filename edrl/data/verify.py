"""Real-data preflight verifier.

The environment this framework was built in has no copy of Harvard-30K /
GAMMA, so the real-data path (``gamma.py``) has only ever executed against
generated fixtures.  This module answers, in seconds and with actionable
errors, the question "will ``--dataset dr2`` (or ``glu2``) work on this
disk?" — BEFORE a user pays the 15-25 minute full-model compile and then
crashes in epoch 0 on a malformed sample.

It guards the reference's fragile loading surface
(``code/data_harvard.py:663-681``: fundus path pattern, NIfTI fallback
name, hard-coded transpose) plus the defects the round-3 review campaign
found live (NIfTI scl_slope/inter handling, lexicographic OCT slice order
scrambling the depth axis, stale resize caches keyed on one shape knob).

Checks are header-level by default (no volume decode); ``deep=True``
additionally loads every sampled item through the real dataset class and
validates shapes/ranges.

CLI front-end: ``scripts/verify_dataset.py``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import struct
from typing import List, Optional, Sequence

import numpy as np

from edrl.config import DataConfig
from edrl.data.gamma import _slice_sort_key, load_labels
from edrl.data.nifti import _DTYPES


@dataclasses.dataclass
class Finding:
    severity: str  # "error" | "warning"
    sample: str  # sample id or "" for dataset-level findings
    message: str

    def __str__(self):
        tag = "ERROR" if self.severity == "error" else "warn "
        where = f"[{self.sample}] " if self.sample else ""
        return f"{tag}: {where}{self.message}"


@dataclasses.dataclass
class Report:
    dataset: str
    findings: List[Finding]
    n_listed: int = 0  # ids found on disk
    n_labeled: int = 0  # rows in the label file
    n_joined: int = 0  # samples that will actually load
    n_checked: int = 0

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors and self.n_joined > 0

    def summary(self) -> str:
        lines = [str(f) for f in self.findings]
        lines.append(
            f"{self.dataset}: {self.n_joined} joined samples "
            f"({self.n_listed} dirs on disk, {self.n_labeled} label rows); "
            f"checked {self.n_checked}; "
            f"{len(self.errors)} errors, {len(self.warnings)} warnings"
        )
        if self.ok:
            lines.append(
                f"READY: --dataset {self.dataset} will load {self.n_joined} "
                f"samples from this tree"
            )
        else:
            lines.append(
                f"NOT READY: fix the errors above before training on this tree"
            )
        return "\n".join(lines)


def _check_nifti_header(path: str, findings: List[Finding], sid: str) -> None:
    """Header-level NIfTI-1 validation mirroring ``nifti.read_nifti`` —
    every rejection here is one read_nifti would crash (or silently
    mis-scale) on."""
    try:
        import gzip

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            raw = f.read(352)
        size = os.path.getsize(path)
    except OSError as e:
        findings.append(Finding("error", sid, f"unreadable NIfTI {path}: {e}"))
        return
    if len(raw) < 348:
        findings.append(
            Finding("error", sid, f"{path}: truncated header ({len(raw)} < 348 bytes)")
        )
        return
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        findings.append(
            Finding(
                "error",
                sid,
                f"{path}: not NIfTI-1 (sizeof_hdr={sizeof_hdr}; byte-swapped "
                f"big-endian files and NIfTI-2 are not supported)",
            )
        )
        return
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    if not (1 <= ndim <= 7):
        findings.append(Finding("error", sid, f"{path}: bad ndim {ndim}"))
        return
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    squeezed = tuple(s for s in shape if s > 1)
    if len(squeezed) != 3:
        findings.append(
            Finding(
                "error",
                sid,
                f"{path}: expected a 3-D volume, header says shape {shape} "
                f"(the loader transposes (H,W,D)->(D,H,W) and a non-3-D "
                f"volume breaks that contract)",
            )
        )
    if any(s <= 1 for s in shape):
        findings.append(
            Finding("warning", sid, f"{path}: degenerate axis in shape {shape}")
        )
    datatype = struct.unpack_from("<h", raw, 70)[0]
    if datatype not in _DTYPES:
        findings.append(
            Finding(
                "error",
                sid,
                f"{path}: unsupported NIfTI datatype code {datatype} "
                f"(supported: {sorted(_DTYPES)})",
            )
        )
        return
    itemsize = np.dtype(_DTYPES[datatype]).itemsize
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0]) or 352
    # .gz payload size is unknown without decompressing; check plain files.
    if not path.endswith(".gz"):
        need = vox_offset + int(np.prod(shape)) * itemsize
        if size < need:
            findings.append(
                Finding(
                    "error",
                    sid,
                    f"{path}: file is {size} bytes but header promises "
                    f"{need} (offset {vox_offset} + {shape} x {itemsize}B) — "
                    f"truncated download?",
                )
            )
    scl_slope = struct.unpack_from("<f", raw, 112)[0]
    scl_inter = struct.unpack_from("<f", raw, 116)[0]
    # Mirror the loader's condition exactly (nifti.py::read_nifti): scaling
    # applies whenever slope != 0 AND (slope != 1 OR inter != 0) — an
    # inter-only shift (slope 1, inter != 0) IS rescaled at load and must
    # not pass preflight silently (ADVICE r4 #3).  NaN means unset.
    if not np.isfinite(scl_slope):
        scl_slope = 0.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        findings.append(
            Finding(
                "warning",
                sid,
                f"{path}: scl_slope={scl_slope:g} scl_inter={scl_inter:g} — "
                f"scaling IS applied (nibabel get_fdata parity); values may "
                f"leave [0,255] and will be clipped after /255",
            )
        )


def _check_image(path: str, findings: List[Finding], sid: str,
                 min_side: int = 8) -> None:
    if not os.path.exists(path):
        findings.append(
            Finding(
                "error",
                sid,
                f"missing fundus image {path} (expected pattern "
                f"data_<id>_fundus.png per code/data_harvard.py:663-668)",
            )
        )
        return
    try:
        from edrl.data.gamma import _read_image

        img = _read_image(path)
    except Exception as e:
        findings.append(Finding("error", sid, f"undecodable image {path}: {e}"))
        return
    if img.ndim != 3 or img.shape[2] != 3:
        findings.append(
            Finding("error", sid, f"{path}: decoded shape {img.shape}, want [H,W,3]")
        )
    elif min(img.shape[:2]) < min_side:
        findings.append(
            Finding("warning", sid, f"{path}: tiny image {img.shape[:2]}")
        )


def _check_stale_caches(d: str, cfg: DataConfig, findings: List[Finding],
                        sid: str) -> None:
    dd, oh, ow = cfg.oct_size
    want = f"_edrl_cache8_{cfg.fundus_size}_{dd}x{oh}x{ow}.npz"
    stale = [
        os.path.basename(p)
        for p in glob.glob(os.path.join(d, "_edrl_cache8_*.npz"))
        if os.path.basename(p) != want
    ]
    if stale:
        findings.append(
            Finding(
                "warning",
                sid,
                f"stale resize caches for other shapes: {stale} (harmless — "
                f"keyed per shape — but delete to reclaim space)",
            )
        )


def verify_tree(
    cfg: DataConfig,
    max_samples: Optional[int] = None,
    deep: bool = False,
) -> Report:
    """Validate that ``cfg.data_path`` + ``cfg.label_file`` can feed
    ``--dataset {cfg.dataset}``.  Returns a :class:`Report`; ``report.ok``
    is the single go/no-go bit."""
    dataset = cfg.dataset
    findings: List[Finding] = []
    rep = Report(dataset=dataset, findings=findings)

    if not os.path.isdir(cfg.data_path):
        findings.append(
            Finding("error", "", f"data_path {cfg.data_path!r} is not a directory")
        )
        return rep
    if not os.path.exists(cfg.label_file):
        findings.append(
            Finding("error", "", f"label_file {cfg.label_file!r} does not exist")
        )
        return rep

    try:
        labels = load_labels(cfg.label_file)
    except Exception as e:
        findings.append(
            Finding(
                "error",
                "",
                f"label file {cfg.label_file} failed to parse: {e!r} (need an "
                f"id column 'data' + one-hot class columns, xlsx or csv)",
            )
        )
        return rep
    rep.n_labeled = len(labels)
    if not labels:
        findings.append(Finding("error", "", f"{cfg.label_file}: no label rows"))
        return rep
    widths = {len(v) for v in labels.values()}
    if len(widths) > 1:
        findings.append(
            Finding(
                "error", "",
                f"label rows have inconsistent one-hot widths {sorted(widths)}",
            )
        )
    bad_rows = [k for k, v in labels.items() if not np.all(np.isfinite(v))]
    if bad_rows:
        findings.append(
            Finding(
                "error", "",
                f"non-numeric/NaN one-hot cells for ids {bad_rows[:5]}"
                + ("..." if len(bad_rows) > 5 else ""),
            )
        )
    multi_hot = [
        k for k, v in labels.items()
        if np.all(np.isfinite(v)) and not np.isclose(float(np.sum(v)), 1.0)
    ]
    if multi_hot:
        findings.append(
            Finding(
                "warning", "",
                f"{len(multi_hot)} label rows do not sum to 1 (consumed as "
                f"argmax — ties resolve to the first class), e.g. "
                f"{multi_hot[:3]}",
            )
        )

    listed = sorted(
        e for e in os.listdir(cfg.data_path)
        if os.path.isdir(os.path.join(cfg.data_path, e))
    )
    rep.n_listed = len(listed)

    def joinable(name: str) -> bool:
        key = name.zfill(5) if name.isdigit() else name
        return key in labels or name in labels

    joined = [n for n in listed if joinable(n)]
    rep.n_joined = len(joined)
    if not joined:
        findings.append(
            Finding(
                "error",
                "",
                f"zero samples join: no directory name under {cfg.data_path} "
                f"matches a label id (disk e.g. {listed[:3]}, labels e.g. "
                f"{sorted(labels)[:3]}; ids are zero-fill-5 normalized when "
                f"numeric)",
            )
        )
        return rep
    unlabeled = len(listed) - len(joined)
    if unlabeled:
        findings.append(
            Finding(
                "warning", "",
                f"{unlabeled} on-disk directories have no label row and will "
                f"be skipped",
            )
        )
    disk_keys = {(n.zfill(5) if n.isdigit() else n) for n in listed} | set(listed)
    missing_on_disk = [k for k in labels if k not in disk_keys]
    if missing_on_disk:
        findings.append(
            Finding(
                "warning", "",
                f"{len(missing_on_disk)} label rows have no directory on "
                f"disk, e.g. {sorted(missing_on_disk)[:3]}",
            )
        )

    check = joined if max_samples is None else joined[:max_samples]
    rep.n_checked = len(check)
    for name in check:
        d = os.path.join(cfg.data_path, name)
        if dataset in ("dr2", "gamma"):
            _check_image(os.path.join(d, f"data_{name}_fundus.png"), findings, name)
            nii = os.path.join(d, f"data_{name}.nii")
            if not os.path.exists(nii):
                alt = os.path.join(d, f"processed_data_{name}.nii")
                if os.path.exists(alt):
                    nii = alt
                else:
                    findings.append(
                        Finding(
                            "error",
                            name,
                            f"missing OCT volume: neither data_{name}.nii nor "
                            f"processed_data_{name}.nii under {d}",
                        )
                    )
                    continue
            _check_nifti_header(nii, findings, name)
            _check_stale_caches(d, cfg, findings, name)
        elif dataset in ("glu2", "sub1"):
            _check_image_sub1(d, name, findings)
        else:
            findings.append(
                Finding("error", "", f"unknown on-disk dataset {dataset!r}")
            )
            break

    if deep and not rep.errors:
        _deep_check(cfg, check, findings)
    return rep


def _check_image_sub1(d: str, name: str, findings: List[Finding]) -> None:
    png = os.path.join(d, f"{name}.png")
    if not os.path.exists(png):
        findings.append(
            Finding("error", name, f"missing fundus image {png} "
                    f"(glu2 layout: <root>/<id>/<id>.png)")
        )
    else:
        _check_image(png, findings, name)
    slice_dir = os.path.join(d, name)
    if not os.path.isdir(slice_dir):
        findings.append(
            Finding(
                "error", name,
                f"missing OCT slice directory {slice_dir} "
                f"(glu2 layout: <root>/<id>/<id>/<slice>.jpg)",
            )
        )
        return
    slices = [
        s for s in os.listdir(slice_dir)
        if s.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
    ]
    if not slices:
        findings.append(
            Finding("error", name, f"{slice_dir}: no image slices found")
        )
        return
    non_numeric = [
        s for s in slices if not any(ch.isdigit() for ch in os.path.splitext(s)[0])
    ]
    if non_numeric:
        findings.append(
            Finding(
                "warning", name,
                f"{len(non_numeric)} slice filenames carry no number (e.g. "
                f"{non_numeric[:3]}) — depth order falls back to "
                f"lexicographic for those and the volume axis may scramble",
            )
        )
    ordered = sorted(slices, key=_slice_sort_key)
    if ordered != sorted(slices):
        # Purely informational: numeric-aware ordering is what the loader
        # uses; flag that plain lexicographic order WOULD have scrambled it.
        findings.append(
            Finding(
                "warning", name,
                "slice filenames are unpadded numbers; numeric-aware "
                "ordering is applied (lexicographic order would scramble "
                "the depth axis)",
            )
        )


def _deep_check(cfg: DataConfig, ids: Sequence[str], findings: List[Finding]):
    """Load every checked sample through the REAL dataset class and
    validate the tensors the trainer will see."""
    from edrl.data.gamma import GammaDataset, GammaSub1Dataset

    cls = GammaSub1Dataset if cfg.dataset in ("glu2", "sub1") else GammaDataset
    try:
        ds = cls(cfg, mode="test", filelists=list(ids))
    except Exception as e:
        findings.append(Finding("error", "", f"dataset construction failed: {e!r}"))
        return
    for i in range(len(ds)):
        sid = ds.samples[i][0]
        try:
            item = ds.get(i)
        except Exception as e:
            findings.append(Finding("error", sid, f"sample load failed: {e!r}"))
            continue
        for k, v in item.items():
            arr = np.asarray(v)
            if not np.all(np.isfinite(arr)):
                findings.append(
                    Finding("error", sid, f"non-finite values in {k!r}")
                )
        fundus = np.asarray(item.get("fundus", item.get("fundus_low")))
        if fundus.shape[:2] != (cfg.fundus_size, cfg.fundus_size):
            findings.append(
                Finding(
                    "error", sid,
                    f"fundus resized to {fundus.shape}, expected "
                    f"({cfg.fundus_size}, {cfg.fundus_size}, 3)",
                )
            )
        oct_key = "oct" if "oct" in item else "oct_low"
        oct_arr = np.asarray(item[oct_key])
        if oct_arr.shape[:3] != tuple(cfg.oct_size):
            findings.append(
                Finding(
                    "error", sid,
                    f"OCT resized to {oct_arr.shape}, expected {cfg.oct_size}",
                )
            )
