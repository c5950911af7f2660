"""GAMMA / Harvard-30K style on-disk dataset.

Rebuilds the active ``GAMMA_dataset`` (``code/data_harvard.py:598-857``):

- fundus: ``{root}/{id}/data_{id}_fundus.png`` (``:663-668``)
- OCT: ``{root}/{id}/data_{id}.nii`` with ``processed_data_{id}.nii``
  fallback (``:671-681``), stored (H, W, D) -> transposed to (D, H, W)
- labels: xlsx/csv with a ``data`` id column and one-hot ``class_*`` columns,
  consumed as argmax (``:645-646,838``)
- transformer path resize: fundus -> 384^2 cubic, OCT -> 96^3 zoom (``:686-688``)
- normalize /255, dual noise views, train augmentations.

Improvement over the reference (SURVEY.md "Hard parts", input-pipeline
throughput): decoded+resized arrays are memoized to ``.npz`` next to the
source files (one-time conversion), so steady-state epochs skip PNG/NIfTI
decode and volume zoom entirely.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from edrl.config import DataConfig
from edrl.data.nifti import read_nifti
from edrl.data.noise import make_noise_views, sample_rng
from edrl.data.transforms import (
    fundus_train_augment,
    oct_train_augment,
    resize_image,
    resize_volume,
)


def _slice_sort_key(name: str):
    """Depth-order key for OCT slice filenames: '2.jpg' < '10.jpg' <
    '100.jpg' (numeric on the first digit run; non-numeric names sort
    after, lexicographically)."""
    import re

    m = re.search(r"\d+", os.path.splitext(name)[0])
    return (0, int(m.group(0)), name) if m else (1, 0, name)


def _read_image(path: str) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1].astype(np.float32)  # BGR -> RGB
    except ImportError:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB")).astype(np.float32)


def load_labels(label_file: str) -> Dict[str, np.ndarray]:
    """id -> one-hot row, from xlsx or csv.

    xlsx parsing is dependency-free (``edrl.data.xlsx``) — this
    environment lacks openpyxl, so ``pd.read_excel`` is unavailable.
    """
    out: Dict[str, np.ndarray] = {}
    if label_file.endswith(".csv"):
        import pandas as pd

        df = pd.read_csv(label_file)
        for _, row in df.iterrows():
            out[str(row["data"]).zfill(5)] = row.values[1:].astype(np.float32)
        return out
    from edrl.data.xlsx import read_xlsx_rows

    rows = read_xlsx_rows(label_file)
    for row in rows[1:]:
        if not row or row[0] is None:
            continue
        sid = str(row[0]).split(".")[0]  # numeric cells may read as "123.0"
        values = np.array(
            [float(v) if v is not None else 0.0 for v in row[1:]], dtype=np.float32
        )
        out[sid.zfill(5)] = values
    return out


class GammaDataset:
    def __init__(
        self,
        cfg: DataConfig,
        mode: str = "train",
        filelists: Optional[Sequence[str]] = None,
        cache: bool = True,
    ):
        self.cfg = cfg
        self.mode = mode.lower()
        self.cache = cache
        labels = load_labels(cfg.label_file)
        ids = filelists if filelists is not None else sorted(os.listdir(cfg.data_path))
        self.samples: List = []
        for sid in ids:
            name = os.path.basename(str(sid))
            key = name.zfill(5) if name.isdigit() else name
            if key not in labels and name not in labels:
                continue
            one_hot = labels.get(key, labels.get(name))
            # Resolve the on-disk directory: ids may be zero-padded in the
            # label file but unpadded on disk (or vice versa).
            candidates = [name]
            if name.isdigit():
                candidates += [name.zfill(5), str(int(name))]
            dir_name = next(
                (c for c in candidates if os.path.isdir(os.path.join(cfg.data_path, c))),
                name,
            )
            self.samples.append((dir_name, one_hot))

    def __len__(self) -> int:
        return len(self.samples)

    def _load_raw(self, sid: str):
        """Decoded + resized sample, memoized to disk as UNCOMPRESSED uint8
        (zlib decompression of float32 caches cost ~30ms/sample; uint8 raw
        reads are ~1ms and lossless for 8-bit sources)."""
        root = self.cfg.data_path
        as_uint8 = self.cfg.device_noise and self.cfg.uint8_transport
        # Key the cache on EVERY shape knob: a filename keyed on fundus_size
        # alone served stale 96^3 volumes after an oct_size change.
        d, oh, ow = self.cfg.oct_size
        cache_path = os.path.join(
            root,
            sid,
            f"_edrl_cache8_{self.cfg.fundus_size}_{d}x{oh}x{ow}.npz",
        )
        if self.cache and os.path.exists(cache_path):
            z = np.load(cache_path)
            if as_uint8:
                return z["fundus"], z["oct"]
            return (
                z["fundus"].astype(np.float32) / 255.0,
                z["oct"].astype(np.float32) / 255.0,
            )
        fundus = _read_image(os.path.join(root, sid, f"data_{sid}_fundus.png"))
        nii = os.path.join(root, sid, f"data_{sid}.nii")
        if not os.path.exists(nii):
            nii = os.path.join(root, sid, f"processed_data_{sid}.nii")
        vol = read_nifti(nii)
        vol = np.transpose(vol, (2, 0, 1))  # (H, W, D) -> (D, H, W), ``:681``
        fundus = resize_image(fundus / 255.0, self.cfg.fundus_size)
        vol = resize_volume(vol, self.cfg.oct_size) / 255.0
        fundus = np.clip(fundus, 0.0, 1.0).astype(np.float32)
        vol = np.clip(vol, 0.0, 1.0).astype(np.float32)
        fundus_u8 = np.rint(fundus * 255.0).astype(np.uint8)
        vol_u8 = np.rint(vol * 255.0).astype(np.uint8)
        if self.cache:
            try:
                np.savez(cache_path, fundus=fundus_u8, oct=vol_u8)
            except OSError:
                pass
            # Serve the uint8 round-trip on the cache-MISS call too: the
            # first epoch must see byte-identical values to every cached
            # epoch/run (post-resize floats are not 8-bit-valued, so
            # returning the raw floats here would make fresh != cached).
            fundus = fundus_u8.astype(np.float32) / 255.0
            vol = vol_u8.astype(np.float32) / 255.0
        if as_uint8:
            return fundus_u8, vol_u8
        return fundus, vol

    def get(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        sid, one_hot = self.samples[index]
        fundus, vol = self._load_raw(sid)
        rng = sample_rng(self.cfg.seed, epoch, index)
        if self.cfg.device_noise:
            # Augmentation + noise happen on-device in the jitted step.
            return {
                "fundus": fundus,
                "oct": vol,
                "label": np.int32(np.argmax(one_hot)),
            }
        views = make_noise_views(fundus, vol, self.cfg.noise, rng)
        if self.mode == "train":
            for key in ("fundus_low", "fundus_high"):
                views[key] = fundus_train_augment(
                    views[key],
                    rng,
                    jitter_prob=self.cfg.color_jitter_prob,
                    grayscale_prob=self.cfg.grayscale_prob,
                    hflip_prob=self.cfg.hflip_prob,
                    jitter_strength=self.cfg.color_jitter_strength,
                )
            for key in ("oct_low", "oct_high"):
                views[key] = oct_train_augment(views[key], rng, self.cfg.hflip_prob)
        views["label"] = np.int32(np.argmax(one_hot))
        return views


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Center crop of an [H, W, C] image (pads if smaller)."""
    h, w = img.shape[:2]
    if h < size or w < size:
        pad_h = max(size - h, 0)
        pad_w = max(size - w, 0)
        img = np.pad(
            img,
            ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
        )
        h, w = img.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[top : top + size, left : left + size]


class GammaSub1Dataset:
    """Legacy single-view GAMMA dataset (``GAMMA_sub1_dataset``,
    ``code/data_harvard.py:50-167``): fundus ``{root}/{id}/{id}.png`` plus an
    OCT slice-image directory ``{root}/{id}/{id}/``; 2000-px fundus scans get
    the reference's fixed clip window; train transforms add CenterCrop(600) +
    resize and per-channel normalization.  Returns ONE view (no noise pair):
    ``{"fundus": [H,W,3], "oct": [D,H,W], "label": int}``.
    """

    # Reference normalization constants (``code/data_harvard.py:64-65``).
    MEAN = np.array([0.3163843, 0.86174834, 0.3641431], dtype=np.float32)
    STD = np.array([0.24608557, 0.11123227, 0.26710403], dtype=np.float32)

    def __init__(self, cfg: DataConfig, mode: str = "train", filelists=None):
        self.cfg = cfg
        self.mode = mode.lower()
        labels = load_labels(cfg.label_file)
        ids = filelists if filelists is not None else sorted(os.listdir(cfg.data_path))
        self.samples = []
        for sid in ids:
            name = os.path.basename(str(sid))
            key = name.zfill(5) if name.isdigit() else name
            if key in labels:
                self.samples.append((name, labels[key]))

    def __len__(self):
        return len(self.samples)

    def get(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        from edrl.data.noise import sample_rng
        from edrl.data.transforms import (
            color_jitter,
            to_grayscale,
        )

        sid, one_hot = self.samples[index]
        root = self.cfg.data_path
        fundus = _read_image(os.path.join(root, sid, f"{sid}.png"))
        slice_dir = os.path.join(root, sid, sid)
        # Numeric-aware order: lexicographic sorting stacks 1,10,100,...,2
        # and scrambles the volume's depth axis for unpadded filenames.
        slices = sorted(os.listdir(slice_dir), key=_slice_sort_key)
        from PIL import Image

        stack = [
            np.asarray(
                Image.open(os.path.join(slice_dir, p)).convert("L"), dtype=np.float32
            )
            for p in slices
        ]
        oct_img = np.stack(stack)  # [D, H, W]

        # Fixed clip window for 2000-px scans (``code/data_harvard.py:135``).
        if fundus.shape[0] == 2000:
            fundus = fundus[1000 - 967 : 1000 + 967, 1496 - 978 : 1496 + 978, :]

        oct_img = resize_volume(oct_img, self.cfg.oct_size) / 255.0
        fundus = fundus / 255.0
        rng = sample_rng(self.cfg.seed, epoch, index)
        if self.mode == "train":
            if rng.random() < self.cfg.color_jitter_prob:
                fundus = color_jitter(fundus, rng, *self.cfg.color_jitter_strength)
            if rng.random() < self.cfg.grayscale_prob:
                fundus = to_grayscale(fundus)
            fundus = center_crop(fundus, 600)
            fundus = np.clip(resize_image(fundus, self.cfg.fundus_size), 0.0, 1.0)
            if rng.random() < self.cfg.hflip_prob:
                fundus = fundus[:, ::-1].copy()
            fundus = (fundus - self.MEAN) / self.STD
        else:
            # cv2 cubic resize can overshoot [0, 1]; clip back.
            fundus = np.clip(resize_image(fundus, self.cfg.fundus_size), 0.0, 1.0)
        return {
            "fundus": fundus.astype(np.float32),
            "oct": np.clip(oct_img, 0.0, 1.0).astype(np.float32),
            "label": np.int32(np.argmax(one_hot)),
        }
