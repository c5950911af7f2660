"""Data-layer tests: noise views, per-sample PRNG, augmentations, NIfTI IO,
GAMMA loader on a synthetic on-disk fixture, kfold parity with sklearn."""

import os

import numpy as np
import pytest

from edrl.config import DataConfig, NoiseConfig
from edrl.data import (
    BatchLoader,
    GammaDataset,
    SyntheticGammaDataset,
    add_gaussian,
    add_salt_pepper,
    kfold_split,
    make_noise_views,
)
from edrl.data.nifti import read_nifti, write_nifti
from edrl.data.noise import sample_rng
from edrl.data.transforms import (
    adjust_hue,
    color_jitter,
    resize_image,
    resize_volume,
)


class TestNoise:
    def test_gaussian_zero_sigma_identity(self, rng):
        img = rng.uniform(size=(8, 8, 3)).astype(np.float32)
        out = add_gaussian(img, 0.0, np.random.default_rng(0))
        np.testing.assert_array_equal(out, img)

    def test_gaussian_clipped(self, rng):
        img = rng.uniform(size=(16, 16)).astype(np.float32)
        out = add_gaussian(img, 0.5, np.random.default_rng(0))
        assert out.min() >= 0.0 and out.max() <= 1.0
        assert not np.array_equal(out, img)

    def test_salt_pepper_fraction(self):
        img = np.full((100, 100), 0.5, dtype=np.float32)
        out = add_salt_pepper(img, 0.05, np.random.default_rng(0))
        salt = np.mean(out == 1.0)
        pepper = np.mean(out == 0.0)
        assert salt == pytest.approx(0.05, abs=0.01)
        assert pepper == pytest.approx(0.05, abs=0.01)

    def test_views_low_clean_high_noisy_default(self, rng):
        """As-executed reference behavior: low view clean, high sigma=0.5."""
        cfg = NoiseConfig()
        f = rng.uniform(size=(8, 8, 3)).astype(np.float32)
        o = rng.uniform(size=(4, 8, 8)).astype(np.float32)
        views = make_noise_views(f, o, cfg, np.random.default_rng(0))
        np.testing.assert_array_equal(views["fundus_low"], f)
        np.testing.assert_array_equal(views["oct_low"], o)
        assert not np.array_equal(views["fundus_high"], f)
        assert not np.array_equal(views["oct_high"], o)

    def test_per_sample_prng_differs(self):
        """Ledger #7 fix: different (epoch, index) -> different noise."""
        a = sample_rng(11, 0, 0).normal(size=4)
        b = sample_rng(11, 0, 1).normal(size=4)
        c = sample_rng(11, 1, 0).normal(size=4)
        d = sample_rng(11, 0, 0).normal(size=4)
        assert not np.array_equal(a, b)
        assert not np.array_equal(a, c)
        np.testing.assert_array_equal(a, d)  # reproducible


class TestTransforms:
    def test_hue_identity_at_zero(self, rng):
        img = rng.uniform(size=(8, 8, 3)).astype(np.float32)
        out = adjust_hue(img, 0.0)
        np.testing.assert_allclose(out, img, atol=1e-5)

    def test_hue_full_turn_identity(self, rng):
        img = rng.uniform(size=(8, 8, 3)).astype(np.float32)
        out = adjust_hue(img, 1.0)
        np.testing.assert_allclose(out, img, atol=1e-5)

    def test_color_jitter_range(self, rng):
        img = rng.uniform(size=(16, 16, 3)).astype(np.float32)
        out = color_jitter(img, np.random.default_rng(0))
        assert out.shape == img.shape
        assert out.min() >= 0.0 and out.max() <= 1.0

    def test_resize_volume_shape_and_content(self):
        vol = np.arange(2 * 4 * 4, dtype=np.float32).reshape(2, 4, 4)
        out = resize_volume(vol, (4, 2, 2))
        assert out.shape == (4, 2, 2)
        assert out[0, 0, 0] == vol[0, 0, 0]

    def test_resize_volume_matches_ndimage_zoom(self):
        """Exact parity with the reference's resize_oct_data_trans
        (``ndimage.zoom(order=0)``, code/data_harvard.py:176-183) — the
        previous floor(i*d/od) map diverged on ~99.98% of voxels for a
        256->96 downsample and never sampled the last input slices."""
        pytest.importorskip("scipy")
        from scipy import ndimage

        rng = np.random.default_rng(0)
        for shape, out_shape in [
            ((20, 26, 26), (10, 10, 10)),  # downsample (ref: 200x256x256->96^3)
            ((5, 6, 7), (8, 9, 10)),  # upsample
            ((3, 3, 3), (5, 5, 5)),  # half-way rounding cells
        ]:
            vol = rng.uniform(size=shape).astype(np.float32)
            got = resize_volume(vol, out_shape)
            want = ndimage.zoom(
                vol, [o / s for o, s in zip(out_shape, shape)], order=0
            )
            assert want.shape == tuple(out_shape), (want.shape, out_shape)
            np.testing.assert_array_equal(got, want)

    def test_resize_image(self, rng):
        img = rng.uniform(size=(32, 48, 3)).astype(np.float32)
        out = resize_image(img, 16)
        assert out.shape == (16, 16, 3)


class TestNifti:
    def test_roundtrip(self, tmp_path, rng):
        vol = rng.uniform(size=(5, 6, 7)).astype(np.float32)
        path = str(tmp_path / "vol.nii")
        write_nifti(path, vol)
        back = read_nifti(path)
        np.testing.assert_allclose(back, vol, rtol=1e-6)

    def test_slope_one_intercept_applied(self, tmp_path, rng):
        """NIfTI-1 scaling: slope==1 does NOT mean 'no scaling' — the
        intercept must still apply (pure-offset volumes, e.g. slope 1 /
        inter -1024, are common in converted data)."""
        import struct

        vol = rng.uniform(size=(4, 5, 6)).astype(np.float32)
        path = str(tmp_path / "off.nii")
        write_nifti(path, vol)
        raw = bytearray(open(path, "rb").read())
        struct.pack_into("<f", raw, 116, -10.0)  # scl_inter
        open(path, "wb").write(raw)
        back = read_nifti(path)
        np.testing.assert_allclose(back, vol - 10.0, rtol=1e-5)

    def test_nan_scaling_fields_mean_unset(self, tmp_path, rng):
        import struct

        vol = rng.uniform(size=(3, 4, 5)).astype(np.float32)
        path = str(tmp_path / "nan.nii")
        write_nifti(path, vol)
        raw = bytearray(open(path, "rb").read())
        struct.pack_into("<f", raw, 112, float("nan"))  # scl_slope
        struct.pack_into("<f", raw, 116, float("nan"))  # scl_inter
        open(path, "wb").write(raw)
        back = read_nifti(path)
        np.testing.assert_allclose(back, vol, rtol=1e-6)


class TestKFold:
    def test_matches_sklearn(self):
        sklearn = pytest.importorskip("sklearn")
        from sklearn.model_selection import KFold

        items = [f"{i:05d}" for i in range(23)]
        ours = kfold_split(items, 5, seed=10)
        kf = KFold(n_splits=5, shuffle=True, random_state=10)
        for (tr_a, va_a), (tr_i, va_i) in zip(ours, kf.split(items)):
            np.testing.assert_array_equal(sorted(va_a), sorted(np.asarray(items)[va_i]))


class TestSyntheticDataset:
    def test_shapes_and_determinism(self):
        cfg = DataConfig(fundus_size=32, oct_size=(16, 16, 16), num_synthetic_samples=8)
        ds = SyntheticGammaDataset(cfg, mode="val")
        s1 = ds.get(0, epoch=0)
        s2 = ds.get(0, epoch=0)
        assert s1["fundus_low"].shape == (32, 32, 3)
        assert s1["oct_low"].shape == (16, 16, 16)
        np.testing.assert_array_equal(s1["fundus_high"], s2["fundus_high"])

    def test_labels_balanced(self):
        cfg = DataConfig(fundus_size=16, oct_size=(8, 8, 8), num_synthetic_samples=8)
        ds = SyntheticGammaDataset(cfg, mode="val")
        labels = [int(ds.get(i)["label"]) for i in range(8)]
        assert sorted(set(labels)) == [0, 1]


class TestGammaDataset:
    @pytest.fixture
    def disk_fixture(self, tmp_path, rng):
        """Synthetic on-disk GAMMA layout: ids 00001..00004 with PNG + NIfTI."""
        import pandas as pd

        root = tmp_path / "data"
        rows = []
        for i in range(1, 5):
            sid = str(i)
            d = root / sid
            d.mkdir(parents=True)
            img = (rng.uniform(size=(40, 40, 3)) * 255).astype(np.uint8)
            try:
                import cv2

                cv2.imwrite(str(d / f"data_{sid}_fundus.png"), img)
            except ImportError:
                from PIL import Image

                Image.fromarray(img).save(d / f"data_{sid}_fundus.png")
            vol = (rng.uniform(size=(32, 32, 20)) * 255).astype(np.float32)
            write_nifti(str(d / f"data_{sid}.nii"), vol)
            rows.append(
                {"data": sid.zfill(5), "class_0": 1 - (i % 2), "class_1": i % 2}
            )
        label_file = tmp_path / "labels.csv"
        pd.DataFrame(rows).to_csv(label_file, index=False)
        return str(root), str(label_file)

    def test_load_and_shapes(self, disk_fixture):
        root, labels = disk_fixture
        cfg = DataConfig(
            dataset="dr2",
            data_path=root,
            label_file=labels,
            fundus_size=32,
            oct_size=(16, 16, 16),
        )
        ds = GammaDataset(cfg, mode="val")
        assert len(ds) == 4
        s = ds.get(0)
        assert s["fundus_low"].shape == (32, 32, 3)
        assert s["oct_low"].shape == (16, 16, 16)
        assert s["label"] in (0, 1)
        assert 0.0 <= s["fundus_low"].min() and s["fundus_low"].max() <= 1.0

    def test_cache_speeds_second_read(self, disk_fixture):
        root, labels = disk_fixture
        cfg = DataConfig(
            dataset="dr2", data_path=root, label_file=labels,
            fundus_size=32, oct_size=(16, 16, 16),
        )
        ds = GammaDataset(cfg, mode="val")
        s1 = ds.get(1)
        assert any(
            f.startswith("_edrl_cache") for f in os.listdir(os.path.join(root, ds.samples[1][0]))
        )
        s2 = ds.get(1)
        # The disk cache stores uint8 (lossless for the 8-bit sources but the
        # cubic-resized intermediate floats quantize to 1/255 granularity).
        np.testing.assert_allclose(
            s1["fundus_low"], s2["fundus_low"], atol=0.5 / 255
        )


class TestBatchLoader:
    def test_batch_shapes_and_drop_last(self):
        cfg = DataConfig(fundus_size=16, oct_size=(8, 8, 8), num_synthetic_samples=10)
        ds = SyntheticGammaDataset(cfg, mode="train")
        loader = BatchLoader(ds, batch_size=4, drop_last=True, num_workers=2)
        batches = list(loader.epoch(0))
        assert len(batches) == 2  # 10 // 4
        b = batches[0]
        assert b["fundus_low"].shape == (4, 16, 16, 3)
        assert b["oct_low"].shape == (4, 8, 8, 8, 1)  # channel dim added
        assert b["label"].shape == (4,)

    def test_shuffle_reproducible_across_runs(self):
        cfg = DataConfig(fundus_size=16, oct_size=(8, 8, 8), num_synthetic_samples=12)
        ds = SyntheticGammaDataset(cfg, mode="val")
        loader = BatchLoader(ds, batch_size=4, seed=3, num_workers=2)
        l1 = [b["label"] for b in loader.epoch(5)]
        l2 = [b["label"] for b in loader.epoch(5)]
        for a, b in zip(l1, l2):
            np.testing.assert_array_equal(a, b)

    def test_different_epoch_different_order(self):
        cfg = DataConfig(fundus_size=16, oct_size=(8, 8, 8), num_synthetic_samples=32)
        ds = SyntheticGammaDataset(cfg, mode="val")
        loader = BatchLoader(ds, batch_size=8, seed=3, num_workers=2)
        l1 = np.concatenate([b["label"] for b in loader.epoch(0)])
        l2 = np.concatenate([b["label"] for b in loader.epoch(1)])
        assert not np.array_equal(l1, l2)


class TestGammaSub1Dataset:
    @pytest.fixture
    def sub1_fixture(self, tmp_path, rng):
        """Legacy layout: {root}/{id}/{id}.png + {root}/{id}/{id}/*.png slices."""
        import pandas as pd
        from PIL import Image

        root = tmp_path / "sub1"
        rows = []
        for i in range(1, 3):
            sid = str(i)
            d = root / sid
            (d / sid).mkdir(parents=True)
            img = (rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"{sid}.png")
            for s in range(4):
                sl = (rng.uniform(size=(32, 32)) * 255).astype(np.uint8)
                Image.fromarray(sl).save(d / sid / f"{s:03d}.png")
            rows.append({"data": sid.zfill(5), "class_0": i % 2, "class_1": 1 - i % 2})
        label_file = tmp_path / "labels.csv"
        pd.DataFrame(rows).to_csv(label_file, index=False)
        return str(root), str(label_file)

    def test_load_shapes_and_normalization(self, sub1_fixture):
        from edrl.data.gamma import GammaSub1Dataset

        root, labels = sub1_fixture
        cfg = DataConfig(
            dataset="sub1", data_path=root, label_file=labels,
            fundus_size=32, oct_size=(8, 16, 16),
        )
        ds = GammaSub1Dataset(cfg, mode="train")
        assert len(ds) == 2
        s = ds.get(0)
        assert s["fundus"].shape == (32, 32, 3)
        assert s["oct"].shape == (8, 16, 16)
        # train path applies per-channel normalization -> values leave [0,1]
        assert s["fundus"].min() < 0 or s["fundus"].max() > 1

    def test_slice_order_is_numeric(self):
        """Unpadded slice names must stack in depth order, not
        lexicographic order (1,10,100,...,2 scrambles the D axis)."""
        from edrl.data.gamma import _slice_sort_key

        names = ["1.jpg", "10.jpg", "100.jpg", "2.jpg", "20.jpg", "3.jpg"]
        assert sorted(names, key=_slice_sort_key) == [
            "1.jpg", "2.jpg", "3.jpg", "10.jpg", "20.jpg", "100.jpg",
        ]

    def test_val_mode_no_normalization(self, sub1_fixture):
        from edrl.data.gamma import GammaSub1Dataset

        root, labels = sub1_fixture
        cfg = DataConfig(
            dataset="sub1", data_path=root, label_file=labels,
            fundus_size=32, oct_size=(8, 16, 16),
        )
        ds = GammaSub1Dataset(cfg, mode="val")
        s = ds.get(1)
        assert 0.0 <= s["fundus"].min() and s["fundus"].max() <= 1.0


class TestCenterCrop:
    def test_crop_and_pad(self):
        from edrl.data.gamma import center_crop

        img = np.arange(8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
        out = center_crop(img, 4)
        assert out.shape == (4, 4, 3)
        np.testing.assert_array_equal(out, img[2:6, 2:6])
        padded = center_crop(img, 12)
        assert padded.shape == (12, 12, 3)


class TestXlsx:
    def test_reads_reference_label_file(self):
        """The dependency-free reader must parse the actual reference
        ``train_true.xlsx`` (3000 rows, 4 one-hot class columns)."""
        import os

        path = "/root/reference/train_true.xlsx"
        if not os.path.exists(path):
            pytest.skip("reference file not mounted")
        from edrl.data.gamma import load_labels

        labels = load_labels(path)
        assert len(labels) == 3000
        assert all(v.shape == (4,) for v in labels.values())
        assert all(v.sum() == 1.0 for v in labels.values())  # one-hot

    def test_first_sheet_is_numeric_not_lexicographic(self, tmp_path):
        """With 10+ sheets, 'first worksheet' must be sheet1.xml — a
        lexicographic sort puts sheet10.xml first."""
        import zipfile

        from edrl.data.xlsx import read_xlsx_rows, write_xlsx

        path = str(tmp_path / "many.xlsx")
        write_xlsx(path, ["data"], [["from_sheet1"]])
        sheet = (
            '<worksheet xmlns="http://schemas.openxmlformats.org/'
            'spreadsheetml/2006/main"><sheetData>'
            '<row r="1"><c r="A1" t="inlineStr"><is><t>WRONG</t></is></c>'
            "</row></sheetData></worksheet>"
        )
        with zipfile.ZipFile(path, "a") as zf:
            for i in range(2, 12):
                zf.writestr(f"xl/worksheets/sheet{i}.xml", sheet)
        rows = read_xlsx_rows(path)
        assert rows[1][0] == "from_sheet1"

    def test_write_read_roundtrip(self, tmp_path):
        from edrl.data.xlsx import read_xlsx_rows, write_xlsx

        path = str(tmp_path / "labels.xlsx")
        write_xlsx(
            path,
            ["data", "class_0", "class_1"],
            [["00001", 1, 0], ["00002", 0, 1]],
        )
        rows = read_xlsx_rows(path)
        assert rows[0] == ["data", "class_0", "class_1"]
        assert rows[1] == ["00001", "1", "0"]

    def test_load_labels_from_written_xlsx(self, tmp_path):
        from edrl.data.gamma import load_labels
        from edrl.data.xlsx import write_xlsx

        path = str(tmp_path / "labels.xlsx")
        write_xlsx(path, ["data", "class_0", "class_1"], [["7", 0, 1]])
        labels = load_labels(path)
        assert "00007" in labels
        np.testing.assert_array_equal(labels["00007"], [0.0, 1.0])
