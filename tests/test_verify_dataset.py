"""Real-data preflight verifier (edrl/data/verify.py, VERDICT r3 #6).

Builds a healthy on-disk GAMMA tree, then corrupts it one defect at a time
and asserts the verifier names each defect with the right severity —
the point is that a user gets an actionable error BEFORE the 15-25 min
full-model compile, not a crash in epoch 0.
"""

import os
import struct

import numpy as np
import pytest

from edrl.config import DataConfig
from edrl.data.nifti import write_nifti
from edrl.data.verify import verify_tree


def _write_png(path, rng, size=(40, 40)):
    img = (rng.uniform(size=(*size, 3)) * 255).astype(np.uint8)
    try:
        import cv2

        cv2.imwrite(str(path), img)
    except ImportError:  # pragma: no cover
        from PIL import Image

        Image.fromarray(img).save(path)


@pytest.fixture
def tree(tmp_path, rng):
    """Healthy 4-sample dr2 layout + csv labels."""
    import pandas as pd

    root = tmp_path / "data"
    rows = []
    for i in range(1, 5):
        sid = str(i)
        d = root / sid
        d.mkdir(parents=True)
        _write_png(d / f"data_{sid}_fundus.png", rng)
        vol = (rng.uniform(size=(32, 32, 20)) * 255).astype(np.float32)
        write_nifti(str(d / f"data_{sid}.nii"), vol)
        rows.append({"data": sid.zfill(5), "class_0": 1 - (i % 2), "class_1": i % 2})
    label_file = tmp_path / "labels.csv"
    pd.DataFrame(rows).to_csv(label_file, index=False)
    return root, label_file


def _cfg(root, label_file, **kw):
    return DataConfig(
        dataset="dr2",
        data_path=str(root),
        label_file=str(label_file),
        fundus_size=64,
        oct_size=(16, 16, 16),
        **kw,
    )


def test_healthy_tree_is_ready(tree):
    root, labels = tree
    rep = verify_tree(_cfg(root, labels), deep=True)
    assert rep.ok, rep.summary()
    assert rep.n_joined == 4 and rep.n_checked == 4
    assert not rep.errors
    assert "READY" in rep.summary()


def test_missing_fundus_is_an_error(tree):
    root, labels = tree
    os.unlink(root / "2" / "data_2_fundus.png")
    rep = verify_tree(_cfg(root, labels))
    assert not rep.ok
    assert any("missing fundus" in str(f) and f.sample == "2" for f in rep.errors)


def test_missing_nifti_names_both_candidates(tree):
    root, labels = tree
    os.unlink(root / "3" / "data_3.nii")
    rep = verify_tree(_cfg(root, labels))
    msgs = [str(f) for f in rep.errors]
    assert any("data_3.nii" in m and "processed_data_3.nii" in m for m in msgs)


def test_processed_fallback_accepted(tree):
    root, labels = tree
    os.rename(root / "3" / "data_3.nii", root / "3" / "processed_data_3.nii")
    rep = verify_tree(_cfg(root, labels), deep=True)
    assert rep.ok, rep.summary()


def test_truncated_nifti_is_an_error(tree):
    root, labels = tree
    path = root / "1" / "data_1.nii"
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    rep = verify_tree(_cfg(root, labels))
    assert any("truncated" in str(f) for f in rep.errors)


def test_non_nifti_garbage_is_an_error(tree):
    root, labels = tree
    (root / "1" / "data_1.nii").write_bytes(b"DICM" + b"\x00" * 400)
    rep = verify_tree(_cfg(root, labels))
    assert any("not NIfTI-1" in str(f) for f in rep.errors)


def test_4d_volume_is_an_error(tree, rng):
    root, labels = tree
    vol4 = (rng.uniform(size=(8, 8, 8, 2)) * 255).astype(np.float32)
    write_nifti(str(root / "1" / "data_1.nii"), vol4)
    rep = verify_tree(_cfg(root, labels))
    assert any("3-D volume" in str(f) for f in rep.errors)


def test_scaled_nifti_is_a_warning_not_error(tree):
    root, labels = tree
    path = root / "1" / "data_1.nii"
    raw = bytearray(path.read_bytes())
    struct.pack_into("<f", raw, 112, 2.5)  # scl_slope
    struct.pack_into("<f", raw, 116, -10.0)  # scl_inter
    path.write_bytes(bytes(raw))
    rep = verify_tree(_cfg(root, labels))
    assert rep.ok
    assert any("scl_slope=2.5" in str(f) for f in rep.warnings)


def test_intercept_only_scaling_warns(tree):
    """slope==1 with inter!=0 IS rescaled by the loader (nifti.py applies
    the intercept) — preflight must warn on it too (ADVICE r4 #3)."""
    root, labels = tree
    path = root / "1" / "data_1.nii"
    raw = bytearray(path.read_bytes())
    struct.pack_into("<f", raw, 112, 1.0)  # scl_slope
    struct.pack_into("<f", raw, 116, -1024.0)  # scl_inter
    path.write_bytes(bytes(raw))
    rep = verify_tree(_cfg(root, labels))
    assert rep.ok
    assert any("scl_inter=-1024" in str(f) for f in rep.warnings)


def test_zero_join_is_an_error_with_examples(tree, tmp_path):
    root, labels = tree
    import pandas as pd

    other = tmp_path / "other_labels.csv"
    pd.DataFrame([{"data": "99999", "class_0": 1, "class_1": 0}]).to_csv(
        other, index=False
    )
    rep = verify_tree(_cfg(root, other))
    assert not rep.ok
    assert any("zero samples join" in str(f) for f in rep.errors)


def test_unlabeled_dirs_and_missing_rows_are_warnings(tree, tmp_path):
    root, labels = tree
    (root / "77").mkdir()  # unlabeled on-disk dir
    import pandas as pd

    df = pd.read_csv(labels, dtype={"data": str})
    df = pd.concat(
        [df, pd.DataFrame([{"data": "00088", "class_0": 1, "class_1": 0}])]
    )
    df.to_csv(labels, index=False)
    rep = verify_tree(_cfg(root, labels))
    assert rep.ok
    warn = " | ".join(str(f) for f in rep.warnings)
    assert "no label row" in warn and "no directory on disk" in warn


def test_bad_label_cells_are_reported(tree):
    """A NaN one-hot cell (empty csv field) or a non-numeric cell must be
    surfaced, not silently argmax'd."""
    root, labels = tree
    with open(labels) as f:
        lines = f.read().splitlines()
    lines[1] = lines[1].rsplit(",", 1)[0] + ","  # empty cell -> NaN
    with open(labels, "w") as f:
        f.write("\n".join(lines))
    rep = verify_tree(_cfg(root, labels))
    assert not rep.ok
    assert any("NaN" in str(f) or "failed to parse" in str(f) for f in rep.errors)


def test_non_numeric_label_cell_fails_loudly(tree):
    root, labels = tree
    with open(labels) as f:
        lines = f.read().splitlines()
    lines[2] = lines[2].rsplit(",", 1)[0] + ",oops"
    with open(labels, "w") as f:
        f.write("\n".join(lines))
    rep = verify_tree(_cfg(root, labels))
    assert not rep.ok


def test_missing_paths_short_circuit(tmp_path):
    rep = verify_tree(_cfg(tmp_path / "nope", tmp_path / "nope.csv"))
    assert not rep.ok
    assert any("not a directory" in str(f) for f in rep.errors)
    (tmp_path / "empty").mkdir()
    rep = verify_tree(_cfg(tmp_path / "empty", tmp_path / "nope.csv"))
    assert any("does not exist" in str(f) for f in rep.errors)


def test_deep_check_loads_real_samples(tree):
    root, labels = tree
    rep = verify_tree(_cfg(root, labels), max_samples=2, deep=True)
    assert rep.ok and rep.n_checked == 2


def test_glu2_layout_checks(tmp_path, rng):
    import pandas as pd

    root = tmp_path / "data"
    for i in (1, 2):
        sid = str(i)
        d = root / sid
        (d / sid).mkdir(parents=True)
        _write_png(d / f"{sid}.png", rng)
        for s in (1, 2, 10):  # unpadded numeric names
            _write_png(d / sid / f"{s}.jpg", rng, size=(16, 16))
    label_file = tmp_path / "labels.csv"
    pd.DataFrame(
        [{"data": "00001", "class_0": 1, "class_1": 0},
         {"data": "00002", "class_0": 0, "class_1": 1}]
    ).to_csv(label_file, index=False)

    cfg = DataConfig(
        dataset="glu2", data_path=str(root), label_file=str(label_file),
        fundus_size=32, oct_size=(8, 8, 8),
    )
    rep = verify_tree(cfg)
    assert rep.ok, rep.summary()
    # Unpadded numeric slices: lexicographic order would scramble -> warned.
    assert any("numeric-aware ordering" in str(f) for f in rep.warnings)

    # Corrupt: drop one slice dir entirely.
    import shutil

    shutil.rmtree(root / "2" / "2")
    rep = verify_tree(cfg)
    assert any("missing OCT slice directory" in str(f) for f in rep.errors)


def test_cli_exit_codes(tree, capsys):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import verify_dataset as cli

    root, labels = tree
    rc = cli.main([
        "--dataset", "dr2", "--data_path", str(root),
        "--label_file", str(labels), "--fundus_size", "64",
        "--oct_size", "16",
    ])
    assert rc == 0
    assert "READY" in capsys.readouterr().out
    os.unlink(root / "1" / "data_1.nii")
    rc = cli.main([
        "--dataset", "dr2", "--data_path", str(root),
        "--label_file", str(labels), "--fundus_size", "64",
        "--oct_size", "16",
    ])
    assert rc == 1
