"""The port's ERT trainer (lip2speech_tpu_torch/pipeline/ert.py) and its
shape-predictor CLI (cli/shape_predictor.py) against the JAX package's: numpy
on the host, so bit for bit. train_ert's model arrays for the same options
and seed; the imglab XML workflow (generate-xml, train; the XML and the
saved model equal); tune's random search at calls=2; and tune at calls=0,
where the port raises ValueError and the JAX tool fails on `best[0]`."""

import json

import numpy as np
import pytest

from landmark_bench import render_face_dataset
from lip2speech_tpu.cli import shape_predictor as jsp
from lip2speech_tpu.pipeline import ert as jert
from lip2speech_tpu_torch.cli import shape_predictor as tsp
from lip2speech_tpu_torch.pipeline import ert as tert

from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

SMALL = dict(cascade_depth=2, trees_per_cascade=6, feature_pool_size=40, tree_depth=3,
             num_test_splits=6, oversampling_amount=3, oversampling_translation_jitter=0.08,
             nu=0.15, seed=4)


def assert_models_equal(got, ref):
    np.testing.assert_array_equal(got.mean_shape, ref.mean_shape)
    assert got.tree_depth == ref.tree_depth and len(got.levels) == len(ref.levels)
    for a, b in zip(got.levels, ref.levels):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def faces():
    return render_face_dataset(n=12, seed=1)


def test_train_ert_matches_jax_bit_for_bit(faces):
    got = tert.train_ert(faces, tert.ErtOptions(**SMALL))
    ref = jert.train_ert(faces, jert.ErtOptions(**SMALL))
    assert_models_equal(got, ref)
    image, box, _ = faces[0]
    np.testing.assert_array_equal(got.predict(image, box), ref.predict(image, box))
    assert tert.evaluate_error(got, faces) == jert.evaluate_error(ref, faces)


def _landmarks_dir(root, faces):
    """<id>.npy landmarks, <id>.png.npy images (the CLI's --image-suffix),
    <id>.box.json boxes."""
    root.mkdir()
    for i, (image, box, lm) in enumerate(faces):
        np.save(root / f"f{i:03d}.npy", lm)
        np.save(root / f"f{i:03d}.png.npy", image)
        (root / f"f{i:03d}.box.json").write_text(json.dumps([int(round(v)) for v in box]))


def test_xml_workflow_matches_jax(faces, tmp_path, monkeypatch, capsys):
    """generate-xml then train (the tiny preset, ERT backend) through both
    CLIs: the same XML bytes and the same saved model; a model trained by
    the port loads in the JAX package and predicts the same."""
    import sys

    _landmarks_dir(tmp_path / "lms", faces)
    for side, mod in (("jax", jsp), ("port", tsp)):
        argv = [["generate-xml", "--landmarks-dir", str(tmp_path / "lms"), "--image-suffix",
                 ".png.npy", "--xml-output-path", str(tmp_path / f"{side}.xml")],
                ["train", "--xml-path", str(tmp_path / f"{side}.xml"), "--output-path",
                 str(tmp_path / f"{side}.npz"), "--preset", "tiny", "--cascade-depth", "2"]]
        for a in argv:
            if side == "jax":
                monkeypatch.setattr(sys, "argv", ["shape_predictor", *a])
                mod.main()
            else:
                mod.main(a)
    out = capsys.readouterr().out
    assert out.count('{"samples": 12}') == 2 and out.count('"backend": "ert"') == 2
    assert (tmp_path / "port.xml").read_bytes() == (tmp_path / "jax.xml").read_bytes()
    assert len(tert.load_imglab_xml(tmp_path / "port.xml")[0][2]) == 41
    got, ref = tert.ErtModel.load(tmp_path / "port.npz"), jert.ErtModel.load(tmp_path / "jax.npz")
    assert_models_equal(got, ref)
    image, box, _ = faces[2]
    np.testing.assert_array_equal(jert.ErtModel.load(tmp_path / "port.npz").predict(image, box),
                                  ref.predict(image, box))


def _xml_pair(tmp_path, faces):
    samples = []
    for i, (image, box, lm) in enumerate(faces):
        np.save(tmp_path / f"img{i}.npy", image)
        samples.append((str(tmp_path / f"img{i}.npy"), tuple(int(round(v)) for v in box), lm))
    tsp.build_training_xml(samples[:8], tmp_path / "train.xml")
    tsp.build_training_xml(samples[8:], tmp_path / "test.xml")
    return str(tmp_path / "train.xml"), str(tmp_path / "test.xml")


def test_tune_matches_jax(faces, tmp_path, capsys):
    """tune's random search at calls=2 (a 4-tree forest a level): the same
    drawn parameters, test errors and best."""
    train_xml, test_xml = _xml_pair(tmp_path, faces)
    got = tsp.tune(train_xml, test_xml, calls=2, seed=3, trees_per_cascade=4)
    ref = jsp.tune(train_xml, test_xml, calls=2, seed=3, trees_per_cascade=4)
    assert got == ref and got["best_params"]["trees_per_cascade"] == 4
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and lines[:2] == lines[2:]


def test_tune_with_no_calls_raises(faces, tmp_path):
    """calls=0 (a departure, ROADMAP §3 item 10): the port refuses before
    reading anything; the JAX tool loads both sets, then fails on best[0]."""
    train_xml, test_xml = _xml_pair(tmp_path, faces)
    with pytest.raises(ValueError, match="at least one call"):
        tsp.tune(train_xml, test_xml, calls=0)
    with pytest.raises(ValueError, match="at least one call"):
        tsp.tune("missing.xml", "missing.xml", calls=-1)
    with pytest.raises(TypeError):
        jsp.tune(train_xml, test_xml, calls=0)
