"""Custom inner-face shape-predictor training tooling (JAX reference:
cli/shape_predictor.py; numpy on the host, no device work).

Rebuild of reference dlib/{generate_shape_predictor_dataset.py:12-117,
train_shape_predictor.py:18-148}: build the dlib-imglab training XML
(inner-face landmarks 27..67 = 41 points, zero-padded back to 68 at serving
time) from per-frame landmark files, then train/tune a shape predictor.

Training backend: dlib.train_shape_predictor when dlib is installed;
otherwise the in-tree ERT trainer (pipeline/ert.py) —
the same Kazemi-Sullivan cascade dlib runs, consuming the same XML and
exposing the same hyperparameters the reference tunes
(train_shape_predictor.py:72-82). `tune` is a random-search over the
reference's exact bounds (the reference uses dlib.find_min_global with
MAX_FUNC_CALLS=100; random search over the same box with a train/test split
is the dlib-free equivalent). The same seed gives the JAX tool's models
and search bit for bit. `tune` with calls < 1 raises ValueError; the JAX
tool fails on `best[0]` with a TypeError after loading both sets.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from xml.sax.saxutils import escape

import numpy as np

from lip2speech_tpu_torch.pipeline import ert
from lip2speech_tpu_torch.pipeline.ert import INNER_FACE_START, pad_inner_to_68  # noqa: F401

# tuning bounds: (low, high, is_integer) — train_shape_predictor.py:72-82
TUNE_BOUNDS = {
    "tree_depth": (2, 5, True),
    "nu": (0.001, 0.2, False),
    "cascade_depth": (4, 25, True),
    "feature_pool_size": (100, 1000, True),
    "num_test_splits": (20, 100, True),
    "oversampling_amount": (1, 10, True),
    "oversampling_translation_jitter": (0.0, 0.3, False),
    "feature_pool_region_padding": (-0.2, 0.2, False),
    "lambda_param": (0.01, 0.99, False),
}

PRESETS = {
    # small model that still beats the mean-shape baseline ~4x on the
    # synthetic benchmark; for CI-speed training runs
    "tiny": dict(cascade_depth=3, trees_per_cascade=25, feature_pool_size=80,
                 tree_depth=3, num_test_splits=8, oversampling_amount=4,
                 nu=0.15),
    # measured 0.0044 normalized test error (14x better than baseline) on
    # 60 synthetic faces in ~45 s
    "default": dict(cascade_depth=8, trees_per_cascade=80,
                    feature_pool_size=200, tree_depth=3, num_test_splits=16,
                    oversampling_amount=8,
                    oversampling_translation_jitter=0.08, nu=0.08),
}


def build_training_xml(
    samples: list[tuple[str, tuple[int, int, int, int], np.ndarray]],
    xml_output_path: str | Path,
) -> None:
    """samples: (image_path, face box (l, t, r, b), (68, 2) landmarks).

    Writes dlib's imglab XML with inner-face parts (indices renumbered 0..40
    like the reference generator). Landmarks already sliced to 41 points are
    written as-is."""
    lines = ["<dataset><images>"]
    for image_path, (left, top, right, bottom), landmarks in samples:
        width, height = right - left, bottom - top
        lines.append(f"<image file='{escape(str(image_path))}'>")
        lines.append(f"<box top='{top}' left='{left}' width='{width}' height='{height}'>")
        lms = np.asarray(landmarks)
        if lms.shape[0] == 68:
            lms = lms[INNER_FACE_START:]
        for i, (x, y) in enumerate(lms):
            lines.append(f"<part name='{i:02d}' x='{int(x)}' y='{int(y)}'/>")
        lines.append("</box></image>")
    lines.append("</images></dataset>")
    Path(xml_output_path).write_text("\n".join(lines) + "\n")


def _dlib_train(xml_path: str, output_path: str, **params) -> bool:
    """dlib.train_shape_predictor; returns False when dlib is absent."""
    try:
        import dlib

        # a bare directory named dlib on sys.path imports as an attribute-less
        # namespace package — treat that as "absent" too
        if not hasattr(dlib, "shape_predictor_training_options"):
            return False
    except ImportError:
        return False
    options = dlib.shape_predictor_training_options()
    for k in ("tree_depth", "cascade_depth", "feature_pool_size",
              "num_test_splits", "oversampling_amount"):
        if k in params:
            setattr(options, k, int(params[k]))
    for k in ("nu", "oversampling_translation_jitter",
              "feature_pool_region_padding", "lambda_param"):
        if k in params:
            setattr(options, k, float(params[k]))
    options.num_threads = params.get("num_threads", 4)
    options.be_verbose = True
    dlib.train_shape_predictor(xml_path, output_path, options)
    return True


def train(xml_path: str, output_path: str, **params) -> dict:
    """Train via dlib when available, else the in-tree ERT. Returns a status
    dict: {trained, backend, test_error?}."""
    if _dlib_train(xml_path, output_path, **params):
        return {"trained": True, "backend": "dlib"}
    opt_fields = {f.name for f in dataclasses.fields(ert.ErtOptions)}
    opts = ert.ErtOptions(**{k: v for k, v in params.items()
                             if k in opt_fields})
    ert.train_from_xml(xml_path, output_path, opts, log=print)
    return {"trained": True, "backend": "ert"}


def tune(train_xml: str, test_xml: str, calls: int = 20, seed: int = 0,
         trees_per_cascade: int = 60) -> dict:
    """Random search over the reference's hyperparameter box
    (train_shape_predictor.py:72-91); returns the best params + test error.
    calls < 1 raises ValueError (there would be no best)."""
    if calls < 1:
        raise ValueError(f"tune needs at least one call, got calls={calls}")
    rng = np.random.default_rng(seed)
    train_samples = [(ert.imread_gray(p), b, lm)
                     for p, b, lm in ert.load_imglab_xml(train_xml)]
    test_samples = [(ert.imread_gray(p), b, lm)
                    for p, b, lm in ert.load_imglab_xml(test_xml)]
    best = None
    for i in range(calls):
        params = {}
        for name, (lo, hi, is_int) in TUNE_BOUNDS.items():
            v = rng.uniform(lo, hi)
            params[name] = int(round(v)) if is_int else float(v)
        # cap the search's per-call cost: the model size knobs scale train
        # time quadratically; the tune loop uses a fixed modest forest
        params["trees_per_cascade"] = trees_per_cascade
        params["cascade_depth"] = min(params["cascade_depth"], 10)
        params["feature_pool_size"] = min(params["feature_pool_size"], 300)
        params["num_test_splits"] = min(params["num_test_splits"], 30)
        model = ert.train_ert(train_samples, ert.ErtOptions(**params))
        err = ert.evaluate_error(model, test_samples)
        print(json.dumps({"call": i, "test_error": round(err, 5),
                          **{k: round(v, 4) if isinstance(v, float) else v
                             for k, v in params.items()}}), flush=True)
        if best is None or err < best[0]:
            best = (err, params)
    return {"best_test_error": best[0], "best_params": best[1]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    p_xml = sub.add_parser("generate-xml")
    p_xml.add_argument("--landmarks-dir", required=True,
                       help="dir of <id>.npy (68,2) landmark files with "
                            "matching <id><image-suffix> images and "
                            "<id>.box.json")
    p_xml.add_argument("--image-suffix", default=".png")
    p_xml.add_argument("--xml-output-path", required=True)

    p_train = sub.add_parser("train")
    p_train.add_argument("--xml-path", required=True)
    p_train.add_argument("--output-path", required=True)
    p_train.add_argument("--preset", default="default",
                         choices=sorted(PRESETS))
    for name in TUNE_BOUNDS:
        p_train.add_argument(f"--{name.replace('_', '-')}", type=float)

    p_tune = sub.add_parser("tune")
    p_tune.add_argument("--train-xml-path", required=True)
    p_tune.add_argument("--test-xml-path", required=True)
    p_tune.add_argument("--calls", type=int, default=20)

    args = p.parse_args(argv)
    if args.cmd == "generate-xml":
        samples = []
        for lm_path in sorted(Path(args.landmarks_dir).glob("*.npy")):
            if lm_path.name.endswith(args.image_suffix):
                continue                       # image sidecar, not landmarks
            stem = lm_path.name[:-len(".npy")]
            img = lm_path.with_name(stem + args.image_suffix)
            boxf = lm_path.with_name(stem + ".box.json")
            if not (img.exists() and boxf.exists()):
                continue
            box = tuple(json.loads(boxf.read_text()))
            samples.append((str(img), box, np.load(lm_path)))
        build_training_xml(samples, args.xml_output_path)
        out = {"samples": len(samples)}
    elif args.cmd == "train":
        params = dict(PRESETS[args.preset])
        for name, (_lo, _hi, is_int) in TUNE_BOUNDS.items():
            v = getattr(args, name)
            if v is not None:
                params[name] = int(v) if is_int else v
        out = train(args.xml_path, args.output_path, **params)
    else:
        out = tune(args.train_xml_path, args.test_xml_path, calls=args.calls)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
