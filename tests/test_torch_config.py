"""The port's OpenCV-YAML parser and `load_config` against the JAX
package's (which parses with PyYAML), on configuration files the tests
write: EuRoC, KITTI with the reference's misspelled keyframe keys, CFSD
without the IMU-camera extrinsics, matrices whose data spans lines as
OpenCV writes them, and the dialect's other scalars. The port's side runs
with `yaml` made unimportable.
"""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from pose_estimation_tpu.utils import config as jconfig
from pose_estimation_tpu_torch import load_config, testing
from pose_estimation_tpu_torch.utils import config as tconfig

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_yaml(monkeypatch):
    """The port never needs PyYAML: any import of it fails in these tests
    (the JAX parser, which needs it, imported it before)."""
    import yaml

    def jax_parse(path, _parse=jconfig._parse_opencv_yaml):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "yaml", yaml)
            return _parse(path)

    monkeypatch.setattr(jconfig, "_parse_opencv_yaml", jax_parse)
    monkeypatch.setitem(sys.modules, "yaml", None)


def _same(a, b, path=""):
    """Equal parse trees: same keys, values of the same type, arrays of the
    same dtype, shape and values."""
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _same_config(a, b):
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, field
            np.testing.assert_array_equal(x, y, err_msg=field)
        else:
            assert type(x) is type(y) and x == y, field


def _write(tmp_path, dataset, drop=(), **overrides):
    cfg = testing.sim_config(dataset=dataset, **overrides)
    path = tmp_path / f"{dataset}.yml"
    testing.write_config(path, cfg, tmp_path / "data")
    if drop:
        # remove the named matrix nodes (5 lines each)
        lines = path.read_text().splitlines()
        keep, skip = [], 0
        for line in lines:
            if line.split(":")[0] in drop:
                skip = 5
            if skip:
                skip -= 1
                continue
            keep.append(line)
        path.write_text("\n".join(keep) + "\n")
    return cfg, path


def test_euroc_file_parses_and_loads_as_in_jax(tmp_path):
    cfg, path = _write(tmp_path, "euroc", num_features=1000, prior_factor=1e-5)
    _same(tconfig._parse_opencv_yaml(path), jconfig._parse_opencv_yaml(path))
    got = load_config(path, dataset="euroc")
    _same_config(got, jconfig.load_config(path, dataset="euroc"))
    for field in ("image_width", "num_features", "prior_factor", "keyframe_rotation"):
        assert getattr(got, field) == getattr(cfg, field)
    np.testing.assert_array_equal(got.k_left, cfg.k_left)
    assert got.dataset_path == f"{tmp_path / 'data'}/"


def test_config_writer_matches_render_euroc(tmp_path):
    """`testing.write_config` writes the EuRoC file `tools/render_euroc.py`
    writes, key for key and byte for byte."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from render_euroc import write_config
    finally:
        sys.path.remove(str(REPO / "tools"))
    cfg = testing.sim_config(num_features=800, width=752, height=480)
    write_config(tmp_path / "a.yml", cfg, tmp_path / "mav0")
    testing.write_config(tmp_path / "b.yml", cfg, tmp_path / "mav0")
    assert (tmp_path / "a.yml").read_text() == (tmp_path / "b.yml").read_text()


def test_kitti_misspelled_keyframe_keys(tmp_path):
    """kitti.yml spells the keyframe keys `keyframe_rotation`; both loaders
    accept that spelling and get the value, not 0."""
    cfg, path = _write(tmp_path, "kitti", keyframe_rotation=0.07, keyframe_translation=0.2)
    text = path.read_text()
    assert "keyframe_rotation: 0.07" in text and "keyframeRotation" not in text
    _same(tconfig._parse_opencv_yaml(path), jconfig._parse_opencv_yaml(path))
    got = load_config(path, dataset="kitti")
    _same_config(got, jconfig.load_config(path, dataset="kitti"))
    assert (got.keyframe_rotation, got.keyframe_translation) == (0.07, 0.2)
    np.testing.assert_allclose(got.gravity, [0, 0, -cfg.gravity_magnitude])


def test_cfsd_missing_extrinsics_warn_and_default(tmp_path):
    _, path = _write(tmp_path, "cfsd", drop=("rotationImuToCamera", "translationImuToCamera"))
    assert "rotationImuToCamera" not in path.read_text()
    with pytest.warns(UserWarning) as caught:
        got = load_config(path, dataset="cfsd")
    said = " ".join(str(w.message) for w in caught)
    assert "rotationImuToCamera" in said and "translationImuToCamera" in said
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same_config(got, jconfig.load_config(path, dataset="cfsd"))
    np.testing.assert_array_equal(got.r_cb, np.eye(3))
    np.testing.assert_array_equal(got.t_cb, np.zeros(3))


def test_unknown_dataset_and_missing_keys_rejected(tmp_path):
    _, path = _write(tmp_path, "euroc")
    with pytest.raises(tconfig.ConfigError, match="unknown dataset"):
        load_config(path, dataset="tum")
    text = path.read_text().replace("stdX:", "# stdX:")
    path.write_text(text)
    with pytest.raises(tconfig.ConfigError, match="stdX"):
        load_config(path, dataset="euroc")
    with pytest.raises(jconfig.ConfigError):
        jconfig.load_config(path, dataset="euroc")


DIALECT = """%YAML:1.0
---
# a comment line
dataset: "/data/euroc sets/mav0/"   # a quoted path
name: 'it''s'
bare: some text
count: 12
octal: 017
hex: 0x1f
negative: -4
ratio: .5
exp_float: 1.5e-03
exp_no_dot: 1e-05
inf: -.inf
flag: true
off_flag: Off
nothing: ~
empty:
list: [ 1, 2.5, three ]
camLeft: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 4.5865400000000000e+02, 0., 3.6721500000000003e+02, 0.,
       4.5729599999999999e+02, 2.4837500000000000e+02, 0., 0., 1. ]
distLeft: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [ -2.8340810000000001e-01, 7.3959689999999997e-02,
       1.9359000000000001e-04,
       1.7618700000000000e-05, 0. ]
nested:
   inner: 3
   deeper:
      leaf: x
"""


def test_dialect_parses_as_pyyaml_does(tmp_path):
    """Comments, quoted and bare strings, YAML 1.1's int, float, bool and
    null forms, a flow list, nested mappings and matrices whose data spans
    lines parse to what the JAX parser (PyYAML) gives."""
    path = tmp_path / "dialect.yml"
    path.write_text(DIALECT)
    got = tconfig._parse_opencv_yaml(path)
    _same(got, jconfig._parse_opencv_yaml(path))
    assert got["camLeft"].shape == (3, 3) and got["distLeft"].shape == (1, 5)
    assert got["octal"] == 15 and got["exp_no_dot"] == "1e-05" and got["nothing"] is None


@pytest.mark.parametrize("bad", ["key: [1, [2]]", "key: &anchor 1", "- item", "key: !!binary x",
                                 "key: {a: 1}", "key: 1\n  indented: 2"])
def test_unsupported_constructs_are_refused(tmp_path, bad):
    path = tmp_path / "bad.yml"
    path.write_text("%YAML:1.0\n" + bad + "\n")
    with pytest.raises(ValueError):
        tconfig._parse_opencv_yaml(path)


def test_empty_file_is_an_empty_mapping(tmp_path):
    path = tmp_path / "empty.yml"
    path.write_text("%YAML:1.0\n# nothing\n")
    assert tconfig._parse_opencv_yaml(path) == jconfig._parse_opencv_yaml(path) == {}
