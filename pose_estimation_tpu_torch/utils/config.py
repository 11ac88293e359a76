"""Runtime configuration of the port.

The same record as `pose_estimation_tpu/utils/config.py:VIOConfig`, field
for field and default for default, and the same loader (`load_config`,
`ConfigError`) of the reference's per-dataset OpenCV-YAML files, kept in
the port so that the port and its GPU smoke test import nothing of the
JAX package. The machine with the GPU has no PyYAML, so the port reads the
OpenCV FileStorage dialect with a parser of its own
(`_parse_opencv_yaml`). `tests/test_torch_geometry.py` holds both records
and both profile tables equal, `tests/test_torch_config.py` both parsers
and both loaders.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import numpy as np

WINDOW_SIZE = 4  # sliding window


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    name: str
    gravity_dir: tuple[float, float, float]
    acc_noise_times_g: bool
    bias_walk_over_sqrt_dt: bool
    acc_bias_times_g: bool
    key_gyr_noise: str
    key_acc_noise: str
    key_gyr_walk: str
    key_acc_walk: str
    alignment_axes: tuple[int, int]


PROFILES = {
    "euroc": DatasetProfile(
        name="euroc", gravity_dir=(-1.0, 0.0, 0.0),
        acc_noise_times_g=False, bias_walk_over_sqrt_dt=False,
        acc_bias_times_g=False,
        key_gyr_noise="gyroscope_noise_density",
        key_acc_noise="accelerometer_noise_density",
        key_gyr_walk="gyroscope_random_walk",
        key_acc_walk="accelerometer_random_walk",
        alignment_axes=(1, 2),
    ),
    "kitti": DatasetProfile(
        name="kitti", gravity_dir=(0.0, 0.0, -1.0),
        acc_noise_times_g=True, bias_walk_over_sqrt_dt=True,
        acc_bias_times_g=True,
        key_gyr_noise="gyrNoise", key_acc_noise="accNoise",
        key_gyr_walk="gyrBias", key_acc_walk="accBias",
        alignment_axes=(0, 1),
    ),
    "cfsd": DatasetProfile(
        name="cfsd", gravity_dir=(0.0, 0.0, 1.0),
        acc_noise_times_g=True, bias_walk_over_sqrt_dt=True,
        acc_bias_times_g=True,
        key_gyr_noise="gyrNoise", key_acc_noise="accNoise",
        key_gyr_walk="gyrBias", key_acc_walk="accBias",
        alignment_axes=(0, 1),
    ),
}


@dataclasses.dataclass(frozen=True)
class VIOConfig:
    """All tunables of the pipeline (see the JAX package's record for the
    meaning of each field)."""

    dataset: str
    dataset_path: str

    image_width: int
    image_height: int
    camera_frequency: int
    std_x: float
    std_y: float
    k_left: np.ndarray
    dist_left: np.ndarray
    k_right: np.ndarray
    dist_right: np.ndarray
    r_lr: np.ndarray
    t_lr: np.ndarray
    r_cb: np.ndarray
    t_cb: np.ndarray

    sampling_rate: int
    gyr_noise: float
    acc_noise: float
    gyr_walk: float
    acc_walk: float
    gravity_magnitude: float

    num_features: int
    scale_factor: float
    level_pyramid: int
    ini_th_fast: int
    min_th_fast: int
    match_ratio: float
    min_match_dist: float
    max_vertical_pixel_dist: float
    max_feature_age: int
    max_depth: float

    keyframe_rotation: float
    keyframe_translation: float
    max_imu_time: float
    max_gyr_bias: float
    max_acc_bias: float
    sfm_rotation: float
    sfm_translation: float
    solve_pnp: int

    max_num_iterations: int
    prior_factor: float

    speed_up: int

    max_keypoints: int = 1024
    max_matches: int = 384
    pool_capacity: int = 1024
    imu_chunk: int = 32
    window_size: int = WINDOW_SIZE
    rectify_mode: str = "sparse"
    full_ba_keyframes: bool = False
    full_ba_iterations: int = 8
    marg_prior: bool = True
    marg_forget: float = 1.0
    ba_prior_sigma: float = 0.0
    fast_backend: str = "auto"
    sample_backend: str = "auto"
    select_dtype: str = "f32"

    @property
    def profile(self) -> DatasetProfile:
        return PROFILES[self.dataset]

    @property
    def dt(self) -> float:
        return 1.0 / float(self.sampling_rate)

    @property
    def gravity(self) -> np.ndarray:
        return np.asarray(self.profile.gravity_dir) * self.gravity_magnitude

    def discrete_noise(self) -> tuple[float, float, float, float]:
        """(gyr_noise_d, acc_noise_d, gyr_walk_d, acc_walk_d)."""
        p = self.profile
        sdt = np.sqrt(self.dt)
        g = self.gravity_magnitude
        gyr_n = self.gyr_noise / sdt
        acc_n = self.acc_noise * (g if p.acc_noise_times_g else 1.0) / sdt
        gyr_w = self.gyr_walk / (sdt if p.bias_walk_over_sqrt_dt else 1.0)
        acc_w = (
            self.acc_walk
            * (g if p.acc_bias_times_g else 1.0)
            / (sdt if p.bias_walk_over_sqrt_dt else 1.0)
        )
        return gyr_n, acc_n, gyr_w, acc_w


# ---- the OpenCV FileStorage YAML dialect (cv::FileStorage's writer)

# The implicit scalar types of YAML 1.1 as PyYAML resolves them (bool,
# null, int, float), so that a value reads as the JAX package's loader,
# which parses with PyYAML, reads it.
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")


def _scalar(text: str, where: str):
    """One plain or quoted scalar."""
    if text[:1] in ("'", '"'):
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"{where}: unterminated string {text!r}")
        return text[1:-1].replace("''", "'") if text[0] == "'" else json.loads(text)
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.fullmatch(text):
        sign = -1 if text[0] == "-" else 1
        digits = text.lstrip("+-").replace("_", "")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.fullmatch(text):
        low = text.replace("_", "").lower()
        if low.endswith(".inf"):
            return -np.inf if low[0] == "-" else np.inf
        if low.endswith(".nan"):
            return np.nan
        return float(low)
    if text[0] in "[]{}&*!|>%@`" or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: unsupported YAML construct {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (one at its start or after a blank,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"') and (i == 0 or line[i - 1] in " :[,"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow_items(text: str, where: str) -> list:
    """The scalars of a flow sequence `[a, b, ...]` (no nesting)."""
    body = text.strip()
    if not (body.startswith("[") and body.endswith("]")) or "[" in body[1:-1]:
        raise ValueError(f"{where}: unsupported flow sequence {text!r}")
    inner = body[1:-1].strip()
    if not inner:
        return []
    return [_scalar(item.strip(), where) for item in inner.split(",")]


def _parse_opencv_yaml(path: str | Path) -> dict:
    """Parse an OpenCV FileStorage YAML file into a plain dict, as the JAX
    package's PyYAML-based parser does, without PyYAML.

    Handles the `%YAML:1.0` header, `#` comments, `key: value` scalars
    (int, float, bool, null, quoted and bare strings), nested mappings by
    indentation, flow sequences, and `!!opencv-matrix` nodes (`rows`,
    `cols`, `dt`, a `data` flow list that may span lines), which become
    float64 arrays of shape (rows, cols). Raises ValueError on any other
    construct."""
    path = Path(path)
    entries = []            # (line number, indent, text) of the content lines
    for n, raw in enumerate(path.read_text().splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.startswith("%YAML") or line.strip() == "---":
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{path}:{n}: tab in indentation")
        entries.append((n, len(line) - len(line.lstrip()), line.strip()))

    def block(i: int, indent: int) -> tuple[dict, int]:
        """The mapping whose keys sit at `indent`, from entries[i]."""
        out = {}
        while i < len(entries):
            n, ind, text = entries[i]
            where = f"{path}:{n}"
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"{where}: unexpected indentation")
            key, sep, rest = text.partition(":")
            if not sep or (rest and rest[0] != " ") or not key:
                raise ValueError(f"{where}: expected `key: value`, got {text!r}")
            key, rest = _scalar(key.strip(), where), rest.strip()
            i += 1
            if rest.startswith("["):
                # a flow sequence, continued over the lines up to its `]`
                while rest.count("[") > rest.count("]") and i < len(entries):
                    rest += " " + entries[i][2]
                    i += 1
                out[key] = _flow_items(rest, where)
            elif rest in ("", "!!opencv-matrix"):
                child = {}
                if i < len(entries) and entries[i][1] > indent:
                    child, i = block(i, entries[i][1])
                if rest:
                    try:
                        rows, cols, data = int(child["rows"]), int(child["cols"]), child["data"]
                    except KeyError as exc:
                        raise ValueError(f"{where}: opencv-matrix without {exc}") from None
                    out[key] = np.asarray(data, dtype=np.float64).reshape(rows, cols)
                else:
                    out[key] = child or None
            elif rest.startswith("!"):
                raise ValueError(f"{where}: unsupported tag {rest.split()[0]!r}")
            else:
                out[key] = _scalar(rest, where)
        return out, i

    if not entries:
        return {}
    data, i = block(0, entries[0][1])
    if i != len(entries):
        raise ValueError(f"{path}:{entries[i][0]}: unexpected indentation")
    return data


class ConfigError(KeyError):
    pass


def _warn_identity(key, value):
    import warnings

    warnings.warn(
        f"config key {key!r} missing; defaulting to identity/zero "
        "(imu-camera extrinsics!)", stacklevel=3,
    )
    return value


def _req(d: dict, *keys):
    """Return the first present key's value; raise if all missing (strict —
    this is the guard against the reference's silent-zero KITTI bug)."""
    for k in keys:
        if k in d and d[k] is not None:
            return d[k]
    raise ConfigError(f"missing required config key(s): {keys}")


def load_config(path: str | Path, dataset: str, **overrides) -> VIOConfig:
    """Load a reference-format YAML config file for the given dataset."""
    if dataset not in PROFILES:
        raise ConfigError(f"unknown dataset {dataset!r}; options: {list(PROFILES)}")
    d = _parse_opencv_yaml(path)
    p = PROFILES[dataset]

    def arr(key, shape):
        a = np.asarray(_req(d, key), dtype=np.float64)
        return a.reshape(shape)

    cfg = dict(
        dataset=dataset,
        dataset_path=str(d.get("dataset", "")),
        image_width=int(_req(d, "imageWidth")),
        image_height=int(_req(d, "imageHeight")),
        camera_frequency=int(d.get("cameraFrequency", 20)),
        std_x=float(_req(d, "stdX")),
        std_y=float(_req(d, "stdY")),
        k_left=arr("camLeft", (3, 3)),
        dist_left=arr("distLeft", (-1,)),
        k_right=arr("camRight", (3, 3)),
        dist_right=arr("distRight", (-1,)),
        r_lr=arr("rotationLeftToRight", (3, 3)),
        t_lr=arr("translationLeftToRight", (3,)),
        # the shipped cfsd.yml comments these out (`config/cfsd.yml:84-93`),
        # so the reference's CFSD build could not actually construct its
        # CameraModel; default to identity extrinsics with a warning.
        r_cb=(
            arr("rotationImuToCamera", (3, 3))
            if "rotationImuToCamera" in d
            else _warn_identity("rotationImuToCamera", np.eye(3))
        ),
        t_cb=(
            arr("translationImuToCamera", (3,))
            if "translationImuToCamera" in d
            else _warn_identity("translationImuToCamera", np.zeros(3))
        ),
        sampling_rate=int(_req(d, "samplingRate")),
        gyr_noise=float(_req(d, p.key_gyr_noise)),
        acc_noise=float(_req(d, p.key_acc_noise)),
        gyr_walk=float(_req(d, p.key_gyr_walk)),
        acc_walk=float(_req(d, p.key_acc_walk)),
        gravity_magnitude=float(_req(d, "gravity")),
        num_features=int(_req(d, "numberOfFeatures")),
        scale_factor=float(_req(d, "scaleFactor")),
        level_pyramid=int(_req(d, "levelPyramid")),
        ini_th_fast=int(d.get("iniThFAST", 20)),
        min_th_fast=int(d.get("minThFAST", 7)),
        match_ratio=float(_req(d, "matchRatio")),
        min_match_dist=float(_req(d, "minMatchDist")),
        max_vertical_pixel_dist=float(_req(d, "maxVerticalPixelDist")),
        max_feature_age=int(_req(d, "maxFeatureAge")),
        max_depth=float(_req(d, "maxDepth")),
        # accept both spellings; reference KITTI yml misspells them
        keyframe_rotation=float(_req(d, "keyframeRotation", "keyframe_rotation")),
        keyframe_translation=float(
            _req(d, "keyframeTranslation", "keyframe_translation")
        ),
        max_imu_time=float(_req(d, "maxImuTime")),
        max_gyr_bias=float(_req(d, "maxGyrBias")),
        max_acc_bias=float(_req(d, "maxAccBias")),
        sfm_rotation=float(d.get("sfmRotation", 0.0)),
        sfm_translation=float(d.get("sfmTranslation", 0.0)),
        solve_pnp=int(d.get("solvePnP", 0)),
        max_num_iterations=int(_req(d, "max_num_iterations")),
        prior_factor=float(_req(d, "priorFactor")),
        speed_up=int(d.get("speedUp", 1)),
    )
    cfg.update(overrides)
    return VIOConfig(**cfg)
