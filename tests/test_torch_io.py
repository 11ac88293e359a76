"""The port's dataset readers, image reader and ingestion adapters against
the JAX package's: the EuRoC, CFSD and KITTI readers' event streams and
calls on datasets written to `tmp_path`, `io/png.py` bit-equal to OpenCV's
`imread` (and its C unfilter to the numpy twin), the OD4 codec, the
shared-memory frame transport and the native EuRoC loader, and the copies'
code equal to the originals.
"""

import ast
import importlib
import inspect
import shutil
import subprocess
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from pose_estimation_tpu_torch import testing  # noqa: E402
from pose_estimation_tpu_torch.io import png  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
COPIES = ("euroc", "cfsd", "kitti", "od4", "shm", "native_loader")


class Recorder:
    """The SLAM object's ingestion API, recording every call."""

    def __init__(self, device="cpu"):
        self.calls = []
        self.device = torch.device(device)

    def collect_imu_data(self, sensor, ts, x, y, z):
        self.calls.append(("imu", sensor.name, ts, float(x), float(y), float(z)))

    def process(self, img_l, img_r, ts):
        self.calls.append(("img", ts, np.asarray(img_l).copy(), np.asarray(img_r).copy()))
        return True


def _same_calls(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0] and len(x) == len(y)
        if x[0] == "imu":
            assert x == y
        else:
            assert x[1] == y[1]
            np.testing.assert_array_equal(x[2], y[2])
            np.testing.assert_array_equal(x[3], y[3])


def _modules(name):
    return (importlib.import_module(f"pose_estimation_tpu.io.{name}"),
            importlib.import_module(f"pose_estimation_tpu_torch.io.{name}"))


def _euroc(root: Path, n_frames=5, n_imu=100, h=48, w=64):
    """A EuRoC mav0 of random frames (PNGs by `testing.write_png`)."""
    rng = np.random.default_rng(0)
    for d in ("cam0/data", "cam1/data", "imu0", "state_groundtruth_estimate0"):
        (root / d).mkdir(parents=True)
    rows = ["#ts,filename"]
    for k in range(n_frames):
        ts = 1_000_000_000 + k * 100_000_000
        for cam in ("cam0", "cam1"):
            testing.write_png(root / cam / "data" / f"{ts}.png",
                              rng.integers(0, 255, (h, w), np.uint8))
        rows.append(f"{ts},{ts}.png")
    for cam in ("cam0", "cam1"):
        (root / cam / "data.csv").write_text("\n".join(rows) + "\n")
    imu = ["#ts,wx,wy,wz,ax,ay,az"] + [
        f"{995_000_000 + k * 5_000_000},{0.01 * k},0.02,0.03,9.8,{0.1 * k},0.2"
        for k in range(n_imu)]
    (root / "imu0" / "data.csv").write_text("\n".join(imu) + "\n")
    gt = ["#ts,px,py,pz"] + [f"{1_000_000_000 + k * 100_000_000},{0.1 * k},0,0"
                             for k in range(n_frames)]
    (root / "state_groundtruth_estimate0" / "data.csv").write_text("\n".join(gt) + "\n")
    return root


def _reader(path):
    return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


# ---- the readers against the JAX package's


@pytest.mark.parametrize("speed_up, max_frames", [(1, None), (2, None), (1, 3)])
def test_euroc_reader_matches_jax(tmp_path, speed_up, max_frames):
    """The same event stream and the same calls into the SLAM object, the
    port's default image reader (`io/png.py`) against OpenCV's, and the
    same ground truth."""
    jeuroc, teuroc = _modules("euroc")
    _euroc(tmp_path)
    jds, tds = jeuroc.EurocDataset(str(tmp_path)), teuroc.EurocDataset(str(tmp_path))
    jev = list(jds.events(speed_up, max_frames))
    tev = list(tds.events(speed_up, max_frames))
    assert len(jev) == len(tev) > 0
    for a, b in zip(jev, tev):
        assert a[:2] == b[:2] and all(np.array_equal(x, y) for x, y in zip(a[2:], b[2:]))
    rec_j, rec_t = Recorder(), Recorder()
    n_j = jeuroc.run_euroc(rec_j, jds, speed_up, max_frames, imread=_reader)
    n_t = teuroc.run_euroc(rec_t, tds, speed_up, max_frames)
    assert n_j == n_t == sum(e[0] == "img" for e in jev)
    _same_calls(rec_t.calls, rec_j.calls)
    np.testing.assert_array_equal(tds.ground_truth(), jds.ground_truth())


@pytest.mark.parametrize("split", [False, True])
def test_cfsd_reader_matches_jax(tmp_path, split):
    """Side-by-side JPEG frames (or pre-split left/ right/ directories),
    one missing, interleaved with the recording's IMU rows."""
    jcfsd, tcfsd = _modules("cfsd")
    rng = np.random.default_rng(3)
    stamps = [1000 + 100 * k for k in range(4)]
    (tmp_path / "imgTimestamp.txt").write_text("\n".join(map(str, stamps)))
    (tmp_path / "imu.csv").write_text("#ts,gx,gy,gz,ax,ay,az\n" + "\n".join(
        f"{990 + 25 * k},{0.1 * k},0.2,0.3,9.8,{0.01 * k},0.0" for k in range(16)))
    for k in range(3):          # frame 3 is missing
        img = rng.integers(0, 255, (24, 64), np.uint8)
        if split:
            for side, half in (("left", img[:, :32]), ("right", img[:, 32:])):
                (tmp_path / side).mkdir(exist_ok=True)
                cv2.imwrite(str(tmp_path / side / f"{k}.jpg"), half)
        else:
            cv2.imwrite(str(tmp_path / f"{k}.jpg"), img)
    results = []
    for mod in (jcfsd, tcfsd):
        rec = Recorder()
        n = mod.run_cfsd(rec, mod.CfsdRecording(str(tmp_path)),
                         imread=None if mod is tcfsd else _reader)
        results.append((n, rec.calls))
    assert results[0][0] == results[1][0] == 3
    _same_calls(results[1][1], results[0][1])


def test_kitti_default_reader_reads_the_pngs(tmp_path):
    """The port's KITTI replay with its default image reader gives the
    calls the JAX replay gives with OpenCV's."""
    jkitti, tkitti = _modules("kitti")
    cfg = testing.sim_config(dataset="kitti", width=64, height=48)
    _, root, n_img, _ = testing.write_kitti(tmp_path, cfg, 0.3, n_landmarks=20)
    results = []
    for mod in (jkitti, tkitti):
        rec = Recorder()
        n = mod.run_kitti(rec, mod.KittiDataset(str(root)), 10**9, 10**9, 20,
                          imread=None if mod is tkitti else _reader)
        results.append((n, rec.calls))
    assert results[0][0] == results[1][0] == n_img
    _same_calls(results[1][1], results[0][1])


# ---- io/png.py


SHAPES = [(1, 1), (5, 7), (33, 65), (37, 101), (48, 64)]


@pytest.mark.parametrize("h, w", SHAPES)
def test_png_reader_is_bit_equal_to_opencv(tmp_path, h, w):
    """Files with every row filter (`testing.write_png`) and files OpenCV
    writes (its own filter choice), at odd widths: the port's reader, on
    the twin, bit-equal to `cv2.imread`."""
    rng = np.random.default_rng(h * 1000 + w)
    smooth = np.clip(np.cumsum(rng.integers(-3, 4, (h, w)), axis=1) + 128, 0, 255)
    for k, img in enumerate((rng.integers(0, 256, (h, w)), smooth)):
        img = img.astype(np.uint8)
        ours, theirs = tmp_path / f"ours{k}.png", tmp_path / f"cv{k}.png"
        testing.write_png(ours, img)
        cv2.imwrite(str(theirs), img)
        if h >= 5:
            assert set(png.read_filtered(str(ours))[:, 0].tolist()) == {0, 1, 2, 3, 4}
        for path in (ours, theirs):
            got = png.reader("cpu")(str(path))
            np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
            np.testing.assert_array_equal(got, img)


def test_png_reader_refuses_other_formats(tmp_path):
    rng = np.random.default_rng(1)
    cv2.imwrite(str(tmp_path / "rgb.png"), rng.integers(0, 255, (8, 8, 3), np.uint8))
    cv2.imwrite(str(tmp_path / "deep.png"), rng.integers(0, 65535, (8, 8)).astype(np.uint16))
    for name, why in (("rgb.png", "colour type 2"), ("deep.png", "bit depth 16")):
        with pytest.raises(ValueError, match=why):
            png.read_png(str(tmp_path / name), png.unfilter_plain)
    testing.write_png(tmp_path / "ok.png", np.zeros((4, 4), np.uint8))
    data = bytearray((tmp_path / "ok.png").read_bytes())
    data[40] ^= 0xFF                                      # inside the IDAT chunk
    (tmp_path / "corrupt.png").write_bytes(bytes(data))
    (tmp_path / "text.png").write_text("not a png")
    for name, why in (("corrupt.png", "corrupt"), ("text.png", "not a PNG")):
        with pytest.raises(ValueError, match=why):
            png.read_png(str(tmp_path / name), png.unfilter_plain)
    assert png.reader("cpu")(str(tmp_path / "missing.png")) is None


def test_c_unfilter_equals_the_twin(tmp_path):
    """`csrc/png_unfilter.cu` is host code: built here by the C++ compiler
    alone, it gives the twin's pixels on every filter type, and names a
    row with an unknown filter."""
    import ctypes

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    lib_path = tmp_path / "libpng_unfilter.so"
    subprocess.run([cxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(REPO / "pose_estimation_tpu_torch/csrc/png_unfilter.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int
    rng = np.random.default_rng(5)
    for h, w in SHAPES + [(240, 320)]:
        testing.write_png(tmp_path / "x.png", rng.integers(0, 256, (h, w)).astype(np.uint8))
        rows = np.ascontiguousarray(png.read_filtered(str(tmp_path / "x.png")))
        out = np.empty((h, w), np.uint8)
        assert lib.png_unfilter(rows.ctypes.data, h, w, out.ctypes.data) == 0
        np.testing.assert_array_equal(out, png.unfilter_plain(rows))
    rows = rows.copy()
    rows[7, 0] = 9
    assert lib.png_unfilter(rows.ctypes.data, h, w, out.ctypes.data) == 8


# ---- ingestion adapters


def test_od4_codec_matches_jax():
    jod4, tod4 = _modules("od4")
    for data_type, xyz, stamp in ((tod4.ANGULAR_VELOCITY_READING, (0.25, -3.5, 9.81), 112),
                                  (tod4.ACCELERATION_READING, (-0.0, 0.0, -9.81), 0)):
        env = dict(data_type=data_type, serialized_data=tod4.encode_reading(*xyz),
                   sample_seconds=1703155200, sample_micros=250_000, sender_stamp=stamp)
        assert tod4.encode_reading(*xyz) == jod4.encode_reading(*xyz)
        wire = tod4.encode_envelope(tod4.Envelope(**env))
        assert wire == jod4.encode_envelope(jod4.Envelope(**env))
        assert tuple(tod4.decode_envelope(wire)) == tuple(jod4.decode_envelope(wire))
        assert tod4.decode_reading(env["serialized_data"]) == jod4.decode_reading(
            env["serialized_data"])
    for junk in (b"", b"\x00" * 16, b"\x0d\xa4\xff\xff\xff"):
        assert tod4.decode_envelope(junk) is None is jod4.decode_envelope(junk)


def test_shm_frames_cross_between_the_packages():
    """A frame published by either package's producer arrives through the
    other's source: the two share `native/libshmframes.so`."""
    import os

    jshm, tshm = _modules("shm")
    if not tshm.available():
        pytest.skip("native/libshmframes.so not built")
    assert jshm.available()
    import threading

    w, h, c = 64, 16, 4
    frame = np.random.default_rng(2).integers(0, 255, (h, w, c), np.uint8)
    gray = (0.114 * frame[..., 0] + 0.587 * frame[..., 1]
            + 0.299 * frame[..., 2]).astype(np.float32)
    for k, (prod_mod, src_mod) in enumerate(((tshm, jshm), (jshm, tshm))):
        name = f"/pet-torch-shm-{os.getpid()}-{k}"
        prod = prod_mod.ShmStereoProducer(name, w, h, c)
        stop = threading.Event()

        def publish():      # until the reader has one (a notification can come early)
            while not stop.wait(0.02):
                prod.publish(frame, ts_micros=1_000_000 + k)

        pub = threading.Thread(target=publish)
        try:
            src = src_mod.ShmStereoSource(name, w, h, c, timeout_ms=2000)
            pub.start()
            ts, left, right = src.read()
            assert ts == 1_000_000 + k
            np.testing.assert_allclose(left, gray[:, :w // 2], atol=1e-4)
            np.testing.assert_allclose(right, gray[:, w // 2:], atol=1e-4)
            src.close()
        finally:
            stop.set()
            if pub.is_alive():
                pub.join(timeout=5)
            assert not pub.is_alive()
            prod.close()


def test_native_loader_matches_the_python_reader(tmp_path):
    """As the JAX package's test runs its loader (skipped where the library
    cannot load, which `available()` answers without raising)."""
    from pose_estimation_tpu_torch.io import native_loader

    if not native_loader.available():
        pytest.skip("native/libingest.so cannot load")
    _euroc(tmp_path)
    frames = list(native_loader.NativeEurocLoader(str(tmp_path), speed_up=1))
    assert len(frames) == 5
    ts0, l0, r0, imu0 = frames[0]
    assert l0.shape == (48, 64) and imu0.shape[1] == 7
    assert 0 < sum(len(f[3]) for f in frames) <= 100
    np.testing.assert_array_equal(
        l0, png.read_png(str(tmp_path / "cam0" / "data" / f"{ts0}.png"), png.unfilter_plain))


def test_native_loader_unavailable_when_the_library_cannot_load(tmp_path, monkeypatch):
    from pose_estimation_tpu_torch.io import native_loader

    broken = tmp_path / "libingest.so"
    broken.write_bytes(b"not a shared library")
    monkeypatch.setattr(native_loader, "_LIB_PATH", broken)
    monkeypatch.setattr(native_loader, "_lib", None)
    assert native_loader.available() is False


# ---- the copies stand for the originals


def _without_default_reader(src: str) -> str:
    """A function's source with its `if imread is None:` block taken out
    (OpenCV's reader in the JAX package, `io/png.py`'s in the port)."""
    out, skipping = [], False
    for line in src.splitlines():
        if line.strip() == "if imread is None:":
            skipping = True
            continue
        if skipping and (not line.strip() or line.startswith(" " * 8)):
            continue
        skipping = False
        out.append(line)
    return "\n".join(out)


def _code(mod, name: str) -> str:
    """The syntax tree of a module's function or class (its comments and
    layout left out), without the default image reader, with the port's
    package named as the JAX package."""
    src = _without_default_reader(inspect.getsource(getattr(mod, name)))
    src = src.replace("pose_estimation_tpu_torch.", "pose_estimation_tpu.")
    return ast.dump(ast.parse(textwrap.dedent(src)))


@pytest.mark.parametrize("name", COPIES)
def test_copied_io_code_equals_the_original(name):
    """Every function, class and constant of the JAX module is in the port's
    copy with the same code, apart from the package of `SensorType`, the
    readers' default image reader and the native loader's `available`
    (which answers False where the library cannot load)."""
    jmod, tmod = _modules(name)
    names = [n for n, obj in vars(jmod).items()
             if getattr(obj, "__module__", None) == jmod.__name__ and n != "available"]
    assert names
    for n in names:
        assert _code(tmod, n) == _code(jmod, n), n
    for n, value in vars(jmod).items():
        if isinstance(value, (int, float, str)) and not n.startswith("__"):
            assert getattr(tmod, n) == value, n
