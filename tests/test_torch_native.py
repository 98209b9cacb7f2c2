"""The port's host library (``dffx_torch/data/native.py`` on
``dffx_torch/csrc/host``) on the CPU, on small files the tests write.

* Normalisation: ``normalize_pad_stack`` (uint8 and float32, padded and
  already x32, pad values 0 and -1, one and four threads) and
  ``hwcn_to_nhwc_normalize`` bit-equal to their numpy versions
  (``*_plain``) and to ``dffx.data.native``.
* Decode: ``imread`` byte-equal to ``cv2.imread`` and to ``dffx``'s,
  ``imread_unchanged`` to ``cv2.IMREAD_UNCHANGED``, each read counted as
  ``native``; the files ``dffx`` hands to ``cv2`` (EXIF orientation 6, alpha,
  16 bits, palette, another format) and CMYK JPEGs equal ``cv2`` and are counted
  ``cv2-punt``; a library built without a unit (its header hidden from the
  probe) sends that unit's formats to ``cv2``, counted ``cv2-absent``.  The
  TIFF cases need the TIFF unit, which is built where ``tiffio.h`` is found.
* The readers with ``cv2`` unimportable: ``RealScenesDataset`` on a JPEG
  scene and the 16-bit PNG depth read.
* The build: the library's place and name, no second build, a broken unit
  and a missing ``g++`` raise, and builds started at once make one library.
"""

import functools
import re
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from dffx.data import native as jnative
from dffx_torch.data import _host_build, native

import torch_fixtures as fx

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _whole_reference_library():
    """``dffx``'s host library built and loadable before this module's first
    ``dffx.data.native`` call (``fx.reference_host_library``)."""
    fx.reference_host_library(jnative._SO, jnative._REQUIRED_VERSION)


@pytest.fixture(autouse=True)
def _fresh_counts():
    native.reset_decodes()
    yield
    native.reset_decodes()


def needs(fmt: str) -> None:
    """Skip unless the library on this machine decodes ``fmt``."""
    if fmt not in native.formats():
        pytest.skip(f"the {fmt} unit is not built here: "
                    f"{native.library().build.absent}")


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,pad_value,threads", [
    ((3, 47, 72, 3), -1.0, 4), ((2, 32, 64, 3), -1.0, 4), ((1, 1, 1, 3), 0.0, 1),
    ((5, 47, 72, 3), 0.0, 4), ((2, 33, 31, 3), -1.0, 1)])
def test_normalize_pad_stack_is_plain_and_dffx(dtype, shape, pad_value, threads):
    rng = np.random.default_rng(sum(shape))
    stack = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8
             else rng.uniform(0, 255, shape).astype(np.float32))
    got = native.normalize_pad_stack(stack, pad_value, threads=threads)
    want = native.normalize_pad_stack_plain(stack, pad_value)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] % 32 == 0 and got.shape[2] % 32 == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.normalize_pad_stack(stack, pad_value))


@pytest.mark.parametrize("shape,threads", [((8, 9, 3, 2), 4), ((32, 40, 3, 5), 4),
                                           ((1, 1, 3, 1), 1), ((47, 72, 3, 10), 3)])
def test_hwcn_to_nhwc_normalize_is_plain_and_dffx(shape, threads):
    hwcn = np.random.default_rng(shape[0]).uniform(0, 255, shape)
    got = native.hwcn_to_nhwc_normalize(hwcn, threads=threads)
    np.testing.assert_array_equal(got, native.hwcn_to_nhwc_normalize_plain(hwcn))
    np.testing.assert_array_equal(got, jnative.hwcn_to_nhwc_normalize(hwcn))


def test_normalisation_checks_its_rank():
    with pytest.raises(ValueError, match="N, H, W, C"):
        native.normalize_pad_stack(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="H, W, C, N"):
        native.hwcn_to_nhwc_normalize(np.zeros((4, 4, 3)))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def palette_png(path: str, rng) -> None:
    from PIL import Image

    img = Image.fromarray(rng.integers(0, 16, (24, 32), dtype=np.uint8), mode="L")
    img = img.convert("P")
    img.putpalette([int(v) for v in rng.integers(0, 256, 16 * 3)])
    img.save(path)


def write_case(tmp_path, name: str) -> str:
    """Write one test image; returns its path (the format from its name)."""
    rng = np.random.default_rng(len(name))
    path = str(tmp_path / name)
    shapes = {"c8": (48, 64, 3), "odd": (47, 72, 3), "g8": (32, 32), "one": (1, 1, 3),
              "a8": (24, 32, 4), "g16": (24, 32), "c16": (24, 32, 3)}
    stem = name.split(".")[0]
    if stem == "pal":
        palette_png(path, rng)
        return path
    if stem == "cmyk":  # libjpeg converts no CMYK scan to BGR; cv2 does
        from PIL import Image

        Image.fromarray(rng.integers(0, 256, (24, 32, 4), dtype=np.uint8),
                        mode="CMYK").save(path, quality=90)
        return path
    if stem == "exif6":
        ok, enc = cv2.imencode(".jpg", rng.integers(0, 256, (24, 40, 3), dtype=np.uint8))
        Path(path).write_bytes(fx.exif_oriented(enc.tobytes(), 6))
        return path
    if stem == "f32":
        img = (rng.standard_normal((24, 32)) * 50).astype(np.float32)
    else:
        dtype = np.uint16 if stem.endswith("16") else np.uint8
        img = rng.integers(0, np.iinfo(dtype).max + 1, shapes[stem], dtype=dtype)
    assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 90] if name.endswith(".jpg")
                       else [])
    return path


FORMAT = {"png": "png", "jpg": "jpeg", "tif": "tiff", "bmp": "other"}


def fmt_of(name: str) -> str:
    return FORMAT[name.rsplit(".", 1)[1]]


@pytest.mark.parametrize("name", ["c8.png", "odd.png", "g8.png", "one.png", "pal.png",
                                  "c8.jpg", "odd.jpg", "g8.jpg", "one.jpg",
                                  "c8.tif", "g8.tif"])
def test_imread_is_cv2_and_dffx(tmp_path, name):
    fmt = fmt_of(name)
    needs(fmt)
    path = write_case(tmp_path, name)
    want = cv2.imread(path)
    got = native.imread(path)
    assert got is not None and got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.imread(path))
    np.testing.assert_array_equal(native.imread_compat(path, "a test"), want)
    assert native.decodes == {(fmt, "native"): 2}


@pytest.mark.parametrize("name", ["g8.png", "g16.png", "c8.png", "c16.png",
                                  "g16.tif", "f32.tif", "c8.tif", "g8.tif"])
def test_imread_unchanged_is_cv2(tmp_path, name):
    fmt = fmt_of(name)
    needs(fmt)
    path = write_case(tmp_path, name)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = native.imread_unchanged_compat(path, "a test")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.imread_unchanged(path))
    assert native.decodes == {(fmt, "native"): 1}


#: (file, unchanged read): the files dffx's decoder hands to cv2
PUNTS = [("exif6.jpg", False), ("cmyk.jpg", False), ("a8.png", False), ("c16.png", False), ("g16.png", False),
         ("a8.png", True), ("pal.png", True), ("c8.jpg", True), ("c8.bmp", False),
         ("c8.bmp", True), ("g16.tif", False), ("c16.tif", False)]


@pytest.mark.parametrize("name,unchanged", PUNTS)
def test_punts_are_read_by_cv2_and_counted(tmp_path, name, unchanged):
    fmt = fmt_of(name)
    if fmt != "other":
        needs(fmt)
    path = write_case(tmp_path, name)
    read = native.imread_unchanged if unchanged else native.imread
    assert read(path) is None
    flag = cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR
    want = cv2.imread(path, flag)
    compat = native.imread_unchanged_compat if unchanged else native.imread_compat
    got = compat(path, "a test")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert native.decodes == {(fmt, "cv2-punt"): 1}
    if name == "exif6.jpg":  # cv2 rotated it: the library would not have
        assert want.shape == (40, 24, 3)


def test_a_decode_error_raises_and_reads_no_cv2(tmp_path, monkeypatch):
    needs("png")
    path = tmp_path / "cut.png"
    path.write_bytes(Path(write_case(tmp_path, "c8.png")).read_bytes()[:40])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(FileNotFoundError, match="cannot decode image .* png decoder returned"):
        native.imread_compat(str(path), "a test")
    with pytest.raises(FileNotFoundError, match="cannot decode image"):
        native.imread_compat(str(tmp_path / "missing.png"), "a test")
    assert not native.decodes


def with_tiff_compression(path: str, scheme: int) -> None:
    """Set the first directory's Compression tag (259) of a little-endian TIFF."""
    buf = bytearray(Path(path).read_bytes())
    assert buf[:4] == b"II*\x00"
    ifd = int.from_bytes(buf[4:8], "little")
    for k in range(int.from_bytes(buf[ifd:ifd + 2], "little")):
        e = ifd + 2 + 12 * k
        if int.from_bytes(buf[e:e + 2], "little") == 259:
            buf[e + 8:e + 10] = scheme.to_bytes(2, "little")
            Path(path).write_bytes(bytes(buf))
            return
    raise AssertionError(f"{path} has no Compression tag")


@pytest.mark.parametrize("unchanged", [False, True])
def test_a_tiff_of_a_compression_libtiff_lacks_is_a_punt(tmp_path, unchanged):
    """A scheme this libtiff was built without is declined by the header read
    (cv2 may carry its own codec), not raised as a decode error."""
    needs("tiff")
    path = write_case(tmp_path, "c8.tif")
    with_tiff_compression(path, 65000)  # no libtiff configures this scheme
    read = native.imread_unchanged if unchanged else native.imread
    assert read(path) is None and not native.decodes


@pytest.fixture
def library_without(monkeypatch, tmp_path):
    """Make ``native`` load a library built with ``headers`` hidden from the
    include probe, in a build directory of the test's own."""

    def hide(*headers):
        probe = _host_build.has_header
        monkeypatch.setattr(_host_build, "has_header",
                            lambda cxx, h: h not in headers and probe(cxx, h))
        monkeypatch.setattr(_host_build, "BUILD_DIR", tmp_path / "host")
        monkeypatch.setattr(native, "library", functools.lru_cache()(native.library.__wrapped__))
        return native.library().build

    return hide


@pytest.mark.parametrize("unit,headers,names", [
    ("tiff", ("tiffio.h",), ("c8.tif", "g16.tif")),
    ("codec", ("jpeglib.h",), ("c8.jpg", "c8.png", "g16.png"))])
def test_an_absent_unit_sends_its_formats_to_cv2(tmp_path, library_without, unit, headers,
                                                 names):
    for fmt in {fmt_of(n) for n in names}:
        needs(fmt)
    paths = [write_case(tmp_path, n) for n in names]
    built = library_without(*headers)
    assert unit not in built.units and built.absent == {unit: headers}
    assert built.path.parent == tmp_path / "host"
    assert not native.formats() & {fmt_of(n) for n in names}
    for name, path in zip(names, paths):
        unchanged = name.startswith("g16")
        flag = cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR
        compat = native.imread_unchanged_compat if unchanged else native.imread_compat
        np.testing.assert_array_equal(compat(path, "a test"), cv2.imread(path, flag))
    want = {}
    for n in names:
        want[(fmt_of(n), "cv2-absent")] = want.get((fmt_of(n), "cv2-absent"), 0) + 1
    assert native.decodes == want
    stack = np.random.default_rng(0).integers(0, 256, (2, 5, 6, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.normalize_pad_stack(stack),
                                  native.normalize_pad_stack_plain(stack))


def test_threads_decode_at_once_and_count_every_read(tmp_path):
    """Sixteen threads (more than the cores) read the same files at once, as
    the ``Loader``'s threads do, with the interpreter switching threads as
    often as it can: every image equals its ``cv2`` read and the counters
    lose no read."""
    import threading

    names = [n for n in ("c8.jpg", "c8.png", "a8.png", "c8.tif") if fmt_of(n) in
             native.formats()]
    paths = [write_case(tmp_path, n) for n in names]
    want = [cv2.imread(p) for p in paths]
    rounds, bad = 20, []

    def work():
        for _ in range(rounds):
            for p, w in zip(paths, want):
                if not np.array_equal(native.imread_compat(p, "a test"), w):
                    bad.append(p)
            native.normalize_pad_stack(np.zeros((2, 5, 6, 3), np.uint8), threads=2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad
    assert sum(native.decodes.values()) == 16 * rounds * len(paths)
    for n in names:
        route = "cv2-punt" if n == "a8.png" else "native"
        assert native.decodes[(fmt_of(n), route)] == 16 * rounds * names.count(n)


def test_real_scenes_reader_runs_without_cv2(tmp_path, monkeypatch):
    import dffx.data as jdata
    from dffx_torch.data import RealScenesDataset

    needs("jpeg")
    root = fx.write_real_scene(str(tmp_path / "scenes"))
    want = jdata.RealScenesDataset(root)[0]
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises
    got = RealScenesDataset(root)[0]
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert native.decodes == {("jpeg", "native"): 11}  # the first slice twice, as dffx


def test_depth_png_read_runs_without_cv2(tmp_path, monkeypatch):
    from dffx_torch.data.datasets import _read_depth_any

    needs("png")
    path = write_case(tmp_path, "g16.png")
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = _read_depth_any(path, "a test")
    assert got.dtype == np.float32 and got.shape == (24, 32)
    np.testing.assert_array_equal(got, want)
    assert native.decodes == {("png", "native"): 1}


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_library_lands_in_build_host_under_a_hash_name():
    built = native.library().build
    assert built.path.parent == ROOT / "build" / "host"
    assert re.fullmatch(r"libdffx_torch_host_[0-9a-f]{16}\.so", built.path.name)
    assert built.path == _host_build.library_path(built.units)
    assert built.units[0] == "normalize" and set(built.units) | set(built.absent) == set(
        _host_build.UNITS)
    assert native.library() and "normalize" in native.formats()


def test_a_second_build_does_not_rebuild():
    first = native.library().build.path
    stamp = first.stat().st_mtime_ns
    again = _host_build.build()
    assert again.path == first and again.seconds == 0.0
    assert first.stat().st_mtime_ns == stamp


@pytest.mark.parametrize("unit", list(_host_build.UNITS))
def test_a_broken_unit_raises_with_the_compiler_output(monkeypatch, tmp_path, unit):
    if unit in native.library().build.absent:
        pytest.skip(f"{unit} is not built here")
    host = tmp_path / "src"
    host.mkdir()
    for u in _host_build.UNITS.values():
        (host / u.source).write_bytes((_host_build.HOST / u.source).read_bytes())
    source = host / _host_build.UNITS[unit].source
    source.write_text(source.read_text() + "\nint broken_here = undeclared_name;\n")
    monkeypatch.setattr(_host_build, "HOST", host)
    monkeypatch.setattr(_host_build, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(_host_build.BuildError,
                       match=rf"(?s)g\+\+ failed.*{source.name}.*undeclared_name"):
        _host_build.build()
    assert not list((tmp_path / "host").glob("*.so"))


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_host_build, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(_host_build.BuildError, match=r"g\+\+ not found"):
        _host_build.build()
    assert not (tmp_path / "host").exists()


def test_builds_started_at_once_make_one_library(tmp_path):
    code = ("import sys; from pathlib import Path; from dffx_torch.data import _host_build as b;"
            " b.BUILD_DIR = Path(sys.argv[1]); print(b.build().path)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "host")], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o.strip() for o in outs}) == 1
    assert [p.name for p in (tmp_path / "host").iterdir() if p.name != ".lock"] == [
        Path(outs[0].strip()).name]
