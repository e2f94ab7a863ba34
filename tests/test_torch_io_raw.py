"""lk_tpu_torch.io.raw and io.native: the LKRAW container and the port's
own framestore build, mirroring tests/test_io_native.py, and the file
format shared with lk_tpu (each package reads the other's files).  Every
comparison is exact: the readers copy bytes (downscale 2 is integer
arithmetic)."""

import os
import threading

import numpy as np
import pytest

from lk_tpu.io import raw as jraw
from lk_tpu_torch.io import native as tnative
from lk_tpu_torch.io import raw as traw

N, H, W = 20, 32, 48


@pytest.fixture
def frames():
    return np.random.default_rng(1234).integers(0, 256, (N, H, W, 3),
                                                dtype=np.uint8)


@pytest.fixture
def raw_file(tmp_path, frames):
    path = str(tmp_path / "clip.lkraw")
    traw.write_lkraw(path, frames)
    return path


def _fallback_reader(path, **kw):
    """A RawFrameReader forced onto the numpy path."""
    orig = traw.get_lib
    traw.get_lib = lambda: None
    try:
        return traw.RawFrameReader(path, **kw)
    finally:
        traw.get_lib = orig


def _read_all(r, n=6):
    got = []
    while True:
        b = r.next_batch(n)
        if b is None:
            break
        got.append(b)
    r.close()
    return np.concatenate(got)


def test_native_lib_builds_in_build_dir():
    """g++ builds the port's own framestore.cpp into lk_tpu_torch/_build
    (git-ignored), keyed by the source's hash, never beside the source."""
    assert tnative.get_lib() is not None, "g++ build of framestore failed"
    so = tnative.library_path()
    assert so.is_file() and so.parent.parent.name == "_build"
    assert so.parent.parent.parent.name == "lk_tpu_torch"
    src_dir = os.path.dirname(tnative.__file__)
    assert not os.path.exists(os.path.join(src_dir, "libframestore.so"))


def test_concurrent_builds(tmp_path, monkeypatch):
    """Builds racing in one directory each write a temporary file and
    rename it into place: every one ends with the whole library."""
    monkeypatch.setattr(tnative, "_BUILD", tmp_path)
    out = [None] * 4

    def build(i):
        out[i] = tnative._build()

    ts = [threading.Thread(target=build, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert len(set(out)) == 1 and out[0] == tnative.library_path()
    assert os.listdir(out[0].parent) == ["libframestore.so"]
    import ctypes

    ctypes.CDLL(str(out[0])).fs_open


@pytest.mark.parametrize("native", [True, False])
def test_roundtrip(raw_file, frames, native):
    r = (traw.RawFrameReader(raw_file, ring=4) if native
         else _fallback_reader(raw_file))
    assert r.native == native
    assert (r.width, r.height, r.channels, r.nframes) == (W, H, 3, N)
    np.testing.assert_array_equal(_read_all(r), frames)


@pytest.mark.parametrize("native", [True, False])
def test_downscale2(raw_file, frames, native):
    r = (traw.RawFrameReader(raw_file, ring=4, downscale=2) if native
         else _fallback_reader(raw_file, downscale=2))
    b = _read_all(r, 20)
    assert b.shape == (N, H // 2, W // 2, 3)
    ref = frames.astype(np.uint16)
    ref = (ref[:, ::2, ::2] + ref[:, 1::2, ::2] + ref[:, ::2, 1::2]
           + ref[:, 1::2, 1::2] + 2) >> 2
    np.testing.assert_array_equal(b, ref.astype(np.uint8))


def test_iterator(raw_file):
    r = traw.RawFrameReader(raw_file)
    assert sum(1 for _ in r) == N
    r.close()


@pytest.mark.parametrize("writer", ["port", "lk_tpu"])
@pytest.mark.parametrize("native", [True, False])
def test_cross_package_files(tmp_path, frames, writer, native):
    """A file written by either package reads back through the other's
    reader (native and numpy paths), byte for byte."""
    path = str(tmp_path / "x.lkraw")
    if writer == "port":
        traw.write_lkraw(path, frames[..., 0])            # (N, H, W) gray
        want = frames[..., :1]
        if native:
            r = jraw.RawFrameReader(path, ring=3)
        else:
            orig = jraw.get_lib
            jraw.get_lib = lambda: None
            try:
                r = jraw.RawFrameReader(path)
            finally:
                jraw.get_lib = orig
    else:
        jraw.write_lkraw(path, frames)
        want = frames
        r = (traw.RawFrameReader(path, ring=3) if native
             else _fallback_reader(path))
    assert r.native == native
    np.testing.assert_array_equal(_read_all(r, 7), want)


def test_truncated_file_clamps_nframes(raw_file, frames, tmp_path):
    """A truncated LKRAW must not read past the mapping (native) or the
    memmap (numpy): nframes clamps to the full frames present."""
    data = open(raw_file, "rb").read()
    frame_bytes = H * W * 3
    cut = str(tmp_path / "cut.lkraw")
    with open(cut, "wb") as fh:
        fh.write(data[: traw._HDR.size + 7 * frame_bytes + frame_bytes // 2])
    for r in (traw.RawFrameReader(cut, ring=4), _fallback_reader(cut)):
        assert r.nframes == 7
        np.testing.assert_array_equal(_read_all(r, 4), frames[:7])


def test_corrupt_header_rejected(tmp_path):
    bad = str(tmp_path / "bad.lkraw")
    with open(bad, "wb") as fh:
        fh.write(b"NOPE" + b"\x00" * 16)
    lib = tnative.get_lib()
    assert lib.fs_open(bad.encode(), 4, 1) is None
    with pytest.raises(ValueError):
        _fallback_reader(bad)
    tiny = str(tmp_path / "tiny.lkraw")
    with open(tiny, "wb") as fh:
        fh.write(b"LKRW\x01")  # shorter than the header
    assert lib.fs_open(tiny.encode(), 4, 1) is None
    with pytest.raises(ValueError):
        _fallback_reader(tiny)


def test_bad_downscale_rejected(raw_file):
    with pytest.raises(ValueError):
        traw.RawFrameReader(raw_file, downscale=3)
    assert tnative.get_lib().fs_open(raw_file.encode(), 4, 4) is None
