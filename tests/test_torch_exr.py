"""Port vs reference: the EXR codec (``libdwt_torch.utils.exr``).

Files written by the two packages from the same seeded numpy images are
byte for byte identical, each package reads the other's file exactly,
and the reference's format checks raise the same errors.  The cases
follow tests/test_exr.py.
"""
import struct

import numpy as np
import pytest

from libdwt_tpu.utils import exr as J
from libdwt_torch.utils import exr as T

IMAGES = {
    "rgb": lambda: np.random.RandomState(0).rand(17, 23, 3).astype(np.float32) * 4.0,
    "gray": lambda: np.arange(12, dtype=np.float32).reshape(3, 4),
    "rgba": lambda: np.random.RandomState(1).randn(5, 9, 4).astype(np.float32),
    "one-channel": lambda: np.random.RandomState(2).rand(6, 7, 1).astype(np.float32),
}


@pytest.mark.parametrize("which", sorted(IMAGES))
def test_written_bytes_and_loads_equal_reference(which, tmp_path):
    img = IMAGES[which]()
    pt, pj = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    T.write_exr(pt, img)
    J.write_exr(pj, img)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for p in (pt, pj):
        got, names = T.read_exr(p)
        want, want_names = J.read_exr(p)
        assert names == want_names and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img if img.ndim == 3 else img[:, :, None])


def test_named_channels_keep_display_order(tmp_path):
    img = np.random.RandomState(3).rand(4, 5, 3).astype(np.float32)
    p = str(tmp_path / "n.exr")
    T.write_exr(p, img, channel_names=["Z", "B", "A"])
    got, names = T.read_exr(p)
    want, want_names = J.read_exr(p)
    assert names == want_names == ["B", "A", "Z"]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="channel_names"):
        T.write_exr(p, img, channel_names=["Y"])


def test_half_channels_read_like_reference(tmp_path):
    # a file with one HALF channel: both readers widen it to float32
    img = np.random.RandomState(4).rand(3, 4).astype(np.float16)
    h, w = img.shape
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (T._attr("channels", "chlist", T._chlist(["Y"], T._PT_HALF))
              + T._attr("compression", "compression", b"\0")
              + T._attr("dataWindow", "box2i", box) + b"\0")
    pre = struct.pack("<ii", 20000630, 2) + header
    line = 8 + 2 * w
    offsets = [len(pre) + 8 * h + y * line for y in range(h)]
    p = str(tmp_path / "h.exr")
    with open(p, "wb") as f:
        f.write(pre + struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, 2 * w) + img[y].tobytes())
    got, names = T.read_exr(p)
    want, _ = J.read_exr(p)
    assert names == ["Y"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :, 0], img.astype(np.float32))


def test_magic_and_errors(tmp_path):
    p = str(tmp_path / "bad.exr")
    with open(p, "wb") as f:
        f.write(b"not an exr file")
    with pytest.raises(ValueError, match="not an EXR"):
        T.read_exr(p)
    for flag, what in ((0x1000, "multi-part"), (0x800, "deep"), (0x200, "tiled")):
        with open(p, "wb") as f:
            f.write(struct.pack("<ii", 20000630, 2 | flag) + b"\0" * 8)
        with pytest.raises(ValueError, match=what):
            T.read_exr(p)


def test_header_is_spec_shaped(tmp_path):
    p = str(tmp_path / "h.exr")
    T.write_exr(p, np.zeros((2, 2), np.float32))
    magic, version = struct.unpack("<ii", open(p, "rb").read(8))
    assert magic == 20000630 and version == 2
