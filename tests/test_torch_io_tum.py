"""PyTorch port: the PNG16 codec (utils/io.py, csrc/depthio.cpp) and the TUM
dataset layer (utils/tum.py) against the JAX package.

Tolerances: decoded images and encoded bytes are equal (both packages'
native codecs link the same zlib; the Python codecs are the same code);
list parsing, association and export text are equal; the quaternion
helpers agree to 1e-7 (float64 arithmetic in both); poses read back from a
TUM export equal the other package's read to the bit, and the written
poses to 1e-5 (six decimals in the file)."""

import os

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu.utils import io as jio
from voxelhashing_demo_tpu.utils import tum as jtum
from voxelhashing_demo_tpu_torch import kernels
from voxelhashing_demo_tpu_torch.utils import io as tio
from voxelhashing_demo_tpu_torch.utils import tum as ttum

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def random_depth(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 20000, size=(h, w)).astype(np.uint16)
    img[10:20, 10:20] = 0  # holes
    return img


WRITERS = {
    "jax_python": lambda p, img: jio.write_depth_png(p, img, native=False),
    "jax_native": lambda p, img: jio.write_depth_png(p, img, native=True),
    "port_python": lambda p, img: tio.write_depth_png(p, img, native=False),
    "port_native": lambda p, img: tio.write_depth_png(p, img),
}
READERS = {
    "jax_python": lambda p: jio.read_depth_png(p, native=False),
    "jax_native": lambda p: jio.read_depth_png(p, native=True),
    "port_python": lambda p: tio.read_depth_png(p, native=False),
    "port_native": lambda p: tio.read_depth_png(p),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_every_codec_decodes_every_writer(tmp_path, writer):
    img = random_depth(seed=sorted(WRITERS).index(writer))
    p = str(tmp_path / "d.png")
    WRITERS[writer](p, img)
    for name, read in READERS.items():
        np.testing.assert_array_equal(read(p), img, err_msg=name)


@pytest.mark.parametrize("native", [False, True])
def test_encoded_bytes_equal(tmp_path, native):
    img = random_depth(seed=5)
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    jio.write_depth_png(a, img, native=native)
    tio.write_depth_png(b, img, native=native)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_eight_bit_png_widens_as_jax(tmp_path):
    """An 8-bit grayscale PNG (hand-built) decodes to v << 8 | v in both
    codecs of both packages."""
    import struct
    import zlib

    img8 = np.random.default_rng(3).integers(0, 256, (6, 9)).astype(np.uint8)
    raw = b"".join(b"\x00" + img8[y].tobytes() for y in range(6))

    def chunk(t, payload):
        c = t + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 9, 6, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    p = str(tmp_path / "e.png")
    with open(p, "wb") as f:
        f.write(data)
    want = jio.read_depth_png(p, native=False)
    np.testing.assert_array_equal(
        want, img8.astype(np.uint16) << 8 | img8.astype(np.uint16))
    for name, read in READERS.items():
        np.testing.assert_array_equal(read(p), want, err_msg=name)


def test_batch_decode_matches_jax(tmp_path):
    imgs = [random_depth(seed=i) for i in range(8)]
    paths = []
    for i, img in enumerate(imgs):
        p = str(tmp_path / f"{i}.png")
        jio.write_depth_png(p, img)
        paths.append(p)
    got = tio.read_depth_batch(paths, 64, 48, num_threads=3)
    np.testing.assert_array_equal(got, jio.read_depth_batch(paths, 64, 48))
    np.testing.assert_array_equal(got, np.stack(imgs))
    assert tio.read_depth_batch([], 64, 48).shape == (0, 48, 64)


def test_batch_decode_rejects_mismatched_sizes(tmp_path):
    paths = []
    for i, (h, w) in enumerate([(48, 64), (48, 64), (40, 64)]):
        p = str(tmp_path / f"{i}.png")
        tio.write_depth_png(p, random_depth(h, w, seed=i))
        paths.append(p)
    with pytest.raises(ValueError, match="2.png: depth image is 64x40"):
        tio.read_depth_batch(paths, 64, 48)
    with pytest.raises(ValueError):
        tio.read_depth_batch(paths[:2], 128, 96)


def test_truncated_and_garbage_files_raise(tmp_path):
    img = random_depth(seed=3)
    p = str(tmp_path / "d.png")
    tio.write_depth_png(p, img)
    data = open(p, "rb").read()
    for cut in (8, 40, len(data) // 2):
        q = str(tmp_path / f"cut_{cut}.png")
        with open(q, "wb") as f:
            f.write(data[:cut])
        for native in (False, None):
            with pytest.raises(ValueError):
                tio.read_depth_png(q, native=native)
        with pytest.raises(ValueError):
            tio.read_depth_batch([q], 64, 48)
    # missing only the IEND trailer: the image data is complete
    q = str(tmp_path / "no_iend.png")
    with open(q, "wb") as f:
        f.write(data[:-4])
    np.testing.assert_array_equal(tio.read_depth_png(q), img)
    junk = str(tmp_path / "junk.png")
    with open(junk, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really a png at all" * 10)
    for native in (False, None):
        with pytest.raises(ValueError):
            tio.read_depth_png(junk, native=native)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a codec that does not build raises with the
    compiler's output, for reads and writes alike."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "host_compiler",
                        lambda: "/bin/false")
    monkeypatch.setattr(tio, "_lib", None)
    p = str(tmp_path / "d.png")
    tio.write_depth_png(p, random_depth(), native=False)
    with pytest.raises(RuntimeError, match="false failed"):
        tio.read_depth_png(p)
    with pytest.raises(RuntimeError):
        tio.write_depth_png(p, random_depth())
    np.testing.assert_array_equal(tio.read_depth_png(p, native=False),
                                  random_depth())


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(40):
        q = rng.normal(size=4)
        R = jtum.quat_to_matrix(*q)
        np.testing.assert_allclose(ttum.quat_to_matrix(*q), R, atol=1e-7)
        np.testing.assert_allclose(ttum.matrix_to_quat(R),
                                   jtum.matrix_to_quat(R), atol=1e-7)
    # the trace <= 0 branches
    for R in (np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
              np.diag([-1.0, -1.0, 1.0])):
        np.testing.assert_allclose(ttum.matrix_to_quat(R),
                                   jtum.matrix_to_quat(R), atol=1e-7)


def test_list_parsing_and_association_match(tmp_path):
    p = str(tmp_path / "depth.txt")
    with open(p, "w") as f:
        f.write("# comment\n2.0 depth/c.png\n0.5 depth/a.png\n"
                "1.0 depth/b.png\n\n1.51 depth/d.png\n")
    assert ttum._parse_list(p) == jtum._parse_list(p)
    a = ttum._parse_list(p)
    b = [(0.005, ["p0"]), (0.49, ["p1"]), (1.5, ["p2"]), (2.001, ["p3"])]
    for dt in (0.02, 0.2):
        assert ttum.associate(a, b, dt) == jtum.associate(a, b, dt)


def _poses(n, seed=0):
    from voxelhashing_demo_tpu_torch.geometry import se3

    rng = np.random.default_rng(seed)
    return [se3.exp(torch.tensor(rng.normal(size=6) * 0.3,
                                 dtype=torch.float32)).numpy()
            for _ in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tum_export_load_across_packages(tmp_path, writer):
    depths = [random_depth(seed=i) for i in range(5)]
    poses = _poses(5)
    root = str(tmp_path / "seq")
    (jtum if writer == "jax" else ttum).export_sequence(root, depths, poses)
    other = str(tmp_path / "other")
    (ttum if writer == "jax" else jtum).export_sequence(other, depths, poses)
    for name in ("depth.txt", "groundtruth.txt"):
        assert (open(os.path.join(root, name)).read()
                == open(os.path.join(other, name)).read())
    for rel in sorted(os.listdir(os.path.join(root, "depth"))):
        assert (open(os.path.join(root, "depth", rel), "rb").read()
                == open(os.path.join(other, "depth", rel), "rb").read())

    js, ts = jtum.TUMSequence(root), ttum.TUMSequence(root)
    assert ts.has_gt and len(ts) == 5
    assert [e[:2] for e in ts.entries] == [e[:2] for e in js.entries]
    for (d, T), (jd, jT), d_ref, T_ref in zip(ts, js, depths, poses):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(d, d_ref)
        np.testing.assert_array_equal(T, jT)
        np.testing.assert_allclose(T, T_ref, atol=1e-5)
    batch, bposes = ts.load_all(64, 48)
    jbatch, _ = js.load_all(64, 48)
    np.testing.assert_array_equal(batch, jbatch)
    np.testing.assert_array_equal(np.stack(bposes),
                                  np.stack([e[2] for e in js.entries]))
    assert len(ttum.TUMSequence(root, max_frames=3)) == 3


def test_sequence_without_groundtruth(tmp_path):
    depths = [random_depth(seed=s) for s in range(3)]
    root = str(tmp_path / "seq")
    ttum.export_sequence(root, depths, [np.eye(4, dtype=np.float32)] * 3)
    os.remove(os.path.join(root, "groundtruth.txt"))
    seq = ttum.TUMSequence(root)
    assert not seq.has_gt
    loaded, gt = seq.load_all(64, 48)
    assert all(p is None for p in gt)
    np.testing.assert_array_equal(loaded, np.stack(depths))


@pytest.mark.parametrize("name,n,shape", [("kinect_png16", 8, (480, 640)),
                                          ("kinect_png16_loop", 72,
                                           (120, 160))])
def test_fixture_frames_decode_equal(name, n, shape):
    root = os.path.join(FIXTURES, name)
    ts, js = ttum.TUMSequence(root), jtum.TUMSequence(root)
    assert len(ts) == n == len(js)
    frames, poses = ts.load_all(shape[1], shape[0])
    jframes, jposes = js.load_all(shape[1], shape[0])
    assert frames.dtype == np.uint16 and frames.shape == (n,) + shape
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(np.stack(poses), np.stack(jposes))
    # one frame through the per-file native read and the Python codec
    path = os.path.join(root, ts.entries[1][1])
    np.testing.assert_array_equal(tio.read_depth_png(path), frames[1])
    np.testing.assert_array_equal(tio.read_depth_png(path, native=False),
                                  frames[1])
