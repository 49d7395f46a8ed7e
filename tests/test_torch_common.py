"""tpuslam_torch against tpuslam on the CPU: host I/O, common/ and the fixed arrays.

Inputs are the KITTI fixtures or numpy draws from a fixed seed; both
packages see the same numpy arrays.
"""

import pkgutil
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.common import camera as jcam
from tpuslam.common import geometry as jgeo
from tpuslam.common.hamming import hamming_matrix as j_hamming
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam_torch.common import camera as tcam
from tpuslam_torch.common import geometry as tgeo
from tpuslam_torch.common.hamming import hamming_matrix as t_hamming
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.pre.stream import FrameStream, decode_png_gray8


def test_png_decoder_matches_cv2(data_dir):
    files = sorted((data_dir / "images").glob("*.png"))
    assert len(files) == 10
    for f in files:
        want = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(decode_png_gray8(f), want)


@pytest.mark.parametrize("ftype", [0, 2, 3, 4])
def test_png_decoder_row_filters(tmp_path, ftype):
    """Every PNG row filter, on an image whose rows use only that filter."""
    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    path = tmp_path / "f.png"
    import struct
    import zlib

    # Re-encode the IDAT with the chosen filter on every row.
    raw = bytearray()
    prev = np.zeros(13, np.int32)
    for row in img.astype(np.int32):
        out = []
        for x in range(13):
            a = row[x - 1] if x else 0
            b = prev[x]
            c = prev[x - 1] if x else 0
            if ftype == 0:
                pred = 0
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out.append((row[x] - pred) & 0xFF)
        raw += bytes([ftype, *out])
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", 13, 9, 8, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(bytes(raw)))
        + chunk(b"IEND", b"")
    )
    path.write_bytes(png)
    np.testing.assert_array_equal(decode_png_gray8(path), img)


def test_png_decoder_rejects_colour(tmp_path):
    path = tmp_path / "rgb.png"
    assert cv2.imwrite(str(path), np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(ValueError, match="grayscale"):
        decode_png_gray8(path)


def test_frame_stream_batches(data_dir):
    st = FrameStream(data_dir / "images")
    chunks = list(st.batches(4))
    assert [c[0].shape for c in chunks] == [(4, 512, 1392)] * 3
    assert [int(c[2].sum()) for c in chunks] == [4, 4, 2]
    np.testing.assert_array_equal(chunks[2][0][3], chunks[2][0][1])  # padding repeats


def test_configs_load_unchanged(data_dir):
    t = TSlamConfig.from_yaml_dir(data_dir.parent.parent / "configs")
    j = JSlamConfig.from_yaml_dir(data_dir.parent.parent / "configs")
    for part in ("detector", "matcher", "pose", "map", "loop_closure"):
        assert vars(getattr(t, part)) == vars(getattr(j, part))


def test_undistort_map_and_gather_bit_exact(kitti_frames, data_dir):
    cfg = data_dir.parent.parent / "configs" / "camera.yml"
    jc = jcam.Camera.from_yaml(cfg)
    tc = tcam.Camera.from_yaml(cfg)
    for a, b in zip(jc.undistort_map(), tc.undistort_map()):
        np.testing.assert_array_equal(a, b)
    j_idx, j_valid = jc.device_undistort_map()
    t_idx, t_valid = tc.device_undistort_map()
    np.testing.assert_array_equal(np.asarray(j_idx), t_idx.numpy())
    np.testing.assert_array_equal(np.asarray(j_valid), t_valid.numpy())
    frames = np.stack(kitti_frames[:2])
    want = np.asarray(jcam.undistort_batch(jnp.asarray(frames), j_idx, j_valid))
    got = tcam.undistort_batch(torch.from_numpy(frames), t_idx, t_valid)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    d1 = rng.integers(0, 256, (3, 70, 32), dtype=np.uint8)
    d2 = rng.integers(0, 256, (3, 90, 32), dtype=np.uint8)
    got = t_hamming(torch.from_numpy(d1), torch.from_numpy(d2)).numpy()
    for i in range(3):
        want = np.asarray(j_hamming(jnp.asarray(d1[i]), jnp.asarray(d2[i])))
        np.testing.assert_array_equal(got[i], want)


def _sign_aligned(a, b):
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    return a, b * np.where(s == 0, 1, s)


def test_round_robin_schedule_matches():
    for n in (4, 9):
        assert tgeo._round_robin_schedule(n) == jgeo._round_robin_schedule(n)


@pytest.mark.parametrize("shape,sweeps", [((256, 8, 9), 3), ((64, 40, 9), 5), ((128, 4, 4), 8)])
def test_nullvec_jacobi_matches(shape, sweeps):
    rng = np.random.default_rng(sum(shape))
    A = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jgeo.nullvec_jacobi(jnp.asarray(A), sweeps=sweeps))
    got = tgeo.nullvec_jacobi(torch.from_numpy(A), sweeps=sweeps).numpy()
    got, want = _sign_aligned(got, want)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_triangulation_matches():
    rng = np.random.default_rng(5)
    X = rng.uniform([-3, -2, 4], [3, 2, 30], size=(200, 3)).astype(np.float32)
    R = np.asarray(
        [[np.cos(0.05), 0, np.sin(0.05)], [0, 1, 0], [-np.sin(0.05), 0, np.cos(0.05)]], np.float32
    )
    t = np.asarray([0.1, 0.02, -1.0], np.float32)
    x1 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:]
    x2 = x2 + rng.normal(scale=1e-3, size=x2.shape).astype(np.float32)
    P1 = np.hstack([np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)])
    P2 = np.hstack([R, t[:, None]])
    want = np.asarray(jgeo.triangulate_homogeneous(*map(jnp.asarray, (P1, P2, x1, x2))))
    got = tgeo.triangulate_homogeneous(*map(torch.from_numpy, (P1, P2, x1, x2))).numpy()
    got, want = _sign_aligned(got, want)
    np.testing.assert_allclose(got, want, atol=1e-5)
    Rn = R + rng.normal(scale=1e-2, size=(3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.orthonormalize_rotation(torch.from_numpy(Rn)).numpy(),
        np.asarray(jgeo.orthonormalize_rotation(jnp.asarray(Rn))),
        atol=1e-6,
    )


def test_converted_arrays_match_port_generated(data_dir):
    """JAX FeatureDetector/SlamPipeline arrays, converted, equal the port's own."""
    from tpuslam.model.slam import SlamPipeline as JPipeline
    from tpuslam_torch.frontend.brief import bin_rotated_offsets
    from tpuslam_torch.frontend.detector import FeatureDetector as TDetector
    from tpuslam_torch.frontend.detector import detector_arrays_numpy
    from tpuslam_torch.model.slam import SlamPipeline as TPipeline
    from tpuslam_torch.utils.convert import detector_arrays_from_numpy, pipeline_arrays_from_numpy

    cfg_dir = data_dir.parent.parent / "configs"
    jcfg = JSlamConfig.from_yaml_dir(cfg_dir, batch_size=4)
    tcfg = TSlamConfig.from_yaml_dir(cfg_dir, batch_size=4)
    jp = JPipeline(jcam.Camera.from_yaml(cfg_dir / "camera.yml"), jcfg)
    tp = TPipeline(tcam.Camera.from_yaml(cfg_dir / "camera.yml"), tcfg, device="cpu")
    jd = jp.detector
    det_np = {f: np.asarray(getattr(jd.pattern, f)) for f in jd.pattern._fields}
    det_np.update(
        blur_kernel=np.asarray(jd.blur_kernel),
        bin_weights_3d=np.asarray(jd.bin_weights_3d),
        moment_weights=np.asarray(jd.moment_weights),
    )
    pipe_np = {
        **det_np,
        "K": np.asarray(jp._K),
        "undistort_idx": np.asarray(jp._undistort_idx),
        "undistort_valid": np.asarray(jp._undistort_valid),
    }
    conv = pipeline_arrays_from_numpy(pipe_np)
    own = detector_arrays_from_numpy(detector_arrays_numpy(tcfg.detector))
    assert set(detector_arrays_from_numpy(det_np)) == set(own)
    for k, v in own.items():
        assert conv[k].dtype == v.dtype, k
        assert torch.equal(conv[k], v), k
    td = tp.detector
    for f in td.pattern._fields:
        assert torch.equal(conv[f], getattr(td.pattern, f)), f
    assert torch.equal(conv["bin_weights_3d"], td.bin_weights_3d)
    assert torch.equal(conv["K"], tp.K)
    assert torch.equal(conv["undistort_idx"], tp.undistort_idx)
    assert torch.equal(conv["undistort_valid"], tp.undistort_valid)
    assert torch.equal(TDetector(tcfg.detector, device="cpu", arrays=conv).bin_weights_3d, td.bin_weights_3d)

    # The per-bin rotated pattern offsets: the port's host table equals what
    # the reference computes per keypoint on device (jnp.cos/sin of the bin angle).
    bins = tcfg.detector.brief_quantized_bins
    a = jnp.arange(bins, dtype=jnp.float32) * (2.0 * jnp.pi / bins)
    cos_t, sin_t = jnp.cos(a)[:, None], jnp.sin(a)[:, None]
    cols = []
    for p in (jd.pattern.p1.astype(jnp.float32), jd.pattern.p2.astype(jnp.float32)):
        cols += [
            (p[None, :, 0] * cos_t - p[None, :, 1] * sin_t).astype(jnp.int32),
            (p[None, :, 0] * sin_t + p[None, :, 1] * cos_t).astype(jnp.int32),
        ]
    want = np.stack([np.asarray(c) for c in cols], axis=-1)
    got = bin_rotated_offsets(td.pattern.p1, td.pattern.p2, bins).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_never_imports_jax():
    """Importing every tpuslam_torch module leaves jax (and tpuslam) unloaded."""
    code = (
        "import importlib, pkgutil, sys, tpuslam_torch\n"
        "for m in pkgutil.walk_packages(tpuslam_torch.__path__, 'tpuslam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'tpuslam'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    # and the walk really covered the package
    import tpuslam_torch

    names = [m.name for m in pkgutil.walk_packages(tpuslam_torch.__path__, "tpuslam_torch.")]
    assert "tpuslam_torch.model.slam" in names and "tpuslam_torch.kernels.pose" in names
