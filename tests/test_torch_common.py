"""tpuslam_torch against tpuslam on the CPU: host I/O, common/ and the fixed arrays.

Inputs are the KITTI fixtures or numpy draws from a fixed seed; both
packages see the same numpy arrays.
"""

import pkgutil
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.common import camera as jcam
from tpuslam.common import geometry as jgeo
from tpuslam.common import hamming as jham
from tpuslam.common.hamming import hamming_matrix as j_hamming
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam_torch.common import camera as tcam
from tpuslam_torch.common import geometry as tgeo
from tpuslam_torch.common import hamming as tham
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
    """Colour at a bit depth PNG forbids is refused, as libpng refuses it; legal colour reads as gray."""
    import struct
    import zlib

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    path = tmp_path / "rgb4.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 4, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(bytes(4 * 9))) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="bit depth 4 for colour type 2"):
        decode_png_gray8(path)
    path = tmp_path / "rgb.png"
    assert cv2.imwrite(str(path), np.full((4, 5, 3), (10, 200, 30), np.uint8))  # B, G, R
    np.testing.assert_array_equal(decode_png_gray8(path), np.full((4, 5), (4899 * 30 + 9617 * 200 + 1868 * 10
                                                                           + 8192) >> 14, np.uint8))


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


@pytest.mark.parametrize("nbytes", [32, 7, 72])
def test_popcount_and_hamming_distance_exact(nbytes):
    """The 256-entry table and the SWAR count on 32-bit words (32 and 72 bytes; 7 takes the table)."""
    rng = np.random.default_rng(nbytes)
    d1 = rng.integers(0, 256, (40, 3, nbytes), dtype=np.uint8)
    d2 = rng.integers(0, 256, (40, 3, nbytes), dtype=np.uint8)
    d2[0] = d1[0]  # distance 0
    d2[1] = ~d1[1]  # every bit
    got = tham.hamming_distance(torch.from_numpy(d1), torch.from_numpy(d2)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jham.hamming_distance(jnp.asarray(d1), jnp.asarray(d2))))
    assert (got[0] == 0).all() and (got[1] == 8 * nbytes).all()
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tham.popcount_bytes(torch.from_numpy(every)).numpy(),
                                  np.asarray(jham.popcount_bytes(jnp.asarray(every))))


def test_so3_log_matches():
    """Generic angles, the small-angle branch and near its switch."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:16] *= 1e-4
    w[16:24] *= 1.4e-3 / np.linalg.norm(w[16:24], axis=1, keepdims=True)
    R = np.array(jgeo.so3_exp(jnp.asarray(w)))
    want = np.asarray(jgeo.so3_log(jnp.asarray(R)))
    got = tgeo.so3_log(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_nullspace_basis_matches():
    """Householder QR nullspace of 5×9 systems: an orthonormal basis equal to the reference's."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(128, 5, 9)).astype(np.float32)
    want = np.asarray(jgeo.nullspace_basis(jnp.asarray(A)))
    got = tgeo.nullspace_basis(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(np.einsum("bmn,bnk->bmk", A, got), 0.0, atol=2e-5)
    np.testing.assert_allclose(np.einsum("bnk,bnl->bkl", got, got), np.tile(np.eye(4), (128, 1, 1)), atol=1e-5)


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


def test_nullvec_minimal_matches():
    """The MGS nullvector of minimal systems (8×9, 4×5, 2×3): float32 rounding, 2e-5 after the sign."""
    rng = np.random.default_rng(11)
    for m, n in ((8, 9), (4, 5), (2, 3)):
        A = rng.normal(size=(64, m, n)).astype(np.float32)
        want = np.asarray(jax.jit(jgeo.nullvec_minimal)(jnp.asarray(A)))
        got = tgeo.nullvec_minimal(torch.from_numpy(A)).numpy()
        got, want = _sign_aligned(got, want)
        np.testing.assert_allclose(got, want, atol=2e-5)
        assert np.abs(np.einsum("bmn,bn->bm", A, got)).max() < 1e-4
    with pytest.raises(ValueError):
        tgeo.nullvec_minimal(torch.zeros(3, 3))


def test_smallest_eigvec_matches_up_to_sign():
    """eigh's sign is free: |v·v_ref| = 1 within 1e-5 on well-separated spectra."""
    rng = np.random.default_rng(12)
    A = rng.normal(size=(32, 12, 9)).astype(np.float32)
    ata = np.einsum("bmi,bmj->bij", A, A)
    want = np.asarray(jgeo.smallest_eigvec(jnp.asarray(ata)))
    got = tgeo.smallest_eigvec(torch.from_numpy(ata)).numpy()
    np.testing.assert_allclose(np.abs(np.einsum("bi,bi->b", got, want)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_points_projection_and_poses_match():
    """dehomogenize (its ±eps guard too), triangulate_points, project, closest_rotation (up to SVD
    signs the rotation itself, 1e-5), compose_se3 and pose_matrix: float32 rounding (rtol 1e-5)."""
    rng = np.random.default_rng(13)
    Xh = rng.normal(size=(50, 4)).astype(np.float32)
    Xh[:3, 3] = [0.0, 1e-14, -1e-14]
    np.testing.assert_allclose(tgeo.dehomogenize(torch.from_numpy(Xh)).numpy(),
                               np.asarray(jax.jit(jgeo.dehomogenize)(jnp.asarray(Xh))), rtol=1e-6)
    X = rng.uniform([-3, -2, 4], [3, 2, 30], size=(100, 3)).astype(np.float32)
    a = 0.05
    R = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    t = np.asarray([0.1, 0.02, -1.0], np.float32)
    K = np.asarray([[700, 0, 600], [0, 700, 180], [0, 0, 1]], np.float32)
    uv, z = tgeo.project(*map(torch.from_numpy, (K, R, t, X)))
    juv, jz = jax.jit(jgeo.project)(*map(jnp.asarray, (K, R, t, X)))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6)
    x1 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:]
    P1 = np.hstack([np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)])
    P2 = np.hstack([R, t[:, None]])
    got = tgeo.triangulate_points(*map(torch.from_numpy, (P1, P2, x1, x2))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jgeo.triangulate_points)(*map(jnp.asarray, (P1, P2, x1, x2)))),
                               rtol=1e-4)
    np.testing.assert_allclose(got, X, rtol=1e-3)
    M = rng.normal(size=(16, 3, 3)).astype(np.float32)
    Rc = tgeo.closest_rotation(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(Rc, np.asarray(jax.jit(jgeo.closest_rotation)(jnp.asarray(M))), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Rc), 1.0, atol=1e-5)
    R2 = np.array(jax.jit(jgeo.so3_exp)(jnp.asarray(rng.normal(size=(16, 3)).astype(np.float32))))
    t1, t2 = rng.normal(size=(2, 16, 3)).astype(np.float32)
    Rs = np.broadcast_to(R, (16, 3, 3)).copy()
    got = tgeo.compose_se3(*map(torch.from_numpy, (Rs, t1, R2, t2)))
    want = jax.jit(jgeo.compose_se3)(*map(jnp.asarray, (Rs, t1, R2, t2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tgeo.pose_matrix(torch.from_numpy(R2), torch.from_numpy(t2)).numpy(),
                                  np.asarray(jgeo.pose_matrix(jnp.asarray(R2), jnp.asarray(t2))))


def test_exact_path_arrays_carry_no_bin_weights(data_dir):
    """At BriefQuantizedBins 0 the reference's detector holds no bin weights; its arrays convert and build the port's."""
    import dataclasses

    from tpuslam.config.schema import DetectorConfig as JDetectorConfig
    from tpuslam.frontend.detector import FeatureDetector as JDetector
    from tpuslam_torch.config.schema import DetectorConfig as TDetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector as TDetector
    from tpuslam_torch.frontend.detector import detector_arrays_numpy
    from tpuslam_torch.utils.convert import detector_arrays_from_numpy

    path = data_dir.parent.parent / "configs" / "feature_detector.yml"
    jd = JDetector(dataclasses.replace(JDetectorConfig.from_yaml(path), brief_quantized_bins=0))
    tcfg = dataclasses.replace(TDetectorConfig.from_yaml(path), brief_quantized_bins=0)
    assert jd.bin_weights is None and "bin_weights_3d" not in detector_arrays_numpy(tcfg)
    det_np = {f: np.asarray(getattr(jd.pattern, f)) for f in jd.pattern._fields}
    det_np.update(blur_kernel=np.asarray(jd.blur_kernel), bin_weights_3d=jd.bin_weights_3d,
                  moment_weights=np.asarray(jd.moment_weights))
    conv = detector_arrays_from_numpy(det_np)
    assert set(conv) == set(detector_arrays_from_numpy(detector_arrays_numpy(tcfg)))
    td = TDetector(tcfg, device="cpu", arrays=conv)
    assert td.bin_weights is None and td.bin_weights_3d is None
    with pytest.raises(KeyError, match="moment_weights"):
        TDetector(tcfg, device="cpu",
                  arrays=detector_arrays_from_numpy({k: v for k, v in det_np.items() if k != "moment_weights"}))
    with pytest.raises(KeyError, match=r"BriefQuantizedBins 16: \['bin_weights_3d'\]"):
        TDetector(dataclasses.replace(tcfg, brief_quantized_bins=16), device="cpu", arrays=conv)
