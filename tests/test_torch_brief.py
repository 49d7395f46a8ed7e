"""tpuslam_torch's BRIEF path against tpuslam on the CPU.

Kernel 2's and kernel 3's plain twins against the reference's Pallas
kernels in interpret mode, and the full quantised descriptors against the
reference's CPU path, all bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.frontend import brief as jb
from tpuslam.frontend.fast import KeypointSet as JKeypointSet
from tpuslam.kernels.brief_pallas import brief_own_bin_dots as j_own_bin_dots
from tpuslam.kernels.brief_pallas import extract_brief_patches_tpu
from tpuslam_torch.frontend import brief as tb
from tpuslam_torch.frontend.fast import KeypointSet as TKeypointSet
from tpuslam_torch.kernels.brief import (
    brief_own_bin_dots,
    brief_own_bin_dots_reference,
    extract_brief_patches,
    extract_patches_work,
    pack_bin_weights,
)

PATCH, BINS, PAIRS = 31, 16, 256


@pytest.fixture(scope="module")
def setup(kitti_frames):
    rng = np.random.default_rng(3)
    crop = np.stack([kitti_frames[0][60:188, 300:556], kitti_frames[1][60:188, 300:556]])
    B, H, W = crop.shape
    K = 48
    xy = np.stack([rng.integers(0, W, (B, K)), rng.integers(0, H, (B, K))], axis=-1)
    xy = xy.astype(np.float32) + rng.uniform(0, 0.99, (B, K, 2)).astype(np.float32)
    valid = rng.random((B, K)) > 0.2
    blur = np.stack(
        [np.asarray(jb.gaussian_blur_u8(jnp.asarray(im), jnp.asarray(jb.gaussian_kernel()))) for im in crop]
    )
    pattern_np = tb.generate_brief_pattern_numpy(PAIRS, PATCH)
    W2, _ = tb.build_brief_bin_weights(pattern_np, PATCH, BINS)
    W3 = np.ascontiguousarray(W2.reshape(W2.shape[0], BINS, PAIRS).transpose(1, 0, 2))
    return dict(crop=crop, blur=blur, xy=xy, valid=valid, W2=W2, W3=W3, rng=rng)


def _sequential_blur(image, k, fma):
    """numpy oracle: the 25 taps added in row-major order, rounding each step to float32."""
    h, w = image.shape
    pad = np.pad(image.astype(np.float64), 2)
    acc = np.zeros((h, w), np.float32)
    for dy in range(5):
        for dx in range(5):
            x = pad[dy : dy + h, dx : dx + w]
            if fma:  # one rounding per tap: fl(acc + k·x)
                acc = (acc.astype(np.float64) + np.float64(k[dy, dx]) * x).astype(np.float32)
            else:  # fl(acc + fl(k·x))
                acc = acc + (k[dy, dx] * x.astype(np.float32)).astype(np.float32)
    out = np.floor(acc + np.float32(0.5)).astype(np.uint8)
    out[:2], out[-2:], out[:, :2], out[:, -2:] = image[:2], image[-2:], image[:, :2], image[:, -2:]
    return out


def test_blur_twin_matches_reference(kitti_frames):
    """The twin rounds every product and sum (the Pallas kernel's order, and kernel 1's).

    The reference's XLA CPU blur is contracted into FMAs by the compiler, so
    it differs from the Pallas kernel where a sum lands within an ulp of .5:
    both are checked against a numpy oracle of their own rounding.
    """
    frame = kitti_frames[0]
    k = tb.gaussian_kernel().astype(np.float32)
    got = tb.gaussian_blur_u8(torch.from_numpy(frame)[None], torch.from_numpy(k))[0].numpy()
    np.testing.assert_array_equal(got, _sequential_blur(frame, k, fma=False))
    xla = np.asarray(jb.gaussian_blur_u8(jnp.asarray(frame), jnp.asarray(jb.gaussian_kernel())))
    np.testing.assert_array_equal(xla, _sequential_blur(frame, k, fma=True))
    assert np.count_nonzero(got != xla) < 10


def test_kernel2_twin_bit_exact_with_pallas(setup):
    want = np.asarray(
        extract_brief_patches_tpu(
            jnp.asarray(setup["blur"]), jnp.asarray(setup["xy"]), PATCH, interpret=True
        )
    )
    got = extract_brief_patches(
        torch.from_numpy(setup["blur"]), torch.from_numpy(setup["xy"]), PATCH
    ).numpy()
    assert got.shape == (2, 48, tb.padded_patch_len(PATCH)) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("patch_size", [25, 15])  # sides 40 and 24 (8 mod 16), S2p 1664 and 640
def test_kernel2_twin_bit_exact_on_and_beyond_borders(setup, patch_size):
    """A second patch size, keypoints on each border and corner and up to 5 px outside."""
    blur = setup["blur"]
    B, H, W = blur.shape
    rng = np.random.default_rng(patch_size)
    on = [(0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1), (W / 2, 0), (W / 2, H - 1), (0, H / 2),
          (W - 1, H / 2), (-0.5, -0.5), (-4.0, 3.0), (W + 4.5, H + 4.5), (W - 0.25, -3.0)]
    outside = np.stack([rng.uniform(-5, W + 5, (B, 36)), rng.uniform(-5, H + 5, (B, 36))], -1)
    xy = np.concatenate([np.broadcast_to(np.asarray(on), (B, len(on), 2)), outside], 1).astype(np.float32)
    want = np.asarray(extract_brief_patches_tpu(jnp.asarray(blur), jnp.asarray(xy), patch_size, interpret=True))
    got = extract_brief_patches(torch.from_numpy(blur), torch.from_numpy(xy), patch_size).numpy()
    side, s2p = tb.patch_side(patch_size), tb.padded_patch_len(patch_size)
    assert side % 16 == 8 and got.shape == (B, 48, s2p) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert not got[..., side * side :].any()  # the zero tail past side²
    assert (got[:, 0, :side] == -128).sum() >= B * tb.rotation_patch_half(patch_size)  # outside → 0 − 128


def test_kernel2_bound_at_main_path_shapes():
    """The yardstick a redesign is held to: frames and keypoints in, patches out, no operations."""
    work = extract_patches_work(16, 512, 1392, 1024, PATCH)
    assert work.bytes == 16 * 512 * 1392 + 16 * 1024 * 8 + 16 * 1024 * 2304 and work.ops == 0
    assert work.bound_by() == "bytes"
    assert round(work.bound_us(), 2) == 14.71


def test_kernel3_twin_bit_exact_with_pallas(setup):
    patches = np.array(
        jax.vmap(lambda bl, xy: jb.extract_brief_patches_i8(
            bl, JKeypointSet(xy, xy[:, 0], xy[:, 0], xy[:, 0] > -1), PATCH
        ))(jnp.asarray(setup["blur"]), jnp.asarray(setup["xy"]))
    )
    bins = setup["rng"].integers(0, BINS, patches.shape[:2]).astype(np.int32)
    want = np.asarray(
        j_own_bin_dots(jnp.asarray(patches), jnp.asarray(bins), jnp.asarray(setup["W3"]), interpret=True)
    )
    got = brief_own_bin_dots(
        torch.from_numpy(patches), torch.from_numpy(bins), pack_bin_weights(torch.from_numpy(setup["W3"]))
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel3_out_of_range_bin_gives_zero(setup):
    patches = torch.from_numpy(setup["rng"].integers(-128, 128, (1, 3, 2304), dtype=np.int8))
    bins = torch.tensor([[-1, 3, BINS]])
    out = brief_own_bin_dots_reference(patches, bins, torch.from_numpy(setup["W3"]))
    assert torch.all(out[0, 0] == 0) and torch.all(out[0, 2] == 0)
    assert torch.any(out[0, 1] != 0)


def test_packed_weights_layout(setup):
    """Kernel 3's (bins, P, S2p) layout: byte s of pair p's row of bin b is W[b, s, p]."""
    W3 = setup["W3"]
    packed = pack_bin_weights(torch.from_numpy(W3))
    t = packed.t
    assert t.shape == (BINS, PAIRS, W3.shape[1]) and t.dtype == torch.int8 and t.is_contiguous()
    flat = t.numpy().reshape(-1)  # the bytes as the kernel reads them
    s2p = W3.shape[1]
    rng = np.random.default_rng(7)
    for b, p, s in zip(rng.integers(0, BINS, 64), rng.integers(0, PAIRS, 64), rng.integers(0, s2p, 64)):
        assert flat[(b * PAIRS + p) * s2p + s] == W3[b, s, p]
    # the 4 bytes an mma fragment register holds: k = 4t .. 4t+3 of one pair, k ascending
    word = t[3, 5, 8:12].contiguous().view(torch.int32).item()
    assert [np.int8((word >> (8 * j)) & 0xFF) for j in range(4)] == [W3[3, s, 5] for s in range(8, 12)]
    np.testing.assert_array_equal(packed.as_3d().numpy(), W3)


def test_detector_packs_weights_once_and_wrapper_checks_layout(data_dir):
    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector

    cfg = DetectorConfig.from_yaml(data_dir.parent.parent / "configs" / "feature_detector.yml")
    det = FeatureDetector(cfg, device="cpu")
    want = det.bin_weights_3d.permute(0, 2, 1)
    assert det.bin_weights.t.is_contiguous() and torch.equal(det.bin_weights.t, want)
    assert det.bin_weights_3d.data_ptr() == det.bin_weights.t.data_ptr()  # a view, not a copy
    patches = torch.zeros((1, 2, det.bin_weights.t.shape[-1]), dtype=torch.int8)
    bins = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="PackedBinWeights"):
        brief_own_bin_dots(patches, bins, det.bin_weights_3d)
    with pytest.raises(ValueError, match="contiguous"):
        brief_own_bin_dots(patches, bins, det.bin_weights._replace(t=det.bin_weights_3d))


def test_descriptors_bit_exact_with_reference_cpu_path(setup):
    """Port: patches → moments → bins → own-bin dots → bits; reference: its CPU quantised path."""
    blur, xy, valid = setup["blur"], setup["xy"], setup["valid"]
    B, K = valid.shape
    jpat = jb.generate_brief_pattern(PAIRS, PATCH)
    jk = JKeypointSet(jnp.asarray(xy), jnp.ones((B, K)), jnp.zeros((B, K)), jnp.asarray(valid))
    j_angles = jax.vmap(lambda bl, k: jb.compute_orientations(bl, k, PATCH))(jnp.asarray(blur), jk)
    j_desc = jax.vmap(
        lambda bl, k, a: jb.compute_brief_descriptors_quantized(
            bl, k, a, jpat, jnp.asarray(setup["W2"]), PAIRS, PATCH, BINS
        )
    )(jnp.asarray(blur), jk, j_angles)

    tpat = tb.generate_brief_pattern(PAIRS, PATCH)
    tk = TKeypointSet(
        torch.from_numpy(xy), torch.ones((B, K)), torch.zeros((B, K)), torch.from_numpy(valid)
    )
    tblur = torch.from_numpy(blur)
    patches = extract_brief_patches(tblur, tk.xy, PATCH)
    mom = torch.from_numpy(tb.disc_moment_weights(PATCH))
    t_angles = tb.orientations_from_patches(patches, mom, tk, PATCH, blur.shape[-2:])
    np.testing.assert_allclose(t_angles.numpy(), np.asarray(j_angles), atol=1e-4)
    bin_idx = tb.quantize_angles(t_angles, BINS)
    np.testing.assert_array_equal(
        bin_idx.numpy(), np.asarray(jb.quantize_angles(j_angles, BINS))
    )
    own = brief_own_bin_dots(patches, bin_idx, pack_bin_weights(torch.from_numpy(setup["W3"])))
    rotated = tb.bin_rotated_offsets(tpat.p1, tpat.p2, BINS)
    t_desc = tb.brief_bits_from_dots(own, bin_idx, tk, tpat, rotated, PAIRS, PATCH, blur.shape[-2:])
    np.testing.assert_array_equal(t_desc.numpy(), np.asarray(j_desc))
    # and the plain one-hot path gives the same bytes
    plain = tb.compute_brief_descriptors_quantized(
        tblur, tk, t_angles, tpat, torch.from_numpy(setup["W3"]), rotated, PAIRS, PATCH
    )
    assert torch.equal(plain, t_desc)
    assert int((t_desc != 0).any(dim=-1).sum()) > 10


def test_quantize_angles_matches_on_bin_edges():
    edges = np.arange(-720.0, 720.0, 22.5 / 2, dtype=np.float32)
    a = np.concatenate([edges, np.nextafter(edges, np.inf), np.nextafter(edges, -np.inf)])
    got = tb.quantize_angles(torch.from_numpy(a), BINS).numpy()
    np.testing.assert_array_equal(got, np.asarray(jb.quantize_angles(jnp.asarray(a), BINS)))
