#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each fatal on failure (no CPU fallback, no caught phase):

1. device — require CUDA; print the card's name and power limit;
2. build — compile ``tpuslam_torch/csrc/*.cu`` for sm_90a from this checkout;
3. kernels — each of the five kernels against its plain PyTorch twin on the
   card, on inputs made from the KITTI fixtures: kernels 1-4 at the main
   path's shapes (1-3 exact, 4 to rtol 1e-5), kernel 5 exact at the
   pyramid's four level shapes; kernels 2, 4 and 5 also at ragged shapes
   (keypoints beyond every border and a second patch size; H, M off the
   tiles with invalid matches; images below and just over kernel 5's tile,
   rows and a buffer that start at any byte, windows 1 to 14, dense, tied
   and empty images), and kernel 4 twice for identical bits;
   median device times of both (CUDA events, the card held back while the
   host queues the call), each kernel's bound (``*_work`` beside its
   wrapper, ``tpuslam_torch/kernels/bounds.py``) and, as yardsticks the
   port never calls, cuBLAS's int8 product over all bins for kernel 3 and
   its float32 ``torch.bmm(E, P)`` for kernel 4; kernel 6 (the Jacobi
   nullvector) at the benchmark cells' five shapes, the main path's four
   and the wide form's (PnP at 2,000 points) on Gaussian rows: its
   twin's bits, the same bits twice, its device
   time, its twin's and ``torch.linalg.svd``'s (a yardstick the port never
   calls), and its bound;
4. frontend — ``FeatureDetector`` on 2 frames on the card and on the CPU,
   with ``configs/`` and with ``configs/multiscale`` (fused NMS): keypoints
   and descriptors identical;
5. main path — VO with ``configs/`` at batch 16 over 96 frames (the fixtures
   ping-pong tiled, as ``bench.py`` does), one warm-up pass, then a timed
   pass with the kernels' launch counters zeroed just before it: kernels
   1-4 launched (6 each), kernel 5 not, kernel 6 36 times (6 a chunk: the
   hypotheses, three LO refits, cheirality, triangulation; the same on the
   pyramid path, and at least that in ``[pnp]``); ``pose_ok`` on >= 90% of frames
   1..95, and the inter-frame motion dominantly along +-z;
6. pyramid path — the same with ``configs/multiscale`` (4 levels, full
   width) and ``nms_fused=True``: exactly 24 launches of kernel 5 (4 levels
   x 6 chunks) and none of kernel 1 in the timed pass, then the same path
   with ``nms_fused=False`` (24 of kernel 1, none of kernel 5), timed in
   turns (fused, kernel 1, kernel 1, fused) for frames/s of each; the
   kernels' device time a chunk is set against the timed chunk of either
   path (``[main] kernels``, ``[pyramid] kernels``);
7. the last modules, each fatal, together under 60 s:
   fast — VO with ``configs/fast`` (512 hypotheses) over the same 96 frames
   at batch 16, a warm-up pass, then timed passes in turns with the main
   path (main, fast, fast, main): kernels 1-4 six launches each, kernel 5
   none, the main path's gates; kernel 4 at (16, 512, 1024) against its
   twin at rtol 1e-5 with its device ms and bound;
   exact-brief — ``FeatureDetector`` with ``BriefQuantizedBins`` 0 on 2
   full-width frames, card against CPU: keypoints and descriptors identical,
   angles within 1e-4 deg; kernel 1 launched once, kernels 2-3 never; ms a
   frame of the exact orientation + BRIEF beside the quantised stage on the
   main path's 16 frames;
   single — on fixture frames 0 and 1: ``undistort_image``, ``detect``,
   ``compute`` and ``detect_and_compute`` on the card equal to the CPU and to
   row 0 of the batch call, ``FeatureMatcher.match`` equal to
   ``match_descriptors``, ``PoseEstimator.estimate`` with recorded draws card
   against CPU (integer fields identical, R 1e-4, t 1e-3); launches 4, 3, 3
   and 1 of kernels 1-4; kernels 1-4 at these B = 1 shapes against their
   twins, with device ms and bounds;
   vocab-fit — ``Vocabulary.fit`` on the card against the CPU on the 10
   fixture frames' descriptors, flat (256 words) and a (16, 16) tree:
   centroids identical, IDF within 1e-6, seconds of each;
   profiling — ``StageTimer`` and ``time_fn`` around one main-path chunk,
   and ``device_trace`` of one chunk: the span recorder must hold the
   chunk's ``vo.step`` tree with its host syncs counted, and its Chrome
   trace must hold the ``vo.*`` ranges and name kernels of the main path
   among its CUDA kernel events;
8. pnp — PnP tracking (``tracking="pnp"``) with ``configs/`` over the same
   96 frames at batch 16, a warm-up pass and a timed pass: kernels 1-4 six
   launches each, kernel 5 none; the trajectory gates of the VO paths; at
   least 30% of the valid points the keyframe window observes seen in >= 2
   keyframes; frames/s,
   the shares of absolute PnP and of the RANSAC fallback, the map's
   ``point_count``; then one chunk in parts (two-view stage, tracker) with
   the tracker run on the card and on the CPU on the same inputs and
   sample indices (integer fields identical, rotations within 1e-4,
   positions within 1e-3), the tracker's share of
   the chunk, device kernels a chunk (``torch.profiler``), and the time a
   call of ``ransac_pnp`` and ``project_associate``, the two branches the
   tracker takes only where a frame needs them;
9. slam, slam-pnp — ``SlamSystem(vocabulary=None).run_sequence`` (loop closure
   off) at the reference's defaults (window 8, 4096 points, BA every 4
   keyframes, 4 LM steps over 512 active points) over the same 96 frames, in
   VO mode and in PnP mode, a warm-up pass and a timed pass: kernels 1-4
   six launches each, kernel 5 none; ``pose_ok`` on >= 90% of frames 1..95;
   BA on every chunk from the first that was due, each run with final cost
   <= initial x 1.001; >= 50% of the points the final window observes seen
   in >= 2 keyframes; TF32 off.  Then one chunk in parts: the batched map
   fold against the per-frame scan on the card on that chunk's inputs
   (integer fields identical, floats bit for bit; VO), and ``bundle_adjust``
   on the card against the CPU on the same map (float32: initial cost rtol
   1e-5, final 1e-2, poses 1e-3; float64: 1e-8); frames/s and ms a chunk
   against the main path's, BA ms a call and the fold's ms a chunk
   (synchronised on either side), device kernels a chunk
   (``torch.profiler``) and the BA cost ratios;
10. slam-lc, slam-lc-pnp — full SLAM with loop closure:
   ``SlamSystem(vocabulary="configs/vocabulary_tree.npz").run_sequence`` at
   the reference's defaults (``configs/loop_closure.yml``: VerifyBudget 4,
   512 keyframes, redundancy eviction; relocalization budget 2; the pose
   graph) over the same 96 frames, which revisit every place, in VO and in
   PnP mode, a warm-up pass and a timed pass: kernels 1-4 six launches
   each, kernel 5 none; ``pose_ok`` on >= 90% of frames 1..95; at least one
   verified loop and the pose graph applied.  Then on the card against the
   CPU, given the same draws: ``LoopClosure.process_chunk`` on a full-width
   chunk with loop candidates (integer fields identical, BoW 1e-6, R 1e-4,
   t 1e-3), and relocalization on a chunk with two noise-blinded frames
   (``_reloc_chunk`` / ``_reloc_chunk_pnp``: flags identical, poses 1e-4 /
   1e-3), with the host syncs each makes counted; the loop-closure stage's
   ms and device kernels a chunk, relocalization's ms, and the pose graph's
   ms on the run's keyframes; once, kernel 4 at relocalization's shape (2
   frames x 1024 five-point samples x 10 candidates, 1024 matches; masked
   candidates hold NaN) against its twin at rtol 1e-5 on the unmasked rows,
   and the pose graph's PCG on a 300-node drift graph, card against CPU;
   and the largest batched RANSAC-PnP call of the warm-up pass (its V
   candidates, one ``_ransac`` call) against V unbatched ``ransac_pnp``
   calls on the same candidates in this call: success and inliers
   identical, T within 1e-4 (R) / 1e-3 (t); host ms and device kernels of
   each;
11. stream, stream-pnp — the streaming driver ``SlamSystem.run`` with the
   tree vocabulary over host numpy chunks shaped as ``FrameStream.batches``
   yields them, staged on the card by ``device_prefetch``, in VO and in PnP
   mode, a warm-up pass and a timed pass: the ``[slam-lc]`` gates (kernels
   1-4 six launches each, kernel 5 none; ``pose_ok`` >= 90%; >= 1 verified
   loop, the pose graph applied); frames/s beside ``run_sequence``'s in
   this call; the run split after frame 48 through a checkpoint file
   (``save_state``, ``load_state`` onto the card, ``run(resume=...)``):
   integer fields, loops, keyframes, counters and the map's and DB's ids
   identical, the raw trajectory bit-equal, the final (pose-graph) poses
   bit-equal or, with the op that differs named, within R 1e-4 / t 1e-3;
   the host-to-device time a chunk with and without prefetch;
12. localize — ``SlamSystem(tracking="pnp", localization_only=True)``
   through ``run(warm_start=...)`` against the map and DB of the
   ``[stream-pnp]`` run, read back from its file, over the 96 frames,
   over frames 40..95 (an unknown start: frame 0 bootstraps by
   relocalization) and over 192 frames: every map and DB leaf bit-equal
   after each run, no BA event, finite poses, ``pose_ok`` >= 90%, lock-in
   within one chunk from frame 40 by relocalization and within 0.6 of the
   mapping run's pose there (positions against the mapping run's over the
   whole runs are printed, not held: ``PERF.md`` §6), kernel 4 at
   relocalization's shape on the bootstrap chunk, that chunk's ``_reloc_chunk_pnp`` card
   against CPU given the same draws (flags identical, R 1e-4, t 1e-3);
   frames/s from scratch, the marginal rate (192 - 96) / (t192 - t96) and
   ``max_memory_allocated`` over 96 and 192 frames; the memory a run's
   result keeps on the card may grow by at most 4 MiB from 96 to 192.
13. timeshard — ``run_timesharded`` (VO, ``configs/``) over 192 frames cut
   into 4 time shards at batch 16 (S 48, V 16: four chunks a shard), the
   four shards as one batched sequence of 64 frames a chunk on the card:
   kernels 1-4 exactly 4 launches each (one a batched chunk), kernel 5
   none; each shard against its window run alone in turn through
   ``process_sequence`` with seed + d on the card (``pose_ok``,
   ``num_matches``, ``num_inliers`` identical, poses within 1e-4 (R) /
   1e-3 (t)); core ``pose_ok`` >= 90% of frames 1..191; the stitched
   trajectory's Sim(3)-aligned ATE against ``process_sequence`` over the
   same 192 frames < 5% of its path length; frames/s of the batched run,
   of the windows in turn and of the single run (before and after), device
   kernels of the batched pass and of one window alone,
   ``max_memory_allocated``, the stitch's host ms;
   kernels 1-4 against their twins on one batched chunk (64 frames);
   multiseq-vo — four VO sequences (the 96 tiled frames from offsets 0, 5,
   10, 15, seeds 0-3) through ``shard_batched_pipeline`` as one batched
   step a chunk against each sequence's ``process_chunk`` calls in turn:
   kernels 1-4 six launches each, kernel 5 none; the same hold; frames/s of
   both, device kernels a batched step and a chunk, ``max_memory_allocated``;
14. timeshard-slam, timeshard-slam-pnp — ``run_timesharded_system`` with
   the tree vocabulary at the reference's defaults over the same 192 frames
   and 4 shards, in VO and in PnP mode: kernels 1-4 at least 16 launches
   each, kernel 5 none; finite poses, core ``pose_ok`` >= 90%; BA events,
   none raising its cost by > 0.1%; at least one cross-segment loop whose
   query lies in a later shard's core and whose match in an earlier one's,
   with >= MinInliersForPnP inliers; the global pose graph applied; ATE
   against ``run_sequence`` over the same frames < 5% of its path; the
   cross-segment pass on the card against the CPU from the same per-shard
   DBs and draws (candidates, ``ok`` and inliers identical, R 1e-4, t
   1e-3); frames/s against ``run_sequence``'s (before and after), the loop
   candidates each verifies, the shards', their folds', the stitch's, the
   cross pass's and the global pose graph's host time and the graph's N;
   the verification A/B of ``[slam-lc]`` on the run's largest batched
   RANSAC-PnP call;
15. multiseq — ``shard_sequence_program`` with one PnP SLAM sequence (tree
   vocabulary) per card over the 96 frames (one sequence on one card):
   kernels 1-3 six launches a sequence, kernel 4 at least that, kernel 5
   none; each sequence bit-equal to ``run_sequence`` with its seed;
   aggregate frames/s;
16. workers — the whole-run programs over ``dist/workers.py``'s worker
   processes, one per mesh entry, at the same time: the mesh ``[cuda:0,
   cuda:0]`` (two processes on the one card; only this phase names a card
   twice) and, with more cards, every card.  ``shard_sequence_program`` with
   two PnP SLAM sequences (tree vocabulary, the 96 frames, seeds 0 and 1),
   each bit-equal to ``run_sequence`` by ``[multiseq]``'s rule, aggregate
   frames/s against the two in turn in one worker process (a pool of one
   entry, before and after; bit-equal too) and in this process;
   ``run_timesharded_system`` (VO, 192 frames from a memmap, 4 shards), twice,
   every field but ``seconds`` bit-equal to the in-process run on ``cuda:0``,
   each worker's seconds against the in-process run's; ``run_timesharded``
   (VO, 4 shards) bit-equal to the same entries in turn in this process
   (``InProcess``) and within ``[timeshard]``'s hold of the one-entry run;
   launch counts summed over the workers equal to the in-process runs'
   exactly, kernels 1-4 launched; the workers' wall intervals overlap; TF32
   off in every worker; a worker that exits raises ``WorkerDied``; no worker
   process outlives its pool; the time of an answer the size of the
   time-sharded run's DBs against an empty one, split into the worker's
   packing into shared memory and the parent's reading;
   step-workers — the per-chunk step over worker processes
   (``shard_batched_pipeline`` with a ``WorkerPool`` on ``[cuda:0, cuda:0]``,
   and every card where there are more): ``[multiseq-vo]``'s 4 VO sequences,
   2 a worker, 6 chunks; every result and the final states fetched from the
   workers bit-equal to the same step in this process (``InProcess``);
   launches summed over the workers exactly the in-process count (kernels
   1-4 12 each, kernel 5 none); the workers' walls overlapping on every
   chunk; frames/s in turns (in process, card frames, host frames, card
   frames, in process), the ms a call spends sending the
   frames (through the entry's buffer on the card, CUDA IPC, or its reused
   block of shared memory) and returning the results, a fresh block's ms,
   each worker's peak memory;
   multihost — a mesh across a process group: two ranks spawned with
   ``MASTER_ADDR`` 127.0.0.1 and a free port (gloo over the loopback), each
   owning ``cuda:0``: ``initialize_multihost()`` True and a global mesh of 2
   entries; ``shard_sequence_program`` over ``[workers]``' two PnP SLAM
   sequences, ``run_timesharded_system`` (VO, the 192 frames from a memmap, 4
   shards) and the per-chunk step with ``hosts.fill_sequences`` bit-equal on
   every rank to the single-process runs of ``[workers]`` and
   ``[step-workers]``; launches summed over the ranks exact; rank 1 made to
   raise named on both ranks within 60 s; the group destroyed, no process
   left; each rank's wall and its exchanges' bytes and seconds;
17. cli-timeshard — ``python -m tpuslam_torch.cli -c configs -v
   tests/data/images --timeshard 2 --slam --batch-size 4 --stats``
   (through ``frames_to_memmap``; on one card in this process): exit 0, 10
   trajectory rows.
18. loader — the port's frame loader (``pre/native_loader.py``, built with
   ``c++`` here): on the fixture directories (the four of the reference,
   and ``tests/data/torch_loader``'s filters, formats and interlaced) the
   native loader and the plain decoder give identical bytes; on every JPEG
   fixture (``torch_loader/jpeg``, ``jpeg_kitti``, ``jpeg_variants``) the
   loader, the plain twin ``decode_jpeg_gray8`` and the libjpeg bytes
   committed in ``expected_gray.npz`` agree, and the CMYK and SOF9
   variants raise their named ``FrameDecodeError`` from both; 96 frames written as adaptive-filter PNGs
   (``post/png.py::encode_png``: Sub, Average and Paeth rows) decode to their source:
   the native loader's ms a frame with its thread count, the plain
   decoder's on 4 of them and on the committed frames, ``FrameStream.batches``
   ms a chunk; the CLI's ``--slam`` over that directory (in this process,
   kernels 1-3 six launches each) and ``SlamSystem.run`` over the same
   frames in memory, a warm-up of each, then in turns: frames/s of both;
19. jpeg — JPEG frames on the card: decode ms a 1392x512 frame, one frame a
   call and 96 in one call on the loader's pool, for the committed KITTI
   JPEGs and PNGs (96 ping-pong links to each); ``python -m
   tpuslam_torch.cli --slam -v <dir> --save-state`` over the 96 JPEG
   frames (in this process; kernels 1-3 six launches each) against
   ``SlamSystem.run`` over the same frames decoded by the plain twin, in
   memory: every checkpoint leaf bit-equal; frames/s of both;
20. vocab-tools — ``tpuslam_torch.tools.train_vocabulary`` flat (256 words)
   and ``--tree 16,16`` over ``torch_loader/jpeg_kitti`` and
   ``images_test_loop`` on the card and on the CPU: the arrays equal; the
   nine ``--augment`` operations card == CPU on a frame;
   ``calibrate_vocabulary.calibrate`` and ``eval_vocabulary.evaluate``
   with ``configs/vocabulary.npz`` and ``vocabulary_tree.npz`` card == CPU
   (rounded fields exactly, other floats to 1e-5); seconds of each tool
   and kernel 1's launches (kernels 2-5 none: BRIEF bins 0);
21. video — a Motion JPEG AVI of the 96 ping-pong KITTI JPEG payloads
   (``write_mjpeg_avi``, below) beside a directory of links to the same
   files: the video's frames (the loader's demuxer and decoder) equal the
   loader's decode of the files, its chunks as the twin ``pre/avi.py`` lists
   them, its timestamps i / 10 s; the committed writer fixtures
   (``tests/data/torch_video/``: OpenCV's and FFmpeg's Motion JPEG) decode
   through the loader and the twin to their committed libjpeg bytes, with no
   OpenCV needed; decode ms a frame, one a call and 96 on the pool,
   of the video beside the directory; the CLI's ``--slam --save-state
   --plot`` over each in turns (video, directory, directory, video) and
   VO with ``--plot`` over each: trajectories and every checkpoint leaf
   bit-equal, kernels 1-3 six launches each and kernel 4 as in jpeg (VO:
   kernels 1-4 six each), kernel 5 none; frames/s of both;
22. plot — ``post/visualizer.py``: keypoints, matches and depth-coloured
   points of one detector run on fixture frames 0 and 1 on the card drawn
   equal to those of the CPU run; every PNG written, [video]'s ``--plot``
   files among them, decodes through the port's loader to its drawn size;
23. soak — in a process of its own, started before ``[loader]`` and
   collected after ``[profile]`` (the script's time limit; its rates are
   taken beside those phases): ``tpuslam_torch/tools/soak.py``'s run: 1,536 frames (the ring of
   512 keyframes overflows three times), VO, the tree vocabulary, the
   redundancy policy: kernels 1-3 96 launches each, kernel 4 at least that,
   kernel 5 none; its pass rule (finite, ``pose_ok`` > 95%, >= 1 revisit
   loop into the prologue) and memory allocated flat from the ring's first
   overflow to the last chunk (within 16 MiB); the report, the memory after
   each chunk summarised;
24. profile — ``tools/profile_stages.py`` (the step's span table) on one
   main-path chunk and one pyramid chunk (kernel 5) and
   ``tools/profile_slam.py`` (full SLAM in VO
   and PnP mode, localization against the PnP run's map) over the 96
   frames: their stage tables.
Each phase from 7 on prints its seconds.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 16
N_FRAMES = 96
TS_FRAMES, TS_SHARDS = 192, 4  # the time-sharded phases: 4 shards of S 48 + V 16 frames
RTOL_MSAC = 1e-5  # kernel 4 sums its 1024 matches in another order than the twin
SLEEP_CYCLES = 2_000_000  # ~1 ms of card time, longer than the host takes to queue one call

# Kernel wrapper name → (its CUDA source, the Pallas kernel it replaces).
KERNELS = {
    "fused_frontend_batch": ("tpuslam_torch/csrc/frontend.cu", "tpuslam/kernels/frontend_pallas.py:115"),
    "fused_frontend_nms_batch": ("tpuslam_torch/csrc/nms.cu", "tpuslam/kernels/frontend_pallas.py:397"),
    "extract_brief_patches": ("tpuslam_torch/csrc/brief.cu", "tpuslam/kernels/brief_pallas.py:62"),
    "brief_own_bin_dots": ("tpuslam_torch/csrc/brief.cu", "tpuslam/kernels/brief_pallas.py:159"),
    "msac_scores": ("tpuslam_torch/csrc/pose.cu", "tpuslam/kernels/pose_pallas.py:54"),
}
# Why library_ms is null: no single PyTorch call computes the kernel's function.
NO_LIBRARY = {
    "fused_frontend_batch": "no single PyTorch call computes a blur with FAST corners and SAD scores",
    "fused_frontend_nms_batch": "no single PyTorch call computes blur, FAST and a windowed-NMS key plane",
    "extract_brief_patches": "no single PyTorch call gathers zero-padded patches around float keypoints",
    "brief_own_bin_dots": "no single PyTorch call dots each row with its own bin's weights; "
                          "library_ms_all_bins times torch._int_mm over all bins",
    "msac_scores": "no single PyTorch call computes truncated-Sampson MSAC scores; "
                   "library_ms_product times torch.bmm(E, P), its 45-term products alone",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_phase(label: str, fn, *args):
    """``fn(*args)``, with the phase's seconds printed after it."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{label}] phase took {time.perf_counter() - t0:.1f} s")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, hold: bool = True) -> float:
    """Median device milliseconds of ``fn()`` (CUDA events, after a warm-up).

    With ``hold`` the card sleeps before each start event while the host
    queues ``fn``'s work, so the time is the card's, not the host's
    dispatch; without it, a host gap between ``fn``'s launches adds to it.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def load_frames(n_frames: int) -> np.ndarray:
    """The 10 fixture frames ping-pong tiled (0..9, 8..1, 0..9, …): a continuous path."""
    from tpuslam_torch.pre.stream import FrameStream

    stream = FrameStream(REPO / "tests" / "data" / "images")
    base = [stream.read_frame(i)[0] for i in range(stream.total_frames)]
    period = 2 * (len(base) - 1)
    idx = [min(i % period, period - i % period) for i in range(n_frames)]
    return np.stack([base[i] for i in idx])


# --- a small RIFF writer: the Motion JPEG AVIs of [video] and the video tests' files ---


def _riff_chunk(fcc: bytes, body: bytes) -> bytes:
    import struct

    return fcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _riff_list(kind: bytes, body: bytes, fcc: bytes = b"LIST") -> bytes:
    import struct

    return fcc + struct.pack("<I", len(body) + 4) + kind + body


def write_mjpeg_avi(path, payloads: list[bytes], width: int, height: int, scale: int = 1, rate: int = 10,
                    frames_per_riff: int = 0, handler: bytes = b"MJPG", fields: int = 1) -> Path:
    """An AVI of one video stream whose frames are the JPEG ``payloads``, at ``rate / scale`` frames a second.

    The file is "RIFF" "AVI " (hdrl: avih, one strl with strh, strf and, with
    ``fields`` 2, an OpenDML vprp saying two fields a frame; odml: dmlh with
    the total; movi: one "00dc" chunk a frame; idx1 over this RIFF's frames),
    then, when ``frames_per_riff`` is set, one "RIFF" "AVIX" of a movi list a
    further ``frames_per_riff`` frames, as OpenDML continues files past 1 GB.
    A payload of zero bytes is a dropped frame.
    """
    import struct

    path = Path(path)
    n = len(payloads)
    per = frames_per_riff or max(n, 1)
    groups = [payloads[i : i + per] for i in range(0, n, per)] or [[]]
    largest = max((len(p) for p in payloads), default=0)
    avih = struct.pack("<14I", round(1e6 * scale / rate), 0, 0, 0x110, len(groups[0]), 0, 1, largest, width, height,
                       0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", handler, 0, 0, 0, 0, scale, rate, 0, n, largest,
                       0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG", width * height * 3, 0, 0, 0, 0)
    strl = _riff_chunk(b"strh", strh) + _riff_chunk(b"strf", strf)
    if fields != 1:
        strl += _riff_chunk(b"vprp", struct.pack("<9I", 0, 0, rate // scale, width, height, 0x00010001, width,
                                                 height, fields) + bytes(40))
    hdrl = _riff_list(b"hdrl", _riff_chunk(b"avih", avih) + _riff_list(b"strl", strl)
                      + _riff_list(b"odml", _riff_chunk(b"dmlh", struct.pack("<I", n) + bytes(244))))
    out = b""
    for g, group in enumerate(groups):
        movi = _riff_list(b"movi", b"".join(_riff_chunk(b"00dc", p) for p in group))
        if g:
            out += _riff_list(b"AVIX", movi, b"RIFF")
            continue
        index, at = b"", 4
        for p in group:
            index += struct.pack("<4sIII", b"00dc", 0x10, at, len(p))
            at += 8 + len(p) + (len(p) & 1)
        out += _riff_list(b"AVI ", hdrl + movi + _riff_chunk(b"idx1", index), b"RIFF")
    path.write_bytes(out)
    return path


def check_record(name, got, want, ms, plain_ms, exact, work) -> dict:
    """Hold a kernel's outputs against its twin's; its JSON record with its bound."""
    if exact:
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{name}: kernel disagrees with its twin at {bad} elements")
        err = 0.0
    else:
        err = require_msac_close(name, got[0], want[0])
    src, replaces = KERNELS[name]
    bound_us = work.bound_us()
    rec = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_us / 1e3, "bound_us": bound_us, "bound_by": work.bound_by(),
           "bound_share": bound_us / (ms * 1e3), "bytes": work.bytes, "ops": work.ops,
           "library_ms": None, "library_note": NO_LIBRARY[name]}
    log(f"[kernels] {name}: {tuple(got[0].shape)} max_abs_err={err} "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_us:.2f} us "
        f"({work.bound_by()}), {100 * rec['bound_share']:.1f}% of bound")
    return rec


def int_mm_all_bins(patches, bins, weights, got) -> float:
    """cuBLAS's int8 product of all patches by all bins' weights (16x kernel 3's
    multiply-accumulates): its time, after checking it agrees with kernel 3
    at each keypoint's own bin.  A yardstick only: the port never calls it."""
    b, k, s2p = patches.shape
    n_bins, p, _ = weights.t.shape
    a = patches.reshape(b * k, s2p)
    w_all = weights.t.reshape(n_bins * p, s2p).t()  # (S2p, bins·P), column-major
    dots = torch._int_mm(a, w_all)
    own = dots.reshape(b, k, n_bins, p).gather(
        2, bins.clamp(0, n_bins - 1).to(torch.int64)[..., None, None].expand(b, k, 1, p))[:, :, 0]
    in_range = (bins >= 0) & (bins < n_bins)
    if not torch.equal(own[in_range], got[in_range]):
        raise AssertionError("brief_own_bin_dots disagrees with torch._int_mm at the own bins")
    return time_ms(lambda: torch._int_mm(a, w_all))


def msac_inputs(pipeline, blur: torch.Tensor, kps, operand: bool = True):
    """Kernel 4's (E, P) as the main path builds them: descriptors of the B frames
    matched pair by pair, 1024 eight-point hypotheses a pair, the (9, 5M) operand.
    With ``operand=False``: the normalised matches (x1, x2), their mask and the threshold."""
    from tpuslam_torch.common.geometry import normalize_points
    from tpuslam_torch.frontend.matcher import match_descriptors
    from tpuslam_torch.frontend.pose import _eight_point_rows, _solve_e_from_rows, draw_ranks
    from tpuslam_torch.kernels import pose as kp

    b = blur.shape[0]
    kps2, desc = pipeline.detector.compute_from_blurred(blur, kps)
    q, t = slice(0, b - 1), slice(1, b)
    m = match_descriptors(desc[q], desc[t], kps2.valid[q], kps2.valid[t], kps2.xy[q], kps2.xy[t],
                          filter_matches=False)
    # pair 0 against itself keeps the batch at B pairs, as in the pipeline
    qi = torch.cat([m.query_idx[:1].clamp_min(0), m.query_idx.clamp_min(0)])
    ti = torch.cat([m.query_idx[:1].clamp_min(0), m.train_idx.clamp_min(0)])
    valid = torch.cat([m.valid[:1], m.valid])
    xy_q = torch.cat([kps2.xy[:1], kps2.xy[:-1]])
    pts1 = torch.gather(xy_q, 1, qi[..., None].expand(-1, -1, 2))
    pts2 = torch.gather(kps2.xy, 1, ti[..., None].expand(-1, -1, 2))
    K = pipeline.K
    x1, x2 = normalize_points(K, pts1), normalize_points(K, pts2)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    if not operand:
        return x1, x2, valid, (pipeline.config.pose.inlier_threshold_px / focal) ** 2
    H = pipeline.config.pose.num_hypotheses
    gen = torch.Generator(device=blur.device).manual_seed(0)
    draws = draw_ranks(valid.sum(-1), H, 8, gen)
    rank_to_idx = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    sample = torch.gather(rank_to_idx, 1, draws.reshape(b, -1))
    rows = torch.gather(_eight_point_rows(x1, x2), 1, sample[..., None].expand(-1, -1, 9))
    E = _solve_e_from_rows(rows.reshape(b, H, 8, 9), project=False, sweeps=3).reshape(b, H, 9)
    return E, kp.build_msac_operand(x1, x2, valid, (1.0 / focal) ** 2)


def require_msac_close(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernel 4 within RTOL_MSAC of its twin; the largest absolute difference."""
    if not torch.allclose(got, want, rtol=RTOL_MSAC, atol=0.0):
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        raise AssertionError(f"{label}: max rel err {rel}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_ragged(blur: torch.Tensor) -> None:
    """Kernels 2 and 4 against their twins off the main path's shapes."""
    from tpuslam_torch.kernels import brief as kb
    from tpuslam_torch.kernels import pose as kp

    rng = np.random.default_rng(0)
    dev = blur.device
    b, h, w = blur.shape
    # kernel 2: K 333, keypoints up to 5 px outside every border; sides 48 (16-byte units) and 40 (8)
    xy = np.stack([rng.uniform(-5, w + 5, (b, 333)), rng.uniform(-5, h + 5, (b, 333))], -1)
    xy[:, :4] = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1)]
    xy = torch.from_numpy(xy.astype(np.float32)).to(dev)
    for patch_size in (31, 25):
        got = kb.extract_brief_patches(blur, xy, patch_size)
        want = kb.extract_brief_patches_reference(blur, xy, patch_size)
        if not torch.equal(got, want):
            raise AssertionError(f"extract_brief_patches (K 333, patch {patch_size}, keypoints beyond the "
                                 f"borders): {int((got != want).sum())} bytes differ from the twin")
    log(f"[kernels] extract_brief_patches: exact at K 333 beyond the borders, patch 31 and 25 "
        f"(sides {kb.patch_side(31)}, {kb.patch_side(25)})")
    # kernel 4: B 3, H 300, M 777, a tenth of the matches invalid and one pair with none
    B, H, M = 3, 300, 777
    x1 = torch.from_numpy(rng.uniform(-0.6, 0.6, (B, M, 2)).astype(np.float32)).to(dev)
    x2 = x1 + torch.from_numpy(rng.normal(0, 2e-3, (B, M, 2)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((B, M)) > 0.1).to(dev)
    valid[2] = False
    E = torch.from_numpy((rng.normal(size=(B, H, 9)) * 0.3).astype(np.float32)).to(dev)
    P = kp.build_msac_operand(x1, x2, valid, 1e-6)
    got = kp.msac_scores(E, P)
    err = require_msac_close("msac_scores (B 3, H 300, M 777)", got, kp.msac_scores_reference(E, P))
    if got[2].any():
        raise AssertionError("msac_scores: a pair without valid matches must score exactly 0")
    log(f"[kernels] msac_scores: within rtol {RTOL_MSAC} at B 3, H 300, M 777 (max_abs_err {err}), "
        f"the all-invalid pair scores 0")


def phase_kernels(pipeline, frames: torch.Tensor) -> list[dict]:
    """Kernels 1-4 against their twins at the main path's shapes; 2 and 4 also at ragged ones."""
    from tpuslam_torch.common.camera import undistort_batch
    from tpuslam_torch.frontend.brief import orientations_from_patches, quantize_angles
    from tpuslam_torch.frontend.fast import select_keypoints
    from tpuslam_torch.kernels import brief as kb
    from tpuslam_torch.kernels import frontend as kf
    from tpuslam_torch.kernels import pose as kp

    det = pipeline.detector
    c = det.config
    und = undistort_batch(frames, pipeline.undistort_idx, pipeline.undistort_valid)
    records = []

    def record(name, got, want, ms, plain_ms, exact, work):
        records.append(check_record(name, got, want, ms, plain_ms, exact, work))
        return records[-1]

    # Kernel 1: blur + FAST on (16, 512, 1392) u8.
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold, taps=det.blur_kernel)
    got = kf.fused_frontend_batch(und, **args)
    want = kf.fused_frontend_reference(und, **args)
    ms = time_ms(lambda: kf.fused_frontend_batch(und, **args))
    plain = time_ms(lambda: kf.fused_frontend_reference(und, **args))
    record("fused_frontend_batch", got, want, ms, plain, exact=True, work=kf.frontend_work(*und.shape))
    blur, corner, score = got
    kps = select_keypoints(corner, score, nms=c.non_max_suppression,
                           window=c.suppression_window_size, max_keypoints=c.max_keypoints)
    if int(kps.valid.sum()) < BATCH * 300:
        raise AssertionError(f"too few keypoints: {int(kps.valid.sum())}")

    # Kernel 2: patches (16, 1024, 2304) i8.
    got = kb.extract_brief_patches(blur, kps.xy, c.patch_size)
    want = kb.extract_brief_patches_reference(blur, kps.xy, c.patch_size)
    ms = time_ms(lambda: kb.extract_brief_patches(blur, kps.xy, c.patch_size))
    plain = time_ms(lambda: kb.extract_brief_patches_reference(blur, kps.xy, c.patch_size))
    record("extract_brief_patches", (got,), (want,), ms, plain, exact=True,
           work=kb.extract_patches_work(*blur.shape, kps.xy.shape[1], c.patch_size))
    patches = got

    # Kernel 3: own-bin dots (16, 1024, 256) i32.
    angles = orientations_from_patches(patches, det.moment_weights, kps, c.patch_size, blur.shape[-2:])
    bins = quantize_angles(angles, c.brief_quantized_bins)
    W, W3 = det.bin_weights, det.bin_weights_3d  # packed at detector init; the twin's view
    got = kb.brief_own_bin_dots(patches, bins, W)
    want = kb.brief_own_bin_dots_reference(patches, bins, W3)
    ms = time_ms(lambda: kb.brief_own_bin_dots(patches, bins, W))
    plain = time_ms(lambda: kb.brief_own_bin_dots_reference(patches, bins, W3))
    rec = record("brief_own_bin_dots", (got,), (want,), ms, plain, exact=True,
                 work=kb.own_bin_dots_work(bins, W))
    rec["library_ms_all_bins"] = int_mm_all_bins(patches, bins, W, got)
    rec["library_all_bins_note"] = ("torch._int_mm (cuBLAS int8) of the (B*K, S2p) patches by all "
                                    "bins' (S2p, bins*P) weights: 16x the kernel's multiply-accumulates")
    log(f"[kernels] brief_own_bin_dots: torch._int_mm over all bins {rec['library_ms_all_bins']:.4f} ms")

    # Kernel 4: MSAC scores of 1024 hypotheses x 1024 matches per pair, 16 pairs.
    E, P = msac_inputs(pipeline, blur, kps)
    got = kp.msac_scores(E, P)
    want = kp.msac_scores_reference(E, P)
    if not torch.equal(got, kp.msac_scores(E, P)):
        raise AssertionError("msac_scores: two runs on the same inputs give different bits")
    ms = time_ms(lambda: kp.msac_scores(E, P))
    plain = time_ms(lambda: kp.msac_scores_reference(E, P))
    rec = record("msac_scores", (got,), (want,), ms, plain, exact=False,
                 work=kp.msac_work(*E.shape[:2], P.shape[-1] // 5))
    rec["library_ms_product"] = time_ms(lambda: torch.bmm(E, P))
    rec["library_product_note"] = ("torch.bmm(E, P) in full float32 (cuBLAS): the 45-term products "
                                   "alone, written out as (B, H, 5M); the port never calls it")
    log(f"[kernels] msac_scores: same bits twice; torch.bmm(E, P) {rec['library_ms_product']:.4f} ms")
    rec["reloc_shape"] = msac_reloc_shape(pipeline, blur, kps)
    check_ragged(blur)
    return records


def check_ragged_kernel5(images: torch.Tensor, args: dict) -> None:
    """Kernel 5 against its twin off the pyramid's shapes: below and just over its 64 x 96
    tile, rows and a buffer that start at any byte, every kind of window, dense and empty images."""
    from tpuslam_torch.kernels import frontend as kf

    def exact(label, img, **over):
        kw = {**args, **over}
        got = kf.fused_frontend_nms_batch(img, **kw)
        want = kf.fused_frontend_nms_reference(img, **kw)
        for g, w, what in zip(got, want, ("blur", "key")):
            if not torch.equal(g, w):
                raise AssertionError(f"fused_frontend_nms_batch ({label}, {tuple(img.shape)}, window "
                                     f"{kw['window']}): {int((g != w).sum())} {what} values differ from the twin")
        return int((got[1] > 0).sum())

    survivors = 0
    for b, h, w in ((3, 77, 203), (2, 20, 37), (2, 65, 97), (1, 129, 193)):
        crop = images[:b, 100 : 100 + h, 300 : 300 + w].contiguous()
        for window in (1, 2, 5, 12, 14):
            survivors += exact("ragged", crop, window=window)
    flat = torch.empty(2 * 97 * 211 + 1, dtype=torch.uint8, device=images.device)
    odd = flat[1:].reshape(2, 97, 211).copy_(images[:2, 50:147, 300:511])
    survivors += exact("odd base address", odd)
    rng = np.random.default_rng(3)
    noise = torch.from_numpy(rng.integers(0, 256, (2, 150, 333), dtype=np.uint8)).to(images.device)
    dense = exact("noise, every other pixel a corner", noise, threshold=0, contiguous=1, window=1)
    if dense < noise.numel() // 3:
        raise AssertionError(f"kernel 5: only {dense} corners on the dense image")
    for window in (5, 12):
        exact("noise", noise, threshold=0, contiguous=1, window=window)
    lattice = torch.zeros((2, 150, 333), dtype=torch.uint8, device=images.device)
    lattice[:, ::4, ::4] = 255  # equal scores: only the inverted raster index decides
    if exact("lattice of equal corners", lattice) != 2:
        raise AssertionError("kernel 5: the first of equal corners must beat all it can see")
    if exact("zeros", torch.zeros_like(noise)) != 0:
        raise AssertionError("kernel 5: survivors on an empty image")
    log(f"[kernels] fused_frontend_nms_batch: exact at 4 ragged shapes x windows 1, 2, 5, 12, 14 "
        f"({survivors} survivors), on an odd base address, on noise ({dense} corners at window 1), "
        f"on a lattice of equal corners and on zeros")


# Kernel 6's calls in one step of the benchmark's cells (32 sequences x 16 frames, 1024 keypoints and
# hypotheses): the 8-point hypotheses, each LO refit, cheirality, triangulation; DLT-PnP's refit; the
# main path's four (one chunk of BATCH frames); the wide form, DLT-PnP's refit at 2,000 points.
JACOBI_SHAPES = {"hypotheses": ((512, 1024, 8, 9), 3), "lo": ((512, 4, 1024, 9), 5),
                 "cheirality": ((512, 4, 256, 4, 4), 4), "triangulate": ((512, 1024, 4, 4), 8),
                 "pnp_refit": ((64, 2048, 12), 8),
                 "main_hypotheses": ((BATCH, 1024, 8, 9), 3), "main_lo": ((BATCH, 4, 1024, 9), 5),
                 "main_cheirality": ((BATCH, 4, 256, 4, 4), 4), "main_triangulate": ((BATCH, 1024, 4, 4), 8),
                 "pnp_refit_wide": ((8, 4000, 12), 8)}
# its calls a chunk on the main and pyramid paths, by shape
JACOBI_MAIN_CALLS = {"main_hypotheses": 1, "main_lo": 3, "main_cheirality": 1, "main_triangulate": 1}
JACOBI_PER_CHUNK = sum(JACOBI_MAIN_CALLS.values())


def phase_jacobi() -> dict:
    """Kernel 6 against its twin at ``JACOBI_SHAPES`` on Gaussian rows, with device ms and bounds; its
    record's ``ms`` is a launch's mean over the main path's calls of a chunk."""
    from tpuslam_torch.common.geometry import nullvec_jacobi_twin
    from tpuslam_torch.kernels import jacobi as kj

    gen = torch.Generator(device="cuda").manual_seed(6)
    rec = {"name": "jacobi_nullvec", "source": "tpuslam_torch/csrc/jacobi.cu",
           "replaces": "none (tpuslam/common/geometry.py nullvec_jacobi, left to XLA)", "shapes": {}}
    for what, (shape, sweeps) in JACOBI_SHAPES.items():
        A = torch.randn(shape, device="cuda", generator=gen)
        m, n = shape[-2:]
        got = kj.jacobi_nullvec(A, sweeps)
        if not torch.equal(got, kj.jacobi_nullvec(A, sweeps)):
            raise AssertionError(f"jacobi_nullvec {shape}: two runs on the same inputs give different bits")
        want = nullvec_jacobi_twin(A, sweeps)
        differ = int((got != want).any(dim=-1).sum())
        if differ:
            raise AssertionError(f"jacobi_nullvec {shape}: {differ} problems differ from the twin's bits")
        dot = float((got * want).sum(dim=-1).abs().min())
        ms = time_ms(lambda: kj.jacobi_nullvec(A, sweeps))
        plain = time_ms(lambda: nullvec_jacobi_twin(A, sweeps), reps=5)
        svd = time_ms(lambda: torch.linalg.svd(A, full_matrices=m < n), reps=5)
        work = kj.jacobi_work(A.numel() // (m * n), m, n, sweeps)
        rec["shapes"][what] = {"shape": shape, "sweeps": sweeps, "lanes": kj.team_lanes(m, n) or "wide",
                               "min_abs_dot": dot,
                               "ms": ms, "plain_ms": plain, "library_ms_svd": svd, "bound_us": work.bound_us(),
                               "bound_by": work.bound_by(), "bound_share": work.bound_us() / (ms * 1e3),
                               "bytes": work.bytes, "ops": work.ops}
        log(f"[kernels] jacobi_nullvec {what} {shape} x{sweeps} sweeps ({kj.team_lanes(m, n) or 'wide form, 512'} "
            f"lanes a problem): "
            f"the twin's bits (min |v . v_twin| {dot:.8f}), the same bits twice; kernel {ms:.4f} ms, "
            f"twin {plain:.4f} ms, "
            f"torch.linalg.svd {svd:.4f} ms, bound {work.bound_us():.2f} us ({work.bound_by()}), "
            f"{100 * work.bound_us() / (ms * 1e3):.1f}% of bound")
    rec["ms"] = sum(rec["shapes"][k]["ms"] * c for k, c in JACOBI_MAIN_CALLS.items()) / JACOBI_PER_CHUNK
    return rec


def phase_kernel5(pipeline, frames: torch.Tensor) -> dict:
    """Kernel 5 against its twin at the pyramid's level shapes, on resized undistorted frames;
    kernels 2 and 3 timed at each level's keypoint capacity, as the pyramid path calls them."""
    from tpuslam_torch.common.camera import undistort_batch
    from tpuslam_torch.frontend.brief import orientations_from_patches, quantize_angles
    from tpuslam_torch.frontend.detector import resize_batch_u8
    from tpuslam_torch.frontend.fast import select_from_key
    from tpuslam_torch.kernels import brief as kb
    from tpuslam_torch.kernels import frontend as kf

    det = pipeline.detector
    c = det.config
    und = undistort_batch(frames, pipeline.undistort_idx, pipeline.undistort_valid)
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold,
                window=c.suppression_window_size, taps=det.blur_kernel)
    levels = det._feasible_levels(*und.shape[-2:])
    shapes, others = [], []
    for (level, h, w), cap in zip(levels, det._level_capacities(levels)):
        img = und if level == 0 else resize_batch_u8(und, h, w)
        got = kf.fused_frontend_nms_batch(img, **args)
        want = kf.fused_frontend_nms_reference(img, **args)
        ms = time_ms(lambda: kf.fused_frontend_nms_batch(img, **args))
        plain = time_ms(lambda: kf.fused_frontend_nms_reference(img, **args))
        shapes.append(check_record("fused_frontend_nms_batch", got, want, ms, plain, exact=True,
                                   work=kf.frontend_nms_work(*img.shape)))
        if int((got[1] > 0).sum()) < BATCH * 100:
            raise AssertionError(f"kernel 5: too few survivors at {tuple(img.shape)}")
        blur, key = got
        kps = select_from_key(key, window=c.suppression_window_size, max_keypoints=cap)
        patches = kb.extract_brief_patches(blur, kps.xy, c.patch_size)
        angles = orientations_from_patches(patches, det.moment_weights, kps, c.patch_size, (h, w))
        bins = quantize_angles(angles, c.brief_quantized_bins)
        others.append({
            "keypoints": cap,
            "extract_brief_patches_ms": time_ms(lambda: kb.extract_brief_patches(blur, kps.xy, c.patch_size)),
            "brief_own_bin_dots_ms": time_ms(lambda: kb.brief_own_bin_dots(patches, bins, det.bin_weights)),
        })
    check_ragged_kernel5(und, args)
    rec = dict(shapes[0])
    rec["ms"] = sum(r["ms"] for r in shapes)  # one 16-frame chunk: the four level shapes
    rec["plain_ms"] = sum(r["plain_ms"] for r in shapes)
    for key in ("bound_us", "bytes", "ops"):
        rec[key] = sum(r[key] for r in shapes)
    rec["bound_ms"] = rec["bound_us"] / 1e3
    rec["bound_share"] = rec["bound_us"] / (rec["ms"] * 1e3)
    rec["per_level"] = [{"shape": [BATCH, h, w], "ms": r["ms"], "plain_ms": r["plain_ms"],
                         "bound_us": r["bound_us"], **o}
                        for (_, h, w), r, o in zip(levels, shapes, others)]
    return rec


def phase_frontend(cfg_path: Path, frames: np.ndarray, nms_fused: bool) -> None:
    """FeatureDetector on 2 frames, card vs CPU: identical keypoints and descriptors."""
    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector

    cfg = DetectorConfig.from_yaml(cfg_path)
    x = torch.from_numpy(frames[:2].copy())
    kg, dg = FeatureDetector(cfg, device="cuda", nms_fused=nms_fused).detect_and_compute_batch(x.cuda())
    kc, dc = FeatureDetector(cfg, device="cpu", nms_fused=nms_fused).detect_and_compute_batch(x)
    label = f"{cfg_path.parent.name}/{cfg_path.name}, {cfg.num_levels} level(s), nms_fused={nms_fused}"
    for name in ("xy", "response", "valid"):
        if not torch.equal(getattr(kg, name).cpu(), getattr(kc, name)):
            raise AssertionError(f"frontend ({label}): keypoint {name} differs between the card and the CPU")
    if not torch.equal(dg.cpu(), dc):
        raise AssertionError(f"frontend ({label}): descriptors differ between the card and the CPU")
    angle_err = float((kg.angle.cpu() - kc.angle).abs().max())
    if angle_err > 1e-3:  # atan2 is a libm call on each side
        raise AssertionError(f"frontend ({label}): angles differ by {angle_err} deg")
    log(f"[frontend] {label}: card == CPU on 2 frames: {int(kc.valid.sum())} keypoints, "
        f"descriptors identical, max angle diff {angle_err:.2e} deg")


def drive(pipeline, chunks: torch.Tensor, valid: torch.Tensor, seed: int, pnp: bool = False):
    """One pass over the chunks with the launch counters zeroed just before it.

    With ``pnp`` the pass is ``process_sequence_pnp``.  Returns (result,
    seconds, launch counts, final state).
    """
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts

    if pnp:
        run, init = pipeline.process_sequence_pnp, pipeline.initial_pnp_state()
    else:
        run, init = pipeline.process_sequence, pipeline.initial_state()
    reset_launch_counts()
    t0 = time.perf_counter()
    result, state = run(chunks, valid, init, seed=seed)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, launch_counts(), state


def check_launches(label: str, counts: dict, expected: dict) -> None:
    """``expected``: wrapper name → exact count, or None for "at least once"."""
    log(f"[{label}] launches {counts}")
    for name, want in expected.items():
        got = counts[name]
        if (got <= 0) if want is None else (got != want):
            raise AssertionError(f"{label}: {name} launched {got} times, expected "
                                 f"{'> 0' if want is None else want}")


def check_trajectory(label: str, result, run_s: float, card: str) -> float:
    """pose_ok on >= 90% of frames 1.., motion dominantly along +z; returns frames/s."""
    poses = result.poses.reshape(-1, 4, 4).cpu().numpy().astype(np.float64)
    pose_ok = result.pose_ok.reshape(-1).cpu().numpy()
    n_inl = result.num_inliers.reshape(-1).cpu().numpy()
    if not np.isfinite(poses).all():
        raise AssertionError(f"{label}: non-finite poses")
    n = len(poses)
    ok_frac = float(pose_ok[1:].mean())
    rel = np.stack([np.linalg.inv(poses[i - 1]) @ poses[i] for i in range(1, n)])
    step = rel[:, :3, 3][pose_ok[1:]]
    z_dominant = float(np.mean(np.abs(step[:, 2]) >= 0.9 * np.linalg.norm(step, axis=1)))
    fps = n / run_s
    log(f"[{label}] VO {n} frames batch {BATCH}: timed {run_s:.3f} s = {fps:.2f} frames/s on "
        f"{card}; pose_ok {ok_frac:.3f} of frames 1..{n - 1}, median inliers "
        f"{float(np.median(n_inl[1:])):.0f}, z-dominant steps {z_dominant:.3f}, "
        f"z after frame 9 {poses[9, 2, 3]:.3f}")
    if ok_frac < 0.9:
        raise AssertionError(f"{label}: pose_ok on only {ok_frac:.3f} of frames")
    if z_dominant < 0.9 or poses[9, 2, 3] <= 0:
        raise AssertionError(f"{label}: motion is not dominantly along +z")
    return fps


def shape_record(label: str, got, want, fn, plain_fn, exact: bool, work, shape) -> dict:
    """A kernel at another shape than its main record's: held against its twin (exact, or kernel 4 at
    RTOL_MSAC), its device ms, its twin's and its bound."""
    if exact:
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: kernel disagrees with its twin at {int((g != w).sum())} elements")
        err = 0.0
    else:
        err = require_msac_close(label, got[0], want[0])
    rec = {"shape": list(shape), "max_abs_err": err, "ms": time_ms(fn), "plain_ms": time_ms(plain_fn, reps=5),
           "bound_ms": work.bound_us() / 1e3, "bound_by": work.bound_by()}
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"[kernels] {label} at {tuple(shape)}: {'exact' if exact else f'within rtol {RTOL_MSAC}'}, kernel "
        f"{rec['ms']:.4f} ms, twin {rec['plain_ms']:.4f} ms, bound {1e3 * rec['bound_ms']:.2f} us "
        f"({rec['bound_by']}), {100 * rec['bound_share']:.1f}% of bound")
    return rec


def main_blur_kps(pipeline, frames: torch.Tensor):
    """Kernel 1's blur and the selected keypoints of undistorted frames, as the main path makes them."""
    from tpuslam_torch.common.camera import undistort_batch

    und = undistort_batch(frames, pipeline.undistort_idx, pipeline.undistort_valid)
    return pipeline.detector._detect_level(und, pipeline.detector.config.max_keypoints)


def phase_fast(main_pipeline, config_dir: Path, chunks: torch.Tensor, valid: torch.Tensor, card: str,
               uses) -> dict:
    """VO with configs/fast (512 hypotheses) at batch 16 over the 96 frames, timed in turns with the
    main path; kernel 4 at (16, 512, 1024) against its twin."""
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels import pose as kp
    from tpuslam_torch.model.slam import SlamPipeline

    fast_dir = config_dir / "fast"
    cfg = SlamConfig.from_yaml_dir(fast_dir, batch_size=BATCH)
    if cfg.pose.num_hypotheses != 512:
        raise AssertionError(f"configs/fast reads {cfg.pose.num_hypotheses} hypotheses, not 512")
    fast = SlamPipeline(Camera.from_yaml(fast_dir / "camera.yml"), cfg, device="cuda")
    drive(fast, chunks, valid, seed=1)  # warm-up
    fps = {"main": [], "fast": []}
    counts = None
    for which in ("main", "fast", "fast", "main"):  # in turns, against drift
        result, run_s, c, _ = drive(fast if which == "fast" else main_pipeline, chunks, valid, seed=0)
        if which == "fast" and counts is None:
            check_launches("fast", c, {**{k: chunks.shape[0] for k in uses}, "fused_frontend_nms_batch": 0})
            counts = c
        fps[which].append(check_trajectory(f"fast ({which})", result, run_s, card))
    log(f"[fast] frames/s configs/fast {fps['fast']} against the main path's {fps['main']} in turns on {card}")
    blur, kps = main_blur_kps(fast, chunks[0])
    E, P = msac_inputs(fast, blur, kps)
    shape = (*E.shape[:2], P.shape[-1] // 5)
    if shape != (BATCH, 512, 1024):
        raise AssertionError(f"kernel 4 at configs/fast's chunk has shape {shape}")
    rec = shape_record("msac_scores (configs/fast)", (kp.msac_scores(E, P),), (kp.msac_scores_reference(E, P),),
                       lambda: kp.msac_scores(E, P), lambda: kp.msac_scores_reference(E, P), exact=False,
                       work=kp.msac_work(*shape), shape=shape)
    return {"launches": counts, "fps": fps["fast"], "main_fps": fps["main"], "msac_scores": rec}


def same_keypoints(label: str, a, b, angle_atol: float) -> float:
    """Keypoints identical but for their angles, held to ``angle_atol`` degrees; the largest angle difference."""
    for name in ("xy", "response", "valid"):
        if not torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()):
            raise AssertionError(f"{label}: keypoint {name} differs")
    err = float((a.angle.cpu() - b.angle.cpu()).abs().max()) if a.angle.numel() else 0.0
    if err > angle_atol:
        raise AssertionError(f"{label}: angles differ by {err} deg")
    return err


def phase_exact_brief(pipeline, config_dir: Path, frames_np: np.ndarray, card: str) -> dict:
    """FeatureDetector with BriefQuantizedBins 0 on 2 full-width frames, card against CPU; kernel 1 launched,
    kernels 2-3 not; ms a frame of the exact stage beside the quantised one on the main path's chunk."""
    import dataclasses

    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts

    cfg = dataclasses.replace(DetectorConfig.from_yaml(config_dir / "feature_detector.yml"), brief_quantized_bins=0)
    gpu, cpu = FeatureDetector(cfg, device="cuda"), FeatureDetector(cfg, device="cpu")
    x = torch.from_numpy(frames_np[:2].copy())
    gpu.detect_and_compute_batch(x.cuda())  # warm-up
    reset_launch_counts()
    kg, dg = gpu.detect_and_compute_batch(x.cuda())
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches("exact-brief", counts, {"fused_frontend_batch": 1, "extract_brief_patches": 0,
                                           "brief_own_bin_dots": 0, "msac_scores": 0, "fused_frontend_nms_batch": 0})
    kc, dc = cpu.detect_and_compute_batch(x)
    angle_err = same_keypoints("exact-brief card vs CPU", kg, kc, 1e-4)
    if not torch.equal(dg.cpu(), dc):
        raise AssertionError(f"exact-brief: {int((dg.cpu() != dc).any(-1).sum())} descriptors differ between "
                             "the card and the CPU")
    # the exact stage against the quantised one on the main path's 16 frames, the same blur and keypoints
    blur, kps = main_blur_kps(pipeline, torch.from_numpy(frames_np[:BATCH]).cuda())
    exact_ms = synced_ms(lambda: gpu.compute_from_blurred(blur, kps)) / BATCH
    quant_ms = synced_ms(lambda: pipeline.detector.compute_from_blurred(blur, kps)) / BATCH
    out = {"launches": counts, "keypoints": int(kc.valid.sum()), "max_angle_diff_deg": angle_err,
           "exact_ms_per_frame": exact_ms, "quantized_ms_per_frame": quant_ms}
    log(f"[exact-brief] card == CPU on 2 frames: {out['keypoints']} keypoints, descriptors identical, max angle "
        f"diff {angle_err:.2e} deg; ms a frame (batch {BATCH}, synchronised): exact orientation + BRIEF "
        f"{exact_ms:.3f}, quantised (kernels 2-3) {quant_ms:.3f} on {card}")
    return out


def phase_single(pipeline, camera, frames_np: np.ndarray, card: str) -> dict:
    """The single-image API and the single-pair facades on fixture frames 0 and 1, card against CPU and
    against row 0 of the batch call; kernels 1-4 at their B = 1 shapes against their twins."""
    from tpuslam_torch.common.camera import undistort_batch, undistort_image
    from tpuslam_torch.frontend.brief import orientations_from_patches, quantize_angles
    from tpuslam_torch.frontend.detector import FeatureDetector
    from tpuslam_torch.frontend.fast import detect_keypoints
    from tpuslam_torch.frontend.matcher import FeatureMatcher, match_descriptors
    from tpuslam_torch.frontend.pose import PoseEstimator
    from tpuslam_torch.kernels import brief as kb
    from tpuslam_torch.kernels import frontend as kf
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.kernels import pose as kp

    cfg = pipeline.config
    gpu = pipeline.detector
    cpu = FeatureDetector(cfg.detector, device="cpu")
    idx, ok = pipeline.undistort_idx, pipeline.undistort_valid
    frames = torch.from_numpy(frames_np[:2].copy())
    reset_launch_counts()
    und = [undistort_image(frames[i].cuda(), idx, ok, normalize=False) for i in (0, 1)]
    norm = undistort_image(frames[0].cuda(), idx, ok)
    k_det = gpu.detect(und[1])
    c = gpu.config
    fast_args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold,
                     nms=c.non_max_suppression, window=c.suppression_window_size, max_keypoints=c.max_keypoints)
    k_fast = detect_keypoints(und[1], **fast_args)
    k_cmp, d_cmp = gpu.compute(und[1], k_det)
    kd, dd = zip(*(gpu.detect_and_compute(u) for u in und))
    matcher = FeatureMatcher(cfg.matcher)
    m = matcher.match(dd[0], dd[1], kd[0], kd[1])
    pts1 = kd[0].xy[m.query_idx.clamp_min(0)]
    pts2 = kd[1].xy[m.train_idx.clamp_min(0)]
    n_valid = int(m.valid.sum())
    draws = torch.from_numpy(np.random.default_rng(5).integers(0, max(n_valid, 1), (cfg.pose.num_hypotheses, 8)))
    pose = PoseEstimator(camera, cfg.pose, device="cuda").estimate(pts1, pts2, m.valid, draws=draws)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches("single", counts, {"fused_frontend_batch": 5, "extract_brief_patches": 3,
                                      "brief_own_bin_dots": 3, "msac_scores": 1, "fused_frontend_nms_batch": 0})
    # card == CPU, and == row 0 of the batch call
    und_c = [undistort_image(frames[i], idx.cpu(), ok.cpu(), normalize=False) for i in (0, 1)]
    batch_und = undistort_batch(frames.cuda(), idx, ok)
    if not all(torch.equal(u.cpu(), c) and torch.equal(u, b) for u, c, b in zip(und, und_c, batch_und)):
        raise AssertionError("undistort_image differs from the CPU or from undistort_batch")
    if not torch.equal(norm.cpu(), undistort_image(frames[0], idx.cpu(), ok.cpu())):
        raise AssertionError("undistort_image (normalised) differs between the card and the CPU")
    same_keypoints("detect card vs CPU", k_det, cpu.detect(und_c[1]), 0.0)
    same_keypoints("detect_keypoints card vs CPU", k_fast, detect_keypoints(und_c[1], **fast_args), 0.0)
    same_keypoints("detect_keypoints vs detect", k_fast, k_det, 0.0)
    kc, dc = cpu.compute(und_c[1], cpu.detect(und_c[1]))
    err = same_keypoints("compute card vs CPU", k_cmp, kc, 1e-3)
    kb_, db_ = gpu.detect_and_compute_batch(torch.stack(und))
    for i in (0, 1):
        same_keypoints("detect_and_compute vs the batch row", kd[i], type(kb_)(*(f[i] for f in kb_)), 0.0)
        if not torch.equal(dd[i], db_[i]):
            raise AssertionError("detect_and_compute differs from the batch row")
    if not (torch.equal(d_cmp.cpu(), dc) and torch.equal(d_cmp, dd[1])):
        raise AssertionError("compute differs from the CPU or from detect_and_compute")
    want_m = match_descriptors(dd[0], dd[1], kd[0].valid, kd[1].valid, kd[0].xy, kd[1].xy,
                               ratio_threshold=cfg.matcher.ratio_test_threshold,
                               max_jump_radius=cfg.matcher.max_jump_radius, use_ratio_test=cfg.matcher.use_ratio_test,
                               filter_matches=cfg.matcher.filter_matches,
                               good_matches_count=cfg.matcher.good_matches_count)
    if not all(torch.equal(a, b) for a, b in zip(m, want_m)):
        raise AssertionError("FeatureMatcher.match differs from match_descriptors")
    pose_c = PoseEstimator(camera, cfg.pose, device="cpu").estimate(pts1.cpu(), pts2.cpu(), m.valid.cpu(), draws=draws)
    if not (bool(pose.success) == bool(pose_c.success) and int(pose.num_inliers) == int(pose_c.num_inliers)
            and torch.equal(pose.inliers.cpu(), pose_c.inliers)):
        raise AssertionError("PoseEstimator: integer fields differ between the card and the CPU")
    r_err = float((pose.R.cpu() - pose_c.R).abs().max())
    t_err = float((pose.t.cpu() - pose_c.t).abs().max())
    if r_err > 1e-4 or t_err > 1e-3:
        raise AssertionError(f"PoseEstimator: R differs by {r_err}, t by {t_err}")
    # kernels 1-4 at the B = 1 shapes the single-image calls and the facade launch
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold, taps=gpu.blur_kernel)
    one = und[1][None]
    shapes = {"fused_frontend_batch": shape_record(
        "fused_frontend_batch (one image)", kf.fused_frontend_batch(one, **args),
        kf.fused_frontend_reference(one, **args), lambda: kf.fused_frontend_batch(one, **args),
        lambda: kf.fused_frontend_reference(one, **args), True, kf.frontend_work(*one.shape), one.shape)}
    blur = kf.fused_frontend_batch(one, **args)[0]
    kps1 = type(k_det)(*(f[None] for f in k_det))
    patches = kb.extract_brief_patches(blur, kps1.xy, c.patch_size)
    shapes["extract_brief_patches"] = shape_record(
        "extract_brief_patches (one image)", (patches,), (kb.extract_brief_patches_reference(blur, kps1.xy, c.patch_size),),
        lambda: kb.extract_brief_patches(blur, kps1.xy, c.patch_size),
        lambda: kb.extract_brief_patches_reference(blur, kps1.xy, c.patch_size), True,
        kb.extract_patches_work(*blur.shape, kps1.xy.shape[1], c.patch_size), patches.shape)
    bins = quantize_angles(orientations_from_patches(patches, gpu.moment_weights, kps1, c.patch_size,
                                                     blur.shape[-2:]), c.brief_quantized_bins)
    shapes["brief_own_bin_dots"] = shape_record(
        "brief_own_bin_dots (one image)", (kb.brief_own_bin_dots(patches, bins, gpu.bin_weights),),
        (kb.brief_own_bin_dots_reference(patches, bins, gpu.bin_weights_3d),),
        lambda: kb.brief_own_bin_dots(patches, bins, gpu.bin_weights),
        lambda: kb.brief_own_bin_dots_reference(patches, bins, gpu.bin_weights_3d), True,
        kb.own_bin_dots_work(bins, gpu.bin_weights), (1, *bins.shape[1:], gpu.bin_weights_3d.shape[-1]))
    x1, x2, v, thr = msac_single_inputs(pipeline, pts1, pts2, m.valid)
    E = torch.from_numpy(np.random.default_rng(6).normal(size=(1, cfg.pose.num_hypotheses, 9)).astype(np.float32)).cuda()
    P = kp.build_msac_operand(x1, x2, v, thr)
    shapes["msac_scores"] = shape_record(
        "msac_scores (one pair)", (kp.msac_scores(E, P),), (kp.msac_scores_reference(E, P),),
        lambda: kp.msac_scores(E, P), lambda: kp.msac_scores_reference(E, P), False,
        kp.msac_work(1, E.shape[1], P.shape[-1] // 5), (1, E.shape[1], P.shape[-1] // 5))
    out = {"launches": counts, "keypoints": int(k_det.count()), "matches": n_valid,
           "inliers": int(pose.num_inliers), "max_angle_diff_deg": err, "pose_R_err": r_err, "pose_t_err": t_err,
           "kernels": shapes}
    log(f"[single] card == CPU == batch row 0: undistort_image, detect ({out['keypoints']} keypoints), "
        f"detect_keypoints, compute, "
        f"detect_and_compute; FeatureMatcher == match_descriptors ({n_valid} matches); PoseEstimator with "
        f"recorded draws {out['inliers']} inliers, R err {r_err:.2e}, t err {t_err:.2e}; launches {counts}")
    return out


def msac_single_inputs(pipeline, pts1: torch.Tensor, pts2: torch.Tensor, valid: torch.Tensor):
    """One pair's normalised matches (1, M, 2), mask and threshold, as ``estimate_relative_pose`` builds them."""
    from tpuslam_torch.common.geometry import normalize_points

    K = pipeline.K
    focal = 0.5 * (K[0, 0] + K[1, 1])
    return (normalize_points(K, pts1[None]), normalize_points(K, pts2[None]), valid[None],
            (pipeline.config.pose.inlier_threshold_px / focal) ** 2)


def phase_vocab_fit(pipeline, frames_np: np.ndarray, card: str) -> dict:
    """Vocabulary.fit on the card against the CPU on the fixture frames' descriptors, flat and a small tree."""
    from tpuslam_torch.backend.vocabulary import Vocabulary

    kps, desc = pipeline.detector.detect_and_compute_batch(torch.from_numpy(frames_np[:10].copy()).cuda())
    docs = [d[v].cpu().numpy() for d, v in zip(desc, kps.valid)]
    out = {"descriptors": int(sum(len(d) for d in docs))}
    for label, kw in (("flat", dict(num_words=256)), ("tree", dict(branching=(16, 16)))):
        seconds = {}
        fits = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            fits[dev] = Vocabulary.fit(docs, device=dev, **kw)
            seconds[dev] = time.perf_counter() - t0
        g, c = fits["cuda"], fits["cpu"]
        if not (g.centroids.is_cuda and torch.equal(g.centroids.cpu(), c.centroids)):
            raise AssertionError(f"vocab-fit ({label}): centroids differ between the card and the CPU")
        if (g.coarse is None) != (c.coarse is None) or (g.coarse is not None and not torch.equal(g.coarse.cpu(), c.coarse)):
            raise AssertionError(f"vocab-fit ({label}): coarse words differ between the card and the CPU")
        idf_err = float((g.idf.cpu() - c.idf).abs().max())
        if idf_err > 1e-6:
            raise AssertionError(f"vocab-fit ({label}): IDF differs by {idf_err}")
        out[label] = {"words": g.num_words, "seconds_card": seconds["cuda"], "seconds_cpu": seconds["cpu"],
                      "idf_err": idf_err}
        log(f"[vocab-fit] {label}: {g.num_words} words from {out['descriptors']} descriptors of 10 frames, card == "
            f"CPU (IDF err {idf_err:.1e}); {seconds['cuda']:.2f} s on the card, {seconds['cpu']:.2f} s on the CPU")
    return out


def phase_profiling(pipeline, chunks: torch.Tensor, valid: torch.Tensor, trace_dir: Path) -> dict:
    """time_fn and StageTimer around one main-path chunk, and device_trace of one chunk: the span
    recorder holds its ``vo.step`` tree and host syncs, and the trace its ``vo.*`` ranges and CUDA kernel
    events naming kernels of the main path."""
    from tpuslam_torch.utils.profiling import RECORDER, StageTimer, device_trace, time_fn

    state = pipeline.initial_state()

    def chunk():
        return pipeline.process_chunk(chunks[0], valid[0], state)[0].poses

    timer = StageTimer()
    for _ in range(2):
        with timer.stage("chunk"):
            chunk()
            torch.cuda.synchronize()
    timed = time_fn(chunk, warmup=1, iters=3)
    RECORDER.clear()
    with device_trace(trace_dir):
        chunk()
    steps = list(RECORDER.steps)
    if [s.name for s in steps] != ["vo.step"] or steps[0].counters.get("vo.host_syncs") is None:
        raise AssertionError(f"the recorder holds {[(s.name, s.counters) for s in steps]}, not one counted vo.step")
    stages = ("vo.upload", "vo.undistort", "vo.detect", "vo.match", "vo.draws", "vo.pose", "vo.triangulate",
              "vo.chain")
    spans_ms = {name: steps[0].total_ns(name) / 1e6 for name in ("vo.step", *stages)}
    path = trace_dir / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    missing = sorted({s.name for s in steps[0].spans} - {e.get("name", "") for e in events})
    if missing:
        raise AssertionError(f"device_trace: the ranges {missing} of the recorded step are not in the trace")
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    ours = sorted(n for n in names if any(k in n for k in ("frontend_kernel", "extract_kernel", "own_bin_kernel",
                                                            "msac_kernel")))
    if not ours:
        raise AssertionError(f"device_trace: no kernel of the main path among {len(names)} kernel names")
    out = {"stage_timer": timer.report(), "time_fn": timed, "trace_bytes": path.stat().st_size,
           "trace_kernel_events": sum(1 for e in events if e.get("cat") == "kernel"), "trace_names": ours,
           "spans_ms": spans_ms, "host_syncs": steps[0].counters["vo.host_syncs"]}
    log(f"[profiling] StageTimer chunk {out['stage_timer']['chunk']['mean_ms']:.2f} ms (2 calls), time_fn "
        f"{timed['per_call_ms']:.2f} ms a chunk (3 calls, synchronised); trace {out['trace_bytes']} bytes, "
        f"{out['trace_kernel_events']} kernel events, naming {ours}; the traced chunk's spans (host ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in spans_ms.items()) + f", host syncs {out['host_syncs']}")
    return out


def count_kernels(fn) -> int | None:
    """Device kernels ``fn()`` launches, from ``torch.profiler`` (None where it records none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def pnp_chunk_inputs(pipeline, frames: torch.Tensor, valid: torch.Tensor, state, seed: int):
    """One chunk's two-view outputs on the card and the tracker's arguments, as process_chunk_pnp
    builds them; the sampler's place (index 6) is left to the caller."""
    from tpuslam_torch.model.slam import PNP_HYPOTHESES

    vo = state.vo
    kps, _, match, mvalid, res, X_prev, X_cur, point_ok = pipeline._two_view_stage(
        frames[None], valid.to(frames.device)[None], [vo], [seed])
    fids = [vo.frame_idx + i for i in range(frames.shape[0])]
    args = (state.map, state.assoc, pipeline.K, vo.pose, fids, valid.to(frames.device), None,
            res.R, res.t, res.success, kps.xy, match.query_idx, match.train_idx, mvalid, X_cur,
            X_prev[..., 2], point_ok)
    kw = dict(pnp_hypotheses=PNP_HYPOTHESES, gate_px=pipeline.config.map.assoc_gate_px,
              min_cand_depth=pipeline.config.map.min_candidate_depth, gn_iters=pipeline.pnp_gn_iters)
    return args, kw, pipeline._pnp_samples(fids, seed)


def check_pnp_card_equals_cpu(args, kw, sampler) -> dict:
    """The tracker on one chunk on the card and on the CPU, the same sample indices fed to both:
    integer fields identical, rotations within 1e-4, positions within 1e-3.

    (Not with ``freeze_map``, localization, off this path: its projection refresh is a
    nearest-landmark argmin whose near-ties the two devices' last-bit differences break either way.)"""
    from tpuslam_torch.model.tracking import pnp_track_chunk

    drawn = {}

    def record(b, valid):
        drawn[b] = sampler(b, valid)
        return drawn[b]

    def replay(b, valid):
        if b not in drawn:
            raise AssertionError(f"[pnp] the CPU tracker asked for samples of frame {b}, the card did not")
        return drawn[b].cpu()

    card_args = list(args)
    card_args[6] = record
    g_res, g_map, g_assoc, _ = pnp_track_chunk(*card_args, **kw)
    cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    cpu_args[0] = type(args[0])(*(x.cpu() for x in args[0]))
    cpu_args[1] = type(args[1])(*(x.cpu() for x in args[1]))
    cpu_args[6] = replay
    c_res, c_map, c_assoc, _ = pnp_track_chunk(*cpu_args, **kw)
    label = "[pnp] card == CPU"
    for name in ("pnp_ok", "num_pnp_inliers", "num_assoc", "used_ransac", "point_count0",
                 "kp_to_point", "kp_birth"):
        g, c = getattr(g_res, name).cpu(), getattr(c_res, name)
        if not torch.equal(g, c):
            raise AssertionError(f"{label}: {name} differs at {int((g != c).sum())} entries")
    for name in ("kf_id", "kf_valid", "point_valid", "point_birth", "obs_mask", "kf_count", "point_count"):
        if not torch.equal(getattr(g_map, name).cpu(), getattr(c_map, name)):
            raise AssertionError(f"{label}: map {name} differs")
    if not torch.equal(g_assoc.kp_to_point.cpu(), c_assoc.kp_to_point):
        raise AssertionError(f"{label}: association differs")
    rot = float((g_res.poses[:, :3, :3].cpu() - c_res.poses[:, :3, :3]).abs().max())
    pos = float((g_res.poses[:, :3, 3].cpu() - c_res.poses[:, :3, 3]).abs().max())
    if rot > 1e-4 or pos > 1e-3:
        raise AssertionError(f"{label}: poses differ by {rot} (rotation), {pos} (position)")
    log(f"{label}: integer fields, map and association identical; rotation diff {rot:.2e}, position diff "
        f"{pos:.2e}; absolute PnP on {int(c_res.pnp_ok.sum())} of {len(args[4])} frames, RANSAC on "
        f"{len(drawn)}")
    return {"rotation_diff": rot, "position_diff": pos, "ransac_frames": len(drawn)}


def phase_pnp(camera, config_dir: Path, chunks: torch.Tensor, valid: torch.Tensor, card: str, uses) -> dict:
    """PnP tracking (``tracking="pnp"``) with ``configs/`` at full width over the 96 frames."""
    from tpuslam_torch.backend.pnp import ransac_pnp
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.model.slam import SlamPipeline
    from tpuslam_torch.model.tracking import pnp_track_chunk, project_associate

    pipe = SlamPipeline(camera, SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH), tracking="pnp",
                        device="cuda")
    n_chunks = chunks.shape[0]
    drive(pipe, chunks, valid, seed=1, pnp=True)  # warm-up
    result, run_s, counts, state = drive(pipe, chunks, valid, seed=0, pnp=True)
    check_launches("pnp", counts, {**{k: n_chunks for k in uses}, "fused_frontend_nms_batch": 0})
    if counts["jacobi_nullvec"] < JACOBI_PER_CHUNK * n_chunks:  # the two-view stage's, and any PnP refit's
        raise AssertionError(f"pnp: jacobi_nullvec launched {counts['jacobi_nullvec']} times, expected at "
                             f"least {JACOBI_PER_CHUNK * n_chunks}")
    fps = check_trajectory("pnp", result, run_s, card)
    # The reference's check (>= 30% of valid points seen in >= 2 keyframes) holds over the points the
    # 8-keyframe window still observes: a recycled keyframe slot takes its observations with it, so
    # after 96 frames most points born early have none left.
    n_obs = state.map.obs_mask.sum(dim=0)[state.map.point_valid].cpu().numpy()
    observed = n_obs[n_obs > 0]
    multi = float((observed >= 2).mean()) if observed.size else 0.0
    absolute = float(result.pnp_absolute_ok.reshape(-1)[1:].float().mean())
    ransac = float(result.pnp_used_ransac.reshape(-1)[1:].float().mean())
    log(f"[pnp] map: point_count {int(state.map.point_count)}, {n_obs.size} valid points, {observed.size} "
        f"observed in the window, {multi:.3f} of these with >= 2 views ({float((n_obs >= 2).mean()):.3f} of "
        f"all valid points); absolute PnP on {absolute:.3f} and the RANSAC fallback on {ransac:.3f} of frames "
        f"1..{N_FRAMES - 1}")
    if observed.size <= 200 or multi < 0.3:
        raise AssertionError(f"[pnp] only {multi:.3f} of {observed.size} observed map points have >= 2 views")

    # One chunk (the second: the map is not empty) in parts: two-view stage, tracker; card == CPU.
    st0 = pipe.initial_pnp_state()
    _, st1 = pipe.process_chunk_pnp(chunks[0], valid[0], st0, seed=0)
    args, kw, sampler = pnp_chunk_inputs(pipe, chunks[1], valid[1], st1, seed=0)
    torch.cuda.synchronize()

    def track():
        return pnp_track_chunk(*args[:6], sampler, *args[7:], **kw)

    t0 = time.perf_counter()
    track()
    torch.cuda.synchronize()
    track_ms = 1e3 * (time.perf_counter() - t0)
    chunk_ms = 1e3 * run_s / n_chunks
    parity = check_pnp_card_equals_cpu(args, kw, sampler)
    k_chunk = count_kernels(lambda: pipe.process_chunk_pnp(chunks[1], valid[1], st1, seed=0))
    k_track = count_kernels(track)
    # The two branch forms: the sync form (kept) runs RANSAC-PnP on the frames that need it; a
    # select form would run it on all 16 frames.  RANSAC-PnP's time a call at the path's shapes:
    # (the map's first M points against the matched pixels of the chunk's frame with most matches)
    m = args[0]
    b = int(torch.argmax(args[13].sum(-1)))
    X = m.points[:args[13].shape[1]]
    uv = args[10][b][torch.clamp_min(args[12][b], 0)]
    ok = args[13][b]
    idx = sampler(b, ok)
    ransac_ms = time_ms(lambda: ransac_pnp(X, uv, ok, pipe.K, idx, num_hypotheses=64, min_inliers=12,
                                           solver_sweeps=8, hyp_sweeps=6, lo_rounds=1, refine="gn"),
                        reps=5, hold=False)
    refresh_ms = time_ms(lambda: project_associate(m, args[3], pipe.K, uv, args[13][b], 0.2, 48.0),
                         reps=5, hold=False)
    rec = {"fps": fps, "chunk_ms": chunk_ms, "tracker_ms_one_chunk": track_ms,
           "tracker_share": track_ms / chunk_ms, "device_kernels_per_chunk": k_chunk,
           "device_kernels_tracker_per_chunk": k_track, "point_count": int(state.map.point_count),
           "multiview_share": multi, "absolute_ok_share": absolute, "used_ransac_share": ransac,
           "ransac_pnp_ms_per_call": ransac_ms, "project_associate_ms_per_call": refresh_ms,
           "card_equals_cpu": parity, "launches": counts}
    log(f"[pnp] {N_FRAMES} frames batch {BATCH}: {fps:.2f} frames/s, {chunk_ms:.2f} ms a chunk; tracker "
        f"{track_ms:.2f} ms of one chunk ({100 * rec['tracker_share']:.1f}%); device kernels a chunk "
        f"{k_chunk if k_chunk else 'not measured'} (tracker {k_track if k_track else 'not measured'}); "
        f"ransac_pnp {ransac_ms:.3f} ms a call (a select form: x16 a chunk), project_associate "
        f"{refresh_ms:.3f} ms a call; kernel launches a chunk "
        f"{ {k: v / n_chunks for k, v in counts.items()} } on {card}")
    return rec


def check_tf32_off() -> None:
    """BA and the map run in full float32: TF32 must be off, as PyTorch leaves it."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the SLAM back end computes in full float32")


def synced_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of ``fn()`` with the card synchronised on either side."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def expected_ba_chunks(pose_ok: np.ndarray, interval: int) -> list[int]:
    """The chunks BA runs on, by the reference's rule: keyframes since the last run reach the interval."""
    kf = pose_ok.reshape(-1, BATCH).copy()
    kf[0, 0] = True  # frame 0 is a keyframe without a pose
    since, chunks = 0, []
    for c, n in enumerate(kf.sum(axis=1)):
        since += int(n)
        if since >= interval:
            chunks.append(c)
            since = 0
    return chunks


def check_ba_card_equals_cpu(label: str, m, K) -> dict:
    """``bundle_adjust`` at the system's settings on the card and on the CPU, on one map."""
    from tpuslam_torch.backend.ba import bundle_adjust

    kw = dict(iterations=4, active_points=512)
    floats = ("kf_R", "kf_t", "points", "obs_uv")
    out = {}
    # (initial cost, final cost, poses): float32's final cost is held to 1%, not 1e-3, for a finding (ROADMAP
    # Queue 3 F5): its LM steps move by far more than an ulp between summation orders (card vs CPU on the
    # second [slam] chunk: final costs 1.31e-3 apart, poses 4.07e-4; H100 80GB HBM3, 700 W); float64 holds
    # the algorithm.
    for dtype, tol in ((torch.float32, (1e-5, 1e-2, 1e-3)), (torch.float64, (1e-8, 1e-8, 1e-8))):
        mg = m._replace(**{k: getattr(m, k).to(dtype) for k in floats})
        mc = type(m)(*(x.cpu() for x in mg))
        g = bundle_adjust(mg, K, **kw)
        c = bundle_adjust(mc, K.cpu(), **kw)
        init = abs(float(g.initial_cost) / float(c.initial_cost) - 1)
        final = abs(float(g.final_cost) / float(c.final_cost) - 1)
        pose = max(float((g.map.kf_R.cpu() - c.map.kf_R).abs().max()), float((g.map.kf_t.cpu() - c.map.kf_t).abs().max()))
        name = str(dtype).replace("torch.", "")
        log(f"[{label}] bundle_adjust card vs CPU, {name}: initial cost {float(g.initial_cost):.6f} / "
            f"{float(c.initial_cost):.6f} (rel {init:.2e}), final {float(g.final_cost):.6f} / "
            f"{float(c.final_cost):.6f} (rel {final:.2e}), poses {pose:.2e}")
        if init > tol[0] or final > tol[1] or pose > tol[2]:
            raise AssertionError(f"[{label}] bundle_adjust on the card differs from the CPU ({name})")
        out[name] = {"initial_rel": init, "final_rel": final, "pose_diff": pose,
                     "card_costs": [float(g.initial_cost), float(g.final_cost)],
                     "cpu_costs": [float(c.initial_cost), float(c.final_cost)]}
    return out


def check_fold_batched_equals_scan(label: str, args: tuple, kw: dict) -> dict:
    """The two map folds on one chunk's inputs on the card: integer fields identical, floats bit for bit."""
    from tpuslam_torch.backend.map import update_map_chunk, update_map_chunk_batched

    mb, ab = update_map_chunk_batched(*args, **kw)
    ms, as_ = update_map_chunk(*args, **kw)
    for got, want in ((mb, ms), (ab, as_)):
        for name, g, w in zip(got._fields, got, want):
            if not torch.equal(g, w):
                diff = float((g.double() - w.double()).abs().max())
                raise AssertionError(f"[{label}] batched fold != scan fold: {name} (max diff {diff})")
    new = int(mb.point_count) - int(args[0].point_count)
    log(f"[{label}] map fold on one chunk's inputs: batched == per-frame scan on the card, integer and bool "
        f"fields identical, floats bit for bit; {new} new points, {int(mb.obs_mask.sum())} observations")
    return {"identical": True, "new_points": new}


def phase_slam(camera, config_dir: Path, frames_np: np.ndarray, card: str, uses, tracking: str,
               main_chunk_ms: float) -> dict:
    """SlamSystem (loop closure off) at the reference's defaults over the 96 frames."""
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.system import SlamSystem

    label = "slam" if tracking == "vo" else "slam-pnp"
    check_tf32_off()
    system = SlamSystem(camera, SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH), vocabulary=None,
                        tracking=tracking, device="cuda")
    n_chunks = N_FRAMES // BATCH
    system.run_sequence(frames_np, seed=1)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = system.run_sequence(frames_np, seed=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(label, counts, {**{k: n_chunks for k in uses}, "fused_frontend_nms_batch": 0})
    poses, pose_ok = out["poses"].astype(np.float64), out["pose_ok"]
    if not np.isfinite(poses).all():
        raise AssertionError(f"[{label}] non-finite poses")
    ok_frac = float(pose_ok[1:].mean())
    if ok_frac < 0.9:
        raise AssertionError(f"[{label}] pose_ok on only {ok_frac:.3f} of frames")
    ran = [e["frame_id"] // BATCH for e in out["ba_events"]]
    want = expected_ba_chunks(pose_ok, system.ba_interval)
    if ran != want or not want or ran != list(range(want[0], n_chunks)):
        raise AssertionError(f"[{label}] BA ran on chunks {ran}, expected every chunk from the first due: {want}")
    ratios = [e["final_cost"] / e["initial_cost"] for e in out["ba_events"]]
    if any(e["final_cost"] > e["initial_cost"] * 1.001 for e in out["ba_events"]):
        raise AssertionError(f"[{label}] a BA run raised the cost: {out['ba_events']}")
    m = out["map"]
    n_obs = m.obs_mask.sum(dim=0)[m.point_valid].cpu().numpy()
    observed = n_obs[n_obs > 0]
    multi = float((observed >= 2).mean()) if observed.size else 0.0
    if observed.size <= 100 or multi < 0.5:
        raise AssertionError(f"[{label}] only {multi:.3f} of {observed.size} observed points have >= 2 views")
    fps = N_FRAMES / run_s
    chunk_ms = 1e3 * run_s / n_chunks
    log(f"[{label}] {N_FRAMES} frames batch {BATCH}: {fps:.2f} frames/s, {chunk_ms:.2f} ms a chunk (main path "
        f"{main_chunk_ms:.2f} ms in this call); pose_ok {ok_frac:.3f}; BA on chunks {ran}, cost ratios "
        f"{[round(r, 4) for r in ratios]}; point_count {int(m.point_count)}, {observed.size} points observed in "
        f"the window, {multi:.3f} with >= 2 views; z at frame 95 {poses[-1, 2, 3]:.3f} on {card}")

    # One chunk (the second) in parts, from the state after the first.
    dev = system.device
    frames = torch.from_numpy(frames_np).to(dev).reshape(n_chunks, BATCH, *frames_np.shape[1:])
    valid = torch.ones((n_chunks, BATCH), dtype=torch.bool)
    carry, _ = system._step(system.initial_carry(), frames[0], valid[0], 0)
    rec = {"fps": fps, "chunk_ms": chunk_ms, "main_chunk_ms": main_chunk_ms, "pose_ok_share": ok_frac,
           "ba_chunks": ran, "ba_cost_ratios": ratios, "ba_events": out["ba_events"],
           "point_count": int(m.point_count), "observed_points": int(observed.size), "multiview_share": multi,
           "launches": counts}
    K = system._K
    if tracking == "vo":
        vo, m0, a0, _, _ = carry
        result, _ = system.pipeline.process_chunk(frames[1], valid[1], vo, 0)
        fids = vo.frame_idx + torch.arange(BATCH, dtype=torch.int32, device=dev)
        args = (m0, a0, K, fids, torch.ones(BATCH, dtype=torch.bool, device=dev), result.poses,
                result.pose_ok, result.kps_xy, result.m_query, result.m_train, result.m_valid,
                result.points3d, result.point_ok)
        kw = dict(gate_px=system.config.map.assoc_gate_px, min_cand_depth=system.config.map.min_candidate_depth)
        from tpuslam_torch.backend.map import update_map_chunk, update_map_chunk_batched

        rec["fold_check"] = check_fold_batched_equals_scan(label, args, kw)
        rec["fold_ms"] = synced_ms(lambda: update_map_chunk_batched(*args, **kw))
        rec["fold_scan_ms"] = synced_ms(lambda: update_map_chunk(*args, **kw))
        rec["fold_device_kernels"] = count_kernels(lambda: update_map_chunk_batched(*args, **kw))
        ba_map = update_map_chunk_batched(*args, **kw)[0]
    else:
        ba_map = carry[0].map
    rec["ba_card_vs_cpu"] = check_ba_card_equals_cpu(label, ba_map, K)
    rec["ba_ms"] = synced_ms(lambda: system._bundle_adjust(ba_map))
    rec["ba_device_kernels"] = count_kernels(lambda: system._bundle_adjust(ba_map))
    rec["step_ms"] = synced_ms(lambda: system._step(carry, frames[1], valid[1], 0), reps=3)
    rec["device_kernels_per_chunk"] = count_kernels(lambda: system._step(carry, frames[1], valid[1], 0))
    rec["ba_share"] = rec["ba_ms"] / rec["step_ms"]
    rec["fold_share"] = rec.get("fold_ms", 0.0) / rec["step_ms"]
    log(f"[{label}] one chunk synchronised {rec['step_ms']:.2f} ms: BA {rec['ba_ms']:.3f} ms a call "
        f"({100 * rec['ba_share']:.1f}%, {rec['ba_device_kernels']} device kernels)"
        + (f", map fold {rec['fold_ms']:.3f} ms ({100 * rec['fold_share']:.1f}%, {rec['fold_device_kernels']} "
           f"device kernels; the per-frame scan {rec['fold_scan_ms']:.3f} ms)" if tracking == "vo" else "")
        + f"; device kernels a chunk {rec['device_kernels_per_chunk']} on {card}")
    return rec



def msac_reloc_shape(pipeline, blur: torch.Tensor, kps) -> dict:
    """Kernel 4 at relocalization's shape: 2 pairs x 1024 five-point samples x 10 candidates against
    1024 matches, on the main path's matches; masked candidates hold NaN (the first of each pair is
    set so).  The unmasked rows against the twin at rtol 1e-5, then times and the bound."""
    from tpuslam_torch.frontend.fivepoint import fivepoint_essential
    from tpuslam_torch.frontend.pose import draw_ranks
    from tpuslam_torch.kernels import pose as kp

    x1, x2, valid, thr = msac_inputs(pipeline, blur, kps, operand=False)
    x1, x2, valid = x1[:2], x2[:2], valid[:2]
    gen = torch.Generator(device=blur.device).manual_seed(3)
    ranks = draw_ranks(valid.sum(-1), 1024, 5, gen)
    rank_to_idx = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    idx = torch.gather(rank_to_idx, 1, ranks.reshape(2, -1))[..., None].expand(-1, -1, 2)
    E, ok = fivepoint_essential(torch.gather(x1, 1, idx).reshape(2, 1024, 5, 2),
                                torch.gather(x2, 1, idx).reshape(2, 1024, 5, 2))
    E = E.reshape(2, 10240, 9).contiguous()
    ok = ok.reshape(2, 10240).clone()
    E[:, 0] = torch.nan
    ok[:, 0] = False
    n_nan = int((~torch.isfinite(E).all(-1)).sum())
    P = kp.build_msac_operand(x1, x2, valid, thr)
    got = kp.msac_scores(E, P)
    want = kp.msac_scores_reference(E, P)
    err = require_msac_close("msac_scores at relocalization's shape (unmasked rows)", got[ok], want[ok])
    if not torch.isfinite(got[ok]).all():
        raise AssertionError("msac_scores: a NaN row reached an unmasked one")
    work = kp.msac_work(2, 10240, P.shape[-1] // 5)
    rec = {"shape": [2, 10240, P.shape[-1] // 5], "max_abs_err": err, "valid_candidates": int(ok.sum()),
           "nan_rows": n_nan, "ms": time_ms(lambda: kp.msac_scores(E, P)),
           "plain_ms": time_ms(lambda: kp.msac_scores_reference(E, P), reps=5),
           "bound_ms": work.bound_us() / 1e3, "bound_by": work.bound_by()}
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"[kernels] msac_scores at relocalization's shape {tuple(rec['shape'])}: {rec['valid_candidates']} "
        f"valid candidates, {n_nan} NaN rows masked after the kernel; unmasked rows within rtol {RTOL_MSAC} "
        f"(max_abs_err {err}); kernel {rec['ms']:.4f} ms, twin {rec['plain_ms']:.4f} ms, bound "
        f"{1e3 * rec['bound_ms']:.2f} us ({rec['bound_by']}), {100 * rec['bound_share']:.1f}% of bound")
    return rec


def count_syncs(fn):
    """(result, host syncs ``fn`` made, {"file:line": count}): the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``, each put at the innermost line of this
    repository on the Python stack when it was raised."""
    import collections
    import traceback
    import warnings

    where = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):  # not the mode switch's own notice
            ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(str(REPO))]
            site = ours[-1] if ours else traceback.FrameSummary(filename, lineno, "")
            where[f"{Path(site.filename).name}:{site.lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(where.values()), dict(where)


def svd_site() -> str:
    """"pose.py:<line>" of the port's one ``torch.linalg.svd`` call, which syncs on the card."""
    import inspect

    from tpuslam_torch.frontend import pose

    lines, start = inspect.getsourcelines(pose._svd)
    return f"pose.py:{start + next(i for i, line in enumerate(lines) if 'torch.linalg.svd' in line)}"


def require_one_read(label: str, stage: str, sync_at: dict, allowed: str | None = None) -> None:
    """The stage syncs with the host once (its predicate read), besides ``allowed`` sites."""
    other = {k: v for k, v in sync_at.items() if k != allowed}
    if sum(other.values()) != 1:
        raise AssertionError(f"[{label}] {stage}: host syncs beyond its one read: {sync_at}")


def to_cpu(x):
    """A tensor, or a named tuple of tensors (None fields kept), on the CPU."""
    if torch.is_tensor(x):
        return x.cpu()
    return type(x)(*(None if f is None else f.cpu() for f in x))


def recorder(store: dict, draw):
    """A draw hook of ``SlamSystem`` (lc_draw_fn / reloc_draw_fn) that keeps what it draws by frame."""
    def hook(frame_idx, *args):
        store[frame_idx] = draw(frame_idx, *args)
        return store[frame_idx]
    return hook


def replayer(store: dict):
    def hook(frame_idx, *args):
        if frame_idx not in store:
            raise AssertionError(f"the CPU asked for draws of frame {frame_idx}, the card did not")
        got = store[frame_idx]
        return tuple(x.cpu() for x in got) if isinstance(got, tuple) else got.cpu()
    return hook


def lc_draw(frame_idx, valid):
    from tpuslam_torch.backend.pnp import gumbel_sample_indices

    gen = torch.Generator(device=valid.device).manual_seed(10_000 + frame_idx)
    return gumbel_sample_indices(valid, 512, 6, gen)


def reloc_draw(frame_idx, pnp_valid, n_valid):
    from tpuslam_torch.backend.pnp import gumbel_sample_indices
    from tpuslam_torch.frontend.pose import draw_ranks

    gen = torch.Generator(device=pnp_valid.device).manual_seed(20_000 + frame_idx)
    samples = gumbel_sample_indices(pnp_valid, 512, 6, gen)
    return samples, draw_ranks(torch.tensor([n_valid], device=pnp_valid.device), 1024, 5, gen)[0]


def check_lc_card_equals_cpu(label, system, cpu_system, db, fids, kf_enabled, result, m) -> dict:
    """``_lc_chunk`` (mp from the chunk, process_chunk) on the card and on the CPU, the same samples."""
    store = {}
    system.lc_draw_fn, cpu_system.lc_draw_fn = recorder(store, lc_draw), replayer(store)
    fids_d = torch.tensor(fids, dtype=torch.int32, device="cuda")
    try:
        g_db, g_res = system._lc_chunk(db, fids_d, fids, kf_enabled, result, 0, m=m)
        c_db, c_res = cpu_system._lc_chunk(to_cpu(db), fids_d.cpu(), fids, kf_enabled.cpu(), to_cpu(result), 0,
                                           m=None if m is None else to_cpu(m))
    finally:
        system.lc_draw_fn = cpu_system.lc_draw_fn = None
    # host syncs of the stage as the system runs it (its own draws)
    _, syncs, sync_at = count_syncs(lambda: system._lc_chunk(db, fids_d, fids, kf_enabled, result, 0, m=m))
    for name in ("success", "candidate_id", "matched_keyframe_id", "num_inliers"):
        if not torch.equal(getattr(g_res, name).cpu(), getattr(c_res, name)):
            raise AssertionError(f"[{label}] process_chunk on the card != CPU: {name}")
    T, Tc = g_res.relative_transform.cpu(), c_res.relative_transform
    rot = float((T[:, :3, :3] - Tc[:, :3, :3]).abs().max())
    pos = float((T[:, :3, 3] - Tc[:, :3, 3]).abs().max())
    bow = float((g_db.bow.cpu() - c_db.bow).abs().max())
    if rot > 1e-4 or pos > 1e-3 or bow > 1e-6:
        raise AssertionError(f"[{label}] process_chunk on the card != CPU: R {rot}, t {pos}, bow {bow}")
    for name, g, c in zip(g_db._fields, g_db, c_db):
        if name not in ("bow", "map_points", "pose") and not torch.equal(g.cpu(), c):
            raise AssertionError(f"[{label}] process_chunk on the card != CPU: DB {name}")
    require_one_read(label, "the loop-closure stage", sync_at)
    n_cand = int((g_res.candidate_id >= 0).sum())
    log(f"[{label}] process_chunk card == CPU on a full-width chunk: {n_cand} candidates, "
        f"{int(g_res.success.sum())} verified (integer fields and DB identical; R {rot:.2e}, t {pos:.2e}, bow "
        f"{bow:.2e}); {syncs} host sync(s) in the loop-closure stage, at {sync_at}")
    return {"candidates": n_cand, "verified": int(g_res.success.sum()), "rotation_diff": rot,
            "position_diff": pos, "bow_diff": bow, "host_syncs": syncs, "host_syncs_at": sync_at}


def check_reloc_card_equals_cpu(label, system, cpu_system, db, result, valid, fids, m,
                                what: str = "a chunk with two noise-blinded frames") -> dict:
    """Relocalization of a chunk with lost frames on the card and on the CPU, the same draws."""
    store = {}
    system.reloc_draw_fn, cpu_system.reloc_draw_fn = recorder(store, reloc_draw), replayer(store)
    fids_d = torch.tensor(fids, dtype=torch.int32, device="cuda")
    try:
        if m is None:
            g_res, g_M, g_ok = system._reloc_chunk(db, result, valid, fids_d, fids, 0)
            c_res, c_M, c_ok = cpu_system._reloc_chunk(to_cpu(db), to_cpu(result), valid.cpu(), fids_d.cpu(), fids, 0)
        else:
            g_res, g_m, g_M, g_ok = system._reloc_chunk_pnp(db, result, m, valid, fids_d, fids, 0)
            c_res, c_m, c_M, c_ok = cpu_system._reloc_chunk_pnp(to_cpu(db), to_cpu(result), to_cpu(m), valid.cpu(),
                                                               fids_d.cpu(), fids, 0)
    finally:
        system.reloc_draw_fn = cpu_system.reloc_draw_fn = None
    # host syncs of relocalization as the system runs it (its own draws)
    if m is None:
        _, syncs, sync_at = count_syncs(lambda: system._reloc_chunk(db, result, valid, fids_d, fids, 0))
    else:
        _, syncs, sync_at = count_syncs(lambda: system._reloc_chunk_pnp(db, result, m, valid, fids_d, fids, 0))
    if not torch.equal(g_ok.cpu(), c_ok) or not torch.equal(g_res.pose_ok.cpu(), c_res.pose_ok):
        raise AssertionError(f"[{label}] relocalization on the card != CPU: {g_ok.tolist()} vs {c_ok.tolist()}")
    P, Pc = g_res.poses.cpu(), c_res.poses
    rot = float((P[:, :3, :3] - Pc[:, :3, :3]).abs().max())
    pos = float((P[:, :3, 3] - Pc[:, :3, 3]).abs().max())
    if m is not None:
        pos = max(pos, float((g_m.points.cpu() - c_m.points).abs().max()) / 10, float((g_m.kf_t.cpu() - c_m.kf_t).abs().max()))
    if rot > 1e-4 or pos > 1e-3:
        raise AssertionError(f"[{label}] relocalization on the card != CPU: rotation {rot}, position {pos}")
    require_one_read(label, "relocalization", sync_at, allowed=svd_site())
    need = int((valid & ~result.pose_ok).sum())
    log(f"[{label}] relocalization card == CPU on {what}: {need} frames lost, "
        f"{int(g_ok.sum())} rescued (frames {torch.nonzero(g_ok).flatten().tolist()}); rotation diff {rot:.2e}, "
        f"position diff {pos:.2e}; {syncs} host sync(s), at {sync_at}")
    return {"lost": need, "rescued": int(g_ok.sum()), "rotation_diff": rot, "position_diff": pos,
            "host_syncs": syncs, "host_syncs_at": sync_at}


def drift_graph(n: int, dtype=torch.float32):
    """A circle of ``n`` poses integrated with a 2% drift and one loop edge (n - 1 to 0, weight 20)."""
    from tpuslam_torch.backend import pose_graph as tpg
    from tpuslam_torch.common.geometry import so3_exp

    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = 2 * np.pi * i / n
        gt[i, :3, :3] = so3_exp(torch.tensor([0.0, a + np.pi / 2, 0.0], dtype=torch.float64)).numpy()
        gt[i, :3, 3] = [10.0 * np.cos(a), 0.0, 10.0 * np.sin(a)]
    est = [gt[0]]
    for i in range(1, n):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        rel[:3, :3] = so3_exp(torch.from_numpy(rng.normal(size=3) * 0.01)).numpy() @ rel[:3, :3]
        rel[:3, 3] *= 1.02
        est.append(est[-1] @ rel)
    g = tpg.graph_from_trajectory(torch.from_numpy(np.stack(est)))
    g = tpg.add_edge(g, n - 1, 0, n - 1, torch.from_numpy(np.linalg.inv(gt[0]) @ gt[n - 1]), weight=20.0)
    return g._replace(nodes=g.nodes.to(dtype), edge_T=g.edge_T.to(dtype), edge_weight=g.edge_weight.to(dtype))


def check_pose_graph_pcg() -> dict:
    """The pose graph's PCG (N 300 > 256) on the card against the CPU, float32 and float64."""
    from tpuslam_torch.backend import pose_graph as tpg

    out = {}
    for dtype, tol in ((torch.float32, 1e-3), (torch.float64, 1e-6)):
        g = drift_graph(300, dtype)
        gg = tpg.PoseGraph(*(x.cuda() for x in g))
        want = tpg.optimize_pose_graph(g, iterations=12)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tpg.optimize_pose_graph(gg, iterations=12)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        diff = float((got.nodes.cpu() - want.nodes).abs().max())
        before = float((torch.linalg.inv(g.nodes[0]) @ g.nodes[-1] - g.edge_T[299])[:3, 3].norm())
        after = float((torch.linalg.inv(want.nodes[0]) @ want.nodes[-1] - g.edge_T[299])[:3, 3].norm())
        name = str(dtype).replace("torch.", "")
        log(f"[pose-graph] PCG on a 300-node drift graph, {name}: card vs CPU max diff {diff:.2e} (held at {tol}); "
            f"loop gap {before:.3f} -> {after:.4f}; {ms:.1f} ms for 12 GN steps on the card (one call)")
        if diff > tol or after > 0.05 * before:
            raise AssertionError(f"[pose-graph] PCG on the card differs from the CPU ({name}): {diff}")
        out[name] = {"card_vs_cpu": diff, "loop_gap": [before, after], "ms": ms}
    return out


def phase_slam_lc(camera, config_dir: Path, frames_np: np.ndarray, card: str, uses, tracking: str,
                  main_chunk_ms: float) -> dict:
    """SlamSystem with loop closure at the reference's defaults over the 96 frames."""
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.backend.pose_graph import optimize_pose_graph
    from tpuslam_torch.model.system import SlamSystem

    label = "slam-lc" if tracking == "vo" else "slam-lc-pnp"
    check_tf32_off()
    cfg = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    vocab = config_dir / "vocabulary_tree.npz"
    system = SlamSystem(camera, cfg, vocabulary=vocab, tracking=tracking, device="cuda")
    n_chunks = N_FRAMES // BATCH
    with RansacRecorder(system.loop_closure) as ransacs:
        system.run_sequence(frames_np, seed=1)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = system.run_sequence(frames_np, seed=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(label, counts, {**{k: n_chunks for k in uses}, "fused_frontend_nms_batch": 0})
    poses, pose_ok = out["poses"].astype(np.float64), out["pose_ok"]
    if not np.isfinite(poses).all():
        raise AssertionError(f"[{label}] non-finite poses")
    ok_frac = float(pose_ok[1:].mean())
    if ok_frac < 0.9:
        raise AssertionError(f"[{label}] pose_ok on only {ok_frac:.3f} of frames")
    loops = out["loops"]
    if not loops or not out["pose_graph_applied"]:
        raise AssertionError(f"[{label}] {len(loops)} verified loops, pose graph applied {out['pose_graph_applied']}")
    fps = N_FRAMES / run_s
    chunk_ms = 1e3 * run_s / n_chunks
    db = out["db"]
    log(f"[{label}] {N_FRAMES} frames batch {BATCH}: {fps:.2f} frames/s, {chunk_ms:.2f} ms a chunk (main path "
        f"{main_chunk_ms:.2f} ms in this call); pose_ok {ok_frac:.3f}; {len(loops)} verified loops "
        f"(first {[(lp['frame_id'], lp['matched_keyframe_id'], lp['num_inliers']) for lp in loops[:6]]}), pose graph "
        f"applied; reloc_ok on {int(out['reloc_ok'].sum())} frames; DB {int(db.count)} keyframes; BA on "
        f"{len(out['ba_events'])} chunks; z at frame 95 {poses[-1, 2, 3]:.3f} on {card}")
    rec = {"fps": fps, "chunk_ms": chunk_ms, "main_chunk_ms": main_chunk_ms, "pose_ok_share": ok_frac,
           "loops": len(loops), "loop_pairs": [[lp["frame_id"], lp["matched_keyframe_id"]] for lp in loops],
           "reloc_frames": int(out["reloc_ok"].sum()), "db_count": int(db.count), "launches": counts}
    rec["verify_ab"] = verify_ab(label, system.loop_closure, ransacs.args, card)

    # One chunk in parts from the state after the first: tracking, then the loop-closure stage; the
    # second chunk revisits the first's places, so it has candidates.
    frames = torch.from_numpy(frames_np).cuda().reshape(n_chunks, BATCH, *frames_np.shape[1:])
    valid = torch.ones((n_chunks, BATCH), dtype=torch.bool)
    carry, _ = system._step(system.initial_carry(), frames[0], valid[0], 0)
    cpu_system = SlamSystem(camera, cfg, vocabulary=vocab, tracking=tracking, device="cpu")
    fids = list(range(BATCH, 2 * BATCH))
    fids_d = torch.tensor(fids, dtype=torch.int32, device="cuda")
    valid_d = valid[1].cuda()

    def track(chunk):
        if tracking == "vo":
            res, _ = system.pipeline.process_chunk(chunk, valid[1], carry[0], 0)
            return res, None, carry[3]
        res, st2 = system.pipeline.process_chunk_pnp(chunk, valid[1], carry[0], 0)
        return res, st2.map, carry[1]

    result, m, db = track(frames[1])
    kf_enabled = valid_d & (result.pose_ok | (fids_d == 0))
    rec["lc_card_vs_cpu"] = check_lc_card_equals_cpu(label, system, cpu_system, db, fids, kf_enabled, result, m)
    rec["lc_stage_ms"] = synced_ms(lambda: system._lc_chunk(db, fids_d, fids, kf_enabled, result, 0, m=m))
    rec["lc_stage_device_kernels"] = count_kernels(lambda: system._lc_chunk(db, fids_d, fids, kf_enabled, result, 0, m=m))
    rec["step_ms"] = synced_ms(lambda: system._step(carry, frames[1], valid[1], 0), reps=3)
    rec["device_kernels_per_chunk"] = count_kernels(lambda: system._step(carry, frames[1], valid[1], 0))

    # Relocalization: the same chunk with two frames blinded by noise.
    rng = np.random.default_rng(5)
    blind = frames[1].clone()
    for b in (BATCH // 4, BATCH // 4 + 1):  # frames 20 and 21
        blind[b] = torch.from_numpy(rng.integers(0, 256, blind.shape[1:], dtype=np.uint8)).cuda()
    b_result, b_m, _ = track(blind)
    rec["reloc_card_vs_cpu"] = check_reloc_card_equals_cpu(label, system, cpu_system, db, b_result, valid_d, fids, b_m)
    if tracking == "vo":
        rec["reloc_ms"] = synced_ms(lambda: system._reloc_chunk(db, b_result, valid_d, fids_d, fids, 0), reps=3)
    else:
        rec["reloc_ms"] = synced_ms(lambda: system._reloc_chunk_pnp(db, b_result, b_m, valid_d, fids_d, fids, 0),
                                    reps=3)

    # The pose graph on the run's keyframes (one node a keyframe: 96) and its loop edges.
    kf_fids = [f for f in range(N_FRAMES) if pose_ok[f] or f == 0]
    g = system._loop_graph(out["poses"], kf_fids, loops)
    rec["pose_graph_nodes"] = len(kf_fids)
    rec["pose_graph_ms"] = synced_ms(lambda: optimize_pose_graph(g, iterations=12), reps=3)
    rec["lc_share"] = rec["lc_stage_ms"] / rec["step_ms"]
    log(f"[{label}] one chunk synchronised {rec['step_ms']:.2f} ms: loop-closure stage {rec['lc_stage_ms']:.2f} ms "
        f"({100 * rec['lc_share']:.1f}%, {rec['lc_stage_device_kernels']} device kernels); relocalization "
        f"{rec['reloc_ms']:.2f} ms when it fires; device kernels a chunk {rec['device_kernels_per_chunk']}; "
        f"optimize_pose_graph {rec['pose_graph_ms']:.2f} ms at N = {len(kf_fids)} (12 GN steps, dense) on {card}")
    return rec


def host_batches(frames_np: np.ndarray, start: int = 0, stop: int | None = None):
    """Chunks of frames[start:stop] shaped as ``FrameStream.batches`` yields them: host numpy, the last
    padded by repeating its last frame, ``valid`` marking the real ones."""
    stop = len(frames_np) if stop is None else stop
    for s in range(start, stop, BATCH):
        blk = frames_np[s:min(s + BATCH, stop)]
        nb = len(blk)
        if nb < BATCH:
            blk = np.concatenate([blk, np.repeat(blk[-1:], BATCH - nb, 0)])
        yield blk, np.arange(s, s + BATCH, dtype=np.float64), np.arange(BATCH) < nb


def prefetch_ms(frames_np: np.ndarray, chunk_ms: float) -> dict:
    """Host-to-device time a chunk: a synchronous copy from pageable memory, against what
    ``device_prefetch`` leaves exposed when each chunk is followed by ``chunk_ms`` of device work."""
    from tpuslam_torch.pre.stream import device_prefetch

    chunks = list(host_batches(frames_np))
    sync_ms = []
    for f, _, _ in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_dev = torch.from_numpy(f).to("cuda")
        torch.cuda.synchronize()
        sync_ms.append(1e3 * (time.perf_counter() - t0))
    del f_dev
    cycles = int(chunk_ms * SLEEP_CYCLES)  # SLEEP_CYCLES is ~1 ms of card time

    def consume(it) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f, _, _ in it:
            torch.cuda._sleep(cycles)  # a chunk's work on the consumer's stream
            f.view(-1)[:1].add_(0)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    staged = [(torch.from_numpy(f).cuda(), s, v) for f, s, v in chunks]
    torch.cuda.synchronize()
    work = min(consume(iter(staged)) for _ in range(2))
    with_prefetch = min(consume(device_prefetch(iter(chunks), "cuda")) for _ in range(2))
    without = min(consume((torch.from_numpy(f).to("cuda"), s, v) for f, s, v in chunks) for _ in range(2))
    n = len(chunks)
    return {"sync_copy_ms": float(np.median(sync_ms)), "work_ms_per_chunk": work / n,
            "exposed_ms_with_prefetch": (with_prefetch - work) / n, "exposed_ms_without": (without - work) / n,
            "chunk_mb": chunks[0][0].nbytes / 2**20}


def ba_folded(ckpt: dict, system) -> np.ndarray:
    """A run's raw trajectory with its BA snapshots folded in, in the map's world frame (no pose graph)."""
    poses = np.asarray(ckpt["raw_poses"])
    for e in range(len(ckpt["ba_frame"])):
        poses = system._apply_ba_snapshot({k: np.asarray(ckpt[f"ba_{k}"][e]) for k in ("kf_id", "kf_valid", "kf_R",
                                                                                        "kf_t")}, poses)
    return poses


def tree_leaves(tree) -> list:
    from tpuslam_torch.utils.checkpoint import flatten

    return [x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in flatten(tree)]


def phase_stream(camera, config_dir: Path, frames_np: np.ndarray, card: str, uses, tracking: str,
                 ckpt_dir: Path) -> dict:
    """``SlamSystem.run`` over host chunks through ``device_prefetch``; split through a checkpoint file."""
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.system import SlamSystem
    from tpuslam_torch.utils.checkpoint import load_state, save_state

    label = "stream" if tracking == "vo" else "stream-pnp"
    cfg = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    system = SlamSystem(camera, cfg, vocabulary=config_dir / "vocabulary_tree.npz", tracking=tracking, device="cuda")
    n_chunks = N_FRAMES // BATCH
    system.run(host_batches(frames_np), seed=1)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = system.run(host_batches(frames_np), seed=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(label, counts, {**{k: n_chunks for k in uses}, "fused_frontend_nms_batch": 0})
    poses, pose_ok, loops = out["poses"], out["pose_ok"], out["loops"]
    ok_frac = float(pose_ok[1:].mean())
    if not np.isfinite(poses).all() or poses.shape != (N_FRAMES, 4, 4):
        raise AssertionError(f"[{label}] poses of shape {poses.shape}, finite {np.isfinite(poses).all()}")
    if ok_frac < 0.9 or not loops or not out["pose_graph_applied"]:
        raise AssertionError(f"[{label}] pose_ok {ok_frac:.3f}, {len(loops)} loops, pose graph "
                             f"{out['pose_graph_applied']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.run_sequence(frames_np, seed=0)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    fps, seq_fps = N_FRAMES / run_s, N_FRAMES / seq_s
    log(f"[{label}] run() {N_FRAMES} frames batch {BATCH} through device_prefetch: {fps:.2f} frames/s "
        f"(run_sequence {seq_fps:.2f} in this call); pose_ok {ok_frac:.3f}; {len(loops)} verified loops, pose graph "
        f"applied; {int(out['reloc_ok'].sum())} relocalized; BA at frames {[e['frame_id'] for e in out['ba_events']]} "
        f"on {card}")

    # split after frame 48: a checkpoint file, loaded onto the card, and run(resume=...)
    first = system.run(host_batches(frames_np, 0, N_FRAMES // 2), seed=0)
    path = ckpt_dir / f"{label}-half.npz"
    save_state(path, slam=first["checkpoint"])
    resume = load_state(path, device="cuda", slam=system.checkpoint_template())["slam"]
    split = system.run(host_batches(frames_np, N_FRAMES // 2), seed=0, resume=resume)
    ck, sk = out["checkpoint"], split["checkpoint"]
    for name in ("pose_ok", "reloc_ok", "num_matches", "num_inliers"):
        if not np.array_equal(out[name], split[name]):
            raise AssertionError(f"[{label}] split run != single run: {name}")
    if [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in loops] != \
            [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in split["loops"]]:
        raise AssertionError(f"[{label}] split run != single run: loops")
    for name in ("kf_fids", "counters", "raw_poses", "ba_frame", "loops_frame", "loops_matched", "loops_ninl"):
        if not np.array_equal(ck[name], sk[name]):
            raise AssertionError(f"[{label}] split run != single run: checkpoint {name}")
    for name, fields in (("world_map", ("kf_id", "kf_valid", "point_valid", "point_birth", "obs_mask", "kf_count",
                                        "point_count")), ("db", ("ids", "count", "last_id", "kp_valid", "mp_valid"))):
        for f in fields:
            if not torch.equal(getattr(ck[name], f), getattr(sk[name], f)):
                raise AssertionError(f"[{label}] split run != single run: {name}.{f}")
    leaves_equal = all(np.array_equal(a, b) for a, b in zip(tree_leaves(ck), tree_leaves(sk)))
    final_equal = bool(np.array_equal(out["poses"], split["poses"]))
    rec = {"fps": fps, "run_sequence_fps": seq_fps, "pose_ok_share": ok_frac, "loops": len(loops),
           "reloc_frames": int(out["reloc_ok"].sum()), "ba_events": len(out["ba_events"]), "launches": counts,
           "split_raw_poses_identical": True, "split_checkpoint_identical": leaves_equal,
           "split_final_poses_identical": final_equal}
    if not final_equal:
        # which op: the pose graph fold run twice on the same inputs
        graph = [system._apply_pose_graph(ba_folded(ck, system), [int(f) for f in ck["kf_fids"]], loops)
                 for _ in range(2)]
        rot = float(np.abs(out["poses"][:, :3, :3] - split["poses"][:, :3, :3]).max())
        pos = float(np.abs(out["poses"][:, :3, 3] - split["poses"][:, :3, 3]).max())
        rec.update(split_final_rot_diff=rot, split_final_pos_diff=pos,
                   pose_graph_twice_identical=bool(np.array_equal(*graph)))
        log(f"[{label}] final poses of the split run differ from the single run's: R {rot:.2e}, t {pos:.2e}; "
            f"the pose graph fold twice on the same inputs identical: {rec['pose_graph_twice_identical']}")
        if rot > 1e-4 or pos > 1e-3:
            raise AssertionError(f"[{label}] split run's final poses differ: R {rot}, t {pos}")
    log(f"[{label}] split after frame {N_FRAMES // 2} through {path.name} (load_state on the card): integer fields, "
        f"loops, keyframes, counters, map and DB ids identical; raw trajectory bit-equal; final poses bit-equal "
        f"{final_equal}; every checkpoint leaf bit-equal {leaves_equal}")
    if tracking == "pnp":
        rec["checkpoint_path"] = ckpt_dir / "stream-pnp.npz"
        save_state(rec["checkpoint_path"], slam=ck)
        rec["mapping_poses"] = ba_folded(ck, system)
    rec["prefetch"] = prefetch_ms(frames_np, 1e3 * run_s / n_chunks)
    p = rec["prefetch"]
    log(f"[{label}] host to device a {p['chunk_mb']:.2f} MB chunk: synchronous copy from pageable memory "
        f"{p['sync_copy_ms']:.3f} ms; with {p['work_ms_per_chunk']:.2f} ms of device work a chunk the copy leaves "
        f"{p['exposed_ms_without']:.3f} ms a chunk exposed without prefetch, {p['exposed_ms_with_prefetch']:.3f} ms "
        f"with device_prefetch")
    return rec


def phase_localize(camera, config_dir: Path, frames_np: np.ndarray, card: str, uses, stream_pnp: dict) -> dict:
    """Localization against the frozen map and DB of the ``[stream-pnp]`` run, loaded from its file."""
    import tpuslam_torch.frontend.pose as fpose
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.system import SlamSystem
    from tpuslam_torch.utils.checkpoint import load_state

    label = "localize"
    cfg = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    kw = dict(vocabulary=config_dir / "vocabulary_tree.npz", tracking="pnp", localization_only=True,
              enable_pose_graph=False)
    system = SlamSystem(camera, cfg, device="cuda", **kw)
    loaded = load_state(stream_pnp["checkpoint_path"], device="cuda", slam=system.checkpoint_template())["slam"]
    warm = {"map": loaded["world_map"], "db": loaded["db"]}
    frozen = tree_leaves((loaded["world_map"], loaded["db"]))
    mapping = stream_pnp["mapping_poses"]
    n_chunks = N_FRAMES // BATCH

    def localize(start: int, stop: int, seed: int):
        frames = frames_np if stop <= N_FRAMES else load_frames(stop)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = system.run(host_batches(frames, start, stop), seed=seed, warm_start=warm)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mem = {"peak": torch.cuda.max_memory_allocated(), "kept": torch.cuda.memory_allocated() - before}
        after = tree_leaves((res["checkpoint"]["world_map"], res["checkpoint"]["db"]))
        if not all(np.array_equal(a, b) for a, b in zip(after, frozen)) or len(after) != len(frozen):
            raise AssertionError(f"[{label}] frames {start}..{stop - 1}: the frozen map or DB changed")
        ok = res["pose_ok"]
        if res["ba_events"] or not np.isfinite(res["poses"]).all() or ok[1:].mean() < 0.9:
            raise AssertionError(f"[{label}] frames {start}..{stop - 1}: BA events {res['ba_events']}, finite poses "
                                 f"{np.isfinite(res['poses']).all()}, pose_ok {ok[1:].mean():.3f}")
        lockin = int(np.argmax(ok))
        # each frame against the mapping run's pose of the same clip frame (a measurement: see PERF.md)
        n = min(stop, N_FRAMES) - start
        err = np.linalg.norm(res["poses"][:n, :3, 3] - mapping[start:start + n, :3, 3], axis=1)
        return res, secs, lockin, err, mem

    system.run(host_batches(frames_np, 0, BATCH), seed=1, warm_start=warm)  # warm-up
    reset_launch_counts()
    res96, t96, lock96, err96, mem96 = localize(0, N_FRAMES, seed=1)
    counts = launch_counts()
    check_launches(label, counts, {**{k: n_chunks for k in uses if k != "msac_scores"}, "msac_scores": None,
                                   "fused_frontend_nms_batch": 0})

    # an unknown start: frame 40 of the clip is frame 0 of the stream, locked in by relocalization
    shapes = []
    msac = fpose.msac_scores

    def recorded(E, P, *args, **kw):
        shapes.append(tuple(E.shape[:2]))
        return msac(E, P, *args, **kw)

    fpose.msac_scores = recorded
    try:
        res40, t40, lock40, err40, _ = localize(40, N_FRAMES, seed=2)
    finally:
        fpose.msac_scores = msac
    # the reference's bar (tests/test_localization.py) where the loaded state fixes the pose: the
    # frame that locked in by relocalization against the DB, within 0.6 of the mapping run's
    if lock40 >= BATCH or not res40["reloc_ok"][lock40] or err40[lock40] > 0.6:
        raise AssertionError(f"[{label}] frames 40..95: lock-in at {lock40} (relocalized "
                             f"{bool(res40['reloc_ok'][lock40])}), {err40[lock40]:.3f} from the mapping run's pose")
    if len(shapes) < 2 or shapes[0][0] != BATCH or shapes[1] != (2, 10 * 1024):  # two-view, then relocalization
        raise AssertionError(f"[{label}] the bootstrap chunk's kernel 4 calls: {shapes[:3]}")

    # the bootstrap chunk's relocalization on the card and on the CPU, the same draws
    chunk = torch.from_numpy(frames_np[40:40 + BATCH]).cuda()
    valid = torch.ones(BATCH, dtype=torch.bool)
    st0 = system.pipeline.initial_pnp_state()._replace(map=loaded["world_map"])
    result, st2 = system.pipeline.process_chunk_pnp(chunk, valid, st0, 0)
    cpu_system = SlamSystem(camera, cfg, device="cpu", **kw)
    boot = check_reloc_card_equals_cpu(label, system, cpu_system, loaded["db"], result, valid.cuda(),
                                       list(range(BATCH)), st2.map, what="the bootstrap chunk (frames 40..55)")
    if not boot["rescued"]:
        raise AssertionError(f"[{label}] the bootstrap chunk rescued no frame")

    res192, t192, lock192, _, mem192 = localize(0, 2 * N_FRAMES, seed=1)
    # what a run keeps on the card (its result alive) may grow only by its per-chunk records
    if mem192["kept"] - mem96["kept"] > 4 * 2**20:
        raise AssertionError(f"[{label}] device memory kept by the run grew from {mem96['kept']} to "
                             f"{mem192['kept']} bytes with the stream")
    rec = {"fps_96": N_FRAMES / t96, "marginal_fps": N_FRAMES / max(t192 - t96, 1e-9), "seconds_96": t96,
           "seconds_192": t192, "pose_ok_share_96": float(res96["pose_ok"].mean()),
           "relocalizations_96": int(res96["reloc_ok"].sum()), "lockin_96": lock96, "lockin_from_40": lock40,
           "relocalizations_from_40": int(res40["reloc_ok"].sum()), "pose_ok_share_192": float(res192["pose_ok"].mean()),
           "lockin_position_err_from_40": float(err40[lock40]),
           "position_err_vs_mapping_96": {"max": float(err96.max()), "median": float(np.median(err96)),
                                          "first_chunk_max": float(err96[:BATCH].max())},
           "position_err_vs_mapping_from_40": {"max": float(err40.max()), "median": float(np.median(err40)),
                                               "first_chunk_max": float(err40[:BATCH].max())},
           "max_memory_allocated_96": mem96["peak"], "max_memory_allocated_192": mem192["peak"],
           "memory_kept_96": mem96["kept"], "memory_kept_192": mem192["kept"], "bootstrap_card_vs_cpu": boot,
           "launches": counts}
    log(f"[{label}] frozen map and DB of [stream-pnp] from its file: 96 frames {rec['fps_96']:.2f} frames/s from "
        f"scratch, pose_ok {rec['pose_ok_share_96']:.3f}, {rec['relocalizations_96']} relocalized, lock-in at frame "
        f"{lock96}; from frame 40 lock-in at stream frame {lock40} by relocalization, {err40[lock40]:.3f} from the "
        f"mapping run's pose ({rec['relocalizations_from_40']} relocalized); 192 frames pose_ok "
        f"{rec['pose_ok_share_192']:.3f}; kernel 4 at {shapes[1]} x 1024 matches on the bootstrap chunk; marginal "
        f"rate (192 - 96) / (t192 - t96) = {rec['marginal_fps']:.2f} frames/s; positions against the mapping run's "
        f"(same clip frame): 96-frame run max {err96.max():.3f} median {np.median(err96):.3f} (first chunk "
        f"{err96[:BATCH].max():.3f}), from frame 40 max {err40.max():.3f} median {np.median(err40):.3f} (first chunk "
        f"{err40[:BATCH].max():.3f}); map and DB bit-equal after every run; no BA event; max_memory_allocated "
        f"{mem96['peak'] / 2**20:.1f} MiB over 96 frames, {mem192['peak'] / 2**20:.1f} MiB over 192 (kept by the "
        f"run's result: {mem96['kept'] / 2**10:.1f} KiB, {mem192['kept'] / 2**10:.1f} KiB) on {card}")
    return rec


def path_length(poses: np.ndarray) -> float:
    return float(np.linalg.norm(np.diff(np.asarray(poses, np.float64)[:, :3, 3], axis=0), axis=1).sum())


def check_ate(label: str, poses: np.ndarray, single: np.ndarray) -> tuple[float, float]:
    """Sim(3)-aligned ATE against the single-device run, held below 5% of its path length
    (the reference's bar, ``tests/test_timeshard.py``) → (ATE, path length)."""
    from tpuslam_torch.post.trajectory import ate_rmse

    ate, path = ate_rmse(poses, single), path_length(single)
    if not ate < 0.05 * max(path, 1.0):
        raise AssertionError(f"[{label}] ATE {ate:.4f} against the single-device run is not < 5% of its path "
                             f"{path:.3f}")
    return ate, path


def check_core_pose_ok(label: str, pose_ok: np.ndarray) -> float:
    share = float(pose_ok[1:].mean())  # frame 0 has no pair
    if share < 0.9:
        raise AssertionError(f"[{label}] pose_ok on only {share:.3f} of the core frames")
    return share


def batched_kernel_records(label: str, pipeline, frames: torch.Tensor) -> dict:
    """Kernels 1-4 against their twins on the frames of one batched chunk (S·B of them), as
    ``main_blur_kps`` and ``msac_inputs`` build the main path's inputs: device ms, twin ms, bound."""
    from tpuslam_torch.common.camera import undistort_batch
    from tpuslam_torch.frontend.brief import orientations_from_patches, quantize_angles
    from tpuslam_torch.kernels import brief as kb
    from tpuslam_torch.kernels import frontend as kf
    from tpuslam_torch.kernels import pose as kp

    det = pipeline.detector
    c = det.config
    und = undistort_batch(frames, pipeline.undistort_idx, pipeline.undistort_valid)
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold, taps=det.blur_kernel)
    out = {}
    out["fused_frontend_batch"] = shape_record(
        f"[{label}] fused_frontend_batch", kf.fused_frontend_batch(und, **args),
        kf.fused_frontend_reference(und, **args), lambda: kf.fused_frontend_batch(und, **args),
        lambda: kf.fused_frontend_reference(und, **args), True, kf.frontend_work(*und.shape), und.shape)
    blur, kps = main_blur_kps(pipeline, frames)
    patches = kb.extract_brief_patches(blur, kps.xy, c.patch_size)
    out["extract_brief_patches"] = shape_record(
        f"[{label}] extract_brief_patches", (patches,),
        (kb.extract_brief_patches_reference(blur, kps.xy, c.patch_size),),
        lambda: kb.extract_brief_patches(blur, kps.xy, c.patch_size),
        lambda: kb.extract_brief_patches_reference(blur, kps.xy, c.patch_size), True,
        kb.extract_patches_work(*blur.shape, kps.xy.shape[1], c.patch_size), patches.shape)
    angles = orientations_from_patches(patches, det.moment_weights, kps, c.patch_size, blur.shape[-2:])
    bins = quantize_angles(angles, c.brief_quantized_bins)
    W, W3 = det.bin_weights, det.bin_weights_3d
    dots = kb.brief_own_bin_dots(patches, bins, W)
    out["brief_own_bin_dots"] = shape_record(
        f"[{label}] brief_own_bin_dots", (dots,), (kb.brief_own_bin_dots_reference(patches, bins, W3),),
        lambda: kb.brief_own_bin_dots(patches, bins, W), lambda: kb.brief_own_bin_dots_reference(patches, bins, W3),
        True, kb.own_bin_dots_work(bins, W), dots.shape)
    E, P = msac_inputs(pipeline, blur, kps)
    out["msac_scores"] = shape_record(
        f"[{label}] msac_scores", (kp.msac_scores(E, P),), (kp.msac_scores_reference(E, P),),
        lambda: kp.msac_scores(E, P), lambda: kp.msac_scores_reference(E, P), False,
        kp.msac_work(*E.shape[:2], P.shape[-1] // 5), (*E.shape[:2], P.shape[-1] // 5))
    return out


def hold_vo_results(label: str, got, want, what: str) -> dict:
    """Batched against in-turn VO results: pose_ok, num_matches and num_inliers identical, poses within
    1e-4 (rotation) and 1e-3 (position); the largest differences."""
    for k in ("pose_ok", "num_matches", "num_inliers"):
        if not torch.equal(getattr(got, k), getattr(want, k)):
            raise AssertionError(f"[{label}] {what}: {k} differs between the batched run and the run in turn")
    g, w = got.poses.double(), want.poses.double()
    rot = float((g[..., :3, :3] - w[..., :3, :3]).abs().max())
    pos = float((g[..., :3, 3] - w[..., :3, 3]).abs().max())
    if rot > 1e-4 or pos > 1e-3:
        raise AssertionError(f"[{label}] {what}: poses differ by R {rot}, t {pos}")
    return {"rotation_diff": rot, "position_diff": pos, "bit_equal": bool(torch.equal(got.poses, want.poses))}


def phase_timeshard(camera, config_dir: Path, frames_np: np.ndarray, card: str, uses) -> dict:
    """VO over the frames cut into TS_SHARDS time shards (``run_timesharded``: the shards of the card as
    one batched sequence), against each shard's window run alone in turn and the frames run single."""
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.dist.timeshard import run_timesharded, stage_shard, stitch_segments
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.slam import SlamPipeline, _stack_results

    label = "timeshard"
    pipeline = SlamPipeline(camera, SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH), device="cuda")
    n = len(frames_np)
    chunks = torch.from_numpy(frames_np).cuda().reshape(n // BATCH, BATCH, *frames_np.shape[1:])
    valid = torch.ones(chunks.shape[:2], dtype=torch.bool)
    result, single_s, _, _ = drive(pipeline, chunks, valid, seed=0)
    single = result.poses.reshape(-1, 4, 4).cpu().numpy()
    run_timesharded(pipeline, frames_np, TS_SHARDS, seed=1)  # warm-up at the batched shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_timesharded(pipeline, frames_np, TS_SHARDS, seed=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    S, V = out["S"], out["V"]
    per_shard = (S + V) // BATCH
    # the shards run as one batched sequence: one launch of each kernel a batched chunk
    check_launches(label, counts, {**{k: per_shard for k in uses}, "fused_frontend_nms_batch": 0})
    kernels_pass = count_kernels(lambda: run_timesharded(pipeline, frames_np, TS_SHARDS, seed=0))

    # the same windows one after another, each through process_sequence with seed + d
    windows = [stage_shard(frames_np, d, S, V, BATCH, "cuda") for d in range(TS_SHARDS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alone = [pipeline.process_sequence(w, w_valid, pipeline.initial_state(), seed=d)[0]
             for d, (w, w_valid) in enumerate(windows)]
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t0
    # one window alone (the four are alike in length): the profiler's cost grows with the kernels it records
    kernels_window = count_kernels(lambda: pipeline.process_sequence(*windows[0], pipeline.initial_state(), seed=0))
    _, single_s2, _, _ = drive(pipeline, chunks, valid, seed=0)
    # each shard against its window alone: the batched call's every field, and run_timesharded's segments
    states, by_chunk = [pipeline.initial_state() for _ in windows], []
    for c in range(per_shard):  # the batched step over the staged windows, for its every field
        results, states = pipeline.process_chunks(torch.stack([w[c] for w, _ in windows]),
                                                   torch.stack([v[c] for _, v in windows]), states,
                                                   list(range(TS_SHARDS)))
        by_chunk.append(results)
    batched = [_stack_results([r[d] for r in by_chunk]) for d in range(TS_SHARDS)]
    held = [hold_vo_results(label, b, a, f"shard {d}") for d, (b, a) in enumerate(zip(batched, alone))]
    for d, a in enumerate(alone):
        if not np.array_equal(a.pose_ok.reshape(-1).cpu().numpy(), out["segments_ok"][d]):
            raise AssertionError(f"[{label}] run_timesharded's shard {d} pose_ok differs from its window alone")
        seg = np.abs(a.poses.reshape(-1, 4, 4).cpu().numpy().astype(np.float64) - out["segments"][d])
        if seg[:, :3, :3].max() > 1e-4 or seg[:, :3, 3].max() > 1e-3:
            raise AssertionError(f"[{label}] run_timesharded's shard {d} differs from its window alone: "
                                 f"R {seg[:, :3, :3].max()}, t {seg[:, :3, 3].max()}")
    ok_share = check_core_pose_ok(label, out["pose_ok"])
    if not np.isfinite(out["poses"]).all():
        raise AssertionError(f"[{label}] non-finite stitched poses")
    ate, path = check_ate(label, out["poses"], single)
    stitch_ms = 1e3 * float(np.median([_host_s(stitch_segments, out["segments"], S, V, n, out["segments_ok"])
                                       for _ in range(5)]))
    # kernels 1-4 against their twins on one batched chunk: chunk 0 of every shard, S·B frames
    ts_kernels = batched_kernel_records(label, pipeline, torch.cat([w[0] for w, _ in windows]))
    log(f"[{label}] kernels 1-4 on one batched chunk of {TS_SHARDS * BATCH} frames held against their twins: " +
        ", ".join(f"{k} {r['ms']:.4f} ms (twin {r['plain_ms']:.4f}, bound {1e3 * r['bound_ms']:.2f} us)"
                  for k, r in ts_kernels.items()) + f" on {card}")
    rec = {"frames": n, "shards": TS_SHARDS, "S": S, "V": V, "fps": n / run_s,
           "windows_in_turn_fps": TS_SHARDS * (S + V) / turn_s, "batched_window_fps": TS_SHARDS * (S + V) / run_s,
           "single_fps": [n / single_s, n / single_s2], "pose_ok_share": ok_share, "ate": ate, "path": path,
           "stitch_ms": stitch_ms, "device_kernels_per_pass": kernels_pass,
           "device_kernels_one_window_alone": kernels_window, "peak_memory_bytes": peak,
           "batched_vs_alone": held, "kernels_at_batch": ts_kernels, "launches": counts}
    worst = (max(h["rotation_diff"] for h in held), max(h["position_diff"] for h in held))
    log(f"[{label}] {n} frames in {TS_SHARDS} shards (S {S}, V {V}, {per_shard} chunks a shard) as one batched "
        f"sequence of {TS_SHARDS * BATCH} frames a chunk: {rec['fps']:.2f} frames/s ({rec['batched_window_fps']:.2f} "
        f"window frames/s) against the windows alone in turn {rec['windows_in_turn_fps']:.2f} window frames/s and "
        f"the single run's {rec['single_fps'][0]:.2f} and {rec['single_fps'][1]:.2f} (before, after); device "
        f"kernels a pass {kernels_pass} batched, {kernels_window} a window alone; peak memory {peak / 2**30:.3f} GiB; "
        f"each shard against its window alone: integer fields identical, poses within R {worst[0]:.2e}, t "
        f"{worst[1]:.2e} (bit-equal {[h['bit_equal'] for h in held]}); core pose_ok {ok_share:.3f}; ATE "
        f"{ate:.4f} against the single run ({100 * ate / path:.2f}% of its {path:.3f} path); stitch "
        f"{stitch_ms:.3f} ms on the host; on {card}")
    return rec


def phase_multiseq_vo(camera, config_dir: Path, card: str, uses) -> dict:
    """Four VO sequences as one batched chunk step (``shard_batched_pipeline`` on the card) against each
    sequence's ``process_chunk`` calls in turn."""
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.dist.mesh import shard_batched_pipeline
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.slam import SlamPipeline, _stack_results

    label = "multiseq-vo"
    n_seq, offset = 4, 5
    pipeline = SlamPipeline(camera, SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH), device="cuda")
    tiled = load_frames(N_FRAMES + offset * (n_seq - 1))
    n_chunks = N_FRAMES // BATCH
    # sequence s: the tiled path from frame offset·s, seed s
    seqs = torch.from_numpy(np.stack([tiled[offset * s: offset * s + N_FRAMES] for s in range(n_seq)])).cuda()
    seqs = seqs.reshape(n_seq, n_chunks, BATCH, *tiled.shape[1:])
    valid = torch.ones((n_seq, BATCH), dtype=torch.bool)
    seeds = list(range(n_seq))
    step = shard_batched_pipeline(pipeline, ["cuda"])

    def batched():
        states, out = [pipeline.initial_state() for _ in seeds], []
        for c in range(n_chunks):
            results, states = step(seqs[:, c], valid, states, seeds)
            out.append(results)
        return [_stack_results([r[s] for r in out]) for s in range(n_seq)]

    def in_turn():
        out = []
        for s in seeds:
            state, rs = pipeline.initial_state(), []
            for c in range(n_chunks):
                r, state = pipeline.process_chunk(seqs[s, c], valid[s], state, seed=s)
                rs.append(r)
            out.append(_stack_results(rs))
        return out

    batched()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = batched()
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches(label, counts, {**{k: n_chunks for k in uses}, "fused_frontend_nms_batch": 0})
    t0 = time.perf_counter()
    want = in_turn()
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t0
    held = [hold_vo_results(label, g, w, f"sequence {s}") for s, (g, w) in enumerate(zip(got, want))]
    for s, g in enumerate(got):
        if float(g.pose_ok.reshape(-1)[1:].float().mean()) < 0.9:
            raise AssertionError(f"[{label}] sequence {s}: pose_ok on too few frames")
    step_kernels = count_kernels(lambda: step(seqs[:, 1], valid, [pipeline.initial_state() for _ in seeds], seeds))
    chunk_kernels = count_kernels(lambda: pipeline.process_chunk(seqs[0, 1], valid[0], pipeline.initial_state()))
    total = n_seq * N_FRAMES
    rec = {"sequences": n_seq, "frames": N_FRAMES, "fps": total / batched_s, "in_turn_fps": total / turn_s,
           "device_kernels_per_batched_step": step_kernels, "device_kernels_per_chunk": chunk_kernels,
           "peak_memory_bytes": peak, "batched_vs_in_turn": held, "launches": counts}
    worst = (max(h["rotation_diff"] for h in held), max(h["position_diff"] for h in held))
    log(f"[{label}] {n_seq} VO sequences of {N_FRAMES} frames (batch {BATCH}) as one batched step of "
        f"{n_seq * BATCH} frames: {rec['fps']:.2f} frames/s against {rec['in_turn_fps']:.2f} in turn; device "
        f"kernels a batched step {step_kernels}, a process_chunk {chunk_kernels}; peak memory "
        f"{peak / 2**30:.3f} GiB; integer fields identical, poses within R {worst[0]:.2e}, t {worst[1]:.2e} "
        f"(bit-equal {[h['bit_equal'] for h in held]}); on {card}")
    return rec


def _host_s(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def cross_draw(frame_idx, n_candidates, valid):
    from tpuslam_torch.backend.pnp import gumbel_sample_indices

    gen = torch.Generator(device=valid.device).manual_seed(30_000 + frame_idx)
    return gumbel_sample_indices(valid, 512, 6, gen)


def check_cross_card_equals_cpu(label: str, system, cpu_system, dbs, D, S, V, n) -> dict:
    """The cross-segment pass from the same per-shard DBs and draws on the card and on the CPU."""
    from tpuslam_torch.dist.timeshard import cross_segment_loop_closure

    store = {}
    system.cross_draw_fn, cpu_system.cross_draw_fn = recorder(store, cross_draw), replayer(store)
    try:
        g = cross_segment_loop_closure(system, dbs, D, S, V, n, seed=0, details=True)
        c = cross_segment_loop_closure(cpu_system, [to_cpu(db) for db in dbs], D, S, V, n, seed=0, details=True)
    finally:
        system.cross_draw_fn = cpu_system.cross_draw_fn = None
    (_, g_cand, g_ok, g_T, g_n), (_, c_cand, c_ok, c_T, c_n) = g, c
    if g_cand != c_cand or not np.array_equal(g_ok, c_ok) or not np.array_equal(g_n, c_n):
        raise AssertionError(f"[{label}] the cross pass on the card != CPU: candidates {g_cand} vs {c_cand}, ok "
                             f"{g_ok} vs {c_ok}, inliers {g_n} vs {c_n}")
    rot = float(np.abs(g_T[:, :3, :3] - c_T[:, :3, :3]).max()) if len(g_T) else 0.0
    pos = float(np.abs(g_T[:, :3, 3] - c_T[:, :3, 3]).max()) if len(g_T) else 0.0
    if rot > 1e-4 or pos > 1e-3:
        raise AssertionError(f"[{label}] the cross pass on the card != CPU: R {rot}, t {pos}")
    return {"candidates": len(g_cand), "verified": int(g_ok.sum()), "rotation_diff": rot, "position_diff": pos}


class VerifyCounter:
    """Counts the loop candidates ``LoopClosure._verify_impl`` verifies while it is installed on ``lc``."""

    def __init__(self, lc):
        self.lc, self.candidates = lc, 0

    def __enter__(self):
        verify = self.lc._verify_impl

        def counted(descriptors, *args, **kw):
            self.candidates += descriptors.shape[0]
            return verify(descriptors, *args, **kw)

        self.lc._verify_impl = counted
        return self

    def __exit__(self, *exc):
        del self.lc._verify_impl


class RansacRecorder:
    """Keeps the arguments of the largest batched RANSAC-PnP call ``LoopClosure._ransac`` makes while it is
    installed on ``lc`` (the candidates of one verification or relocalization)."""

    def __init__(self, lc):
        self.lc, self.args = lc, None

    def __enter__(self):
        ransac = self.lc._ransac

        def recorded(pts3d, *args):
            if self.args is None or pts3d.shape[0] > self.args[0].shape[0]:
                self.args = (pts3d, *args)
            return ransac(pts3d, *args)

        self.lc._ransac = recorded
        return self

    def __exit__(self, *exc):
        del self.lc._ransac


def verify_ab(label: str, lc, args, card: str) -> dict:
    """One batched RANSAC-PnP call over V candidates against V unbatched ``ransac_pnp`` calls on the same
    candidates, in this call: success and inliers identical, T within 1e-4 (R) / 1e-3 (t); host ms
    (synchronised) and device kernels of each."""
    from tpuslam_torch.backend.loop_closure import _rt
    from tpuslam_torch.backend.pnp import ransac_pnp

    pts3d, pts2d, valid, K, samples = args
    V = pts3d.shape[0]
    cfg = lc.config
    kw = dict(num_hypotheses=samples.shape[1], sample_size=6, reproj_threshold=cfg.ransac_reprojection_threshold,
              min_inliers=cfg.min_inliers_for_pnp, hyp_sweeps=6, lo_rounds=2, refine="gn")

    def batched():
        return lc._ransac(pts3d, pts2d, valid, K, samples)

    def singles():
        res = [ransac_pnp(pts3d[v], pts2d[v], valid[v], K, samples[v], **kw) for v in range(V)]
        return (torch.stack([r.success for r in res]), _rt(torch.stack([r.R for r in res]),
                torch.stack([r.t for r in res])), torch.stack([r.num_inliers for r in res]))

    (b_ok, b_T, b_n), (s_ok, s_T, s_n) = batched(), singles()
    if not torch.equal(b_ok, s_ok) or not torch.equal(b_n, s_n):
        raise AssertionError(f"[{label}] batched verification != {V} single calls: ok {b_ok.tolist()} vs "
                             f"{s_ok.tolist()}, inliers {b_n.tolist()} vs {s_n.tolist()}")
    rot = float((b_T[:, :3, :3] - s_T[:, :3, :3]).abs().max())
    pos = float((b_T[:, :3, 3] - s_T[:, :3, 3]).abs().max())
    if rot > 1e-4 or pos > 1e-3:
        raise AssertionError(f"[{label}] batched verification != {V} single calls: R {rot}, t {pos}")
    rec = {"candidates": V, "hypotheses": samples.shape[1], "matches": pts3d.shape[1],
           "verified": int(b_ok.sum()), "batched_ms": synced_ms(batched), "singles_ms": synced_ms(singles),
           "batched_device_kernels": count_kernels(batched), "singles_device_kernels": count_kernels(singles),
           "rotation_diff": rot, "position_diff": pos, "bit_equal": bool(torch.equal(b_T, s_T))}
    log(f"[{label}] verification A/B on {V} candidates ({rec['hypotheses']} hypotheses, {rec['matches']} "
        f"matches, {rec['verified']} verified): one batched ransac_pnp {rec['batched_ms']:.2f} ms, "
        f"{rec['batched_device_kernels']} device kernels; {V} single calls {rec['singles_ms']:.2f} ms, "
        f"{rec['singles_device_kernels']} device kernels; success and inliers identical, T within R {rot:.2e}, "
        f"t {pos:.2e} (bit-equal {rec['bit_equal']}); on {card}")
    return rec


def phase_timeshard_slam(camera, config_dir: Path, frames_np: np.ndarray, card: str, uses, tracking: str) -> dict:
    """Full SLAM over the frames cut into TS_SHARDS time shards (``run_timesharded_system``), against
    ``run_sequence`` over the same frames."""
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.dist.timeshard import run_timesharded_system
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.system import SlamSystem

    label = "timeshard-slam" if tracking == "vo" else "timeshard-slam-pnp"
    cfg = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    vocab = config_dir / "vocabulary_tree.npz"
    system = SlamSystem(camera, cfg, vocabulary=vocab, tracking=tracking, device="cuda")
    n = len(frames_np)

    def run_single():
        t0 = time.perf_counter()
        out = system.run_sequence(frames_np, seed=0)
        return out, time.perf_counter() - t0

    with VerifyCounter(system.loop_closure) as single_verified:
        single, single_s = run_single()
    with VerifyCounter(system.loop_closure) as sharded_verified, RansacRecorder(system.loop_closure) as ransacs:
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run_timesharded_system(system, frames_np, TS_SHARDS, seed=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
    _, single_s2 = run_single()
    S, V = out["S"], out["V"]
    least = TS_SHARDS * (S + V) // BATCH
    log(f"[{label}] launches {counts}")
    if any(counts[k] < least for k in uses) or counts["fused_frontend_nms_batch"]:
        raise AssertionError(f"[{label}] launches {counts}: kernels 1-4 at least {least} each, kernel 5 none")
    if not np.isfinite(out["poses"]).all():
        raise AssertionError(f"[{label}] non-finite poses")
    ok_share = check_core_pose_ok(label, out["pose_ok"])
    ba = out["ba_events"]
    if not ba or any(e["final_cost"] > e["initial_cost"] * 1.001 for e in ba):
        raise AssertionError(f"[{label}] BA events {[(e['initial_cost'], e['final_cost']) for e in ba]}")
    min_inliers = cfg.loop_closure.min_inliers_for_pnp
    cross = [lp for lp in out["cross_loops"] if lp["frame_id"] // S > lp["matched_keyframe_id"] // S
             and lp["num_inliers"] >= min_inliers]
    if not cross or not out["pose_graph_applied"]:
        pairs = [(lp["frame_id"], lp["matched_keyframe_id"], lp["num_inliers"]) for lp in out["cross_loops"]]
        raise AssertionError(f"[{label}] cross-segment loops {pairs}, global pose graph applied "
                             f"{out['pose_graph_applied']}")
    ate, path = check_ate(label, out["poses"], single["poses"])
    cpu_system = SlamSystem(camera, cfg, vocabulary=vocab, tracking=tracking, device="cpu")
    cross_check = check_cross_card_equals_cpu(label, system, cpu_system, out["dbs"], TS_SHARDS, S, V, n)
    ab = verify_ab(label, system.loop_closure, ransacs.args, card)
    sec = out["seconds"]
    in_shard = len(out["loops"]) - len(out["cross_loops"])
    rec = {"frames": n, "shards": TS_SHARDS, "S": S, "V": V, "fps": n / run_s,
           "single_fps": [n / single_s, n / single_s2], "pose_ok_share": ok_share, "ate": ate, "path": path,
           "in_shard_loops": in_shard,
           "cross_loops": len(out["cross_loops"]), "cross_pairs": [[lp["frame_id"], lp["matched_keyframe_id"],
                                                                    lp["num_inliers"]] for lp in out["cross_loops"]],
           "ba_events": len(ba), "shard_seconds": sec["shards"], "shard_fold_seconds": sec["folds"],
           "verified_candidates": sharded_verified.candidates, "single_verified_candidates":
           single_verified.candidates, "stitch_ms": 1e3 * sec["stitch"],
           "cross_ms": 1e3 * sec["cross"], "global_pose_graph_ms": 1e3 * sec["pose_graph"],
           "global_pose_graph_nodes": len(out["global_keyframes"]), "single_loops": len(single["loops"]),
           "cross_card_vs_cpu": cross_check, "verify_ab": ab, "launches": counts}
    log(f"[{label}] {n} frames in {TS_SHARDS} shards (S {S}, V {V}) in turn on one card: {rec['fps']:.2f} "
        f"frames/s against run_sequence's {rec['single_fps'][0]:.2f} and {rec['single_fps'][1]:.2f} (before, "
        f"after) in this call; core pose_ok {ok_share:.3f}; "
        f"{in_shard} in-shard loops, {len(out['cross_loops'])} cross-segment loops ({rec['cross_pairs'][:4]}), "
        f"{len(ba)} BA events; ATE {ate:.4f} against run_sequence ({100 * ate / path:.2f}% of its {path:.3f} path, "
        f"{len(single['loops'])} loops there); loop candidates verified {sharded_verified.candidates} (in-shard "
        f"and cross), {single_verified.candidates} in run_sequence; shards {[round(x, 3) for x in sec['shards']]} s "
        f"and their folds {[round(x, 3) for x in sec['folds']]} s, stitch "
        f"{rec['stitch_ms']:.3f} ms, cross pass {rec['cross_ms']:.2f} ms ({cross_check['candidates']} candidates, "
        f"{cross_check['verified']} verified; card == CPU, R {cross_check['rotation_diff']:.2e}, t "
        f"{cross_check['position_diff']:.2e}), global pose graph {rec['global_pose_graph_ms']:.2f} ms at N = "
        f"{rec['global_pose_graph_nodes']} on {card}")
    return rec


def phase_multiseq(camera, config_dir: Path, frames_np: np.ndarray, card: str, uses) -> dict:
    """One PnP SLAM sequence per card (``shard_sequence_program``), as ``bench.py::measure_multiseq``."""
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.dist.mesh import make_device_mesh, shard_sequence_program
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.system import SlamSystem

    label = "multiseq"
    S = torch.cuda.device_count()
    devices = make_device_mesh(S)
    system = SlamSystem(camera, SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH),
                        vocabulary=config_dir / "vocabulary_tree.npz", tracking="pnp", device="cuda")
    n = len(frames_np)
    chunks = np.broadcast_to(frames_np.reshape(1, n // BATCH, BATCH, *frames_np.shape[1:]),
                             (S, n // BATCH, BATCH, *frames_np.shape[1:])).copy()
    valid = np.ones(chunks.shape[:3], bool)
    seeds = list(range(S))
    step = shard_sequence_program(system, devices)
    reset_launch_counts()
    t0 = time.perf_counter()
    carries, outs = step(chunks, valid, seeds)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(label, counts, {**{k: S * (n // BATCH) for k in uses if k != "msac_scores"},
                                   "msac_scores": None, "fused_frontend_nms_batch": 0})
    for s in range(S):  # each sequence bit-equal to run_sequence with its seed and frames
        got = system._fold_sequence(outs[s], n, carries[s])
        want = system.run_sequence(frames_np, seed=seeds[s])
        for k in ("poses", "pose_ok", "num_matches", "num_inliers", "reloc_ok"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"[{label}] sequence {s}: {k} differs from run_sequence")
        if [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in got["loops"]] != \
                [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in want["loops"]]:
            raise AssertionError(f"[{label}] sequence {s}: loops differ from run_sequence")
    rec = {"sequences": S, "devices": [str(d) for d in devices], "frames": n, "fps": S * n / run_s,
           "launches": counts}
    log(f"[{label}] {S} PnP SLAM sequence(s) of {n} frames on {[str(d) for d in devices]}: aggregate "
        f"{rec['fps']:.2f} frames/s; each bit-equal to run_sequence with its seed; on {card}")
    return rec


def same_bits(label: str, got, want, path: str = "result") -> None:
    """``got`` equals ``want`` bit for bit (arrays and tensors compared on the host, in the dicts, lists,
    tuples and scalars holding them); the first difference fails ``label``."""
    if torch.is_tensor(want) or isinstance(want, np.ndarray):
        g, w = (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in (got, want))
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w, equal_nan=g.dtype.kind == "f"):
            raise AssertionError(f"[{label}] {path} differs")
    elif isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"[{label}] {path}: keys {sorted(got)} against {sorted(want)}")
        for k in want:
            same_bits(label, got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"[{label}] {path}: {len(got)} items against {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            same_bits(label, g, w, f"{path}[{i}]")
    elif got != want:
        raise AssertionError(f"[{label}] {path}: {got!r} against {want!r}")


def phase_workers(camera, config_dir: Path, frames_np: np.ndarray, ts_frames: np.ndarray, card: str,
                  uses) -> dict:
    """The dist layer's whole-run programs over worker processes, one per mesh entry, at the same time.

    The mesh names ``cuda:0`` twice (two processes on the one card; only here, to exercise the pool on
    one card) and, where there are more cards, every card.  On each: (a) ``shard_sequence_program``,
    two PnP SLAM sequences (tree vocabulary) over the 96 frames with seeds 0 and 1, each bit-equal to
    ``run_sequence`` by ``[multiseq]``'s rule, aggregate frames/s against the two in turn in one worker
    process (a pool of one entry; before and after, bit-equal too) and in this process; (b) ``run_timesharded_system`` (VO) over the 192 frames from a memmap in
    4 shards, every field but ``seconds`` bit-equal to the in-process run on ``cuda:0`` (the DBs too),
    twice (the first builds the workers' replicas), each worker's seconds; (c) ``run_timesharded`` (VO) in 4
    shards, bit-equal to the same entries in turn in this process (``InProcess``: the same batches),
    and against the one-entry run within ``[timeshard]``'s hold; (d) launch counts summed over the
    workers equal to the in-process runs' exactly; (e) the workers' wall intervals overlap, TF32 off
    in every worker, a dying worker raises ``WorkerDied``, and no child is left.  Also the time of an
    answer as large as (b)'s DBs against an empty one.
    """
    import multiprocessing
    import os

    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.dist.mesh import make_device_mesh, shard_sequence_program
    from tpuslam_torch.dist.timeshard import run_timesharded, run_timesharded_system
    from tpuslam_torch.dist.workers import InProcess, WorkerDied, WorkerPool
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.slam import SlamPipeline
    from tpuslam_torch.model.system import SlamSystem

    label = "workers"
    config = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    vocab = config_dir / "vocabulary_tree.npz"
    pnp = SlamSystem(camera, config, vocabulary=vocab, tracking="pnp", device="cuda")
    vo = SlamSystem(camera, config, vocabulary=vocab, tracking="vo", device="cuda")
    pipe = SlamPipeline(camera, config, device="cuda")
    n, seeds = len(frames_np), [0, 1]
    chunks = np.broadcast_to(frames_np.reshape(1, n // BATCH, BATCH, *frames_np.shape[1:]),
                             (2, n // BATCH, BATCH, *frames_np.shape[1:])).copy()
    valid = np.ones(chunks.shape[:3], bool)

    def timed(fn, *args, **kw):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts()

    def in_turn():
        return [pnp.run_sequence(frames_np, seed=s) for s in seeds]

    want_seq, in_turn_s, seq_counts = timed(in_turn)
    want_sys, sys_s, sys_counts = timed(run_timesharded_system, vo, ts_frames, TS_SHARDS, devices=["cuda:0"])
    want_vo1, vo1_s, _ = timed(run_timesharded, pipe, ts_frames, TS_SHARDS, devices=["cuda:0"])
    meshes = [["cuda:0", "cuda:0"]] + ([make_device_mesh()] if torch.cuda.device_count() > 1 else [])
    recs, refs = [], None
    with contextlib.ExitStack() as stack, tempfile.TemporaryDirectory(prefix="chip_smoke_workers_") as tmp:
        # the two sequences in turn in one worker process: (a)'s like-for-like baseline
        solo = stack.enter_context(WorkerPool(["cuda:0"]))
        solo_step = shard_sequence_program(pnp, ["cuda:0"], pool=solo)
        ts_mm = np.memmap(Path(tmp) / "frames.u8", dtype=np.uint8, mode="w+", shape=ts_frames.shape)
        ts_mm[:] = ts_frames
        ts_mm.flush()
        for devices in meshes:
            names = [str(d) for d in devices]
            t0 = time.perf_counter()
            pool = WorkerPool(devices)
            start_s = time.perf_counter() - t0
            try:
                for info in pool.info:
                    if info["tf32"] or info["matmul_precision"] != "highest":
                        raise AssertionError(f"[{label}] TF32 is on in worker {info['index']}")
                # (a) two PnP SLAM sequences, one a worker
                step = shard_sequence_program(pnp, devices, pool=pool)
                _, warm_s, _ = timed(step, chunks, valid, [2, 3])
                timed(solo_step, chunks, valid, [2, 3])  # the one worker's replica and first run
                # one worker in turn, the workers at once, one worker in turn again: the same process kind
                solo_runs = [timed(solo_step, chunks, valid, seeds)]
                (carries, outs), run_s, counts = timed(step, chunks, valid, seeds)
                walls = dict(pool.last_walls)
                if refs is None:  # [multihost] holds its ranks to the run over [cuda:0, cuda:0]
                    refs = {"seq": (carries, outs), "seq_counts": counts, "sys_counts": sys_counts,
                            "sys": {k: v for k, v in want_sys.items() if k != "seconds"}}
                solo_runs.append(timed(solo_step, chunks, valid, seeds))
                _, in_turn_after_s, _ = timed(in_turn)
                check_launches(label, counts, {**{k: None for k in uses}, "fused_frontend_nms_batch": 0})
                for what, got_counts in [("over the workers", counts)] + [("in one worker", r[2]) for r in solo_runs]:
                    if got_counts != seq_counts:
                        raise AssertionError(f"[{label}] (a) launches {got_counts} {what}, {seq_counts} in turn")
                runs_a = [("over the workers", carries, outs)] + [("in one worker", *r[0]) for r in solo_runs]
                for what, cs, os_ in runs_a:
                    for s in range(2):  # the rule of [multiseq]
                        got = pnp._fold_sequence(os_[s], n, cs[s])
                        for k in ("poses", "pose_ok", "num_matches", "num_inliers", "reloc_ok"):
                            same_bits(label, got[k], want_seq[s][k], f"(a) {what}, sequence {s} {k}")
                        if [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in got["loops"]] != \
                                [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in want_seq[s]["loops"]]:
                            raise AssertionError(f"[{label}] (a) {what}, sequence {s}: loops differ from run_sequence")
                if not max(t0 for t0, _ in walls.values()) < min(t1 for _, t1 in walls.values()):
                    raise AssertionError(f"[{label}] (a) the workers did not run at the same time: {walls}")
                fps, fps_turn = 2 * n / run_s, [2 * n / in_turn_s, 2 * n / in_turn_after_s]
                fps_solo = [2 * n / r[1] for r in solo_runs]
                log(f"[{label}] {names} (a) 2 PnP SLAM sequences of {n} frames: {fps:.2f} frames/s over "
                    f"the workers ({pool.threads} torch threads each; warm-up {warm_s:.2f} s) against "
                    f"{fps_solo[0]:.2f} / {fps_solo[1]:.2f} in turn in one worker process ({solo.threads} threads; "
                    f"before / after): {fps / fps_solo[0]:.3f}x / {fps / fps_solo[1]:.3f}x; in turn in this "
                    f"process {fps_turn[0]:.2f} / {fps_turn[1]:.2f} (before / after); each bit-equal to "
                    f"run_sequence; walls {[round(t1 - t0, 3) for t0, t1 in walls.values()]} s; launches {counts} "
                    f"(== in turn); pool start {start_s:.2f} s; on {card}")
                # (b) time-sharded full SLAM, the frames from a memmap
                runs = []
                for rep in range(2):
                    got, secs, counts_b = timed(run_timesharded_system, vo, ts_mm, TS_SHARDS, devices=devices,
                                                pool=pool)
                    same_bits(label, {k: v for k, v in got.items() if k != "seconds"},
                              {k: v for k, v in want_sys.items() if k != "seconds"}, "(b)")
                    if counts_b != sys_counts:
                        raise AssertionError(f"[{label}] (b) launches {counts_b} over the workers, {sys_counts} "
                                             "in process")
                    db_bytes = sum(t.numel() * t.element_size() for db in got["dbs"] for t in db)
                    runs.append({"seconds": secs, "workers_s": got["seconds"]["workers"],
                                 "answers": [pool.last_answers[i] for i in sorted(pool.last_answers)],
                                 "shards_s": got["seconds"]["shards"], "folds_s": got["seconds"]["folds"],
                                 "cross_s": got["seconds"]["cross"], "pose_graph_s": got["seconds"]["pose_graph"],
                                 "db_bytes": db_bytes})
                log(f"[{label}] {names} (b) run_timesharded_system VO, {TS_FRAMES} frames in {TS_SHARDS} shards: "
                    f"{runs[0]['seconds']:.2f} / {runs[1]['seconds']:.2f} s over the workers (first / second "
                    f"call), each worker {[round(w, 3) for w in runs[1]['workers_s']]} s, shards "
                    f"{[round(w, 3) for w in runs[1]['shards_s']]} s, folds {[round(w, 3) for w in runs[1]['folds_s']]}"
                    f" s, then here the cross pass {runs[1]['cross_s']:.3f} s and the global graph "
                    f"{runs[1]['pose_graph_s']:.3f} s, the DBs {runs[1]['db_bytes'] / 2**20:.1f} MiB back (each "
                    f"answer's MiB, packed in the worker / read here s: "
                    f"{[(round(a['bytes'] / 2**20, 1), round(a['pack_s'], 3), round(a['unpack_s'], 3)) for a in runs[1]['answers']]}"
                    f"); in process "
                    f"{sys_s:.2f} s (shards {[round(w, 3) for w in want_sys['seconds']['shards']]}, folds "
                    f"{[round(w, 3) for w in want_sys['seconds']['folds']]}, cross {want_sys['seconds']['cross']:.3f}, "
                    f"graph {want_sys['seconds']['pose_graph']:.3f}); every field bit-equal; launches == in process; "
                    f"on {card}")
                # (c) time-sharded VO: each entry's shards batched in its worker
                want_vo, turn_s, turn_counts = timed(run_timesharded, pipe, ts_frames, TS_SHARDS, devices=devices,
                                                     pool=InProcess(devices))
                got_vo, vo_s, vo_counts = timed(run_timesharded, pipe, ts_frames, TS_SHARDS, devices=devices,
                                                pool=pool)
                same_bits(label, got_vo, want_vo, "(c)")
                if vo_counts != turn_counts:
                    raise AssertionError(f"[{label}] (c) launches {vo_counts} over the workers, {turn_counts} in turn")
                same_bits(label, got_vo["segments_ok"], want_vo1["segments_ok"], "(c) against one entry: pose_ok")
                g, w = got_vo["segments"].astype(np.float64), want_vo1["segments"].astype(np.float64)
                rot, pos = float(np.abs(g[..., :3, :3] - w[..., :3, :3]).max()), float(np.abs(g[..., :3, 3] -
                                                                                          w[..., :3, 3]).max())
                if rot > 1e-4 or pos > 1e-3:
                    raise AssertionError(f"[{label}] (c) against the one-entry run: R {rot}, t {pos}")
                log(f"[{label}] {names} (c) run_timesharded VO, {TS_SHARDS} shards: {vo_s:.2f} s over the workers, "
                    f"{turn_s:.2f} s for the same batches in turn in this process (bit-equal, launches "
                    f"{vo_counts} == in turn), {vo1_s:.2f} s as one batch of {TS_SHARDS} on one entry (R {rot:.3g}, "
                    f"t {pos:.3g}, bit-equal {bool(rot == 0 and pos == 0)}); on {card}")
                # what an answer's size costs: (b)'s DBs as one tensor, against an empty answer
                n_floats = runs[1]["db_bytes"] // 4
                pool.run([(0, torch.zeros, (n_floats,))])  # warm-up
                answer_s, answer_split = [], []
                for k in (1, n_floats, 1, n_floats):
                    answer_s.append(_host_s(pool.run, [(0, torch.zeros, (k,))]))
                    answer_split.append(pool.last_answers[0])
                log(f"[{label}] {names} (b') an answer of {runs[1]['db_bytes'] / 2**20:.1f} MiB (a float32 tensor "
                    f"made in the worker) {answer_s[1]:.3f} / {answer_s[3]:.3f} s (packed into shared memory in the "
                    f"worker {answer_split[1]['pack_s']:.3f} / {answer_split[3]['pack_s']:.3f} s, read out here "
                    f"{answer_split[1]['unpack_s']:.3f} / {answer_split[3]['unpack_s']:.3f} s), an empty one "
                    f"{answer_s[0]:.3f} / {answer_s[2]:.3f} s; on {card}")
                # (e) a worker that dies fails the run with a named error
                try:
                    pool.run([(len(devices) - 1, os._exit, (3,))])
                    raise AssertionError(f"[{label}] a dying worker raised nothing")
                except WorkerDied as exc:
                    died = str(exc)
            finally:
                pool.close()
            alive = [c.pid for c in multiprocessing.active_children() if c.pid in pool.pids]
            for pid in set(pool.pids) - set(alive):
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, 0)  # raises for a process that is gone
                    alive.append(pid)
            if alive:
                raise AssertionError(f"[{label}] worker processes {alive} outlived the pool")
            log(f"[{label}] {names} (e) a dying worker: {died}; no worker process left")
            recs.append({"devices": names, "pool_start_s": start_s, "fps": fps, "fps_in_turn": fps_turn,
                         "fps_one_worker": fps_solo, "speedup_vs_one_worker": [fps / f for f in fps_solo],
                         "threads": pool.threads, "threads_one_worker": solo.threads,
                         "speedup": [fps / f for f in fps_turn], "walls_s": [t1 - t0 for t0, t1 in walls.values()],
                         "warm_up_s": warm_s, "launches": counts, "timeshard_slam": runs,
                         "timeshard_slam_in_process_s": sys_s, "timeshard_slam_in_process": want_sys["seconds"], "timeshard_vo_s": vo_s,
                         "timeshard_vo_in_turn_s": turn_s, "timeshard_vo_one_entry_s": vo1_s,
                         "answer_s": {"empty": answer_s[0::2], "db_sized": answer_s[1::2],
                                      "db_sized_pack_s": [a["pack_s"] for a in answer_split[1::2]],
                                      "db_sized_unpack_s": [a["unpack_s"] for a in answer_split[1::2]]},
                         "one_entry_diff": {"rotation": rot, "position": pos}})
        del ts_mm
    alive = [c.pid for c in multiprocessing.active_children() if c.pid in solo.pids]
    if alive:
        raise AssertionError(f"[{label}] the one-worker pool's process {alive} outlived it")
    return {"meshes": recs, "launches": recs[0]["launches"], "multihost_refs": refs}


def phase_step_workers(camera, config_dir: Path, card: str, uses) -> tuple[dict, dict]:
    """The per-chunk step over worker processes (``shard_batched_pipeline`` with a ``WorkerPool``).

    ``[multiseq-vo]``'s data: 4 VO sequences of 96 frames at batch 16 (offsets 5, seeds 0-3), two a mesh
    entry on the mesh ``[cuda:0, cuda:0]`` (and every card where there are more), 6 chunks.  Against the
    same step in this process (``InProcess``, the entries in turn): every result and the final states
    fetched from the workers bit-equal, launches summed exactly to the in-process count, the workers'
    walls overlapping on every chunk; frames/s of both in turns (in process, the card's frames through
    CUDA IPC, the host's frames through the reused blocks, CUDA IPC, in process), the ms a call spends
    sending the frames and returning the results, a fresh block of shared memory for one entry's frames
    (the whole-run programs' way) beside them, and each worker's peak memory.  Returns the record and,
    for ``[multihost]``, the in-process run on ``[cuda:0, cuda:0]``."""
    import multiprocessing

    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.dist import workers
    from tpuslam_torch.dist.mesh import make_device_mesh, shard_batched_pipeline
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.slam import SlamPipeline

    label = "step-workers"
    n_seq, offset, seeds = 4, 5, [0, 1, 2, 3]
    pipeline = SlamPipeline(camera, SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH), device="cuda")
    tiled = load_frames(N_FRAMES + offset * (n_seq - 1))
    n_chunks = N_FRAMES // BATCH
    host = np.stack([tiled[offset * s: offset * s + N_FRAMES] for s in range(n_seq)])
    host = host.reshape(n_seq, n_chunks, BATCH, *tiled.shape[1:])
    card_frames = torch.from_numpy(host).cuda()
    valid = torch.ones((n_seq, BATCH), dtype=torch.bool)

    def drive(step, frames) -> dict:
        torch.cuda.synchronize()
        reset_launch_counts()
        states, out, walls, answers = [pipeline.initial_state() for _ in seeds], [], [], []
        t0 = time.perf_counter()
        for c in range(n_chunks):
            results, states = step(frames[:, c], valid, states, seeds)
            out.append(results)
            walls.append(dict(step.pool.last_walls))
            answers.append(dict(getattr(step.pool, "last_answers", {})))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        return {"results": out, "states": [step.fetch(h) for h in states], "seconds": secs, "launches": counts,
                "walls": walls, "answers": answers}

    def per_call_ms(run: dict, *keys) -> float:
        """The ms a call spent on ``keys`` of the answers, the slowest entry of each call, averaged."""
        return 1e3 * float(np.mean([max(sum(a[k] for k in keys) for a in call.values()) for call in run["answers"]]))

    meshes = [["cuda:0", "cuda:0"]] + ([make_device_mesh()] if torch.cuda.device_count() > 1 else [])
    recs, refs = [], None
    for devices in meshes:
        names = [str(d) for d in devices]
        in_process = shard_batched_pipeline(pipeline, devices, pool=workers.InProcess(devices))
        t0 = time.perf_counter()
        pool = workers.WorkerPool(devices)
        start_s = time.perf_counter() - t0
        try:
            step = shard_batched_pipeline(pipeline, devices, pool=pool)
            t0 = time.perf_counter()
            drive(step, card_frames)  # the workers' replicas and first launches
            warm_s = time.perf_counter() - t0
            runs = {"in_process": [drive(in_process, card_frames)]}
            runs["ipc"] = [drive(step, card_frames)]
            runs["block"] = [drive(step, host)]
            runs["ipc"].append(drive(step, card_frames))
            runs["in_process"].append(drive(in_process, card_frames))
            want = runs["in_process"][0]
            n_entries = min(n_seq, len(devices))
            check_launches(label, want["launches"], {**{k: n_entries * n_chunks for k in uses},
                                                     "fused_frontend_nms_batch": 0})
            for how in ("in_process", "ipc", "block"):
                for i, run in enumerate(runs[how]):
                    what = f"{names} {how} pass {i}"
                    same_bits(label, run["results"], want["results"], f"{what} results")
                    same_bits(label, run["states"], want["states"], f"{what} final states")
                    if run["launches"] != want["launches"]:
                        raise AssertionError(f"[{label}] {what}: launches {run['launches']}, in process "
                                             f"{want['launches']}")
                    if how != "in_process" and not all(
                            max(t0 for t0, _ in w.values()) < min(t1 for _, t1 in w.values()) for w in run["walls"]):
                        raise AssertionError(f"[{label}] {what}: the workers' walls do not overlap on every chunk")
            peaks = pool.run([(i, torch.cuda.max_memory_allocated, ()) for i in range(len(devices))])
            # the whole-run programs' way: a fresh block of shared memory for one entry's frames each call
            rows = host[[0, 2], 0]
            fresh = []
            for _ in range(6):
                t0 = time.perf_counter()
                with workers._frames_file(rows):
                    pass
                fresh.append(1e3 * (time.perf_counter() - t0))
        finally:
            pool.close()
        left = [c.pid for c in multiprocessing.active_children() if c.pid in pool.pids]
        if left:
            raise AssertionError(f"[{label}] worker processes {left} outlived the pool")
        total = n_seq * N_FRAMES
        fps = {how: [total / r["seconds"] for r in rs] for how, rs in runs.items()}
        ms = {how: {"send_ms": [per_call_ms(r, "send_s") for r in runs[how]],
                    "open_ms": [per_call_ms(r, "open_s") for r in runs[how]],
                    "return_ms": [per_call_ms(r, "pack_s", "unpack_s") for r in runs[how]]}
              for how in ("ipc", "block")}
        rec = {"devices": names, "sequences": n_seq, "frames": N_FRAMES, "chunks": n_chunks, "fps": fps,
               "speedup_ipc": [f / fps["in_process"][i] for i, f in enumerate(fps["ipc"])],
               "exchange": ms, "fresh_block_ms": fresh, "pool_start_s": start_s, "warm_up_s": warm_s,
               "worker_peak_memory_bytes": peaks, "launches": runs["ipc"][0]["launches"],
               "in_process_launches": want["launches"]}
        log(f"[{label}] {names}: {n_seq} VO sequences of {N_FRAMES} frames, 2 a worker, {n_chunks} chunks: "
            f"frames/s in process {[round(f, 2) for f in fps['in_process']]}, over the workers with the card's "
            f"frames through CUDA IPC {[round(f, 2) for f in fps['ipc']]} ({[round(x, 3) for x in rec['speedup_ipc']]}"
            f"x), with host frames through the reused blocks {[round(f, 2) for f in fps['block']]}; every result "
            f"and the final states bit-equal to the step in process, launches {want['launches']} summed == in "
            f"process, walls overlapping on every chunk; a call's frames: IPC {ms['ipc']['send_ms']} ms to send, "
            f"{ms['ipc']['open_ms']} ms to open; reused block {ms['block']['send_ms']} ms to copy, "
            f"{ms['block']['open_ms']} ms to open; a fresh block for one entry "
            f"{[round(x, 3) for x in fresh]} ms; results back {ms['ipc']['return_ms']} ms; worker peak memory "
            f"{[round(p / 2**30, 3) for p in peaks]} GiB; pool start {start_s:.2f} s, warm-up {warm_s:.2f} s; "
            f"on {card}")
        recs.append(rec)
        if refs is None:
            refs = {"results": want["results"], "states": want["states"], "launches": want["launches"]}
    return {"meshes": recs, "launches": recs[0]["launches"]}, refs


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multihost_rank(rank: int, port: int, ts_path: str, ts_shape: tuple, out_dir: str) -> None:
    """One of ``[multihost]``'s two ranks, each owning ``cuda:0``: ``initialize_multihost()`` from the
    environment, the global mesh, then ``shard_sequence_program``, ``run_timesharded_system`` and the
    per-chunk step over it, and a run in which rank 1 raises; what it saw goes to ``out_dir/rank<r>.pkl``."""
    import os

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                      GLOO_SOCKET_IFNAME="lo")  # both ranks on this host: gloo over the loopback
    import torch.distributed as dist

    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.dist import hosts
    from tpuslam_torch.dist.mesh import (initialize_multihost, make_device_mesh, shard_batched_pipeline,
                                         shard_sequence_program)
    from tpuslam_torch.dist.timeshard import run_timesharded, run_timesharded_system
    from tpuslam_torch.dist.workers import _dumps
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.slam import SlamPipeline
    from tpuslam_torch.model.system import SlamSystem

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 2))
    t_start = time.perf_counter()
    rec: dict = {"rank": rank, "joined": initialize_multihost()}
    devices = make_device_mesh()
    rec["mesh"] = [str(d) for d in devices]
    config_dir = REPO / "configs"
    camera = Camera.from_yaml(config_dir / "camera.yml")
    config = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    vocab = config_dir / "vocabulary_tree.npz"
    pnp = SlamSystem(camera, config, vocabulary=vocab, tracking="pnp", device="cuda")
    vo = SlamSystem(camera, config, vocabulary=vocab, tracking="vo", device="cuda")
    pipe = SlamPipeline(camera, config, device="cuda")
    frames_np = load_frames(N_FRAMES)
    n = len(frames_np)
    chunks = np.broadcast_to(frames_np.reshape(1, n // BATCH, BATCH, *frames_np.shape[1:]),
                             (2, n // BATCH, BATCH, *frames_np.shape[1:])).copy()
    ts = np.memmap(ts_path, dtype=np.uint8, mode="r", shape=ts_shape)
    tiled = load_frames(N_FRAMES + 15)
    seqs = torch.from_numpy(np.stack([tiled[5 * s: 5 * s + N_FRAMES] for s in range(4)])).cuda()
    seqs = seqs.reshape(4, n // BATCH, BATCH, *tiled.shape[1:])
    rec["setup_s"] = time.perf_counter() - t_start

    def run(name: str, fn, *args, **kw):
        torch.cuda.synchronize()
        reset_launch_counts()
        hosts.EXCHANGES.clear()
        t0 = time.perf_counter()
        value = fn(*args, **kw)
        torch.cuda.synchronize()
        rec[name] = {"seconds": time.perf_counter() - t0, "launches": launch_counts(), "value": value,
                     "exchanges": list(hosts.EXCHANGES)}

    run("sequence_program", shard_sequence_program(pnp, devices), chunks, np.ones(chunks.shape[:3], bool), [0, 1])
    run("timeshard_slam", lambda: {k: v for k, v in run_timesharded_system(vo, ts, TS_SHARDS, devices=devices).items()
                                   if k != "seconds"})

    def drive_step():
        with shard_batched_pipeline(pipe, devices) as step:
            states, out = [pipe.initial_state() for _ in range(4)], []
            for c in range(n // BATCH):
                results, states = step(seqs[:, c], torch.ones((4, BATCH), dtype=torch.bool), states, [0, 1, 2, 3])
                out.append(hosts.fill_sequences(results))
            final = hosts.fill_sequences([None if h is None else step.fetch(h) for h in states])
        return {"results": out, "states": final}

    run("step", drive_step)

    def refuse_on_rank_1(d: int) -> dict:
        if rank == 1:
            raise RuntimeError(f"shard {d} refused on rank 1")
        return {}

    t0 = time.perf_counter()
    try:
        run_timesharded(pipe, ts, TS_SHARDS, devices=devices, shard_hooks=refuse_on_rank_1)
        rec["raised"] = None
    except hosts.RankError as exc:
        rec["raised"] = {"message": str(exc)[:4000], "seconds": time.perf_counter() - t0}
    dist.destroy_process_group()
    rec["destroyed"] = not dist.is_initialized()
    rec["wall_s"] = time.perf_counter() - t_start
    Path(out_dir, f"rank{rank}.pkl").write_bytes(_dumps(rec))


def phase_multihost(ts_frames: np.ndarray, card: str, uses, workers_refs: dict, step_refs: dict) -> dict:
    """A mesh that spans a process group: two ranks (``torch.multiprocessing`` ``spawn``, ``MASTER_ADDR``
    127.0.0.1 and a free port, gloo for every exchange), each owning ``cuda:0``.  On every rank:
    ``initialize_multihost()`` True and a global mesh of 2 entries; ``shard_sequence_program`` over
    ``[workers]``' two PnP SLAM sequences bit-equal to that phase's run over ``[cuda:0, cuda:0]``;
    ``run_timesharded_system`` (VO, the 192 frames from a memmap, 4 shards, 2 a rank) bit-equal to the
    in-process run on every field but ``seconds``; the per-chunk step with ``hosts.fill_sequences`` bit-equal
    to ``[step-workers]``' in-process step; launches summed over the ranks exact; rank 1 made to raise is
    named on rank 0 within 60 s; the group destroyed and no process left.  Each rank's wall, and the
    bytes and seconds of the exchanges."""
    import multiprocessing
    import pickle

    label = "multihost"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multihost_") as tmp:
        ts_path = Path(tmp) / "frames.u8"
        mm = np.memmap(ts_path, dtype=np.uint8, mode="w+", shape=ts_frames.shape)
        mm[:] = ts_frames
        mm.flush()
        del mm
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(
            _multihost_rank, args=(_free_port(), str(ts_path), tuple(ts_frames.shape), tmp), nprocs=2,
            join=False, start_method="spawn")
        pids = ctx.pids()
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 600:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"[{label}] the ranks did not end within 600 s")
        wall = time.perf_counter() - t0
        recs = [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes()) for r in range(2)]
    alive = [c.pid for c in multiprocessing.active_children() if c.pid in pids]
    if alive:
        raise AssertionError(f"[{label}] rank processes {alive} outlived the run")
    wants = {"sequence_program": (workers_refs["seq"], workers_refs["seq_counts"]),
             "timeshard_slam": (workers_refs["sys"], workers_refs["sys_counts"]),
             "step": ({"results": step_refs["results"], "states": step_refs["states"]}, step_refs["launches"])}
    summed = {}
    for r, rec in enumerate(recs):
        if rec["joined"] is not True or rec["mesh"] != ["rank 0 cuda:0", "rank 1 cuda:0"]:
            raise AssertionError(f"[{label}] rank {r}: joined {rec['joined']}, mesh {rec['mesh']}")
        for name, (want, _) in wants.items():
            same_bits(label, rec[name]["value"], want, f"rank {r} {name}")
        raised = rec["raised"]
        if raised is None or not raised["message"].startswith(f"rank 1 failed (seen on rank {r})") or \
                "shard 1 refused on rank 1" not in raised["message"] or raised["seconds"] >= 60:
            raise AssertionError(f"[{label}] rank {r}: the raising rank was not named in time: {raised}")
        if not rec["destroyed"]:
            raise AssertionError(f"[{label}] rank {r}: the group was not destroyed")
    for name, (_, want_counts) in wants.items():
        summed[name] = {k: sum(rec[name]["launches"][k] for rec in recs) for k in want_counts}
        if summed[name] != want_counts:
            raise AssertionError(f"[{label}] {name}: launches summed over the ranks {summed[name]}, in one process "
                                 f"{want_counts}")
    check_launches(label, summed["step"], {**{k: None for k in uses}, "fused_frontend_nms_batch": 0})
    total = {k: sum(s[k] for s in summed.values()) for k in summed["step"]}
    out = {"wall_s": wall, "launches": total, "launches_by_program": summed,
           "ranks": [{"wall_s": rec["wall_s"], "setup_s": rec["setup_s"], "raised_s": rec["raised"]["seconds"],
                      **{name: {"seconds": rec[name]["seconds"],
                                "exchange_bytes": sum(x["bytes"] for x in rec[name]["exchanges"]),
                                "exchange_s": sum(x["seconds"] for x in rec[name]["exchanges"]),
                                "largest_exchange": max(rec[name]["exchanges"], key=lambda x: x["bytes"],
                                                        default=None)}
                         for name in wants}} for rec in recs]}
    for r, rank in enumerate(out["ranks"]):
        log(f"[{label}] rank {r}: wall {rank['wall_s']:.2f} s (set-up {rank['setup_s']:.2f} s); " + "; ".join(
            f"{name} {rank[name]['seconds']:.2f} s, exchanges {rank[name]['exchange_bytes'] / 2**20:.1f} MiB in "
            f"{rank[name]['exchange_s']:.3f} s (largest {rank[name]['largest_exchange']})" for name in wants) +
            f"; rank 1's error reached it after {rank['raised_s']:.2f} s; on {card}")
    log(f"[{label}] 2 ranks on cuda:0 over gloo: shard_sequence_program, run_timesharded_system and the "
        f"per-chunk step bit-equal on every rank to the single-process runs, launches summed exact "
        f"({summed}); the raising rank named on both; {wall:.1f} s with the ranks' start; on {card}")
    return out


def phase_cli_timeshard(card: str) -> dict:
    """``python -m tpuslam_torch.cli --timeshard 2 --slam`` over the 10 fixtures, through ``frames_to_memmap``."""
    label = "cli-timeshard"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        traj = Path(tmp) / "traj.txt"
        cmd = [sys.executable, "-m", "tpuslam_torch.cli", "-c", "configs", "-v", "tests/data/images",
               "--timeshard", "2", "--slam", "--batch-size", "4", "--stats", "-o", str(traj)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[{label}] exit {proc.returncode}: {proc.stderr[-2000:]}")
        rows = np.loadtxt(traj)
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
    if rows.shape != (10, 12) or not np.isfinite(rows).all() or stats["frames"] != 10 or stats["segments"] != 2:
        raise AssertionError(f"[{label}] trajectory {rows.shape}, stats {stats}")
    log(f"[{label}] {' '.join(cmd[1:-2])}: exit 0, 10 trajectory rows, stats {stats}; {secs:.1f} s with the "
        f"process start, on {card}")
    return {"stats": stats, "seconds": secs}


LOADER_DIRS = ("images", "images_test_loop", "images_test_loop2", "test_images", "torch_loader/filters",
               "torch_loader/formats", "torch_loader/interlaced")


def write_adaptive_frames(frames_np: np.ndarray, directory: Path) -> None:
    """Each frame as a PNG with libpng's adaptive row filters (``encode_png``): Sub, Average, Paeth rows.

    The frames repeat the 10 fixtures, so each distinct frame is encoded once and its bytes copied.
    """
    from tpuslam_torch.post.png import encode_png

    encoded: dict[bytes, bytes] = {}
    for i, f in enumerate(frames_np):
        key = f.tobytes()
        if key not in encoded:
            encoded[key] = encode_png(f)
        (directory / f"{i:06d}.png").write_bytes(encoded[key])


def phase_loader(camera, config_dir: Path, frames_np: np.ndarray, card: str) -> dict:
    """The port's frame loader: native == plain decoder on every fixture directory; decode rates; the CLI's
    ``--slam`` over a directory of adaptive-filter PNGs beside ``SlamSystem.run`` over the frames in memory."""
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.system import SlamSystem
    from tpuslam_torch.pre import native_loader
    from tpuslam_torch.pre.stream import FrameStream, decode_png_gray8

    label = "loader"
    data = REPO / "tests" / "data"
    t0 = time.perf_counter()
    native_loader.library()
    build_s = time.perf_counter() - t0
    for name in LOADER_DIRS:
        loader = native_loader.NativeFrameLoader(data / name)
        got = loader.decode_batch(0, loader.n_frames)
        for frame, path in zip(got, loader.files):
            if not np.array_equal(frame, decode_png_gray8(path)):
                raise AssertionError(f"[{label}] {path}: the native loader and the plain decoder differ")
        loader.close()
    t0 = time.perf_counter()
    jpeg, twin_frames = check_jpeg_fixtures(label)
    jpeg["seconds"] = time.perf_counter() - t0
    log(f"[{label}] loader built in {build_s:.1f} s; native == plain decoder on {len(LOADER_DIRS)} directories "
        f"({', '.join(LOADER_DIRS)}); JPEG: loader == plain twin == the committed libjpeg bytes on "
        f"{jpeg['decoded']} fixtures of {', '.join(JPEG_DIRS)}, {jpeg['refused']} refused variants named "
        f"({'; '.join(jpeg['refusals'])}) in {jpeg['seconds']:.1f} s")

    cfg = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    vocab = config_dir / "vocabulary_tree.npz"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_png_") as tmp:
        tmp = Path(tmp)
        write_adaptive_frames(frames_np, tmp)
        loader = native_loader.NativeFrameLoader(tmp)
        decoded = loader.decode_indices(range(len(frames_np)))  # warm: the files in the page cache
        if not np.array_equal(decoded, frames_np):
            raise AssertionError(f"[{label}] the adaptive-filter frames do not decode to their source")
        t0 = time.perf_counter()
        loader.decode_indices(range(len(frames_np)))
        native_ms = 1e3 * (time.perf_counter() - t0) / len(frames_np)
        plain = [loader.files[i] for i in (0, 5, 9, 14)]
        t0 = time.perf_counter()
        for p in plain:
            decode_png_gray8(p)
        plain_ms = 1e3 * (time.perf_counter() - t0) / len(plain)
        t0 = time.perf_counter()
        for p in plain:
            decode_png_gray8(REPO / "tests" / "data" / "images" / f"{int(p.stem) % 10:010d}.png")
        committed_ms = 1e3 * (time.perf_counter() - t0) / len(plain)
        threads = loader.threads
        loader.close()
        stream = FrameStream(tmp)
        t0 = time.perf_counter()
        n_chunks = sum(1 for _ in stream.batches(BATCH))
        batches_ms = 1e3 * (time.perf_counter() - t0) / n_chunks
        stream.close()
        log(f"[{label}] {len(frames_np)} adaptive-filter frames: native {native_ms:.3f} ms a frame on {threads} "
            f"threads ({native_ms * threads:.3f} ms a frame a thread), FrameStream.batches {batches_ms:.2f} ms a "
            f"{BATCH}-frame chunk; plain decoder {plain_ms:.1f} ms a frame (the committed Sub-filtered frames: "
            f"{committed_ms:.1f}) on {card}")

        # the CLI in this process, so that both sides are warm: its --stats time covers its run()
        # over FrameStream.batches (the loader's pool decoding ahead) through device_prefetch
        from tpuslam_torch.cli import main as cli_main

        argv = ["-c", str(config_dir), "-v", str(tmp), "--slam", "--batch-size", str(BATCH), "--stats",
                "-o", str(tmp / "traj.txt")]
        system = SlamSystem(camera, cfg, vocabulary=vocab, tracking="vo", device="cuda")
        cli_fps, run_fps = [], []
        for turn in ("cli", "run", "cli", "run", "run", "cli"):  # a warm-up of each, then in turns
            if turn == "run":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = system.run(host_batches(frames_np), seed=0)
                torch.cuda.synchronize()
                run_fps.append(len(frames_np) / (time.perf_counter() - t0))
                continue
            printed = io.StringIO()
            reset_launch_counts()
            with contextlib.redirect_stdout(printed):
                rc = cli_main(argv)
            cli_launches = launch_counts()
            stats = json.loads(printed.getvalue().strip().splitlines()[-1])
            rows = np.loadtxt(tmp / "traj.txt")
            if rc or stats["frames"] != len(frames_np) or rows.shape != (len(frames_np), 12) \
                    or not np.isfinite(rows).all():
                raise AssertionError(f"[{label}] CLI exit {rc}, stats {stats}, trajectory {rows.shape}")
            cli_fps.append(stats["fps"])
        if float(out["pose_ok"][1:].mean()) < 0.9:
            raise AssertionError(f"[{label}] run: pose_ok {float(out['pose_ok'][1:].mean()):.3f}")
    n_chunks = len(frames_np) // BATCH
    check_launches(f"{label} cli", cli_launches, {"fused_frontend_batch": n_chunks, "extract_brief_patches": n_chunks,
                                                  "brief_own_bin_dots": n_chunks, "msac_scores": None,
                                                  "fused_frontend_nms_batch": 0})
    cli_fps, run_fps = cli_fps[1:], run_fps[1:]
    ratio = float(np.mean(cli_fps) / np.mean(run_fps))
    log(f"[{label}] --slam over the directory {[round(x, 2) for x in cli_fps]} frames/s (the CLI's --stats, "
        f"in this process) beside SlamSystem.run over the frames in memory {[round(x, 2) for x in run_fps]} "
        f"(after a warm-up of each, in turns: cli, run, run, cli): {ratio:.3f}x on {card}")
    return {"build_s": build_s, "native_ms_per_frame": native_ms, "threads": threads,
            "native_ms_per_frame_thread": native_ms * threads, "batches_ms_per_chunk": batches_ms,
            "plain_ms_per_frame": plain_ms, "plain_ms_per_frame_committed": committed_ms,
            "cli_fps": cli_fps, "run_fps": run_fps, "cli_over_run": ratio, "jpeg": jpeg, "cli_launches": cli_launches,
            "jpeg_twin_frames": twin_frames}


JPEG_DIRS = ("torch_loader/jpeg", "torch_loader/jpeg_kitti", "torch_loader/jpeg_variants")
JPEG_REFUSED = ("98_cmyk.jpg", "99_sof9.jpg")  # CMYK, and SOF9 (arithmetic coding)


def check_jpeg_fixtures(label: str) -> tuple[dict, dict]:
    """Every JPEG fixture through the loader and the plain twin, held to the libjpeg bytes of
    ``tests/data/torch_loader/expected_gray.npz`` (their SHA-256, and the variants' bytes themselves);
    the refused variants raise their named ``FrameDecodeError`` from both.  → (summary, the twin's
    ``jpeg_kitti`` frames by file name)."""
    import hashlib

    from tpuslam_torch.pre import native_loader
    from tpuslam_torch.pre.jpeg import decode_jpeg_gray8

    data = REPO / "tests" / "data"
    expected = np.load(data / "torch_loader" / "expected_gray.npz")
    twin_frames, decoded, refusals = {}, 0, []
    for sub in JPEG_DIRS:
        loader = native_loader.NativeFrameLoader(data / sub)
        for i, path in enumerate(loader.files):
            key = f"{sub.split('/', 1)[1]}/{path.name}"
            if path.name in JPEG_REFUSED:
                for decode in (lambda: loader.decode_indices([i]), lambda: decode_jpeg_gray8(path)):
                    try:
                        decode()
                    except native_loader.FrameDecodeError as exc:
                        if "not supported" not in str(exc) or path.name not in str(exc):
                            raise AssertionError(f"[{label}] {path}: refused without naming it: {exc}") from exc
                        refusals.append(str(exc).split(": ", 1)[1])
                    else:
                        raise AssertionError(f"[{label}] {path}: a refused JPEG variant decoded")
                continue
            got = loader.decode_indices([i])[0]
            if not np.array_equal(got, decode_jpeg_gray8(path)):
                raise AssertionError(f"[{label}] {path}: the loader and the plain twin differ")
            if hashlib.sha256(got.tobytes()).digest() != expected[f"{key}:sha256"].tobytes() or (
                    key in expected.files and not np.array_equal(got, expected[key])):
                raise AssertionError(f"[{label}] {path}: not the libjpeg bytes committed in expected_gray.npz")
            if sub.endswith("jpeg_kitti"):
                twin_frames[path.name] = got
            decoded += 1
        loader.close()
    return {"decoded": decoded, "refused": len(JPEG_REFUSED), "refusals": sorted(set(refusals))}, twin_frames


def ping_pong(n_frames: int, n_base: int) -> list[int]:
    period = 2 * (n_base - 1)
    return [min(i % period, period - i % period) for i in range(n_frames)]


def decode_rates(source: Path) -> dict:
    """The loader's ms a frame over a directory or a video: one frame a call (one thread busy) and all in one
    call (the pool)."""
    from tpuslam_torch.pre import native_loader

    opener = native_loader.NativeVideoLoader if source.is_file() else native_loader.NativeFrameLoader
    loader = opener(source)
    n = loader.n_frames
    loader.decode_indices(range(n))  # warm: the files in the page cache
    t0 = time.perf_counter()
    for i in range(n):
        loader.decode_indices([i])
    one = 1e3 * (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    loader.decode_indices(range(n))
    pool = 1e3 * (time.perf_counter() - t0) / n
    out = {"one_thread_ms": one, "pool_ms": pool, "threads": loader.threads}
    loader.close()
    return out


def phase_jpeg(camera, config_dir: Path, twin_frames: dict, card: str) -> dict:
    """JPEG frames on the card: decode ms a 1392x512 frame beside PNG's on the same frames, and the CLI's
    ``--slam`` over 96 JPEG frames (ping-pong links to the committed KITTI JPEGs) bit-equal to
    ``SlamSystem.run`` over the same frames decoded by the plain twin, in memory."""
    from tpuslam_torch.cli import main as cli_main
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.model.system import SlamSystem
    from tpuslam_torch.utils.checkpoint import save_state

    label = "jpeg"
    data = REPO / "tests" / "data"
    names = sorted(twin_frames)
    idx = ping_pong(N_FRAMES, len(names))
    frames_np = np.stack([twin_frames[names[k]] for k in idx])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jpeg_") as tmp:
        tmp = Path(tmp)
        jdir, pdir = tmp / "jpeg", tmp / "png"
        jdir.mkdir()
        pdir.mkdir()
        for i, k in enumerate(idx):
            (jdir / f"{i:06d}.jpg").symlink_to(data / "torch_loader" / "jpeg_kitti" / names[k])
            (pdir / f"{i:06d}.png").symlink_to(data / "images" / names[k].replace(".jpg", ".png"))
        rates = {"jpeg": decode_rates(jdir), "png": decode_rates(pdir)}
        log(f"[{label}] decode ms a 1392x512 frame, one frame a call / all {N_FRAMES} in one call on "
            f"{rates['jpeg']['threads']} threads: JPEG (4:2:0, quality 65) {rates['jpeg']['one_thread_ms']:.2f} / "
            f"{rates['jpeg']['pool_ms']:.2f}, PNG (the committed Sub-filtered frames) "
            f"{rates['png']['one_thread_ms']:.2f} / {rates['png']['pool_ms']:.2f} on {card}")

        cfg = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
        system = SlamSystem(camera, cfg, vocabulary=config_dir / "vocabulary_tree.npz", tracking="vo",
                            device="cuda")
        argv = ["-c", str(config_dir), "-v", str(jdir), "--slam", "--batch-size", str(BATCH), "--stats",
                "-o", str(tmp / "traj.txt"), "--save-state", str(tmp / "cli.npz")]
        cli_fps, run_fps = [], []
        for turn in ("cli", "run", "cli", "run", "run", "cli"):  # a warm-up of each, then in turns
            if turn == "run":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = system.run(host_batches(frames_np), seed=0)
                torch.cuda.synchronize()
                run_fps.append(len(frames_np) / (time.perf_counter() - t0))
                continue
            printed = io.StringIO()
            reset_launch_counts()
            with contextlib.redirect_stdout(printed):
                rc = cli_main(argv)
            cli_launches = launch_counts()
            stats = json.loads(printed.getvalue().strip().splitlines()[-1])
            if rc or stats["frames"] != len(frames_np):
                raise AssertionError(f"[{label}] CLI exit {rc}, stats {stats}")
            cli_fps.append(stats["fps"])
        save_state(tmp / "run.npz", slam=out["checkpoint"])
        cli_ck, run_ck = np.load(tmp / "cli.npz"), np.load(tmp / "run.npz")
        if sorted(cli_ck.files) != sorted(run_ck.files):
            raise AssertionError(f"[{label}] the CLI's checkpoint and run()'s hold different leaves")
        for k in run_ck.files:
            a, b = cli_ck[k], run_ck[k]
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                raise AssertionError(f"[{label}] the CLI over the JPEG directory != run() over the twin's frames: "
                                     f"leaf {k}")
        if float(out["pose_ok"][1:].mean()) < 0.9:
            raise AssertionError(f"[{label}] run: pose_ok {float(out['pose_ok'][1:].mean()):.3f}")
    n_chunks = len(frames_np) // BATCH
    check_launches(f"{label} cli", cli_launches, {"fused_frontend_batch": n_chunks, "extract_brief_patches": n_chunks,
                                                  "brief_own_bin_dots": n_chunks, "msac_scores": None,
                                                  "fused_frontend_nms_batch": 0})
    log(f"[{label}] --slam over {len(frames_np)} JPEG frames == SlamSystem.run over the twin's frames in memory: "
        f"{len(run_ck.files)} checkpoint leaves bit-equal, pose_ok {float(out['pose_ok'][1:].mean()):.3f}; "
        f"frames/s CLI {[round(x, 2) for x in cli_fps[1:]]} (--stats) and run() {[round(x, 2) for x in run_fps[1:]]} "
        f"(after a warm-up of each, in turns: cli, run, run, cli): {np.mean(cli_fps[1:]) / np.mean(run_fps[1:]):.3f}x "
        f"on {card}")
    return {"decode": rates, "cli_fps": cli_fps[1:], "run_fps": run_fps[1:],
            "cli_over_run": float(np.mean(cli_fps[1:]) / np.mean(run_fps[1:])), "leaves": len(run_ck.files),
            "pose_ok": float(out["pose_ok"][1:].mean()), "cli_launches": cli_launches}


VIDEO_FIXTURES = {"opencv_mjpeg.avi": (1, 10), "ffmpeg_mjpeg.avi": (100, 2997)}  # dwScale, dwRate


def check_video_fixtures(label: str) -> int:
    """The committed writer fixtures (OpenCV's own Motion JPEG writer, FFmpeg's) through the loader and the twin,
    held to the libjpeg bytes of ``tests/data/torch_video/expected_luma.npz``, without OpenCV."""
    from tpuslam_torch.pre import native_loader
    from tpuslam_torch.pre.avi import open_avi

    d = REPO / "tests" / "data" / "torch_video"
    expected = np.load(d / "expected_luma.npz")
    for name, time_base in VIDEO_FIXTURES.items():
        loader = native_loader.NativeVideoLoader(d / name)
        twin = open_avi(d / name)
        if (loader.scale, loader.rate) != time_base or loader.n_frames != len(expected[name]):
            raise AssertionError(f"[{label}] {name}: time base {loader.scale}/{loader.rate}, {loader.n_frames} frames")
        if not np.array_equal(loader.decode_batch(0, loader.n_frames), expected[name]) or any(
                not np.array_equal(twin.decode(i), expected[name][i]) for i in range(twin.n_frames)):
            raise AssertionError(f"[{label}] {name}: not the libjpeg bytes committed in expected_luma.npz")
        loader.close()
    return len(VIDEO_FIXTURES)


def phase_video(config_dir: Path, twin_frames: dict, card: str) -> dict:
    """A Motion JPEG AVI of the 96 ping-pong KITTI JPEGs (``write_mjpeg_avi``) beside a directory of links to
    the same files: the frames equal, decode ms a frame of each, and the CLI's ``--slam`` (with
    ``--save-state``) and VO over each with ``--plot``, in turns: trajectories and checkpoint leaves bit-equal."""
    from tpuslam_torch.cli import main as cli_main
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.pre import native_loader
    from tpuslam_torch.pre.avi import open_avi
    from tpuslam_torch.pre.stream import FrameStream

    label = "video"
    src = REPO / "tests" / "data" / "torch_loader" / "jpeg_kitti"
    names = sorted(twin_frames)
    idx = ping_pong(N_FRAMES, len(names))
    n_fixtures = check_video_fixtures(label)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as tmp:
        tmp = Path(tmp)
        jdir = tmp / "jpeg"
        jdir.mkdir()
        for i, k in enumerate(idx):
            (jdir / f"{i:06d}.jpg").symlink_to(src / names[k])
        avi = write_mjpeg_avi(tmp / "kitti.avi", [(src / names[k]).read_bytes() for k in idx], 1392, 512)
        video = native_loader.NativeVideoLoader(avi)
        frames = video.decode_batch(0, video.n_frames)
        twin = open_avi(avi)
        same = np.array_equal(frames, native_loader.NativeFrameLoader(jdir).decode_batch(0, N_FRAMES)) and all(
            np.array_equal(frames[i], twin_frames[names[k]]) for i, k in enumerate(idx))
        if video.n_frames != N_FRAMES or not same or not np.array_equal(twin.offsets, video.offsets):
            raise AssertionError(f"[{label}] the video's frames differ from the loader's decode of the JPEG files")
        stream = FrameStream(avi)
        last, stamp = stream.read_frame(N_FRAMES - 1)
        if stream.total_frames != N_FRAMES or stamp != (N_FRAMES - 1) / 10 or not np.array_equal(last, frames[-1]):
            raise AssertionError(f"[{label}] FrameStream: {stream.total_frames} frames, stamps {stream._timestamps[:3]}")
        stream.close()
        video.close()
        rates = {"video": decode_rates(avi), "jpeg": decode_rates(jdir)}
        log(f"[{label}] decode ms a 1392x512 frame, one frame a call / all {N_FRAMES} in one call on "
            f"{rates['video']['threads']} threads: the Motion JPEG AVI {rates['video']['one_thread_ms']:.2f} / "
            f"{rates['video']['pool_ms']:.2f}, the directory of the same JPEGs {rates['jpeg']['one_thread_ms']:.2f} / "
            f"{rates['jpeg']['pool_ms']:.2f} on {card}")

        def cli(source: Path, name: str, *extra: str) -> tuple[dict, dict]:
            printed = io.StringIO()
            reset_launch_counts()
            with contextlib.redirect_stdout(printed):
                rc = cli_main(["-c", str(config_dir), "-v", str(source), "--batch-size", str(BATCH), "--stats",
                               "-o", str(tmp / f"{name}.txt"), "--plot", str(tmp / f"{name}.png"), *extra])
            stats = json.loads(printed.getvalue().strip().splitlines()[-1])
            if rc or stats["frames"] != N_FRAMES:
                raise AssertionError(f"[{label}] CLI {name}: exit {rc}, stats {stats}")
            return stats, launch_counts()

        sources = {"video": avi, "directory": jdir}
        fps = {"video": [], "directory": []}
        slam_launches = {}
        for turn in ("video", "directory", "directory", "video"):
            stats, slam_launches[turn] = cli(sources[turn], f"slam_{turn}", "--slam", "--save-state",
                                             str(tmp / f"slam_{turn}.npz"))
            fps[turn].append(stats["fps"])
        vo_launches = {turn: cli(sources[turn], f"vo_{turn}")[1] for turn in sources}
        for kind in ("slam", "vo"):
            if (tmp / f"{kind}_video.txt").read_bytes() != (tmp / f"{kind}_directory.txt").read_bytes():
                raise AssertionError(f"[{label}] {kind}: the trajectory over the video != over the directory")
        ck = {turn: np.load(tmp / f"slam_{turn}.npz") for turn in sources}
        if sorted(ck["video"].files) != sorted(ck["directory"].files) or any(
                ck["video"][k].tobytes() != ck["directory"][k].tobytes() or ck["video"][k].dtype != ck["directory"][k].dtype
                for k in ck["video"].files):
            raise AssertionError(f"[{label}] --slam: a checkpoint leaf over the video != over the directory")
        plots = {name: (tmp / f"{name}.png").read_bytes() for name in ("slam_video", "vo_video")}
    n_chunks = N_FRAMES // BATCH
    for turn in sources:
        check_launches(f"{label} --slam {turn}", slam_launches[turn],
                       {"fused_frontend_batch": n_chunks, "extract_brief_patches": n_chunks,
                        "brief_own_bin_dots": n_chunks, "msac_scores": None, "fused_frontend_nms_batch": 0})
        check_launches(f"{label} vo {turn}", vo_launches[turn],
                       {**{k: n_chunks for k in ("fused_frontend_batch", "extract_brief_patches",
                                                 "brief_own_bin_dots", "msac_scores")}, "fused_frontend_nms_batch": 0})
    if slam_launches["video"] != slam_launches["directory"]:
        raise AssertionError(f"[{label}] --slam launches differ: {slam_launches}")
    log(f"[{label}] the CLI over the video == over the directory: --slam trajectory and {len(ck['video'].files)} "
        f"checkpoint leaves, VO trajectory, bit-equal; {n_fixtures} committed writer fixtures == their libjpeg bytes; "
        f"frames/s --slam (--stats, in turns: video, directory, directory, video) video "
        f"{[round(x, 2) for x in fps['video']]}, directory {[round(x, 2) for x in fps['directory']]}: "
        f"{np.mean(fps['video']) / np.mean(fps['directory']):.3f}x on {card}")
    return {"decode": rates, "cli_fps": fps, "video_over_directory": float(np.mean(fps["video"]) / np.mean(fps["directory"])),
            "leaves": len(ck["video"].files), "cli_launches": slam_launches["video"], "vo_launches": vo_launches["video"],
            "fixtures": n_fixtures, "plots": plots}


def phase_plot(pipeline, frames_np: np.ndarray, plots: dict, card: str) -> dict:
    """The visualizer: keypoints, matches and depth-coloured points of one detector run on the card drawn
    equal to those of the same run on the CPU; every PNG written (these and [video]'s ``--plot`` files)
    decodes through the port's loader to its drawn size."""
    from tpuslam_torch.common.camera import undistort_image
    from tpuslam_torch.frontend.detector import FeatureDetector
    from tpuslam_torch.frontend.matcher import FeatureMatcher
    from tpuslam_torch.post import visualizer
    from tpuslam_torch.pre import native_loader

    label = "plot"
    cfg = pipeline.config
    idx, ok = pipeline.undistort_idx, pipeline.undistort_valid
    frames = torch.from_numpy(frames_np[:2].copy())
    runs = {}
    for key, det in (("card", pipeline.detector), ("cpu", FeatureDetector(cfg.detector, device="cpu"))):
        dev = det.device
        und = [undistort_image(frames[i].to(dev), idx.to(dev), ok.to(dev), normalize=False) for i in (0, 1)]
        kd, dd = zip(*(det.detect_and_compute(u) for u in und))
        m = FeatureMatcher(cfg.matcher).match(dd[0], dd[1], kd[0], kd[1])
        runs[key] = (und[0].cpu().numpy(), und[1].cpu().numpy(), kd, m)
    drawn, ms = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plot_") as tmp:
        tmp = Path(tmp)
        for key, (img0, img1, kd, m) in runs.items():
            t0 = time.perf_counter()
            drawn[key] = {
                "keypoints": visualizer.draw_keypoints(img0, kd[0], tmp / f"keypoints_{key}.png"),
                "matches": visualizer.draw_matches(img0, kd[0], img1, kd[1], m, tmp / f"matches_{key}.png"),
                "depth": visualizer.draw_depth_matches(img0, kd[0].xy, kd[0].response, kd[0].valid,
                                                       tmp / f"depth_{key}.png"),
            }
            ms[key] = 1e3 * (time.perf_counter() - t0)
        for name in drawn["card"]:
            if not np.array_equal(drawn["card"][name], drawn["cpu"][name]):
                raise AssertionError(f"[{label}] {name}: drawn from the card's run != from the CPU's")
        want = {name: (visualizer.SIZE, visualizer.SIZE) for name in plots}
        for name, data in plots.items():
            (tmp / f"{name}.png").write_bytes(data)
        for key, arrays in drawn.items():
            want.update({f"{name}_{key}": a.shape[:2] for name, a in arrays.items()})
        shapes = {}
        for name, shape in want.items():  # each file alone: a directory's frames share one size
            (tmp / name).mkdir()
            (tmp / f"{name}.png").rename(tmp / name / "0.png")
            img = native_loader.NativeFrameLoader(tmp / name).decode_indices([0])[0]
            if img.shape != shape:
                raise AssertionError(f"[{label}] {name}.png decodes to {img.shape}, drawn {shape}")
            shapes[name] = list(img.shape)
    n_kps, n_matches = int(runs["card"][2][0].valid.sum()), int(runs["card"][3].valid.sum())
    log(f"[{label}] {n_kps} keypoints and {n_matches} matches of the card's detector run drawn == the CPU run's "
        f"(keypoints, matches, depth-coloured points); {len(shapes)} PNGs, [video]'s --plot files among them, "
        f"decode through the port's loader to their drawn size; drawing the three {ms['card']:.1f} ms on {card}")
    return {"keypoints": n_kps, "matches": n_matches, "draw_ms": ms, "shapes": shapes}


ROUNDED = ("min_absolute_score", "relative_score_factor", "recall_envelope", "forward_false_candidate_rate")


def same_result(label: str, got, want, path: str = "result") -> None:
    """Tool result dicts equal: ints, bools and strings exactly, floats to 1e-5 (the rounded fields of
    ``calibrate``'s result are held exactly by the caller)."""
    if isinstance(want, dict):
        if got.keys() != want.keys():
            raise AssertionError(f"[{label}] {path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_result(label, got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"[{label}] {path}: {len(got)} != {len(want)} entries")
        for i, (g, w) in enumerate(zip(got, want)):
            same_result(label, g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        if abs(got - want) > 1e-5:
            raise AssertionError(f"[{label}] {path}: {got} != {want}")
    elif got != want:
        raise AssertionError(f"[{label}] {path}: {got!r} != {want!r}")


def phase_vocab_tools(card: str) -> dict:
    """``train_vocabulary`` (flat and a (16, 16) tree over the KITTI JPEG and a PNG loop directory, and
    every augment operation), ``calibrate_vocabulary`` and ``eval_vocabulary`` (``configs/vocabulary.npz``
    and the tree) on the card against the CPU: the arrays equal, the result dicts equal."""
    from tpuslam_torch.config.schema import LoopClosureConfig
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.tools import calibrate_vocabulary, eval_vocabulary, train_vocabulary

    label = "vocab-tools"
    data = REPO / "tests" / "data"
    dirs = [str(data / "torch_loader" / "jpeg_kitti"), str(data / "images_test_loop")]
    seconds, launches = {}, {}
    total = {k: 0 for k in KERNELS}

    def on(name, dev, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds[f"{name} {dev}"] = time.perf_counter() - t0
        if dev == "cuda":
            launches[name] = launch_counts()
            for k, v in launches[name].items():
                total[k] += v
        return out, printed.getvalue()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_vocab_") as tmp:
        tmp = Path(tmp)
        for kind, extra in (("flat", []), ("tree", ["--tree", "16,16"])):
            for dev in ("cuda", "cpu"):
                on(f"train_vocabulary {kind}", dev, lambda: train_vocabulary.main(
                    [*dirs, "-o", str(tmp / f"{kind}_{dev}.npz"), *extra, "--device", dev]))
            got, want = np.load(tmp / f"{kind}_cuda.npz"), np.load(tmp / f"{kind}_cpu.npz")
            if sorted(got.files) != sorted(want.files) or any(not np.array_equal(got[k], want[k]) for k in want.files):
                raise AssertionError(f"[{label}] train_vocabulary {kind}: the card's arrays != the CPU's")
    frame = torch.from_numpy(load_frames(1)[0])
    card_vars = list(train_vocabulary.variants(frame.cuda(), 9, 0))
    cpu_vars = list(train_vocabulary.variants(frame, 9, 0))
    if any(not torch.equal(g.cpu(), c) for g, c in zip(card_vars, cpu_vars)):
        raise AssertionError(f"[{label}] an augment operation differs between the card and the CPU")
    lc_cfg = LoopClosureConfig.from_yaml(REPO / "configs" / "loop_closure.yml")
    results = {}
    for vocab in ("configs/vocabulary.npz", "configs/vocabulary_tree.npz"):
        for tool, fn in (("calibrate_vocabulary", calibrate_vocabulary.calibrate),
                         ("eval_vocabulary", eval_vocabulary.evaluate)):
            name = f"{tool} {Path(vocab).stem}"
            got, _ = on(name, "cuda", lambda: fn(REPO / vocab, lc_cfg, device="cuda"))
            want, _ = on(name, "cpu", lambda: fn(REPO / vocab, lc_cfg, device="cpu"))
            same_result(f"{label} {name}", got, want)
            if tool == "calibrate_vocabulary" and any(got.get(k) != want.get(k) for k in ROUNDED):
                raise AssertionError(f"[{label}] {name}: rounded fields {got} != {want}")
            results[name] = got
    for name in launches:
        if launches[name]["fused_frontend_batch"] == 0 or any(
                launches[name][k] for k in KERNELS if k != "fused_frontend_batch"):
            raise AssertionError(f"[{label}] {name}: launches {launches[name]} (kernel 1 only, BRIEF bins 0)")
    log(f"[{label}] train_vocabulary (flat 256 words, tree 16x16) over {len(dirs)} directories (JPEG, PNG) and "
        f"the 9 augment operations: card == CPU; calibrate_vocabulary and eval_vocabulary with "
        f"vocabulary.npz and vocabulary_tree.npz: card == CPU ({results['calibrate_vocabulary vocabulary_tree']})")
    log(f"[{label}] seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + f" on {card}")
    log(f"[{label}] kernel 1 launches on the card: "
        + ", ".join(f"{k} {v['fused_frontend_batch']}" for k, v in launches.items()))
    return {"seconds": seconds, "launches_by_tool": launches, "launches": total, "results": results}


def phase_soak(card: str) -> dict:
    """``tools/soak.py``'s run: 1,536 frames, VO, the tree vocabulary, redundancy eviction."""
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.tools import soak

    label = "soak"
    frames, filler_end = soak.build_sequence(1536)
    system = soak.soak_system("redundancy", "vo", "configs/vocabulary_tree.npz", "cuda")
    reset_launch_counts()
    report, _ = soak.run_soak(system, frames, filler_end)
    counts = launch_counts()
    n_chunks = len(frames) // BATCH
    check_launches(label, counts, {"fused_frontend_batch": n_chunks, "extract_brief_patches": n_chunks,
                                   "brief_own_bin_dots": n_chunks, "msac_scores": None, "fused_frontend_nms_batch": 0})
    if counts["msac_scores"] < n_chunks:  # one a chunk, and one more a chunk where a lost frame relocalizes
        raise AssertionError(f"[{label}] kernel 4 launched {counts['msac_scores']} times in {n_chunks} chunks")
    mem = report["memory_allocated_by_chunk"]
    shown = {k: v for k, v in report.items() if k != "memory_allocated_by_chunk"}
    steps = np.diff(mem)
    log(f"[{label}] {json.dumps(shown)} on {card}")
    log(f"[{label}] memory allocated after chunks 0, 1, {report['memory_settled_chunk']} (the ring's first "
        f"overflow) and the last: {mem[0]}, {mem[1]}, {mem[report['memory_settled_chunk']]}, {mem[-1]} bytes; "
        f"largest step {int(steps.max())} after chunk {int(steps.argmax())}, "
        f"{int((steps > 0).sum())} of {len(steps)} steps up")
    if not report["ok"]:
        raise AssertionError(f"[{label}] the soak failed its rule: {report}")
    report["launches"] = counts
    return report


def _soak_process(out_path: str, card: str) -> None:
    """``phase_soak`` in a process of its own: its report and printed lines, or its traceback, to
    ``out_path`` as JSON."""
    import traceback

    torch.set_num_threads(2)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            result = ["ok", phase_soak(card)]
    except Exception:
        result = ["error", traceback.format_exc()]
    Path(out_path).write_text(json.dumps(result + [printed.getvalue()]))


def start_soak(card: str, tmp: str):
    """``[soak]`` started in its own process (spawned, its own launch counters), beside the phases that
    follow; ``finish_soak`` collects it."""
    import multiprocessing

    out_path = str(Path(tmp) / "soak.json")
    proc = multiprocessing.get_context("spawn").Process(target=_soak_process, args=(out_path, card))
    proc.start()
    return proc, out_path, time.perf_counter()


def finish_soak(proc, out_path: str, t0: float) -> dict:
    """Wait for ``start_soak``'s process (at most 900 s), print its lines, and fail where it failed."""
    proc.join(900)
    if proc.is_alive():
        proc.kill()
        proc.join()
        raise AssertionError("[soak] did not end within 900 s")
    if not Path(out_path).exists():
        raise AssertionError(f"[soak] its process ended with exit code {proc.exitcode} and no report")
    status, value, printed = json.loads(Path(out_path).read_text())
    sys.stdout.write(printed)
    if status != "ok":
        raise AssertionError(f"[soak] failed in its process:\n{value}")
    log(f"[soak] phase took {time.perf_counter() - t0:.1f} s, beside the phases since [loader]")
    return value


def phase_profile(camera, config_dir: Path, frames_np: np.ndarray, card: str) -> dict:
    """``tools/profile_stages.py`` on the main path and the pyramid, and ``tools/profile_slam.py`` (VO,
    PnP and localization against the PnP run's map, the tree vocabulary) over the 96 frames."""
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.model.slam import SlamPipeline
    from tpuslam_torch.tools import profile_slam, profile_stages

    label = "profile"
    chunk = torch.from_numpy(frames_np[:BATCH])
    out = {}
    for name, cfg_dir, fused in (("main", config_dir, False), ("pyramid", config_dir / "multiscale", True)):
        pipe = SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml") if fused else camera,
                            SlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH), device="cuda", nms_fused=fused)
        out[name] = profile_stages.profile_stages(pipe, chunk[None])
        log(f"[{label}] profile_stages, {name} ({cfg_dir.relative_to(REPO)}), batch {BATCH}, on {card}:\n"
            + profile_stages.format_table(out[name]))
    cfg = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    out["slam"] = profile_slam.profile_slam(camera, cfg, config_dir / "vocabulary_tree.npz", frames_np, "cuda")
    log(f"[{label}] profile_slam, {len(frames_np)} frames batch {BATCH}, tree vocabulary, on {card}:\n"
        + profile_slam.format_table(out["slam"]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels.build import library
    from tpuslam_torch.model.slam import SlamPipeline

    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = library()
    log(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    config_dir = REPO / "configs"
    pyramid_dir = config_dir / "multiscale"
    camera = Camera.from_yaml(config_dir / "camera.yml")
    pipeline = SlamPipeline(camera, SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH), device="cuda")
    pyr_config = SlamConfig.from_yaml_dir(pyramid_dir, batch_size=BATCH)
    pyr_camera = Camera.from_yaml(pyramid_dir / "camera.yml")
    pyramid = {fused: SlamPipeline(pyr_camera, pyr_config, device="cuda", nms_fused=fused)
               for fused in (True, False)}
    frames_np = load_frames(N_FRAMES)
    frames = torch.from_numpy(frames_np).cuda()

    records = phase_kernels(pipeline, frames[:BATCH])
    records.insert(1, phase_kernel5(pyramid[True], frames[:BATCH]))
    records.append(phase_jacobi())
    phase_frontend(config_dir / "feature_detector.yml", frames_np, nms_fused=False)
    phase_frontend(pyramid_dir / "feature_detector.yml", frames_np, nms_fused=True)

    chunks = frames.reshape(-1, BATCH, *frames.shape[1:])
    valid = torch.ones(chunks.shape[:2], dtype=torch.bool)
    n_chunks = chunks.shape[0]
    main_uses = ("fused_frontend_batch", "extract_brief_patches", "brief_own_bin_dots", "msac_scores")

    # Main path: configs/, kernels 1-4.
    drive(pipeline, chunks, valid, seed=1)  # warm-up
    result, run_s, main_counts, _ = drive(pipeline, chunks, valid, seed=0)
    check_launches("main", main_counts, {**{k: None for k in main_uses}, "fused_frontend_nms_batch": 0,
                                         "jacobi_nullvec": JACOBI_PER_CHUNK * n_chunks})
    fps = check_trajectory("main", result, run_s, card)

    # Pyramid path: configs/multiscale, kernel 5 on every level, then kernel 1 on every level.
    n_levels = len(pyramid[True].detector._feasible_levels(*frames.shape[-2:]))
    per_level = n_levels * n_chunks
    expected = {
        fused: {"fused_frontend_nms_batch": per_level if fused else 0,
                "fused_frontend_batch": 0 if fused else per_level,
                "extract_brief_patches": per_level, "brief_own_bin_dots": per_level,
                "msac_scores": None, "jacobi_nullvec": JACOBI_PER_CHUNK * n_chunks}
        for fused in (True, False)
    }
    for fused in (True, False):
        drive(pyramid[fused], chunks, valid, seed=1)  # warm-up
    pyr_fps = {True: [], False: []}
    pyr_counts = {}
    for fused in (True, False, False, True):  # in turns, against drift
        result, run_s, counts, _ = drive(pyramid[fused], chunks, valid, seed=0)
        label = f"pyramid nms_fused={fused}"
        if fused not in pyr_counts:
            check_launches(label, counts, expected[fused])
            pyr_counts[fused] = counts
        pyr_fps[fused].append(check_trajectory(label, result, run_s, card))
    log(f"[pyramid] {n_levels} levels, {N_FRAMES} frames batch {BATCH}: frames/s with kernel 5 "
        f"{pyr_fps[True]}, with kernel 1 + NMS {pyr_fps[False]} on {card}")

    # The last modules: the configs/fast profile, exact BRIEF, the single-image API and facades,
    # Vocabulary.fit and the profiling utilities.
    t_new = time.perf_counter()
    fast = timed_phase("fast", phase_fast, pipeline, config_dir, chunks, valid, card, main_uses)
    exact = timed_phase("exact-brief", phase_exact_brief, pipeline, config_dir, frames_np, card)
    single = timed_phase("single", phase_single, pipeline, camera, frames_np, card)
    vocab_fit = timed_phase("vocab-fit", phase_vocab_fit, pipeline, frames_np, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as trace_dir:
        profiling = timed_phase("profiling", phase_profiling, pipeline, chunks, valid, Path(trace_dir))
    log(f"[new phases] fast, exact-brief, single, vocab-fit, profiling took {time.perf_counter() - t_new:.1f} s")

    # PnP tracking: configs/ with tracking="pnp", kernels 1-4 in its two-view stage.
    pnp = timed_phase("pnp", phase_pnp, camera, config_dir, chunks, valid, card, main_uses)

    # The SLAM back end (loop closure off): VO, then PnP tracking, kernels 1-4 in the two-view stage.
    main_chunk_ms = 1e3 * N_FRAMES / fps / n_chunks
    slam = {tracking: timed_phase(f"slam{'' if tracking == 'vo' else '-pnp'}", phase_slam, camera, config_dir,
                                  frames_np, card, main_uses, tracking, main_chunk_ms)
            for tracking in ("vo", "pnp")}

    # Full SLAM with loop closure, relocalization and the pose graph: VO, then PnP tracking.
    slam_lc = {tracking: timed_phase(f"slam-lc{'' if tracking == 'vo' else '-pnp'}", phase_slam_lc, camera,
                                     config_dir, frames_np, card, main_uses, tracking, main_chunk_ms)
               for tracking in ("vo", "pnp")}
    pose_graph = check_pose_graph_pcg()

    # The streaming driver through device_prefetch, VO then PnP, each split through a checkpoint file;
    # then localization against the frozen map and DB of the PnP run, read back from its file.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ckpt_dir:
        stream = {tracking: timed_phase("stream" if tracking == "vo" else "stream-pnp", phase_stream, camera,
                                        config_dir, frames_np, card, main_uses, tracking, Path(ckpt_dir))
                  for tracking in ("vo", "pnp")}
        localize = timed_phase("localize", phase_localize, camera, config_dir, frames_np, card, main_uses,
                               stream["pnp"])
    for key in ("checkpoint_path", "mapping_poses"):
        stream["pnp"].pop(key)

    # Time sharding: 192 frames cut into 4 shards, run in turn on the card; VO, then full SLAM in both
    # modes; then one PnP SLAM sequence per card, and the CLI's --timeshard.
    ts_frames = load_frames(TS_FRAMES)
    timeshard = timed_phase("timeshard", phase_timeshard, camera, config_dir, ts_frames, card, main_uses)
    multiseq_vo = timed_phase("multiseq-vo", phase_multiseq_vo, camera, config_dir, card, main_uses)
    ts_slam = {tracking: timed_phase("timeshard-slam" if tracking == "vo" else "timeshard-slam-pnp",
                                     phase_timeshard_slam, camera, config_dir, ts_frames, card, main_uses, tracking)
               for tracking in ("vo", "pnp")}
    multiseq = timed_phase("multiseq", phase_multiseq, camera, config_dir, frames_np, card, main_uses)
    workers = timed_phase("workers", phase_workers, camera, config_dir, frames_np, ts_frames, card, main_uses)
    t_new = time.perf_counter()
    step_workers, step_refs = timed_phase("step-workers", phase_step_workers, camera, config_dir, card, main_uses)
    multihost = timed_phase("multihost", phase_multihost, ts_frames, card, main_uses, workers.pop("multihost_refs"),
                            step_refs)
    del step_refs
    log(f"[new phases] step-workers, multihost took {time.perf_counter() - t_new:.1f} s")
    cli_ts = timed_phase("cli-timeshard", phase_cli_timeshard, card)

    # The frame loader and the CLI over a directory, the soak past the keyframe ring (in a process of its
    # own, beside the phases after it: the script's time limit), the stage profiles.
    soak_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_soak_")
    soak_run = start_soak(card, soak_tmp.name)
    t_new = time.perf_counter()
    loader = timed_phase("loader", phase_loader, camera, config_dir, frames_np, card)
    t_jpeg = time.perf_counter()
    twin_frames = loader.pop("jpeg_twin_frames")
    jpeg = timed_phase("jpeg", phase_jpeg, camera, config_dir, twin_frames, card)
    vocab_tools = timed_phase("vocab-tools", phase_vocab_tools, card)
    log(f"[new phases] jpeg, vocab-tools took {time.perf_counter() - t_jpeg:.1f} s (and the JPEG checks of "
        f"[loader] {loader['jpeg']['seconds']:.1f} s)")
    t_video = time.perf_counter()
    video = timed_phase("video", phase_video, config_dir, twin_frames, card)
    plot = timed_phase("plot", phase_plot, pipeline, frames_np, video.pop("plots"), card)
    log(f"[new phases] video, plot took {time.perf_counter() - t_video:.1f} s")
    profile = timed_phase("profile", phase_profile, camera, config_dir, frames_np, card)
    soak = finish_soak(*soak_run)
    soak_tmp.cleanup()
    log(f"[new phases] loader, jpeg, vocab-tools, video, plot, soak, profile took {time.perf_counter() - t_new:.1f} s")

    for r in records:
        on_pyramid = r["name"] == "fused_frontend_nms_batch"
        r["path"] = "pyramid (configs/multiscale, nms_fused)" if on_pyramid else "main (configs/)"
        r["launches"] = (pyr_counts[True] if on_pyramid else main_counts)[r["name"]]
        r["launches_per_chunk"] = r["launches"] / n_chunks
        r["launches_by_path"] = {"main": main_counts[r["name"]], "pyramid_nms_fused": pyr_counts[True][r["name"]],
                                 "pyramid_kernel1": pyr_counts[False][r["name"]],
                                 "fast": fast["launches"][r["name"]], "exact_brief": exact["launches"][r["name"]],
                                 "single": single["launches"][r["name"]],
                                 "pnp": pnp["launches"][r["name"]],
                                 "slam": slam["vo"]["launches"][r["name"]],
                                 "slam_pnp": slam["pnp"]["launches"][r["name"]],
                                 "slam_lc": slam_lc["vo"]["launches"][r["name"]],
                                 "slam_lc_pnp": slam_lc["pnp"]["launches"][r["name"]],
                                 "stream": stream["vo"]["launches"][r["name"]],
                                 "stream_pnp": stream["pnp"]["launches"][r["name"]],
                                 "localize": localize["launches"][r["name"]],
                                 "timeshard": timeshard["launches"][r["name"]],
                                 "timeshard_slam": ts_slam["vo"]["launches"][r["name"]],
                                 "timeshard_slam_pnp": ts_slam["pnp"]["launches"][r["name"]],
                                 "multiseq": multiseq["launches"][r["name"]],
                                 "multiseq_vo": multiseq_vo["launches"][r["name"]],
                                 "workers_multiseq": workers["launches"][r["name"]],
                                 "step_workers": step_workers["launches"][r["name"]],
                                 "multihost": multihost["launches"][r["name"]],
                                 "cli_directory": loader["cli_launches"][r["name"]],
                                 "cli_jpeg": jpeg["cli_launches"][r["name"]],
                                 "video": video["cli_launches"][r["name"]],
                                 "video_vo": video["vo_launches"][r["name"]],
                                 "vocab_tools": vocab_tools["launches"][r["name"]],
                                 "soak": soak["launches"][r["name"]]}
        if r["name"] in timeshard["kernels_at_batch"]:
            r["timeshard_batch_shape"] = timeshard["kernels_at_batch"][r["name"]]
        if r["name"] in single["kernels"]:
            r["single_shape"] = single["kernels"][r["name"]]
        if r["name"] == "msac_scores":
            r["fast_shape"] = fast["msac_scores"]
    # the main path's kernel time per chunk, from the kernels phase, against its timed chunk
    chunk_ms = main_chunk_ms
    kernel_ms = sum(r["ms"] * r["launches_per_chunk"] for r in records if r["path"].startswith("main"))
    log(f"[main] kernels {kernel_ms:.4f} ms of a {chunk_ms:.2f} ms chunk "
        f"({100 * kernel_ms / chunk_ms:.2f}%)")
    # the same for the pyramid path with kernel 5: its four launches a chunk, kernels 2 and 3
    # as timed at each level's keypoint capacity, kernels 4 and 6 at the main path's shapes (the same)
    by_name = {r["name"]: r for r in records}
    k5 = by_name["fused_frontend_nms_batch"]
    pyr_chunk_ms = 1e3 * N_FRAMES / float(np.mean(pyr_fps[True])) / n_chunks
    pyr_kernel_ms = {
        "fused_frontend_nms_batch": k5["ms"],
        "extract_brief_patches": sum(lv["extract_brief_patches_ms"] for lv in k5["per_level"]),
        "brief_own_bin_dots": sum(lv["brief_own_bin_dots_ms"] for lv in k5["per_level"]),
        "msac_scores": by_name["msac_scores"]["ms"] * pyr_counts[True]["msac_scores"] / n_chunks,
        "jacobi_nullvec": by_name["jacobi_nullvec"]["ms"] * pyr_counts[True]["jacobi_nullvec"] / n_chunks,
    }
    pyr_total = sum(pyr_kernel_ms.values())
    log(f"[pyramid] kernels {pyr_total:.4f} ms of a {pyr_chunk_ms:.2f} ms chunk "
        f"({100 * pyr_total / pyr_chunk_ms:.2f}%): " +
        ", ".join(f"{k} {v:.4f}" for k, v in pyr_kernel_ms.items()) +
        f"; kernel 5 alone {100 * k5['ms'] / pyr_chunk_ms:.2f}%")
    log(json.dumps({"kernels": records, "vo_fps": fps, "vo_frames": N_FRAMES, "batch": BATCH,
                    "main_chunk_ms": chunk_ms, "main_kernel_ms_per_chunk": kernel_ms,
                    "pyramid_chunk_ms": pyr_chunk_ms, "pyramid_kernel_ms_per_chunk": pyr_kernel_ms,
                    "pyramid_fps_nms_fused": pyr_fps[True], "pyramid_fps_kernel1": pyr_fps[False],
                    "fast": fast, "exact_brief": exact, "single": single, "vocab_fit": vocab_fit,
                    "profiling": profiling, "pnp": pnp, "slam": slam["vo"], "slam_pnp": slam["pnp"], "slam_lc": slam_lc["vo"],
                    "slam_lc_pnp": slam_lc["pnp"], "pose_graph_pcg": pose_graph, "stream": stream["vo"],
                    "stream_pnp": stream["pnp"], "localize": localize, "timeshard": timeshard,
                    "timeshard_slam": ts_slam["vo"], "timeshard_slam_pnp": ts_slam["pnp"], "multiseq": multiseq, "multiseq_vo": multiseq_vo,
                    "workers": workers, "step_workers": step_workers, "multihost": multihost, "cli_timeshard": cli_ts, "loader": loader, "jpeg": jpeg, "video": video, "plot": plot,
                    "vocab_tools": vocab_tools, "soak": soak, "profile": profile}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
