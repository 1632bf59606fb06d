"""Detector tests: per-stage golden checks on rendered synthetic scenes and
end-to-end ID/corner parity against ground truth (SURVEY.md section 4)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from chalkydri_tpu.detector import (
    adaptive_threshold,
    gradient_clusters,
    fit_quads,
    label_components,
    load_family,
    make_detector,
    refine_quads,
)
from chalkydri_tpu.detector.segment import INVALID, labels_converged
from tests.reference_impl.render import axis_aligned_corners, simple_scene

FAM = load_family("tag36h11")


def detect_once(canvas, **kw):
    detect = make_detector(**kw)
    return detect(jnp.asarray(canvas)[None])


def valid_list(out):
    v = np.asarray(out.valid[0])
    return [
        (int(out.ids[0, i]), np.asarray(out.corners[0, i]))
        for i in np.where(v)[0]
    ]


class TestThreshold:
    def test_classifies_black_white_skip(self):
        canvas, _ = simple_scene(FAM, [(0, axis_aligned_corners(200, 240, 60))])
        tern = np.asarray(adaptive_threshold(jnp.asarray(canvas)[None])[0])
        assert set(np.unique(tern)) <= {0, 127, 255}
        # Near the border's outer edge there's local contrast: black inside,
        # white outside. (Deep interior of a thick border is legitimately
        # 'skip' — its whole tile neighborhood is black, as in libapriltag.)
        assert tern[300 - 2, 200] == 0  # just inside bottom border edge
        assert tern[300 + 2, 200] == 255  # just outside (white ring)
        # Flat background far from the tag is 'skip' (no contrast).
        assert tern[10, 10] == 127

    def test_batch_shape(self):
        canvas, _ = simple_scene(FAM, [(0, axis_aligned_corners(200, 240, 60))])
        batch = jnp.stack([jnp.asarray(canvas)] * 3)
        tern = adaptive_threshold(batch)
        assert tern.shape == batch.shape


class TestSegment:
    def test_matches_scipy_components(self):
        """Same-label iff same connected component, checked against
        scipy.ndimage on the black pixels (4+8 connectivity match)."""
        from scipy import ndimage

        canvas, _ = simple_scene(
            FAM,
            [(0, axis_aligned_corners(200, 240, 60)),
             (7, axis_aligned_corners(450, 240, 80))],
        )
        tern_j = adaptive_threshold(jnp.asarray(canvas)[None])
        labels = np.asarray(label_components(tern_j, iters=32)[0])
        tern = np.asarray(tern_j[0])

        black = tern == 0
        ref_lab, n = ndimage.label(black, structure=np.ones((3, 3)))
        # Our black connectivity is 4-connective; scipy 8-connective labels
        # are a superset — every one of OUR blobs must sit inside ONE scipy
        # blob, and pixels of one of our labels must agree.
        ours = labels.copy()
        ours[~black] = -1
        for lab in np.unique(ours[ours >= 0]):
            sel = ours == lab
            assert len(np.unique(ref_lab[sel])) == 1

        # White: 8-connectivity both sides -> 1:1 correspondence of partitions
        white = tern == 255
        ref_w, _ = ndimage.label(white, structure=np.ones((3, 3)))
        for lab in np.unique(labels[white]):
            sel = (labels == lab) & white
            assert len(np.unique(ref_w[sel])) == 1
        for lab in np.unique(ref_w[white]):
            sel = (ref_w == lab) & white
            assert len(np.unique(labels[sel])) == 1

    def test_convergence_on_tag_scene(self):
        canvas, _ = simple_scene(FAM, [(3, axis_aligned_corners(320, 240, 100))])
        tern = adaptive_threshold(jnp.asarray(canvas)[None])
        labels = label_components(tern, iters=16)
        assert labels_converged(tern, labels)

    def test_skip_pixels_invalid(self):
        canvas, _ = simple_scene(FAM, [(0, axis_aligned_corners(200, 240, 60))])
        tern = adaptive_threshold(jnp.asarray(canvas)[None])
        labels = np.asarray(label_components(tern)[0])
        assert np.all(labels[np.asarray(tern[0]) == 127] == INVALID)


class TestClusterQuad:
    def test_batched_clusters_canonical_across_batch_composition(self):
        """The fused batch sort is CANONICAL (lexicographic on
        (frame | hash, payload), payload unique per candidate), so a
        frame's clusters must be bit-identical whether it is clustered
        alone, batched with another frame, or at a different batch
        position — this is what keeps the spatially-sharded path (local
        batch = per-shard frames) exactly consistent with the
        single-device path (local batch = all frames)."""
        from chalkydri_tpu.detector.cluster import gradient_clusters_batched

        scenes = [
            simple_scene(FAM, [(7, axis_aligned_corners(450, 240, 80))])[0],
            simple_scene(FAM, [(1, axis_aligned_corners(200, 160, 60)),
                               (9, axis_aligned_corners(440, 320, 70))],
                         noise=6.0)[0],
        ]
        batch = jnp.stack([jnp.asarray(s) for s in scenes])
        tern = adaptive_threshold(batch)
        labels = label_components(tern)

        both = gradient_clusters_batched(tern, labels)
        swapped = gradient_clusters_batched(tern[::-1], labels[::-1])
        for b in range(2):
            solo = gradient_clusters(tern[b], labels[b])
            assert int(solo.valid.sum()) >= 1
            for name in ("points", "mask", "count", "valid"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(solo, name)),
                    np.asarray(getattr(both, name))[b],
                    err_msg=f"batched[{b}].{name} != solo")
                np.testing.assert_array_equal(
                    np.asarray(getattr(solo, name)),
                    np.asarray(getattr(swapped, name))[1 - b],
                    err_msg=f"swapped[{1 - b}].{name} != solo")

    def test_border_cluster_and_quad(self):
        canvas, gts = simple_scene(FAM, [(7, axis_aligned_corners(450, 240, 80))])
        tern = adaptive_threshold(jnp.asarray(canvas)[None])[0]
        labels = label_components(tern[None])[0]
        cl = gradient_clusters(tern, labels)
        # The tag border boundary is the biggest cluster.
        assert int(cl.count[0]) > 500
        quads = fit_quads(cl.points, cl.mask, cl.valid)
        qv = np.asarray(quads.valid)
        assert qv.sum() >= 1
        # One of the valid quads matches the tag's outer border within 1 px
        # (pre-refinement: the 0.5 px midpoint bias is expected).
        gt = gts[7]
        found = False
        for i in np.where(qv)[0]:
            c = np.asarray(quads.corners[i])
            for s in range(4):
                if np.abs(np.roll(c, s, axis=0) - gt).max() < 1.0:
                    found = True
        assert found

    def test_refine_removes_midpoint_bias(self):
        canvas, gts = simple_scene(FAM, [(7, axis_aligned_corners(450, 240, 80))])
        gray = jnp.asarray(canvas)
        tern = adaptive_threshold(gray[None])[0]
        labels = label_components(tern[None])[0]
        cl = gradient_clusters(tern, labels)
        quads = fit_quads(cl.points, cl.mask, cl.valid)
        refined = refine_quads(gray, quads.corners, quads.valid)
        gt = gts[7]
        best = 1e9
        for i in np.where(np.asarray(quads.valid))[0]:
            c = np.asarray(refined[i])
            for s in range(4):
                best = min(best, np.abs(np.roll(c, s, axis=0) - gt).max())
        assert best < 0.1, f"refined corner error {best}"


class TestDetectEndToEnd:
    def test_ids_and_corners_exact(self):
        canvas, gts = simple_scene(
            FAM,
            [(0, axis_aligned_corners(200, 240, 60)),
             (7, axis_aligned_corners(450, 240, 80))],
        )
        out = detect_once(canvas)
        dets = dict((tid, c) for tid, c in valid_list(out))
        assert set(dets.keys()) == {0, 7}
        for tid, c in dets.items():
            err = np.abs(c - gts[tid]).max()
            assert err < 0.1, f"tag {tid} corner err {err}"

    @pytest.mark.parametrize("r90", [0, 1, 2, 3])
    def test_rotated_tags_canonical_corners(self, r90):
        """Physically rotated tags must decode to the same id with corners
        reported in canonical tag-frame order."""
        canvas, gts = simple_scene(
            FAM, [(3, axis_aligned_corners(320, 240, 80))], rot90s=[r90]
        )
        out = detect_once(canvas)
        dets = dict(valid_list(out))
        assert 3 in dets
        assert np.abs(dets[3] - gts[3]).max() < 0.1

    def test_projective_warp(self):
        """A perspective-distorted tag: id exact, corners < 0.3 px."""
        corners = np.array(
            [[180.0, 330.0], [420.0, 300.0], [400.0, 130.0], [210.0, 160.0]],
            np.float32,
        )
        canvas, gts = simple_scene(FAM, [(11, corners)])
        out = detect_once(canvas)
        dets = dict(valid_list(out))
        assert 11 in dets
        assert np.abs(dets[11] - gts[11]).max() < 0.3

    def test_empty_scene(self):
        canvas = np.full((480, 640), 128, np.uint8)
        out = detect_once(canvas)
        assert int(out.count()[0]) == 0

    @pytest.mark.parametrize("sigma,lo,hi,max_err", [
        (1.0, 0, 255, 0.35),    # motion/defocus blur, full contrast
        (2.0, 90, 170, 0.55),   # blur + washed-out lighting
        (3.0, 110, 150, 0.65),  # heavy blur + 40-count contrast
    ])
    def test_blur_and_low_contrast(self, sigma, lo, hi, max_err):
        """Detection must survive defocus/motion blur and washed-out
        lighting (gym lighting + cheap optics — the reference's deploy
        reality). Measured envelope: detects through sigma=3 Gaussian
        blur at a 40-count contrast range with graceful corner
        degradation (0.2 px at sigma=1 -> 0.5 px at sigma=3)."""
        cv2 = pytest.importorskip("cv2")

        canvas, gts = simple_scene(
            FAM, [(5, axis_aligned_corners(320, 240, 90))])
        f = canvas.astype(np.float32) / 255.0 * (hi - lo) + lo
        f = cv2.GaussianBlur(f, (0, 0), sigma).astype(np.uint8)
        out = detect_once(f)
        dets = dict(valid_list(out))
        assert 5 in dets, f"tag lost at sigma={sigma} contrast=({lo},{hi})"
        assert np.abs(dets[5] - gts[5]).max() < max_err

    def test_noise_robustness(self):
        canvas, gts = simple_scene(
            FAM, [(5, axis_aligned_corners(320, 240, 90))], noise=8.0
        )
        out = detect_once(canvas)
        dets = dict(valid_list(out))
        assert 5 in dets
        assert np.abs(dets[5] - gts[5]).max() < 0.6

    def test_16h5_family(self):
        fam16 = load_family("tag16h5")
        canvas, gts = simple_scene(fam16, [(4, axis_aligned_corners(320, 240, 80))])
        out = detect_once(canvas, family="tag16h5", bits_corrected=0)
        dets = dict(valid_list(out))
        assert 4 in dets

    @pytest.mark.parametrize(
        "name,tid,bits",
        [("tag25h9", 7, 1), ("tag36h10", 1234, 2)],
    )
    def test_other_families(self, name, tid, bits):
        """The remaining classic libapriltag families the reference's
        Family::parse accepts (crates/apriltags/src/lib.rs:229): 25h9
        exercises the odd 5x5 data grid, 36h10 the 2320-code codebook."""
        fam = load_family(name)
        canvas, gts = simple_scene(
            fam, [(tid, axis_aligned_corners(320, 240, 80))])
        out = detect_once(canvas, family=name, bits_corrected=bits)
        dets = dict(valid_list(out))
        assert tid in dets
        assert np.abs(dets[tid] - gts[tid]).max() < 0.1

    def test_batch_equals_singles(self):
        """Batch of N frames == N independent detects (SURVEY.md section 4
        batch equivalence)."""
        scenes = [
            simple_scene(FAM, [(i, axis_aligned_corners(320, 240, 80))])[0]
            for i in (0, 5, 9)
        ]
        detect = make_detector()
        batch_out = detect(jnp.stack([jnp.asarray(s) for s in scenes]))
        for b, scene in enumerate(scenes):
            single = detect(jnp.asarray(scene)[None])
            np.testing.assert_array_equal(
                np.asarray(batch_out.ids[b]), np.asarray(single.ids[0])
            )
            np.testing.assert_allclose(
                np.asarray(batch_out.corners[b]),
                np.asarray(single.corners[0]),
                atol=1e-4,
            )

    def test_no_false_positives_on_texture(self):
        rng = np.random.default_rng(5)
        canvas = (rng.uniform(0, 255, (480, 640))).astype(np.uint8)
        out = detect_once(canvas)
        assert int(out.count()[0]) == 0

    def test_agrees_with_opencv_aruco(self):
        """Independent oracle: cv2's AprilTag detector finds the same ids on
        the same image."""
        cv2 = pytest.importorskip("cv2")
        canvas, _ = simple_scene(
            FAM,
            [(2, axis_aligned_corners(200, 240, 70)),
             (30, axis_aligned_corners(460, 240, 70))],
        )
        out = detect_once(canvas)
        ours = sorted(tid for tid, _ in valid_list(out))
        d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11)
        det = cv2.aruco.ArucoDetector(d)
        _, ids, _ = det.detectMarkers(canvas)
        theirs = sorted(int(i) for i in ids.ravel()) if ids is not None else []
        assert ours == theirs == [2, 30]


class TestGrayscale:
    def test_formats(self):
        from chalkydri_tpu.detector.grayscale import to_gray_device

        rng = np.random.default_rng(0)
        gray = rng.integers(0, 255, (2, 16, 32), np.uint8)
        assert to_gray_device(jnp.asarray(gray), "GREY") is not None

        rgb = rng.integers(0, 255, (2, 16, 32, 3), np.uint8)
        out = np.asarray(to_gray_device(jnp.asarray(rgb), "RGB"))
        r64 = rgb.astype(np.int64)
        ref = (77 * r64[..., 0] + 150 * r64[..., 1] + 29 * r64[..., 2]) >> 8
        np.testing.assert_array_equal(out, ref.astype(np.uint8))
        bgr = rgb[..., ::-1].copy()
        np.testing.assert_array_equal(
            np.asarray(to_gray_device(jnp.asarray(bgr), "BGR")), out
        )

        # YUYV: Y at even columns
        yuyv = rng.integers(0, 255, (1, 8, 32), np.uint8)
        np.testing.assert_array_equal(
            np.asarray(to_gray_device(jnp.asarray(yuyv), "YUYV")), yuyv[..., 0::2]
        )
        # NV12: Y plane = top 2/3 rows
        nv12 = rng.integers(0, 255, (1, 12, 16), np.uint8)
        np.testing.assert_array_equal(
            np.asarray(to_gray_device(jnp.asarray(nv12), "NV12")), nv12[:, :8, :]
        )

    def test_color_detect_end_to_end(self):
        """BASELINE config #2: color frame in, detection out, via on-device
        grayscale (tested through the fused pipeline surface)."""
        import json

        from chalkydri_tpu.geometry.field_layout import parse_field_layout
        from chalkydri_tpu.pipeline import build_rig_from_config, make_vision_pipeline

        canvas, gts = simple_scene(FAM, [(3, axis_aligned_corners(320, 240, 80))])
        rgb = np.stack([canvas] * 3, axis=-1)  # gray content as RGB

        calib = {"fx": 600.0, "fy": 600.0, "cx": 320.0, "cy": 240.0,
                 "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
                 "width": 640, "height": 480}
        tags = [{"ID": 3, "pose": {"translation": {"x": 10, "y": 4, "z": 1},
                 "rotation": {"quaternion": {"W": 0, "X": 0, "Y": 0, "Z": 1}}}}]
        layout = parse_field_layout({"tags": tags, "field": {"length": 16, "width": 8}},
                                    dtype=jnp.float32)
        cams = [{"calib": json.dumps({"OpenCVModel5": calib}),
                 "robot_to_cam": json.dumps({"roll": 0, "pitch": 0, "yaw": 0,
                                             "x": 0, "y": 0, "z": 1.0})}]
        params, rc = build_rig_from_config(cams, layout)
        step = make_vision_pipeline(layout, params, rc, input_format="RGB")
        out = step(jnp.asarray(rgb)[None], jnp.zeros(1, jnp.float32))
        ids = [int(i) for i in np.asarray(out.detections.ids[0]) if i >= 0]
        assert 3 in ids


class TestCapacityAndEdgeCases:
    def test_sixteen_tags_capacity(self):
        """A full MAX_DETECTIONS complement in one frame (grid of 16 tags)."""
        tags = []
        for i in range(16):
            r, c = divmod(i, 4)
            tags.append((i, axis_aligned_corners(90 + 150 * c, 70 + 115 * r, 45)))
        canvas, gts = simple_scene(FAM, tags, size=(560, 720))
        out = detect_once(canvas)
        found = sorted(tid for tid, _ in valid_list(out))
        assert found == list(range(16)), found
        for tid, c in valid_list(out):
            assert np.abs(c - gts[tid]).max() < 0.15

    def test_partially_visible_tag_not_decoded(self):
        """A tag cut by the image border must not produce a (wrong) pose."""
        canvas, _ = simple_scene(FAM, [(3, axis_aligned_corners(620, 240, 80))])
        out = detect_once(canvas)
        for tid, c in valid_list(out):
            # If anything is reported it must NOT claim to be tag 3 with
            # corners inside the visible region only.
            assert tid != 3

    def test_small_tag(self):
        """A ~26 px tag still detects with sub-pixel corners."""
        canvas, gts = simple_scene(FAM, [(9, axis_aligned_corners(320, 240, 13))])
        out = detect_once(canvas)
        dets = dict(valid_list(out))
        assert 9 in dets
        assert np.abs(dets[9] - gts[9]).max() < 0.4

    def test_two_copies_same_id_dedup(self):
        """Two physical copies of one id: the margin-ranked dedup keeps one
        (defensive choice — the solver maps ids to unique field poses,
        crates/apriltags/src/lib.rs:306-308)."""
        canvas, _ = simple_scene(
            FAM,
            [(7, axis_aligned_corners(180, 240, 70)),
             (7, axis_aligned_corners(460, 240, 70))],
        )
        out = detect_once(canvas)
        ids = [tid for tid, _ in valid_list(out)]
        assert ids.count(7) == 1


class TestGoldenCorpus:
    def test_detection_statistics(self):
        """Statistical regression gate over a randomized scene corpus:
        detection rate and corner accuracy must not regress."""
        rng = np.random.default_rng(2026)
        detect = make_detector()
        total = found = 0
        errs = []
        for trial in range(10):
            # Jittered 2-slot grid: no overlap by construction.
            slots = [(170.0, 240.0), (470.0, 240.0)]
            n_tags = int(rng.integers(1, 3))
            placed = []
            used = set()
            for k in range(n_tags):
                tid = int(rng.integers(0, 587))
                while tid in used:
                    tid = int(rng.integers(0, 587))
                used.add(tid)
                cx = slots[k][0] + float(rng.uniform(-30, 30))
                cy = slots[k][1] + float(rng.uniform(-60, 60))
                half = float(rng.uniform(35, 70))
                base = axis_aligned_corners(cx, cy, half)
                # random perspective jitter, keep convex
                base = base + rng.uniform(-0.15 * half, 0.15 * half, (4, 2))
                placed.append((tid, base.astype(np.float32)))
            canvas, gts = simple_scene(FAM, placed, noise=float(rng.uniform(0, 4)),
                                       seed=trial)
            out = detect(jnp.asarray(canvas)[None])
            dets = dict(valid_list_from(out))
            for tid, _ in placed:
                total += 1
                if tid in dets:
                    found += 1
                    errs.append(np.abs(dets[tid] - gts[tid]).max())
        assert total >= 15
        rate = found / total
        assert rate >= 0.9, f"detection rate {rate:.2f} ({found}/{total})"
        errs = np.array(errs)
        assert np.median(errs) < 0.25, f"median corner err {np.median(errs):.3f}"
        assert np.quantile(errs, 0.9) < 0.8, f"p90 corner err {np.quantile(errs, 0.9):.3f}"


def valid_list_from(out):
    v = np.asarray(out.valid[0])
    return [
        (int(out.ids[0, i]), np.asarray(out.corners[0, i]))
        for i in np.where(v)[0]
    ]


class TestFamilyTables:
    """The committed .npz codebooks must match a fresh regeneration from the
    canonical family definitions (VERDICT round-1 item 10: drift gate for
    tools/gen_families.py --check)."""

    @pytest.mark.parametrize(
        "name", ["tag36h11", "tag36h10", "tag25h9", "tag16h5"])
    def test_npz_matches_regenerated(self, name):
        cv2 = pytest.importorskip("cv2")
        import os

        from chalkydri_tpu.tools.gen_families import (
            FAMILIES,
            OUT_DIR,
            check_min_hamming,
            extract_family,
        )

        attr, dim, min_h = FAMILIES[name]
        fresh = extract_family(cv2, attr, dim)
        stored = np.load(os.path.join(OUT_DIR, f"{name}.npz"))
        assert stored["dim"] == dim
        assert stored["min_hamming"] == min_h
        assert np.array_equal(stored["codes"], fresh), f"{name} codebook drifted"

    def test_min_hamming_16h5(self):
        # The cheap family is small enough to verify the 'h5' property here.
        from chalkydri_tpu.tools.gen_families import check_min_hamming

        fam = load_family("tag16h5")
        assert check_min_hamming(np.asarray(fam.codes), 4, 5) >= 5


def _scipy_partition(tern):
    """Ground-truth component ids: white 8-conn, black 4-conn (libapriltag's
    merge rule), 0 on skip pixels."""
    from scipy import ndimage

    white = tern == 255
    black = tern == 0
    lab_w, n_w = ndimage.label(white, structure=np.ones((3, 3)))
    lab_b, _ = ndimage.label(black)
    return np.where(white, lab_w, np.where(black, lab_b + n_w + 1, 0))


def _partitions_equal(a, b, valid):
    """Same grouping of the valid pixels under a bijection of label ids."""
    m, inv = {}, {}
    for x, y in zip(a[valid].ravel(), b[valid].ravel()):
        if m.setdefault(x, y) != y:
            return False
        if inv.setdefault(y, x) != x:
            return False
    return True


def _serpentine(h, w, stripes):
    """White snake: vertical stripes joined alternately at the top and
    bottom row. The minimum label must travel the whole snake, crossing
    one stripe per propagation round — the long-path worst case for a
    fixed round count."""
    tern = np.full((h, w), 127, np.uint8)
    cols = np.linspace(2, w - 3, stripes).astype(int)
    for c in cols:
        tern[:, c] = 255
    for i in range(len(cols) - 1):
        row = 0 if i % 2 == 0 else h - 1
        tern[row, cols[i]:cols[i + 1] + 1] = 255
    return tern


class TestSegmentStats:
    """cluster.segment_stats (run-length segmentation + per-chunk top-2 of
    the sorted candidate keys) against a numpy oracle, on adversarial run
    layouts the end-to-end scenes can't guarantee to produce: runs crossing
    chunk boundaries, an all-invalid array, a single run spanning
    everything, every element its own run, and a length that is not a
    chunk multiple."""

    @staticmethod
    def _reference(ks, payload):
        _INT_MAX = np.iinfo(np.int32).max
        n = len(ks)
        prev_key = np.concatenate([[-1], ks[:-1]])
        new_seg = ks != prev_key
        idx = np.arange(n)
        start_pos = np.maximum.accumulate(np.where(new_seg, idx, -1))
        nxt = np.where(new_seg, idx, _INT_MAX)
        next_start = np.minimum.accumulate(nxt[::-1])[::-1]
        next_start = np.concatenate([next_start[1:], [n]])
        next_start = np.minimum(next_start, n)
        run_len = next_start - start_pos
        s_valid = ks != _INT_MAX
        score = np.where(new_seg & s_valid, run_len, 0)
        d0 = (((payload >> 26) & 0x3) == 0) & s_valid
        t = np.cumsum(d0.astype(np.int32))
        # chunk-128 top-2 (ties to the first index)
        score = np.concatenate([score, np.zeros((-n) % 128, score.dtype)])
        grid = score.reshape(-1, 128)
        m1 = grid.max(axis=1)
        a1 = grid.argmax(axis=1)
        grid2 = grid.copy()
        grid2[np.arange(len(grid)), a1] = 0
        m2 = grid2.max(axis=1)
        a2 = grid2.argmax(axis=1)
        base = np.arange(len(grid)) * 128
        cand_len = np.concatenate([m1, m2]).astype(np.int32)
        cand_pos = np.concatenate([base + a1, base + a2]).astype(np.int32)
        return t, cand_len, cand_pos

    @staticmethod
    def _case(name, n, rng):
        _INT_MAX = np.iinfo(np.int32).max
        if name == "one_run":
            return np.full(n, 7, np.int32)
        if name == "all_invalid":
            return np.full(n, _INT_MAX, np.int32)
        if name == "every_element_a_run":
            return np.arange(n, dtype=np.int32)
        # random runs crossing chunk boundaries + an invalid tail
        ks = []
        while sum(len(k) for k in ks) < n - 300:
            ks.append(np.full(int(rng.integers(1, 400)),
                              int(rng.integers(0, 1 << 30))))
        flat = np.sort(np.concatenate(ks)[: n - 100].astype(np.int32))
        return np.concatenate(
            [flat, np.full(n - len(flat), _INT_MAX, np.int32)])

    @pytest.mark.parametrize("name,n", [
        ("one_run", 2048), ("all_invalid", 2048),
        ("every_element_a_run", 2048), ("random_runs", 2048),
        ("random_runs", 1000),
    ])
    def test_adversarial_layouts(self, name, n):
        from chalkydri_tpu.detector.cluster import segment_stats

        rng = np.random.default_rng(5)
        ks = self._case(name, n, rng)
        payload = rng.integers(0, 1 << 29, n).astype(np.int32)
        t, cl, cp = segment_stats(jnp.asarray(ks), jnp.asarray(payload))
        t_ref, cl_ref, cp_ref = self._reference(ks, payload)
        np.testing.assert_array_equal(np.asarray(t), t_ref, err_msg="t")
        np.testing.assert_array_equal(np.asarray(cl), cl_ref, err_msg="len")
        np.testing.assert_array_equal(np.asarray(cp), cp_ref, err_msg="pos")


class TestLabelComponentsOracle:
    """label_components run to its fixed point gives exactly scipy's
    partition (white 8-conn, black 4-conn), on fields that stress the
    scan-based propagation: speckle noise, a serpentine whose minimum label
    must cross every stripe, and non-aligned frame shapes with a solid
    border row."""

    @staticmethod
    def _check(tern_np, iters):
        tern = jnp.asarray(tern_np[None])
        labels = label_components(tern, iters=iters)
        assert labels_converged(tern, labels), "raise iters: not converged"
        lab = np.asarray(labels)[0]
        valid = tern_np != 127
        assert (lab[valid] != INVALID).all()
        assert (lab[~valid] == INVALID).all()
        assert _partitions_equal(_scipy_partition(tern_np), lab, valid)
        return lab

    def test_noisy_tag_scene(self):
        # Sensor-noise speckle needs ~256 rounds to reach the fixed point
        # at this size (tag borders settle within the production 12).
        canvas, _ = simple_scene(
            FAM, [(5, axis_aligned_corners(160, 120, 70))],
            size=(240, 320), noise=6.0,
        )
        tern = np.asarray(adaptive_threshold(jnp.asarray(canvas)[None]))[0]
        self._check(tern, iters=320)

    def test_random_ternary_field(self):
        rng = np.random.default_rng(11)
        tern = rng.choice([0, 127, 255], size=(96, 160),
                          p=[0.35, 0.3, 0.35]).astype(np.uint8)
        self._check(tern, iters=48)

    @pytest.mark.parametrize("h,w,stripes", [(96, 160, 6), (96, 128, 32)])
    def test_serpentine_is_one_component(self, h, w, stripes):
        t = _serpentine(h, w, stripes)
        lab = self._check(t, iters=2 * stripes + 8)
        assert len(np.unique(lab[t == 255])) == 1

    def test_unaligned_shape_with_solid_edge_row(self):
        """A 52x200 frame (neither dimension a multiple of 8 or 128) whose
        bottom row is solid white: labels stay INVALID exactly on skip
        pixels and the edge row joins only what it touches."""
        rng = np.random.default_rng(3)
        tern = rng.choice([0, 127, 255], size=(52, 200),
                          p=[0.4, 0.2, 0.4]).astype(np.uint8)
        tern[-1, :] = 255
        self._check(tern, iters=128)


def _cyclic_corner_rms(their_c: np.ndarray, our_c: np.ndarray) -> float:
    """Corner RMS under the best RIGID quad assignment: oracle corner 0
    (and winding — aruco winds opposite to ours, measured ~0.99 px at the
    reversed shift vs ~125 px at any same-order shift) may differ, so try
    the 8 dihedral arrangements (4 cyclic shifts x both orientations).
    Unlike a per-corner nearest pick, a degenerate quad with clustered
    corners can't game a rigid assignment (ADVICE round-4)."""
    best = np.inf
    for oc in (our_c, our_c[::-1]):
        for shift in range(4):
            d = np.linalg.norm(their_c - np.roll(oc, shift, axis=0), axis=-1)
            best = min(best, float(np.sqrt((d**2).mean())))
    return best


class TestArucoParityCorpus:
    """Decode/corner parity vs an independent C++ oracle across a corpus of
    >= 50 rendered scenes with perspective, blur, and noise (VERDICT round-1
    item 3). The oracle is cv2.aruco's AprilTag3 detector — the same
    algorithm family the reference consumes via apriltag-sys
    (crates/apriltags/Cargo.toml:10-11)."""

    N_SCENES = 56

    def _corpus(self):
        # Shared with the golden-corpus generator (tests/golden/gen_golden.py)
        # so the checked-in golden file pins exactly these scenes.
        from tests.reference_impl.corpus import build_parity_corpus

        return build_parity_corpus(self.N_SCENES)

    def test_corpus_vs_aruco(self):
        cv2 = pytest.importorskip("cv2")
        scenes = self._corpus()
        frames = jnp.asarray(np.stack([c for c, _ in scenes]))
        # capacity_fallback: scene 18's sigma-5 noise flood overflows the
        # standard candidate budget (the round-4 "84th detection" miss);
        # the host-side 2x-budget redispatch recovers it.
        detect = make_detector(capacity_fallback=True)
        out = detect(frames)  # one batched launch for the whole corpus

        d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11)
        aruco = cv2.aruco.ArucoDetector(d)

        ids_np = np.asarray(out.ids)
        corners_np = np.asarray(out.corners)
        valid_np = np.asarray(out.valid)

        n_oracle = n_matched = 0
        corner_rms = []
        gt_err = []
        for s, (canvas, gts) in enumerate(scenes):
            ours = {
                int(ids_np[s, i]): corners_np[s, i]
                for i in np.where(valid_np[s])[0]
            }
            ac, aids, _ = aruco.detectMarkers(canvas)
            theirs = (
                {int(i): c.reshape(4, 2) for i, c in zip(aids.ravel(), ac)}
                if aids is not None
                else {}
            )
            for tid, their_c in theirs.items():
                n_oracle += 1
                if tid not in ours:
                    continue
                n_matched += 1
                # order-free corner matching (aruco's corner 0 differs):
                # best cyclic rotation of our quad against theirs.
                corner_rms.append(_cyclic_corner_rms(their_c, ours[tid]))
            for tid, gt in gts.items():
                if tid in ours:
                    gt_err.append(np.abs(ours[tid] - gt).max())

        assert n_oracle >= 50, f"oracle found only {n_oracle} tags"
        rate = n_matched / n_oracle
        assert rate == 1.0, f"matched {n_matched}/{n_oracle} of oracle's tags"
        corner_rms = np.array(corner_rms)
        # The oracle's OWN corners sit ~0.70 px median from exact ground
        # truth on this corpus (measured: its corner convention/refinement),
        # so vs-aruco RMS is bounded below by that; gate at 1.0/1.6. The
        # meaningful sub-pixel gate is vs exact ground truth: < 0.3 px.
        assert np.median(corner_rms) < 1.0, f"median RMS vs aruco {np.median(corner_rms):.3f}"
        assert np.quantile(corner_rms, 0.9) < 1.6
        gt_err = np.array(gt_err)
        assert np.median(gt_err) < 0.3, f"median err vs ground truth {np.median(gt_err):.3f}"

    def test_capacity_fallback_recovers_flooded_scene(self):
        """The round-4 '84th golden detection' (VERDICT weak #1 /
        directive 3), root-caused: corpus scene 18 (tag 471, sigma-5
        noise on the low-contrast background) thresholds to a texture
        flood of 34.4k boundary candidates; the standard budget's
        512-blocks/dir compaction cap binds, and with every ranking
        signal saturated by the uniform flood (both-direction boost true
        on 100% of rows/columns; tag blocks' counts 13-18 tie noise
        blocks' at the cutoff) the drop lands on 82 of the tag's 160
        dir-0 blocks — fragmenting its cluster below quad fit. The
        standard program must REPORT the overflow (dropped_points > 0,
        the health signal), and the capacity_fallback dispatcher must
        recover the tag on the 2x-budget program."""
        from tests.reference_impl.corpus import build_parity_corpus

        canvas, gts = build_parity_corpus(19)[18]
        assert 471 in gts
        frames = jnp.asarray(canvas[None])

        base = make_detector()(frames)
        assert int(np.asarray(base.dropped_points)[0]) > 0, (
            "scene 18 no longer overflows the standard budget — "
            "re-characterize this regression test"
        )
        assert 471 not in np.asarray(base.ids[0])[np.asarray(base.valid[0])]

        out = make_detector(capacity_fallback=True)(frames)
        ids = np.asarray(out.ids[0])[np.asarray(out.valid[0])]
        assert 471 in ids, f"fallback did not recover tag 471: {ids}"
        assert int(np.asarray(out.dropped_points)[0]) == 0

    def test_corpus_vs_golden_refined(self):
        """Parity vs the CHECKED-IN golden corpus
        (tests/golden/aruco_apriltag_refine.json): ids + corners from
        cv2.aruco with CORNER_REFINE_APRILTAG — OpenCV's implementation of
        libapriltag's corner refinement, the closest obtainable oracle to
        the reference's umich libapriltag (apriltag-sys,
        crates/apriltags/Cargo.toml:10-11; the C library itself is not
        installable in this image — see tests/golden/gen_golden.py).
        Checked in so an OpenCV upgrade can't silently move the goalposts.

        Also pins the decision-margin DISTRIBUTION on matched tags: the
        corpus renders full-contrast tags, where libapriltag's margin
        (mean |sample - local threshold| over data cells, intensity
        units) sits near half the dynamic range (~127); mild blur/noise
        must not collapse it. User thresholds written for libapriltag
        (filtered_by_decision_margin, crates/apriltags/src/lib.rs:127-141)
        rely on this scale."""
        import json as _json

        golden_path = os.path.join(
            os.path.dirname(__file__), "golden", "aruco_apriltag_refine.json"
        )
        with open(golden_path) as f:
            golden = _json.load(f)

        scenes = self._corpus()
        assert len(golden["scenes"]) == len(scenes)
        frames = jnp.asarray(np.stack([c for c, _ in scenes]))
        out = make_detector(capacity_fallback=True)(frames)
        ids_np = np.asarray(out.ids)
        corners_np = np.asarray(out.corners)
        valid_np = np.asarray(out.valid)
        marg_np = np.asarray(out.decision_margins)

        n_oracle = n_matched = 0
        rms, margins = [], []
        for s, entry in enumerate(golden["scenes"]):
            ours = {
                int(ids_np[s, i]): (corners_np[s, i], float(marg_np[s, i]))
                for i in np.where(valid_np[s])[0]
            }
            for det in entry["detections"]:
                n_oracle += 1
                if det["id"] not in ours:
                    continue
                n_matched += 1
                oc, mg = ours[det["id"]]
                tc = np.asarray(det["corners"])
                rms.append(_cyclic_corner_rms(tc, oc))
                margins.append(mg)

        assert n_oracle >= 50, f"golden has only {n_oracle} detections"
        rate = n_matched / n_oracle
        assert rate == 1.0, f"matched {n_matched}/{n_oracle} of golden"
        rms = np.array(rms)
        assert np.median(rms) < 1.0, f"median RMS vs golden {np.median(rms):.3f}"
        assert np.quantile(rms, 0.9) < 1.6
        # Margin distribution: full-contrast corpus tags must hold the
        # libapriltag unit scale (~half range) through the corpus's
        # blur/noise levels. Measured band: [125.0, 127.3].
        margins = np.array(margins)
        assert margins.min() > 100.0, f"margin floor {margins.min():.1f}"
        assert 110.0 < np.median(margins) <= 128.0
        assert margins.max() <= 128.0  # mean |s - t| can't exceed range/2

    def test_decision_margin_scale(self):
        """decision_margin rides libapriltag's scale: mean |sample - local
        threshold| over data cells, in intensity units [0, 255]. The margin
        must track scene contrast ~linearly so user thresholds written for
        libapriltag (reference: filtered_by_decision_margin,
        crates/apriltags/src/lib.rs:127-141) carry over."""
        detect = make_detector()
        margins = {}
        for contrast in (1.0, 0.6, 0.3):
            canvas = np.full((480, 640), 160, np.uint8)
            sub = np.full((480, 640), 160, np.float32)
            tmp = np.full((480, 640), 160, np.uint8)
            from tests.reference_impl.render import place_tag

            place_tag(tmp, FAM, 7, axis_aligned_corners(320, 240, 80))
            # squeeze contrast about the background level
            sub = 160 + (tmp.astype(np.float32) - 160) * contrast
            canvas = np.clip(sub, 0, 255).astype(np.uint8)
            out = detect(jnp.asarray(canvas)[None])
            dets = dict(valid_list_from(out))
            assert 7 in dets
            i = int(np.where(np.asarray(out.ids[0]) == 7)[0][0])
            margins[contrast] = float(np.asarray(out.decision_margins[0, i]))
        # full-contrast tag on this renderer: black ~28, white ~232 ->
        # margin ~ (232-28)/2 ~ 100
        assert margins[1.0] > 80.0
        # linear-ish scaling with contrast (wide tolerance: threshold
        # adaption interacts at low contrast)
        assert 0.4 < margins[0.6] / margins[1.0] < 0.8
        assert 0.15 < margins[0.3] / margins[1.0] < 0.5


class TestMarginDiscrimination:
    """VERDICT round-4 directive 6: decision margins must DISCRIMINATE —
    a degraded tag must score a low margin, so the
    ``filtered_by_decision_margin`` threshold semantics users bring from
    libapriltag (crates/apriltags/src/lib.rs:127-141) actually do
    something. Measured operating curve (tag 17, 140 px, 480x640):

      blur sigma   0     2      3      4      5      6
      margin     127.5  127.1  126.4  119.5  106.7   91.7
      noise sigma  0    10     20     30     40     50
      margin     127.5  124.3  121.0  117.7  114.1  110.1
      contrast   1.0   0.6    0.4    0.25   0.15   0.08
      margin     127.5  76.5   51.0   31.5   19.0   10.0

    Monotone on every axis; a threshold of 50 separates clean
    (margin >100) from heavily corrupted (contrast <=0.25) detections.
    """

    def _scene(self, blur=0.0, noise=0.0, contrast=1.0, tid=17):
        from scipy import ndimage

        from tests.reference_impl.render import place_tag

        canvas = np.full((480, 640), 160, np.uint8)
        place_tag(canvas, FAM, tid, axis_aligned_corners(320, 240, 70))
        f = 160 + (canvas.astype(np.float32) - 160) * contrast
        if blur > 0:
            f = ndimage.gaussian_filter(f, blur)
        if noise > 0:
            rng = np.random.default_rng(7)
            f = f + rng.normal(0, noise, f.shape)
        return np.clip(f, 0, 255).astype(np.uint8)

    def _margin(self, detect, canvas, tid=17):
        out = detect(jnp.asarray(canvas[None]))
        ids = np.asarray(out.ids[0])
        valid = np.asarray(out.valid[0])
        hits = np.where((ids == tid) & valid)[0]
        assert hits.size == 1, f"tag {tid} not detected"
        return float(np.asarray(out.decision_margins[0])[hits[0]])

    def test_margin_monotone_under_degradation(self):
        detect = make_detector()
        batches = {
            "blur": [self._scene(blur=b) for b in (0.0, 2.0, 3.0, 4.0,
                                                   5.0, 6.0)],
            "noise": [self._scene(noise=n) for n in (0, 10, 20, 30, 40,
                                                     50)],
            "contrast": [self._scene(contrast=c)
                         for c in (1.0, 0.6, 0.4, 0.25)],
        }
        for axis, frames in batches.items():
            ms = [self._margin(detect, c) for c in frames]
            diffs = np.diff(ms)
            assert (diffs <= 0.5).all(), (
                f"margins not monotone under {axis}: {np.round(ms, 1)}"
            )
            assert ms[0] - ms[-1] > 10.0, (
                f"margins barely move under {axis}: {np.round(ms, 1)}"
            )

    def test_margin_threshold_separates(self):
        detect = make_detector()
        clean = self._margin(detect, self._scene())
        corrupted = self._margin(detect, self._scene(contrast=0.25))
        assert clean > 100.0
        assert corrupted < 50.0

    def test_filtered_by_decision_margin_end_to_end(self):
        """The fused pipeline's decision_margin_min excludes a detected-
        but-degraded tag from the SOLVE (pose invalid, tag_count 0) while
        the unfiltered pipeline uses it — filtered_by_decision_margin
        semantics (crates/apriltags/src/lib.rs:127-141) applied at the
        solver gate."""
        import __graft_entry__ as ge
        from chalkydri_tpu.pipeline import (
            build_rig_from_config,
            make_vision_pipeline,
        )

        layout, cams = ge._tiny_rig(jnp.float32)
        params, rc = build_rig_from_config(cams, layout)
        frames = ge._render_scene(layout, 1)
        # squeeze contrast about the background so the tags still decode
        # but their margins collapse under the 50 threshold
        low = np.clip(
            150 + (frames.astype(np.float32) - 150) * 0.25, 0, 255
        ).astype(np.uint8)
        gyro = jnp.zeros(1, jnp.float32)

        open_step = make_vision_pipeline(layout, params, rc)
        out_open = open_step(jnp.asarray(low), gyro)
        assert bool(np.asarray(out_open.pose_valid)[0]), (
            "degraded tags must still decode with no margin filter"
        )
        margins = np.asarray(out_open.detections.decision_margins[0])
        valid = np.asarray(out_open.detections.valid[0])
        assert margins[valid].max() < 50.0

        gated_step = make_vision_pipeline(
            layout, params, rc, decision_margin_min=50.0)
        out_gated = gated_step(jnp.asarray(low), gyro)
        assert int(np.asarray(out_gated.tag_count)[0]) == 0
        assert not bool(np.asarray(out_gated.pose_valid)[0])
        # the clean frame passes the same gate
        out_clean = gated_step(jnp.asarray(frames), gyro)
        assert bool(np.asarray(out_clean.pose_valid)[0])
        assert int(np.asarray(out_clean.tag_count)[0]) >= 1


class TestFarTagRecall:
    """Round-5 evaluation of VERDICT stretch #10 (qd=1 as deployed
    default): on a degraded far-tag corpus (rotation, blur sigma 0.8,
    sensor noise sigma 3) quad_decimate=2 detects small tags BETTER than
    quad_decimate=1 — full-resolution thresholding floods on sensor
    noise (178k candidates dropped on one 480x640 frame) while the 2x2
    mean decimation halves the noise sigma first. Decision: qd=2 stays
    the deployed default (full table: docs/performance.md). This pins
    the qd=2 recall floor and the flood asymmetry that justifies it."""

    @staticmethod
    def _scene(rng, half, deg):
        from scipy import ndimage

        from tests.reference_impl.render import place_tag

        a = np.radians(deg)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        base = np.array([[-half, half], [half, half], [half, -half],
                         [-half, -half]], np.float64)
        corners = (base @ R.T + [320.0, 240.0]).astype(np.float32)
        canvas = np.full((480, 640), 150, np.uint8)
        place_tag(canvas, FAM, 5, corners)
        f = ndimage.gaussian_filter(canvas.astype(np.float32), 0.8)
        f = f + rng.normal(0, 3, f.shape)
        return np.clip(f, 0, 255).astype(np.uint8)

    def test_qd2_recall_floor_on_degraded_small_tags(self):
        rng = np.random.default_rng(3)
        detect = make_detector(quad_decimate=2)
        frames = np.stack([self._scene(rng, 20, d) for d in (5, 12, 20)])
        out = detect(jnp.asarray(frames))
        hits = sum(
            5 in np.asarray(out.ids[b])[np.asarray(out.valid[b])]
            for b in range(3)
        )
        assert hits >= 2, f"qd=2 small-tag recall regressed: {hits}/3"

    def test_qd1_floods_on_sensor_noise(self):
        """The measured asymmetry behind the qd=2 default: the same
        degraded frame overflows the candidate budget at qd=1 by an
        order of magnitude more than at qd=2."""
        rng = np.random.default_rng(3)
        frame = jnp.asarray(self._scene(rng, 20, 15)[None])
        d1 = make_detector(quad_decimate=1)(frame)
        d2 = make_detector(quad_decimate=2)(frame)
        drop1 = int(np.asarray(d1.dropped_points)[0])
        drop2 = int(np.asarray(d2.dropped_points)[0])
        assert drop1 > 10 * max(drop2, 1), (drop1, drop2)


class TestHomographyPrecision:
    def test_exact_under_bf16_default_matmul(self):
        """A default-precision float32 matmul may run at reduced precision
        (TF32 on the GPU's tensor cores; bf16 is coarser still), so the
        homography's pixel-scale math must not route through one (a t_inv
        @ hn compose once quantized far-from-origin translations to ~4 px).
        Force bf16 matmuls on CPU and require sub-0.02 px mapping."""
        import jax

        from chalkydri_tpu.detector.homography import (
            TAG_CORNERS,
            apply_homography,
            homography_from_corners,
        )

        corners = jnp.asarray(
            [[1554.0, 1234.0], [1634.0, 1234.0], [1634.0, 1154.0],
             [1554.0, 1154.0]], jnp.float32
        )
        with jax.default_matmul_precision("bfloat16"):
            h = homography_from_corners(corners)
            mapped = apply_homography(h, TAG_CORNERS)
        err = float(jnp.max(jnp.abs(mapped - corners)))
        assert err < 0.02, f"homography pixel error {err:.3f}px under bf16"


class TestAdversarialCapacity:
    """VERDICT round-2 directive 7: scenes engineered past the compaction
    slack — dense directional texture flooding one direction's candidates,
    tags pushed to the frame corners. Round 2's density-ranked compaction
    lost every tag here; the per-direction budgets + row-dilated
    both-directions boost (cluster.rank_blocks/direction_boosts) plus direction-diversity
    cluster ranking must keep them decoding, and the capacity counter must
    make the degradation mode visible."""

    H, W = 800, 1280
    TAGS = [(1, (90, 90)), (5, (1190, 90)), (9, (90, 710)), (13, (1190, 710))]

    def _scene(self, horizontal: bool):
        from tests.reference_impl.render import place_tag

        fam = load_family("tag36h11")
        canvas = np.full((self.H, self.W), 150, np.uint8)
        # 4-px stripes: 2 px after decimation — wide enough to pass the
        # speckle gate, dense enough to occupy ~every candidate block.
        if horizontal:
            idx = (np.arange(self.H) // 4) % 2
            canvas[:] = np.where(idx[:, None] == 0, 60, 200).astype(np.uint8)
        else:
            idx = (np.arange(self.W) // 4) % 2
            canvas[:] = np.where(idx[None, :] == 0, 60, 200).astype(np.uint8)
        for tid, (cx, cy) in self.TAGS:
            canvas[max(0, cy - 88):cy + 88, max(0, cx - 88):cx + 88] = 150
            place_tag(
                canvas, fam, tid,
                np.array([[cx - 70, cy + 70], [cx + 70, cy + 70],
                          [cx + 70, cy - 70], [cx - 70, cy - 70]],
                         np.float32),
            )
        return canvas

    @pytest.mark.parametrize("horizontal", [True, False])
    def test_tags_survive_directional_texture_flood(self, horizontal):
        det = make_detector()
        out = det(jnp.asarray(self._scene(horizontal)[None]))
        valid = np.asarray(out.valid[0])
        ids = sorted(int(i) for i in np.asarray(out.ids[0])[valid])
        assert set(t for t, _ in self.TAGS) <= set(ids), (
            f"tags lost at the capacity cliff: {ids}"
        )
        # The cliff is ACTIVE (candidates really were dropped) and VISIBLE.
        assert int(out.dropped_points[0]) > 10_000

    def test_full_res_clean_tags_drop_nothing(self):
        """Round-3 regression: at 1600x1304 quad_decimate=1, four clean
        140 px tags occupied ~1100 right-direction candidate blocks under
        row-major blocking (vertical edges land 1-2 candidates per
        128-block) and the 2x-slack budget evicted one tag with NOTHING
        else in the scene. Orientation-aligned blocking (dir 0 blocks the
        transposed page) must detect all four with zero dropped
        candidates."""
        from tests.reference_impl.render import place_tag

        fam = load_family("tag36h11")
        qs = {1: [[150, 500], [330, 500], [330, 320], [150, 320]],
              5: [[520, 560], [700, 530], [690, 360], [530, 390]],
              9: [[880, 1180], [1020, 1180], [1020, 1040], [880, 1040]],
              13: [[1180, 800], [1320, 790], [1315, 660], [1185, 670]]}
        canvas = np.full((1304, 1600), 150, np.uint8)
        for tid, q in qs.items():
            place_tag(canvas, fam, tid, np.array(q, np.float32))
        det = make_detector(quad_decimate=1)
        out = det(jnp.asarray(canvas[None]))
        valid = np.asarray(out.valid[0])
        ids = sorted(int(i) for i in np.asarray(out.ids[0])[valid])
        assert ids == sorted(qs), ids
        assert int(out.dropped_points[0]) == 0

    def test_benign_scene_reports_zero_dropped(self):
        from tests.reference_impl.render import place_tag

        fam = load_family("tag36h11")
        canvas = np.full((self.H, self.W), 150, np.uint8)
        place_tag(canvas, fam, 2, np.array(
            [[400, 500], [580, 500], [580, 320], [400, 320]], np.float32))
        det = make_detector()
        out = det(jnp.asarray(canvas[None]))
        valid = np.asarray(out.valid[0])
        assert 2 in np.asarray(out.ids[0])[valid]
        assert int(out.dropped_points[0]) == 0
