"""The VIBE demo's host stages against nemo_tpu's: the greedy-IoU and SORT
trackers, STAF pose tracklets, crops and the SPIN crop geometry, bbox and
pose smoothing, and the crop <-> image camera and keypoint maps.

Both packages run the same numpy and scipy code here, so the outputs are
held to 1e-6 (relative) and ids, frame ids and shapes exactly. The cases
follow tests/test_tracker.py's (crossing people, an occlusion gap, a gap
past max_age, interpolated pose-tracking holes, trimmed ends).
"""

import numpy as np
import pytest

from nemo_tpu.data import crops as jcrops
from nemo_tpu.data import smoothing as jsmooth
from nemo_tpu.data import tracker as jtracker
from nemo_tpu_torch.data import crops as tcrops
from nemo_tpu_torch.data import smoothing as tsmooth
from nemo_tpu_torch.data import tracker as ttracker

RTOL = 1e-6


def _same_tracks(got, want):
    assert sorted(got) == sorted(want)
    for tid in want:
        assert sorted(got[tid]) == sorted(want[tid])
        for k, v in want[tid].items():
            np.testing.assert_array_equal(got[tid][k], v, err_msg=k)
            assert got[tid][k].dtype == v.dtype, k


def _crossing(F=30):
    dets = []
    for f in range(F):
        xa, xb = 10.0 + 10.0 * f, 300.0 - 10.0 * f
        dets.append(np.array([[xa, 100, xa + 40, 180],
                              [xb, 100, xb + 40, 180]], np.float32))
    return dets


def _occluded(F=20, gap=(8, 11)):
    dets = []
    for f in range(F):
        if gap[0] <= f < gap[1]:
            dets.append(np.zeros((0, 4), np.float32))
        else:
            x = 10.0 + 5.0 * f
            dets.append(np.array([[x, 50, x + 30, 110]], np.float32))
    return dets


def _jittered(seed=0, F=40, people=3):
    rng = np.random.RandomState(seed)
    base = rng.rand(people, 2) * 400
    dets = []
    for f in range(F):
        boxes = []
        for p in range(people):
            if rng.rand() < 0.15:       # missed detection
                continue
            c = base[p] + f * np.array([3.0, -1.0]) * (p - 1) \
                + rng.randn(2) * 2
            boxes.append([c[0], c[1], c[0] + 50 + p, c[1] + 120])
        dets.append(np.asarray(boxes, np.float32).reshape(-1, 4))
    return dets


CASES = {"crossing": _crossing, "occluded": _occluded,
         "long_gap": lambda: _occluded(30, (5, 20)), "jittered": _jittered}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method,kw", [
    ("track_bboxes", {}), ("track_bboxes", {"max_age": 3}),
    ("track_bboxes_sort", {"iou_threshold": 0.1}),
    ("track_bboxes_sort", {"iou_threshold": 0.2, "max_age": 5})])
def test_trackers(case, method, kw):
    dets = CASES[case]()
    _same_tracks(getattr(ttracker, method)(dets, **kw),
                 getattr(jtracker, method)(dets, **kw))


def _kp(rng, cx, cy, n=25, conf=0.9):
    kp = np.zeros((n, 3), np.float32)
    kp[:, 0] = cx + 10 * rng.randn(n)
    kp[:, 1] = cy + 20 * rng.randn(n)
    kp[:, 2] = conf
    return kp


def _posetrack_people(rng):
    lo = _kp(rng, 20, 20, conf=0.05)
    return {
        0: {"joints2d": np.stack([_kp(rng, 20 + 5 * i, 20) for i in
                                  (0, 3, 4, 7)]),
            "frames": np.array([2, 5, 6, 9])},          # interior holes
        3: {"joints2d": np.stack([lo, _kp(rng, 30, 20), lo]),
            "frames": np.array([0, 1, 2])},             # trimmed ends
        7: {"joints2d": np.stack([lo, lo]), "frames": np.array([3, 4])},
        9: {"joints2d": np.zeros((0, 25, 3), np.float32),
            "frames": np.zeros((0,), np.int64)},
    }


def test_tracks_from_posetrack():
    people = _posetrack_people(np.random.RandomState(2))
    got = ttracker.tracks_from_posetrack(people)
    _same_tracks(got, jtracker.tracks_from_posetrack(people))
    assert sorted(got) == [0, 3]


def test_crops_and_geometry():
    rng = np.random.RandomState(3)
    img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    for bbox in ([30.0, 20.0, 40.0], [5.0, 3.0, 70.0], [60.5, 44.2, 17.3]):
        for fn in ("get_single_image_crop",):
            np.testing.assert_allclose(
                getattr(tcrops, fn)(img, np.asarray(bbox), out_res=32),
                getattr(jcrops, fn)(img, np.asarray(bbox), out_res=32),
                rtol=RTOL, atol=RTOL)
    kp = np.concatenate([rng.rand(4, 25, 2) * 60,
                         (rng.rand(4, 25, 1) > 0.3)], -1).astype(np.float32)
    np.testing.assert_allclose(tcrops.bbox_from_keypoints(kp),
                               jcrops.bbox_from_keypoints(kp), rtol=RTOL)
    for rot in (0.0, 25.0):
        np.testing.assert_allclose(
            tcrops.crop_scale(img, (30.0, 22.0), 0.2, (24, 24), rot),
            jcrops.crop_scale(img, (30.0, 22.0), 0.2, (24, 24), rot),
            rtol=RTOL, atol=1e-4)
        np.testing.assert_allclose(
            tcrops.get_transform((30.0, 22.0), 0.3, (32, 32), rot),
            jcrops.get_transform((30.0, 22.0), 0.3, (32, 32), rot),
            rtol=RTOL)
        np.testing.assert_array_equal(
            tcrops.transform_point([5, 9], (30.0, 22.0), 0.3, (32, 32),
                                   invert=True, rot=rot),
            jcrops.transform_point([5, 9], (30.0, 22.0), 0.3, (32, 32),
                                   invert=True, rot=rot))
    patch = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        tcrops.uncrop(patch, (30.0, 22.0), 0.3, (48, 64, 3)),
        jcrops.uncrop(patch, (30.0, 22.0), 0.3, (48, 64, 3)))
    aa = rng.randn(3)
    np.testing.assert_allclose(tcrops.rot_aa(aa, 30.0),
                               jcrops.rot_aa(aa, 30.0), rtol=RTOL)
    np.testing.assert_array_equal(tcrops.flip_img(img), jcrops.flip_img(img))


def test_smoothing():
    rng = np.random.RandomState(4)
    track = np.stack([np.linspace(0, 100, 60), np.linspace(50, 60, 60),
                      np.full(60, 40.0)], 1) + 3.0 * rng.randn(60, 3)
    for n in (60, 9, 2):
        np.testing.assert_allclose(
            tsmooth.smooth_bbox_params(track[:n].astype(np.float32)),
            jsmooth.smooth_bbox_params(track[:n].astype(np.float32)),
            rtol=RTOL)
    pose = (np.sin(np.linspace(0, 6, 80))[:, None] * np.ones((1, 72))
            + 0.05 * rng.randn(80, 72)).astype(np.float32)
    np.testing.assert_allclose(
        tsmooth.smooth_pose_sequence(pose, 0.004, 0.7),
        jsmooth.smooth_pose_sequence(pose, 0.004, 0.7), rtol=RTOL)


def test_camera_and_keypoint_maps():
    rng = np.random.RandomState(5)
    T = 7
    cam = np.stack([0.8 + 0.2 * rng.rand(T), 0.1 * rng.randn(T),
                    0.1 * rng.randn(T)], 1).astype(np.float32)
    boxes = np.stack([rng.rand(4) * 100 + [0, 0, 100, 150]
                      for _ in range(T)]).astype(np.float32)
    cs = np.stack([ttracker.bbox_to_cs(b) for b in boxes])
    np.testing.assert_array_equal(
        cs, np.stack([jtracker.bbox_to_cs(b) for b in boxes]))
    np.testing.assert_allclose(
        ttracker.convert_crop_cam_to_orig_img(cam, cs, 640, 360),
        jtracker.convert_crop_cam_to_orig_img(cam, cs, 640, 360), rtol=RTOL)
    kp = rng.uniform(-1, 1, (T, 49, 2)).astype(np.float32)
    np.testing.assert_allclose(ttracker.crop_to_image_coords(cs, kp, 224),
                               jtracker.crop_to_image_coords(cs, kp, 224),
                               rtol=RTOL)
    a, b = boxes[0], boxes[1]
    assert ttracker.iou(a, b) == jtracker.iou(a, b)
