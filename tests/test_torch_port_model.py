"""Port modules against nemo_tpu on identical numpy inputs (CPU).

Covers the body model (both smpl_forward paths, FK transforms, the v2v
prior), rotations (including gradients at the identity, where every fit
starts), cameras, the networks (MotionNet, monotonic warps, all 11 RBF
kernels), the priors (VPoser, GMM, GMoF) and the keypoint losses.
Tolerances are f32 ordering noise between two frameworks, stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.body import smpl as jsmpl
from nemo_tpu.fit import losses as jlosses
from nemo_tpu.geometry import camera as jcam
from nemo_tpu.geometry import rotations as jrot
from nemo_tpu.modules import networks as jnet
from nemo_tpu.priors import gmm as jgmm
from nemo_tpu.priors import robustifiers as jrob
from nemo_tpu.priors import vposer as jvp
from nemo_tpu_torch.body import smpl as tsmpl
from nemo_tpu_torch.body.assets import smpl_from_numpy, synthetic_smpl_model
from nemo_tpu_torch.fit import losses as tlosses
from nemo_tpu_torch.geometry import camera as tcam
from nemo_tpu_torch.geometry import rotations as trot
from nemo_tpu_torch.modules import networks as tnet
from nemo_tpu_torch.priors import gmm as tgmm
from nemo_tpu_torch.priors import robustifiers as trob
from nemo_tpu_torch.priors import vposer as tvp

torch.set_num_threads(1)
T = torch.tensor


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **kw)


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    return jm, smpl_from_numpy(jm)


@pytest.fixture(scope="module")
def poses():
    rng = np.random.RandomState(0)
    B = 6
    return dict(body_aa=(0.5 * rng.randn(B, 69)).astype(np.float32),
                orient_aa=(0.5 * rng.randn(B, 3)).astype(np.float32),
                betas=(0.5 * rng.randn(1, 10)).astype(np.float32),
                transl=rng.randn(B, 3).astype(np.float32))


# ---------------------------------------------------------------------------
# body model
# ---------------------------------------------------------------------------

class TestBody:
    def test_synthetic_model_tables_identical(self, models):
        jm, _ = models
        tm = synthetic_smpl_model(num_vertices=300, seed=0)
        for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "lbs_weights", "J_regressor_extra", "fused_ES", "fused_EP",
                  "fused_EW", "posedirs_t", "lbs_weights_t"):
            np.testing.assert_array_equal(_np(getattr(tm, f)),
                                          np.asarray(getattr(jm, f)), f)
        for f in ("parents", "vertex_joint_ids", "joint_map", "faces"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), f)

    @pytest.mark.parametrize("source", ["synthetic", "converted"])
    def test_model_tensors_contiguous(self, models, source):
        """The kernels take contiguous operands only (posedirs_t and
        lbs_weights_t are transposes of the raw tables)."""
        tm = models[1] if source == "converted" else synthetic_smpl_model(
            num_vertices=300, seed=0)
        for f in tsmpl._TENSOR_FIELDS:
            assert getattr(tm, f).is_contiguous(), f

    @pytest.mark.parametrize("want_vertices", [True, False])
    def test_smpl_forward(self, models, poses, want_vertices):
        jm, tm = models
        vj, jj, pj = jax.jit(lambda b, p, o, t: jsmpl.smpl_forward(
            jm, b, p, o, pose2rot=True, want_vertices=want_vertices,
            transl=t, want_fk_joints=True))(
            *(jnp.asarray(poses[k]) for k in ("betas", "body_aa", "orient_aa",
                                              "transl")))
        vt, jt, pt = tsmpl.smpl_forward(
            tm, T(poses["betas"]), T(poses["body_aa"]), T(poses["orient_aa"]),
            pose2rot=True, want_vertices=want_vertices,
            transl=T(poses["transl"]), want_fk_joints=True)
        # metre-scale coordinates after 8 chained rotations: ~1e-6 noise
        _close(jt, jj, atol=2e-5)
        _close(pt, pj, atol=2e-5)
        if want_vertices:
            _close(vt, vj, atol=2e-5)
        else:
            assert vt is None and vj is None

    def test_joints_paths_agree(self, models, poses):
        _, tm = models
        args = (tm, T(poses["betas"]), T(poses["body_aa"]),
                T(poses["orient_aa"]))
        _, j_mesh = tsmpl.smpl_forward(*args, pose2rot=True)
        _, j_fused = tsmpl.smpl_forward(*args, pose2rot=True,
                                        want_vertices=False)
        _close(j_fused, j_mesh, atol=2e-5)

    def test_batch_rigid_transform(self, models, poses):
        jm, tm = models
        rot = jrot.batch_rodrigues(jnp.asarray(
            poses["body_aa"]).reshape(-1, 23, 3))
        rot = jnp.concatenate([jnp.broadcast_to(jnp.eye(3), (6, 1, 3, 3)),
                               rot], axis=1)
        J = jnp.asarray(np.asarray(jm.J_regressor) @ np.asarray(jm.v_template))
        pj, Aj = jsmpl.batch_rigid_transform(rot, J, jm.parents)
        pt, At = tsmpl.batch_rigid_transform(T(np.asarray(rot)),
                                             T(np.asarray(J)), tm.parents)
        _close(pt, pj, atol=2e-5)
        _close(At, Aj, atol=2e-5)

    def test_smpl_v2v_l1_sum_value_and_grads(self, models, poses):
        jm, tm = models
        rng = np.random.RandomState(5)
        rot_o = np.asarray(jrot.batch_rodrigues(jnp.asarray(
            poses["body_aa"]).reshape(-1, 23, 3)))
        rot_r = np.asarray(jrot.batch_rodrigues(jnp.asarray(
            (0.5 * rng.randn(6, 69)).astype(np.float32)).reshape(-1, 23, 3)))
        orient = np.asarray(jrot.batch_rodrigues(jnp.asarray(
            poses["orient_aa"])))[:, None]
        betas = poses["betas"]

        def jf(b, ro, o):
            return jsmpl.smpl_v2v_l1_sum(jm, b, ro, o, jnp.asarray(rot_r), o)
        val_j, g_j = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(
            jnp.asarray(betas), jnp.asarray(rot_o), jnp.asarray(orient))
        b, ro, o = (T(a, requires_grad=True) for a in (betas, rot_o, orient))
        val_t = tsmpl.smpl_v2v_l1_sum(tm, b, ro, o, T(rot_r), o)
        val_t.backward()
        # 5400 |diff| terms; gradients are sums over V=300 vertices
        _close(val_t, val_j, rtol=1e-5)
        for name, gt, gj in (("betas", b, g_j[0]), ("body_rot_o", ro, g_j[1]),
                             ("orient", o, g_j[2])):
            gj = np.asarray(gj)
            _close(gt.grad, gj, atol=2e-5 * np.abs(gj).max(), err_msg=name)


# ---------------------------------------------------------------------------
# rotations and cameras
# ---------------------------------------------------------------------------

class TestRotations:
    @pytest.fixture(scope="class")
    def x6(self):
        return np.random.RandomState(1).randn(10, 6).astype(np.float32)

    def test_rot6d_roundtrip(self, x6):
        Rj = jrot.rot6d_to_rotmat(jnp.asarray(x6))
        Rt = trot.rot6d_to_rotmat(T(x6))
        _close(Rt, Rj, atol=1e-6)
        _close(trot.rotmat_to_rot6d(Rt), jrot.rotmat_to_rot6d(Rj), atol=1e-6)

    def test_batch_rodrigues(self):
        aa = np.random.RandomState(2).randn(12, 3).astype(np.float32)
        aa[0] = 0.0
        _close(trot.batch_rodrigues(T(aa)), jrot.batch_rodrigues(
            jnp.asarray(aa)), atol=1e-6)

    def test_rotmat_to_aa_and_quaternions(self, x6):
        R = np.asarray(jrot.rot6d_to_rotmat(jnp.asarray(x6)))
        R = np.concatenate([R, np.eye(3, dtype=np.float32)[None]])
        _close(trot.rotmat_to_quat(T(R)), jrot.rotmat_to_quat(jnp.asarray(R)),
               atol=2e-6)
        _close(trot.rotmat_to_aa(T(R)), jrot.rotmat_to_aa(jnp.asarray(R)),
               atol=2e-5)
        q = np.random.RandomState(3).randn(5, 4).astype(np.float32)
        _close(trot.quat_to_rotmat(T(q)), jrot.quat_to_rotmat(jnp.asarray(q)),
               atol=2e-6)
        aa = np.random.RandomState(4).randn(5, 3).astype(np.float32)
        _close(trot.aa_to_quat(T(aa)), jrot.aa_to_quat(jnp.asarray(aa)),
               atol=1e-6)

    def test_identity_gradients_finite_and_match(self):
        """MotionNet starts at the identity 6D bias: rot6d -> rotmat -> aa
        must have finite, matching gradients exactly there."""
        x = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), (4, 1))
        w = np.random.RandomState(5).randn(4, 3).astype(np.float32)
        gj = jax.jit(jax.grad(lambda v: jnp.sum(jrot.rotmat_to_aa(
            jrot.rot6d_to_rotmat(v)) * w)))(jnp.asarray(x))
        xt = T(x, requires_grad=True)
        (trot.rotmat_to_aa(trot.rot6d_to_rotmat(xt)) * T(w)).sum().backward()
        assert torch.isfinite(xt.grad).all()
        _close(xt.grad, gj, atol=1e-5)
        aa = T(np.zeros((3, 3), np.float32), requires_grad=True)
        trot.batch_rodrigues(aa).sum().backward()
        assert torch.isfinite(aa.grad).all()


class TestCamera:
    def test_projection_through_learned_camera(self):
        rng = np.random.RandomState(6)
        p9 = np.concatenate([rng.randn(5, 3) + [0, 0, 10],
                             rng.randn(5, 6)], -1).astype(np.float32)
        pts = rng.randn(5, 7, 3).astype(np.float32)
        pts[0, 0] = [0.0, 0.0, -10.0 - p9[0, 2]]   # near the camera plane
        cj = jcam.camera_from_params(jnp.asarray(p9), 1000.0, 1900.0)
        ct = tcam.camera_from_params(T(p9), 1000.0, 1900.0)
        _close(ct.center, cj.center)
        _close(ct.rotation, cj.rotation, atol=1e-6)
        pj = jcam.project(jnp.asarray(pts), cj)
        pt = tcam.project(T(pts), ct)
        assert torch.isfinite(pt).all()
        _close(pt, pj, rtol=1e-5, atol=1e-2)

    def test_init_camera_params_layout(self):
        p = tcam.init_camera_params(3, 1000.0,
                                    generator=torch.Generator().manual_seed(0))
        assert p.shape == (3, 9)
        _close(p[:, 3], np.ones(3), atol=1e-3)
        _close(p[:, 2], np.full(3, 10.0), atol=1e-3)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

class TestNetworks:
    @pytest.mark.parametrize("kernel", sorted(jnet.RBF_KERNELS))
    def test_rbf_kernel(self, kernel):
        rng = np.random.RandomState(7)
        x = rng.rand(9, 1).astype(np.float32)
        ls = (0.3 * rng.randn(8)).astype(np.float32)
        rbf = tnet.RBF(8)
        with torch.no_grad():
            rbf.log_sigmas.copy_(T(ls))
        _close(tnet.apply_rbf(rbf, T(x), kernel),
               jnet.apply_rbf({"log_sigmas": jnp.asarray(ls)},
                              jnp.asarray(x), kernel), rtol=2e-6, atol=1e-6)

    def test_kernel_sets_match(self):
        assert sorted(tnet.RBF_KERNELS) == sorted(jnet.RBF_KERNELS)
        assert len(tnet.RBF_KERNELS) == 11

    def test_motion_net(self):
        pj = jnet.init_motion_net(jax.random.PRNGKey(3), 12, 32, 24,
                                  init_last_layer_zero=False)
        net = tnet.MotionNet(12, 32, 24, init_last_layer_zero=False)
        with torch.no_grad():
            for name, p in net.named_parameters():
                src = pj
                for part in name.split("."):
                    src = src[part]
                p.copy_(T(np.asarray(src)))
        x = np.random.RandomState(8).randn(10, 12).astype(np.float32)
        dj, oj, tj = jax.jit(lambda p, v: jnet.apply_motion_net(p, v, 24))(
            pj, jnp.asarray(x))
        dt, ot, tt = net(T(x))
        _close(tt, tj, atol=1e-5)
        for k in ("rot6d", "rotmat", "pose"):
            _close(dt[k], dj[k], atol=2e-5, err_msg=k)
            _close(ot[k], oj[k], atol=2e-5, err_msg=k)

    def test_monotonic_gather(self):
        rng = np.random.RandomState(9)
        sh = rng.rand(3, 5).astype(np.float32)
        sc = (10 + 5 * rng.rand(3, 5)).astype(np.float32)
        vi = np.array([0, 2, 1, 2, 0])
        x = rng.rand(5, 1).astype(np.float32)
        mono = tnet.MonotonicNets(3, 5)
        with torch.no_grad():
            mono.shifts.copy_(T(sh))
            mono.scales.copy_(T(sc))
        _close(tnet.apply_monotonic_gather(mono, T(vi), T(x)),
               jnet.apply_monotonic_gather(
                   {"shifts": jnp.asarray(sh), "scales": jnp.asarray(sc)},
                   jnp.asarray(vi), jnp.asarray(x)), atol=1e-6)


# ---------------------------------------------------------------------------
# priors and losses
# ---------------------------------------------------------------------------

class TestPriors:
    def test_vposer(self):
        pj = jvp.init_vposer(jax.random.PRNGKey(7))
        pt = tvp.vposer_from_numpy({k: np.asarray(v) for k, v in pj.items()})
        x = (0.3 * np.random.RandomState(10).randn(6, 63)).astype(np.float32)
        mj, sj, dj = jax.jit(lambda p, v: (
            *jvp.vposer_encode(p, v), jvp.vposer_decode(
                p, jvp.vposer_encode(p, v)[0])))(pj, jnp.asarray(x))
        mt, st = tvp.vposer_encode(pt, T(x))
        _close(mt, mj, atol=1e-5)
        _close(st, sj, atol=1e-5)
        dt = tvp.vposer_decode(pt, mt)
        for k in ("pose_body", "pose_body_matrot"):
            _close(dt[k], dj[k], atol=5e-5, err_msg=k)
        _close(tvp.vposer_kl_to_std_normal(mt, st),
               jvp.vposer_kl_to_std_normal(mj, sj), rtol=1e-5)

    def test_vposer_init_shapes(self):
        p = tvp.init_vposer(generator=torch.Generator().manual_seed(0))
        pj = jvp.init_vposer(jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            {k: tuple(v.shape) for k, v in pj.items()}

    def test_gmm(self):
        gj = jgmm.synthetic_gmm_prior(4)
        gt = tgmm.synthetic_gmm_prior(4)
        for f in ("means", "precisions", "nll_weights"):
            np.testing.assert_array_equal(_np(getattr(gt, f)),
                                          np.asarray(getattr(gj, f)))
        x = (0.3 * np.random.RandomState(11).randn(7, 69)).astype(np.float32)
        _close(tgmm.gmm_log_likelihood(gt, T(x)),
               jgmm.gmm_log_likelihood(gj, jnp.asarray(x)), rtol=1e-5)

    @pytest.mark.parametrize("sqrt", [False, True])
    def test_gmof(self, sqrt):
        r = (50 * np.random.RandomState(12).randn(8, 25, 2)).astype(
            np.float32)
        _close(trob.gmof(T(r), sqrt=sqrt), jrob.gmof(jnp.asarray(r),
                                                     sqrt=sqrt), rtol=1e-6)


class TestLosses:
    @pytest.mark.parametrize("loss_type", list(jlosses.KEYPOINT_LOSS_TYPES))
    def test_keypoint_loss(self, loss_type):
        rng = np.random.RandomState(13)
        pred = (100 * rng.randn(6, 25, 2)).astype(np.float32)
        gt = (100 * rng.randn(6, 25, 2)).astype(np.float32)
        conf = rng.rand(6, 25, 1).astype(np.float32)
        size = (200 + 50 * rng.rand(6)).astype(np.float32)
        _close(tlosses.keypoint_loss(T(pred), T(gt), T(conf), T(size),
                                     loss_type),
               jlosses.keypoint_loss(jnp.asarray(pred), jnp.asarray(gt),
                                     jnp.asarray(conf), jnp.asarray(size),
                                     loss_type), rtol=1e-5)

    def test_per_view_average_and_camera_loss(self):
        rng = np.random.RandomState(14)
        loss = rng.rand(9, 25, 2).astype(np.float32)
        conf = rng.rand(9, 25, 1).astype(np.float32)
        vi = np.array([0, 0, 2, 2, 2, 3, 0, 3, 3])      # view 1 absent
        _close(tlosses.per_view_average(T(loss), T(conf), T(vi), 4),
               jlosses.per_view_average(jnp.asarray(loss), jnp.asarray(conf),
                                        jnp.asarray(vi), 4), rtol=1e-6)
        p = (100 * rng.randn(4, 25, 2)).astype(np.float32)
        g = np.concatenate([100 * rng.randn(4, 25, 2), rng.rand(4, 25, 1)],
                           -1).astype(np.float32)
        s = np.full(4, 300.0, np.float32)
        _close(tlosses.camera_fitting_loss(T(p), T(g), T(s)),
               jlosses.camera_fitting_loss(jnp.asarray(p), jnp.asarray(g),
                                           jnp.asarray(s)), rtol=1e-6)
