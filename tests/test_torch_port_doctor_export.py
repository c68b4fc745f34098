"""The port's doctor and export CLIs against nemo_tpu's, and the recipe's
outer stages end to end in the port, on the CPU.

- doctor: the (status, what) rows equal JAX's, row for row, on a ready
  layout with written asset files, on one with a view's OpenPose missing,
  with no arguments (rc 2) and with a malformed asset (rc 1);
- export: from one JAX-written checkpoint, the port's payload against JAX's
  (pose, trans and joints15 within 2e-5, cameras equal), the npz/JSON round
  trip, and the payload rebuilt through the port's smpl_forward;
- preprocess -> fit -> export, all in the port on --device cpu.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_port_preprocess import write_mocap_layout

EXPORT_ATOL = 2e-5       # port against JAX, from the same checkpoint
RECON_ATOL = 2e-4        # the payload against its own SMPL rebuild


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Asset files in the real layouts, written from the port's synthetic
    body and priors (utils/asset_files.py)."""
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_arrays
    from nemo_tpu_torch.priors.vposer import init_vposer
    from nemo_tpu_torch.utils import asset_files as af
    d = str(tmp_path_factory.mktemp("assets"))
    smpl = synthetic_smpl_model(300, seed=0)
    arrays = af.smpl_file_arrays(smpl)
    os.makedirs(os.path.join(d, "smpl"))
    files = {
        "--smpl_path": af.write_smpl_pkl(
            os.path.join(d, "smpl", "SMPL_NEUTRAL.pkl"), arrays),
        "--j_regressor_extra": os.path.join(d, "J_regressor_extra.npy"),
        "--vposer_path": af.write_vposer_snapshot(
            os.path.join(d, "V02_05"),
            init_vposer(generator=torch.Generator().manual_seed(7))),
        "--gmm_path": af.write_gmm_pkl(os.path.join(d, "gmm_08.pkl"),
                                       *synthetic_gmm_arrays(8)),
    }
    np.save(files["--j_regressor_extra"], smpl.J_regressor_extra.numpy())
    return files


def _doctor_rows(argv, capsys):
    """(rc, rows) of JAX's doctor, then of the port's (--device cpu)."""
    from nemo_tpu.cli import doctor as J
    from nemo_tpu_torch.cli import doctor as P
    rcs, rows = [], []
    for mod, extra in ((J, []), (P, ["--device", "cpu"])):
        rcs.append(mod.main(argv + extra))
        rows.append([(s, w) for s, w, _ in mod._ROWS])
        capsys.readouterr()
    return rcs, rows


def _flags(d, keys):
    return [x for k in keys for x in (k, d[k])]


@pytest.mark.parametrize("case", ["ready", "view_missing", "assets_only",
                                  "malformed_asset", "no_arguments"])
def test_doctor_rows_equal_jax(tmp_path, assets, capsys, case):
    cfg, flags = write_mocap_layout(str(tmp_path / "raw"))
    argv = ["--nemo_cfg_path", cfg] + _flags(assets, sorted(assets)) + \
        _flags(flags, ("--gt_cam_paths", "--mocap_pkl"))
    want_rc = 0
    if case == "view_missing":
        shutil.rmtree(os.path.join(str(tmp_path / "raw"), "exp",
                                   "view1.mp4.op"))
        want_rc = 1
    elif case == "assets_only":
        argv = _flags(assets, sorted(assets))
    elif case == "malformed_asset":
        bad = str(tmp_path / "gmm_bad.pkl")
        with open(bad, "wb") as f:
            f.write(b"not a pickle")
        argv = _flags(dict(assets, **{"--gmm_path": bad}), sorted(assets))
        want_rc = 1
    elif case == "no_arguments":
        argv, want_rc = [], 2
    if case in ("ready", "view_missing"):
        # the JAX doctor fails a .npy camera, which both packers accept;
        # the port's passes it (the one row where the two differ)
        npy = [p for p in flags["--gt_cam_paths"].split(",")
               if p.endswith(".npy")]
        (_, prc), (_, prows) = _doctor_rows(argv, capsys)
        assert prc == want_rc
        assert ("PASS", f"GT camera {npy[0]}") in prows
        i = argv.index("--gt_cam_paths") + 1
        argv[i] = ",".join(p for p in flags["--gt_cam_paths"].split(",")
                           if not p.endswith(".npy"))
    (jrc, prc), (jrows, prows) = _doctor_rows(argv, capsys)
    assert jrc == prc == want_rc
    assert prows == jrows
    if case == "ready":
        assert len(prows) > 15 and {s for s, _ in prows} == {"PASS"}


def test_doctor_details_and_verdict(tmp_path, assets, capsys):
    """The assets' detail strings equal JAX's; READY on the last line."""
    from nemo_tpu.cli import doctor as J
    from nemo_tpu_torch.cli import doctor as P
    argv = _flags(assets, sorted(assets))
    assert J.main(argv) == 0
    jrows = list(J._ROWS)
    capsys.readouterr()
    assert P.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert list(P._ROWS) == jrows
    assert out.strip().splitlines()[-1].startswith("READY")


def test_doctor_cuda_without_a_card_raises(assets):
    from nemo_tpu_torch.cli.doctor import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--smpl_path", assets["--smpl_path"]])


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

_CFG = dict(model_version=2, h_dim=32, instance_code_size=4,
            phase_rbf_dim=8, rbf_kernel="quadratic",
            monotonic_network_n_nodes=8, batch_size=16,
            n_steps=4, warmup_step=0, opt_cam_step=0,
            weight_gmm_loss=0.0, weight_vp_loss=0.0, weight_vp_z_loss=0.0)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A 2-step JAX fit at the export CLI's synthetic topology (3 views x
    10 frames), saved in the JAX checkpoint layout."""
    from nemo_tpu.body import synthetic_smpl_model
    from nemo_tpu.data import synthetic_problem
    from nemo_tpu.fit import NemoConfig, NemoFitter, build_assets
    from nemo_tpu.utils import save_fit_state
    model = synthetic_smpl_model()
    cfg = NemoConfig(**_CFG)
    bundle, _ = synthetic_problem(model, num_views=3, num_frames=10)
    fitter = NemoFitter(cfg, build_assets(bundle, model, cfg), seed=0)
    fitter.fit(steps=2, chunk=2)
    ckpt = str(tmp_path_factory.mktemp("run") / "ckpt" / "sd_000002")
    save_fit_state(ckpt, fitter.state, cfg)
    return ckpt


def _export_both(tmp_path, ckpt, extra=()):
    from nemo_tpu.cli.export import main as jax_main
    from nemo_tpu_torch.cli.export import load_motion, main
    jout, pout = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    base = ["--load_ckpt_path", ckpt, "--synthetic_assets", "--num_views",
            "3", "--num_frames", "10", *extra]
    assert jax_main(base + ["--out", jout]) == 0
    assert main(base + ["--out", pout, "--json", "--device", "cpu"]) == 0
    return load_motion(jout), load_motion(pout), pout


def test_export_from_jax_checkpoint_equals_jax(tmp_path, jax_ckpt):
    jp, pp, _ = _export_both(tmp_path, jax_ckpt)
    assert sorted(pp) == sorted(jp)
    for k in ("pose", "trans", "joints15"):
        assert pp[k].shape == jp[k].shape and pp[k].dtype == np.float32
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=EXPORT_ATOL,
                                   err_msg=k)
    for k in ("cameras", "betas", "fps"):
        assert np.array_equal(pp[k], jp[k]), k
    for k in ("cam_rotation", "cam_translation", "cam_focal", "cam_center"):
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_export_round_trip_and_rebuild(tmp_path, jax_ckpt):
    """The JSON sidecar holds the npz's payload; pose, trans and betas
    rebuild joints15 through the port's smpl_forward."""
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.cli.export import load_motion
    _, back, pout = _export_both(tmp_path, jax_ckpt, ["--fps", "25"])
    side = load_motion(os.path.splitext(pout)[0] + ".json")
    assert sorted(side) == sorted(back)
    for k in back:
        assert np.array_equal(side[k], back[k]), k
    assert float(back["fps"]) == 25.0
    V, F = back["pose"].shape[:2]
    pose = torch.from_numpy(back["pose"].reshape(V * F, 72))
    _, j49 = smpl_forward(synthetic_smpl_model(),
                          torch.from_numpy(back["betas"])[None],
                          pose[:, 3:], pose[:, :3], pose2rot=True,
                          want_vertices=False,
                          transl=torch.from_numpy(
                              back["trans"].reshape(V * F, 3)))
    np.testing.assert_allclose(j49[:, :15].numpy().reshape(V, F, 15, 3),
                               back["joints15"], rtol=0, atol=RECON_ATOL)


def test_export_cuda_without_a_card_raises(jax_ckpt, tmp_path):
    from nemo_tpu_torch.cli.export import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--load_ckpt_path", jax_ckpt, "--synthetic_assets",
              "--out", str(tmp_path / "m.npz")])


# ---------------------------------------------------------------------------
# the recipe's outer stages, end to end in the port
# ---------------------------------------------------------------------------

FIT = ["--synthetic_assets", "--model_version", "2", "--phase_rbf_dim", "8",
       "--rbf_kernel", "quadratic", "--h_dim", "16",
       "--monotonic_network_n_nodes", "4", "--instance_code_size", "4",
       "--batch_size", "16", "--n_steps", "2", "--warmup_step", "1",
       "--opt_cam_step", "1", "--save_every", "2", "--label_type", "gt",
       "--loss", "mse_robust", "--weight_gmm_loss", "0.5"]


@pytest.mark.parametrize("motion_mlp", ["plain", "fused"])
def test_preprocess_fit_export_in_the_port(tmp_path, capsys, motion_mlp):
    """Raw files -> bundle -> a 1 + 1 + 2-step fit -> the motion payload,
    all through the port's CLIs on the CPU; the export restores the fit's
    MotionNet mode from the run's config.json."""
    from nemo_tpu_torch.cli import export, fit, preprocess
    from nemo_tpu_torch.data import MultiViewBundle
    cfg, flags = write_mocap_layout(str(tmp_path / "raw"))
    bundle = str(tmp_path / "bundle.npz")
    assert preprocess.main(["--nemo_cfg_path", cfg, "--out", bundle,
                            "--mocap_pkl", flags["--mocap_pkl"]]) == 0
    out = str(tmp_path / "fit")
    assert fit.main(FIT + ["--bundle", bundle, "--device", "cpu",
                           "--motion_mlp", motion_mlp, "--out_dir", out]) == 0
    ckpt = os.path.join(out, "000000", "ckpt", "sd_000002")
    motion = str(tmp_path / "motion.npz")
    capsys.readouterr()
    assert export.main(["--load_ckpt_path", ckpt, "--bundle", bundle,
                        "--synthetic_assets", "--device", "cpu",
                        "--out", motion]) == 0
    assert f"motion_mlp {motion_mlp}" in capsys.readouterr().out
    got = export.load_motion(motion)
    b = MultiViewBundle.load(bundle)
    assert got["pose"].shape == (b.num_views, b.num_frames, 72)
    assert np.array_equal(got["framerate_multiplier"],
                          b.framerate_multiplier)
    assert all(np.isfinite(v).all() for v in got.values())
    saved = json.load(open(os.path.join(ckpt, "meta.json")))
    assert saved["step"] == 2
