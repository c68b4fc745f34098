"""``python -m nemo_tpu_torch.cli.fit`` against ``nemo_tpu.cli.fit``.

A tiny synthetic fit through both CLIs with the same flags: the port (run in
a fresh interpreter on the CPU, which must never import jax) writes the same
files, and every eval CSV has the JAX CLI's header row and row count.
"""

import csv
import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--synthetic_assets", "--model_version", "2", "--phase_rbf_dim", "8",
         "--rbf_kernel", "quadratic", "--h_dim", "16",
         "--monotonic_network_n_nodes", "4", "--instance_code_size", "4",
         "--batch_size", "16", "--n_steps", "2", "--warmup_step", "1",
         "--opt_cam_step", "1", "--save_every", "2", "--label_type", "gt",
         "--loss", "mse_robust", "--weight_gmm_loss", "0.5",
         "--weight_vp_loss", "1.0"]
CSVS = ("eval_2d.csv", "eval_3d.csv", "eval_3d_dynamic.csv",
        "eval_3d_global.csv")

_PORT_MAIN = (
    "import sys\n"
    "import torch\n"
    "torch.set_num_threads(2)\n"
    "from nemo_tpu_torch.cli.{module} import main\n"
    "rc = main(sys.argv[1:])\n"
    "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
    " ('jax', 'jaxlib', 'optax', 'nemo_tpu'))\n"
    "assert not bad, bad\n"
    "sys.exit(rc)\n")


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _run_port(args, module="fit", **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c",
                           _PORT_MAIN.format(module=module), *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600, **kw)


def test_cli_outputs_match_jax_cli(tmp_path):
    from nemo_tpu.cli.fit import main as jax_main
    assert jax_main(FLAGS + ["--out_dir", str(tmp_path / "jax")]) == 0
    out = _run_port(FLAGS + ["--device", "cpu", "--out_dir",
                             str(tmp_path / "port")])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    jdir = tmp_path / "jax" / "000000"
    tdir = tmp_path / "port" / "000000"
    for name in ("config.json", "metrics.jsonl", "losses.npz") + CSVS:
        assert (tdir / name).is_file(), name
    for name in CSVS:
        j, t = _rows(jdir / name), _rows(tdir / name)
        assert t[0] == j[0], name
        assert len(t) == len(j), name
    phases = lambda d: [json.loads(line)["phase"]
                        for line in open(d / "metrics.jsonl")]
    assert phases(tdir) == phases(jdir)
    final_t = [json.loads(line) for line in open(tdir / "metrics.jsonl")][-1]
    final_j = [json.loads(line) for line in open(jdir / "metrics.jsonl")][-1]
    assert sorted(final_t) == sorted(final_j)


@pytest.mark.parametrize("extra", [["--dp", "2"]])
def test_unported_flags_raise(tmp_path, extra, monkeypatch):
    """--dp is ported (tests/test_torch_port_parallel.py runs it); what it
    still refuses is more ranks than visible cards, naming both numbers,
    before it starts any rank."""
    from nemo_tpu_torch.cli.fit import main
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=r"--dp 2 needs a card a rank: "
                                         r"0 visible"):
        main(FLAGS + extra + ["--device", "cuda", "--out_dir",
                              str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("subset", [0, 64])
def test_skin_bf16_builds_bf16_tables(subset):
    """--skin_bf16 parses in both CLIs; the port's load_assets builds the
    body's skinning tables (and the v2v subset's) in bf16, every other
    table in f32; without it, f32."""
    import torch
    from nemo_tpu.cli.fit import build_parser as jax_parser
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.cli.fit import build_parser, load_assets
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.fit.model import NemoConfig
    from nemo_tpu_torch.utils.exp import dataclass_from_namespace
    argv = FLAGS + ["--vp_v2v_n_verts", str(subset)]
    assert jax_parser().parse_args(argv + ["--skin_bf16"]).skin_bf16
    argv = argv + ["--device", "cpu"]
    for bf16 in (False, True):
        args = build_parser().parse_args(argv + ["--skin_bf16"] * bf16)
        assert args.skin_bf16 == bf16
        cfg = dataclass_from_namespace(NemoConfig, args)
        bundle, _ = synthetic_problem(synthetic_smpl_model(300, seed=0),
                                      num_views=2, num_frames=4)
        assets = load_assets(args, bundle, cfg, torch.device("cpu"))
        want = torch.bfloat16 if bf16 else torch.float32
        assert assets.smpl.posedirs_t.dtype == want
        assert assets.smpl.lbs_weights_t.dtype == want
        assert assets.smpl.posedirs.dtype == torch.float32
        if subset:
            assert assets.v2v_posedirs_t.dtype == want
            assert assets.v2v_lbs_weights_t.dtype == want


def test_skin_bf16_fit_matches_jax_cli_phases(tmp_path, monkeypatch):
    """A 1 + 1 + 2-step fit with --skin_bf16 through both CLIs on the CPU:
    the port writes config.json with the flag, and metrics.jsonl with the
    JAX CLI's phases and keys, every value finite. The JAX CLI sets
    NEMO_TPU_SKIN_BF16 itself; setting it here first has monkeypatch put it
    back afterwards, so later tests in this process build f32 tiles."""
    from nemo_tpu.cli.fit import main as jax_main
    from nemo_tpu_torch.cli.fit import main
    monkeypatch.setenv("NEMO_TPU_SKIN_BF16", "0")
    flags = FLAGS + ["--skin_bf16"]
    assert jax_main(flags + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert main(flags + ["--device", "cpu", "--out_dir",
                         str(tmp_path / "port")]) == 0
    jdir = tmp_path / "jax" / "000000"
    tdir = tmp_path / "port" / "000000"
    assert json.load(open(tdir / "config.json"))["args"]["skin_bf16"] is True
    lines = lambda d: [json.loads(line) for line in open(d / "metrics.jsonl")]
    lj, lt = lines(jdir), lines(tdir)
    assert [m["phase"] for m in lt] == [m["phase"] for m in lj]
    assert [sorted(m) for m in lt] == [sorted(m) for m in lj]
    assert all(math.isfinite(v) for m in lt for v in m.values()
               if isinstance(v, float))
    assert lt[-1]["vp_recon_loss"] > 0


SMALL = ["--model_version", "2", "--phase_rbf_dim", "8", "--rbf_kernel",
         "quadratic", "--h_dim", "16", "--monotonic_network_n_nodes", "4",
         "--instance_code_size", "4", "--batch_size", "16", "--n_steps", "2",
         "--warmup_step", "1", "--opt_cam_step", "1", "--save_every", "2",
         "--label_type", "gt", "--loss", "mse_robust"]


def _asset_files(d):
    """SMPL (the chumpy pickle of the 150-vertex synthetic body, in a
    directory, and J_regressor_extra.npy), a VPoser snapshot directory, a
    gmm_08.pkl and a HuMoR checkpoint (hidden layers 64 wide, latent 48)
    under d, and a bundle of that body with vs, pare and GLAMR baselines
    and GLAMR world data. Returns the fit flags that name them."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.models.humor import HumorConfig, init_mlp
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_arrays
    from nemo_tpu_torch.priors.vposer import init_vposer
    from nemo_tpu_torch.utils import asset_files as af
    smpl = synthetic_smpl_model(150, seed=0, device="cpu")
    os.makedirs(os.path.join(d, "smpl"))
    af.write_smpl_pkl(os.path.join(d, "smpl", "SMPL_NEUTRAL.pkl"),
                      af.smpl_file_arrays(smpl))
    jre = os.path.join(d, "J_regressor_extra.npy")
    np.save(jre, smpl.J_regressor_extra.numpy())
    gen = torch.Generator().manual_seed(0)
    af.write_vposer_snapshot(os.path.join(d, "V02_05"),
                             init_vposer(generator=gen))
    af.write_gmm_pkl(os.path.join(d, "gmm_08.pkl"), *synthetic_gmm_arrays(8))
    cfg = HumorConfig()
    D, L, w = cfg.input_dim, cfg.latent_size, [64] * 4
    humor = {"encoder": init_mlp(gen, [2 * D] + w + [2 * L]),
             "decoder": init_mlp(gen, [D + L] + w[:3] + [cfg.output_dim],
                                 skip_size=L),
             "prior": init_mlp(gen, [D] + w + [2 * L])}
    af.write_humor_ckpt(os.path.join(d, "humor.pth"), humor, "module.")
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=8)
    rng = np.random.default_rng(0)
    pose = lambda: np.concatenate(
        [bundle.gt3d_pose[..., 3:] + 0.1 * rng.standard_normal((2, 8, 69)),
         np.ones((2, 8, 1))], -1).astype(np.float32)
    bundle.baseline_poses = {"vs": pose(), "pare": pose(), "glamr": pose()}
    bundle.glamr_orient = (bundle.gt3d_pose[..., :3]
                           + 0.1 * rng.standard_normal((2, 8, 3))).astype(
                               np.float32)
    bundle.glamr_trans = (bundle.gt3d_trans + 0.1 * rng.standard_normal(
        (2, 8, 3))).astype(np.float32)
    bundle.save(os.path.join(d, "glamr.npz"))
    return ["--bundle", os.path.join(d, "glamr.npz"),
            "--smpl_path", os.path.join(d, "smpl"),
            "--j_regressor_extra", jre,
            "--vposer_path", os.path.join(d, "V02_05"),
            "--gmm_path", os.path.join(d, "gmm_08.pkl"),
            "--humor_ckpt", os.path.join(d, "humor.pth")]


@pytest.fixture(scope="module")
def asset_flags(tmp_path_factory):
    return _asset_files(str(tmp_path_factory.mktemp("assets")))


def test_asset_files_and_glamr_bundle_through_both_clis(tmp_path,
                                                        asset_flags):
    """Both CLIs fit from the same written asset files (no synthetic
    assets) on a bundle with GLAMR world data, with the HuMoR term on: the
    same eval CSV columns and rows (the GLAMR and baseline columns among
    them), the same metrics (humor_loss among them), and config.json
    records --init-motion-prior."""
    from nemo_tpu.cli.fit import main as jax_main
    flags = SMALL + asset_flags + [
        "--weight_vp_loss", "1.0", "--weight_gmm_loss", "0.5",
        "--weight_humor_loss", "1.0", "--humor_fps", "25",
        "--init-motion-prior", "init_state_prior_gmm.npz"]
    assert jax_main(flags + ["--out_dir", str(tmp_path / "jax")]) == 0
    out = _run_port(flags + ["--device", "cpu", "--out_dir",
                             str(tmp_path / "port")])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    jdir = tmp_path / "jax" / "000000"
    tdir = tmp_path / "port" / "000000"
    for name in CSVS:
        j, t = _rows(jdir / name), _rows(tdir / name)
        assert t[0] == j[0], name
        assert len(t) == len(j) == 3, name
    assert _rows(tdir / "eval_3d_global.csv")[0] == [
        "", "mpjpe-ours", "mpvpe-ours", "mpjpe-glamr", "mpvpe-glamr"]
    assert "mpjpe-glamr" in _rows(tdir / "eval_3d.csv")[0]
    assert "pa_mpjpe-pare" in _rows(tdir / "eval_3d_dynamic.csv")[0]
    for name in ("eval_3d.csv", "eval_3d_global.csv"):
        for row in _rows(tdir / name)[1:]:
            assert all(math.isfinite(float(v)) for v in row[1:]), name
    final_t = [json.loads(line) for line in open(tdir / "metrics.jsonl")][-1]
    final_j = [json.loads(line) for line in open(jdir / "metrics.jsonl")][-1]
    assert sorted(final_t) == sorted(final_j)
    assert "humor_loss" in final_t and math.isfinite(final_t["humor_loss"])
    cfg_t = json.load(open(tdir / "config.json"))
    cfg_j = json.load(open(jdir / "config.json"))
    assert cfg_t["args"]["init_motion_prior"] == "init_state_prior_gmm.npz"
    assert "init_motion_prior" in cfg_j["args"]
    assert cfg_t["cfg"]["humor_fps"] == cfg_j["cfg"]["humor_fps"] == 25.0


@pytest.mark.parametrize("flag", ["--smpl_path", "--j_regressor_extra",
                                  "--vposer_path", "--gmm_path",
                                  "--humor_ckpt"])
def test_named_missing_asset_raises(tmp_path, asset_flags, flag):
    """A named file that is not there raises FileNotFoundError, even with
    --synthetic_assets: the port never fits on a stand-in for it."""
    from nemo_tpu_torch.cli.fit import main
    extra = [flag, str(tmp_path / "missing")]
    if flag == "--j_regressor_extra":
        extra = asset_flags[2:4] + extra
    with pytest.raises(FileNotFoundError):
        main(FLAGS + extra + ["--weight_humor_loss", "1", "--device", "cpu",
                              "--out_dir", str(tmp_path / "out")])


def test_cuda_device_without_a_card_raises(tmp_path):
    from nemo_tpu_torch.cli.fit import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(FLAGS + ["--out_dir", str(tmp_path)])


def _recipe_flags():
    """The flag list of run_examples/custom-video-example.sh's fit command,
    with its shell variables filled in."""
    with open(os.path.join(REPO, "run_examples",
                           "custom-video-example.sh")) as f:
        lines = f.read().splitlines()
    start = lines.index("python -m nemo_tpu.cli.fit \\") + 1
    words = []
    for line in lines[start:]:
        if line.strip() == "done":
            break
        words += line.strip().rstrip("\\").split()
    subst = {'"$EXPS/bundle.npz"': "bundle.npz", '"$CFG"': "action.yml",
             '"$DATA/out/custom-${lr_human}"': "out/custom",
             '"${lr_human}"': "1e-3",
             "configs/default-v1.yml": os.path.join(REPO, "configs",
                                                    "default-v1.yml")}
    return [subst.get(w, w) for w in words]


def test_recipe_flags_parse_and_stop_at_real_assets(tmp_path):
    """The custom-video recipe's command line passes the port's argparse
    (as it passes the JAX CLI's) and the refusals, and stops at the real
    SMPL files it names, which are not here: FileNotFoundError, never the
    synthetic body in their place."""
    import numpy as np
    from nemo_tpu.cli.fit import build_parser as jax_parser
    from nemo_tpu_torch.cli.fit import build_parser, main
    from nemo_tpu_torch.data.bundle import MultiViewBundle
    flags = _recipe_flags()
    assert "--db" in flags and "--nemo_cfg_path" in flags
    assert "--data_loader_type" in flags and "--full_batch" in flags
    jax_args = vars(jax_parser().parse_args(flags))
    args = vars(build_parser().parse_args(flags))
    assert set(jax_args) <= set(args)
    assert {k: args[k] for k in jax_args} == jax_args
    out = flags[flags.index("--out_dir") + 1]
    flags[flags.index("--out_dir") + 1] = str(tmp_path / out)
    z = lambda *s: np.zeros(s, np.float32)
    bundle = str(tmp_path / "bundle.npz")
    MultiViewBundle(labels={"gt": z(1, 4, 25, 3), "op": z(1, 4, 25, 3)},
                    hmr_theta=z(1, 4, 69), hmr_mask=z(1, 4, 1),
                    img_hw=np.array([480, 640])).save(bundle)
    flags[flags.index("--bundle") + 1] = bundle
    with pytest.raises(FileNotFoundError) as err:
        main(flags + ["--device", "cpu"])
    assert "software/smpl" in str(err.value)


V0_RATES = ["--model_version", "0", "--lr_pose", "3e-3", "--lr_orient",
            "2e-3", "--lr_trans", "4e-3"]


def test_v0_rates_reach_the_optimizer_groups():
    """--lr_pose/--lr_orient/--lr_trans give the port's NemoConfig and V0's
    pose, orient and trans optimizers the rates the JAX CLI gives its
    groups from the same command line."""
    from nemo_tpu.cli.fit import build_parser as jax_parser
    from nemo_tpu.fit import NemoConfig as JaxConfig
    from nemo_tpu.fit.optimizer import group_lrs as jax_group_lrs
    from nemo_tpu.utils import dataclass_from_namespace as jax_from_ns
    from nemo_tpu.utils import merge_config as jax_merge
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.cli.fit import build_parser
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.fit import NemoConfig, NemoFitter, build_assets
    from nemo_tpu_torch.utils.exp import (dataclass_from_namespace,
                                          merge_config)
    argv = FLAGS + V0_RATES
    cfg_j = jax_from_ns(JaxConfig, jax_merge(jax_parser(), argv))
    cfg = dataclass_from_namespace(NemoConfig, merge_config(build_parser(),
                                                            argv))
    want = {"poses": 3e-3, "orient": 2e-3, "trans": 4e-3}
    lrs_j = jax_group_lrs(cfg_j)
    assert {g: lrs_j[g] for g in want} == want
    smpl = synthetic_smpl_model(300, device="cpu")
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=8)
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import init_vposer
    fitter = NemoFitter(cfg, build_assets(
        bundle, smpl, cfg, gmm=synthetic_gmm_prior(4), vposer=init_vposer(),
        device="cpu"))
    groups = fitter.optimizer.groups
    assert {g: groups[g].lr for g in want} == want
    assert {g: groups[g].lr for g in groups} == {
        g: lrs_j[g] for g in groups}
