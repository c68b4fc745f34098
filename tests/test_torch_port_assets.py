"""The port's asset loaders against nemo_tpu's, on files in the real layouts.

No licensed file is needed: ``nemo_tpu_torch.utils.asset_files`` writes the
synthetic objects in the layouts of the real SMPL pickle (chumpy arrays, a
scipy sparse ``J_regressor``, uint32 ``kintree_table`` and faces), the smplx
.npz, the V02_05 VPoser snapshot directory, the SPIN gmm_08.pkl and the
HuMoR checkpoint. Each file goes through both packages' loaders: the SMPL,
VPoser and HuMoR arrays must be equal bit for bit (to each other and to the
objects written), the GMM's precisions and weights within 1e-6 relative.
"""

import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from nemo_tpu.body import assets as jassets
from nemo_tpu.cli import humor_tool as jhumor_tool
from nemo_tpu.models import humor as jhumor
from nemo_tpu.priors import gmm as jgmm
from nemo_tpu.priors import vposer as jvposer
from nemo_tpu_torch.body import assets as tassets
from nemo_tpu_torch.body.smpl import _TENSOR_FIELDS
from nemo_tpu_torch.cli import humor_tool as thumor_tool
from nemo_tpu_torch.models import humor as thumor
from nemo_tpu_torch.priors import gmm as tgmm
from nemo_tpu_torch.priors import vposer as tvposer
from nemo_tpu_torch.utils import asset_files

torch.set_num_threads(1)
ARRAY_FIELDS = ("parents", "vertex_joint_ids", "joint_map", "faces")


def assert_same_smpl(got, want):
    """Every SMPLModel field bit-identical (tensors, index arrays, faces)."""
    for f in _TENSOR_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == torch.float32, f
        assert torch.equal(a, b), f
    for f in ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.int64, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def body():
    return tassets.synthetic_smpl_model(150, seed=0, device="cpu")


def _write(directory, model, fmt, name=None, shapedirs=None):
    arrays = asset_files.smpl_file_arrays(model)
    if shapedirs is not None:
        arrays["shapedirs"] = shapedirs
    path = os.path.join(directory, name or f"SMPL_NEUTRAL.{fmt}")
    write = asset_files.write_smpl_pkl if fmt == "pkl" else \
        asset_files.write_smpl_npz
    return write(path, arrays)


def _jre(directory, model):
    path = os.path.join(directory, "J_regressor_extra.npy")
    np.save(path, model.J_regressor_extra.numpy())
    return path


@pytest.mark.parametrize("fmt", ["pkl", "npz"])
def test_smpl_file_matches_source_and_jax(tmp_path, body, fmt):
    path = _write(str(tmp_path), body, fmt)
    jre = _jre(str(tmp_path), body)
    load = {"pkl": tassets.load_smpl_pkl, "npz": tassets.load_smpl_npz}[fmt]
    got = load(path, jre, device="cpu")
    assert_same_smpl(got, body)
    jload = {"pkl": jassets.load_smpl_pkl, "npz": jassets.load_smpl_npz}[fmt]
    assert_same_smpl(got, tassets.smpl_from_numpy(jload(path, jre)))
    assert got.parents[0] == -1


def test_smpl_pickle_is_chumpy_layout(tmp_path, body):
    """The written pickle needs the tolerant unpickler: plain pickle cannot
    find chumpy, and the writer leaves no chumpy module behind."""
    import pickle
    path = _write(str(tmp_path), body, "pkl")
    assert "chumpy" not in sys.modules and "chumpy.ch" not in sys.modules
    with open(path, "rb") as f:
        with pytest.raises(ModuleNotFoundError, match="chumpy"):
            pickle.load(f, encoding="latin1")
    with open(path, "rb") as f:
        data = tassets._TolerantUnpickler(f, encoding="latin1").load()
    assert type(data["J_regressor"]).__name__ == "csc_matrix"
    assert data["kintree_table"].dtype == np.uint32
    assert data["kintree_table"][0, 0] == 4294967295
    assert data["f"].dtype == np.uint32
    stub = data["v_template"]
    assert isinstance(stub, tassets._ChumpyStub)
    np.testing.assert_array_equal(np.asarray(stub, np.float64, copy=True),
                                  body.v_template.numpy())


def test_shapedirs_cut_to_num_betas(tmp_path, body):
    """A 300-beta shapedirs (SMPL 1.1) is cut to its first 10 columns."""
    rng = np.random.default_rng(0)
    wide = np.concatenate([body.shapedirs.numpy(), rng.standard_normal(
        (150, 3, 290)).astype(np.float32)], -1)
    path = _write(str(tmp_path), body, "pkl", shapedirs=wide)
    jre = _jre(str(tmp_path), body)
    got = tassets.load_smpl(path, jre, device="cpu")
    assert got.shapedirs.shape == (150, 3, 10)
    assert_same_smpl(got, body)
    assert_same_smpl(got, tassets.smpl_from_numpy(jassets.load_smpl(path,
                                                                     jre)))


def test_smpl_full_size_pickle(tmp_path):
    """The 6890-vertex body through the pickle, without J_regressor_extra
    (its rows are then zero, as in the JAX package)."""
    body = tassets.synthetic_smpl_model(6890, seed=0, device="cpu")
    path = _write(str(tmp_path), body, "pkl")
    got = tassets.load_smpl(str(tmp_path), device="cpu")
    assert_same_smpl(got, tassets.smpl_from_numpy(jassets.load_smpl(path)))
    assert not got.J_regressor_extra.any()
    for f in ("v_template", "J_regressor", "posedirs_t", "lbs_weights_t"):
        assert torch.equal(getattr(got, f), getattr(body, f)), f


def test_directory_prefers_the_pickle(tmp_path, body):
    """SMPL_NEUTRAL.pkl wins over SMPL_NEUTRAL.npz, which wins over the
    basicmodel names; both packages pick the same file."""
    other = tassets.synthetic_smpl_model(150, seed=1, device="cpu")
    d = str(tmp_path / "smpl")
    os.makedirs(d)
    jre = {"body": _jre(str(tmp_path), body),
           "other": str(tmp_path / "other_jre.npy")}
    np.save(jre["other"], other.J_regressor_extra.numpy())
    _write(d, other, "pkl", name="basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl")
    assert_same_smpl(tassets.load_smpl(d, jre["other"], device="cpu"), other)
    _write(d, body, "npz")
    assert_same_smpl(tassets.load_smpl(d, jre["body"], device="cpu"), body)
    _write(d, other, "pkl")
    got = tassets.load_smpl(d, jre["other"], device="cpu")
    assert_same_smpl(got, other)
    assert_same_smpl(got, tassets.smpl_from_numpy(jassets.load_smpl(
        d, jre["other"])))


def test_missing_smpl_raises(tmp_path):
    for load in (tassets.load_smpl, jassets.load_smpl):
        with pytest.raises(FileNotFoundError, match="no SMPL model file"):
            load(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tassets.load_smpl(str(tmp_path / "SMPL_NEUTRAL.pkl"))
    with pytest.raises(FileNotFoundError):
        tassets.load_smpl(str(tmp_path / "model.npz"))


def test_chumpy_stub_takes_numpy2_copy_keyword():
    stub = tassets._ChumpyStub()
    stub.__setstate__({"x": np.arange(3.0)})
    assert stub.__array__(np.float32, copy=True).dtype == np.float32
    np.testing.assert_array_equal(np.asarray(stub), np.arange(3.0))


@pytest.mark.parametrize("prefix", ["vp_model.", ""])
def test_vposer_snapshot_directory(tmp_path, prefix):
    """The last snapshot in sorted order wins; every array equals the
    written weights and nemo_tpu's load_vposer; encode and decode agree
    with JAX within 1e-5."""
    gen = torch.Generator().manual_seed(3)
    old = tvposer.init_vposer(generator=gen)
    new = tvposer.init_vposer(generator=gen)
    d = str(tmp_path / "V02_05")
    asset_files.write_vposer_snapshot(d, old, name="a_epoch=01.ckpt",
                                      prefix=prefix)
    asset_files.write_vposer_snapshot(d, new, name="b_epoch=13.ckpt",
                                      prefix=prefix)
    got = tvposer.load_vposer(d, device="cpu")
    jp = jvposer.load_vposer(d)
    assert sorted(got) == sorted(new) == sorted(jp)
    for k in new:
        assert torch.equal(got[k], new[k]), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jp[k]))
    rng = np.random.default_rng(0)
    pose = (0.3 * rng.standard_normal((6, 63))).astype(np.float32)
    mu, scale = tvposer.vposer_encode(got, torch.tensor(pose))
    jmu, jscale = jvposer.vposer_encode(jp, pose)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), atol=1e-5)
    dec = tvposer.vposer_decode(got, mu)
    jdec = jvposer.vposer_decode(jp, jmu)
    for k in jdec:
        np.testing.assert_allclose(dec[k].numpy(), np.asarray(jdec[k]),
                                   atol=1e-5, err_msg=k)


def test_vposer_missing_snapshots_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no snapshots"):
        tvposer.load_vposer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tvposer.load_vposer(str(tmp_path / "V02_05.ckpt"))


@pytest.mark.parametrize("layout", ["dict", "attributes"])
def test_gmm_pickle(tmp_path, layout):
    """A dict pickle and an sklearn-style object's: the same prior as the
    in-memory synthetic one and as nemo_tpu's loader."""
    means, covs, weights = tgmm.synthetic_gmm_arrays(8)
    path = str(tmp_path / "gmm_08.pkl")
    if layout == "dict":
        asset_files.write_gmm_pkl(path, means, covs, weights)
    else:
        import pickle
        with open(path, "wb") as f:
            pickle.dump(types.SimpleNamespace(
                means_=means, covars_=covs, weights_=weights), f, protocol=2)
    got = tgmm.load_gmm_prior(path, device="cpu")
    want = tgmm.synthetic_gmm_prior(8)
    for f in ("means", "precisions", "nll_weights"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    jp = jgmm.load_gmm_prior(path)
    np.testing.assert_array_equal(got.means.numpy(), np.asarray(jp.means))
    np.testing.assert_allclose(got.precisions.numpy(),
                               np.asarray(jp.precisions), rtol=1e-6)
    np.testing.assert_allclose(got.nll_weights.numpy(),
                               np.asarray(jp.nll_weights), rtol=1e-6)
    pose = (0.3 * np.random.default_rng(1).standard_normal(
        (5, 69))).astype(np.float32)
    np.testing.assert_allclose(
        tgmm.gmm_log_likelihood(got, torch.tensor(pose)).numpy(),
        np.asarray(jgmm.gmm_log_likelihood(jp, pose)), rtol=1e-5)


@pytest.fixture(scope="module")
def humor_params():
    cfg = thumor.HumorConfig(latent_size=8)
    return cfg, thumor.init_humor(torch.Generator().manual_seed(0), cfg)


def _same_humor(got, want):
    assert sorted(got) == sorted(want)
    for m in want:
        assert sorted(got[m]) == sorted(want[m]), m
        for k in want[m]:
            a = got[m][k]
            b = want[m][k]
            b = b if torch.is_tensor(b) else torch.tensor(np.asarray(b))
            assert a.dtype == torch.float32 and torch.equal(a, b), (m, k)


@pytest.mark.parametrize("prefix", ["module.", ""])
def test_humor_checkpoint(tmp_path, humor_params, prefix):
    """{'model': state_dict}, with and without DataParallel's prefix: the
    written weights back, bit for bit, as nemo_tpu's load_humor gives."""
    cfg, params = humor_params
    path = asset_files.write_humor_ckpt(str(tmp_path / "humor.pth"), params,
                                        prefix)
    got = thumor.load_humor(path, cfg, device="cpu")
    _same_humor(got, params)
    jcfg = jhumor.HumorConfig(latent_size=8)
    _same_humor(got, jhumor.load_humor(path, jcfg))
    _same_humor(thumor_tool._humor_params(path, cfg, 0, "cpu"), params)
    _same_humor(got, jhumor_tool._load_humor_params(path, jcfg, None))


def test_humor_tool_npz_and_random_weights(tmp_path, humor_params):
    """humor_tool's flat .npz layout as the JAX CLI reads it; an empty path
    gives init_humor's weights from the seed."""
    cfg, params = humor_params
    path = asset_files.write_humor_npz(str(tmp_path / "humor.npz"), params)
    got = thumor_tool._humor_params(path, cfg, 0, "cpu")
    _same_humor(got, params)
    _same_humor(got, jhumor_tool._load_humor_params(
        path, jhumor.HumorConfig(latent_size=8), jax.random.PRNGKey(0)))
    _same_humor(thumor_tool._humor_params("", cfg, 0, "cpu"), params)
    with pytest.raises(FileNotFoundError):
        thumor_tool._humor_params(str(tmp_path / "none.pth"), cfg, 0, "cpu")
