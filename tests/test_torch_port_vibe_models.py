"""The VIBE demo's networks against nemo_tpu on the CPU: ResNet-50, the
SPIN regressor, the GRU temporal encoder, vibe_forward and hmr_forward,
and a SPIN checkpoint written by the port read by both packages.

The weights are drawn by the port's initializers (the backbone's batch
norms calibrated, see ``nets``) and read into JAX's layout by JAX's own
converters; the port's modules come back from those pytrees through
``resnet50_from_jax``/``hmr_head_from_jax``/``gru_from_jax``. The
networks run at full width (ResNet-50 to 2048 features, the 2048 GRU, the
3-iteration regressor) on 64 x 64 crops; SMPL is the 150-vertex synthetic
body. JAX's networks are compiled once for the module (``jax_out``: the
features, vibe_forward and hmr_forward in one jit). Tolerance: 1e-4 of
each output's largest entry — float32 layers in another summation order
(oneDNN against XLA) through 53 convolutions and a 2048-wide GRU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.models import hmr as jhmr
from nemo_tpu.models import resnet as jresnet
from nemo_tpu.models import vibe as jvibe
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.models import hmr as thmr
from nemo_tpu_torch.models import resnet as tresnet
from nemo_tpu_torch.models import vibe as tvibe
from nemo_tpu_torch.utils import asset_files as af

RTOL = 1e-4
T = 6


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


@pytest.fixture(scope="module")
def crops():
    rng = np.random.RandomState(1)
    return rng.randn(1, T, 64, 64, 3).astype(np.float32)


@pytest.fixture(scope="module")
def nets(crops):
    """(JAX params (backbone, head, gru), the port's modules, bodies).

    The backbone is the port's He-init draw with its batch norms
    calibrated on the test crops (asset_files.calibrate_batch_norm:
    running statistics equal to each layer's input statistics, as a
    trained network's are). Raw, the draw's features reach ~2e3, the
    regressor's camera scale goes negative and kp_2d divides by depths
    near zero, where the 1e-7 relative differences of two float32
    backbones grow to 1e-3. JAX reads the three modules' state dicts with
    convert_torch_hmr (convert_torch_resnet50 inside) / convert_torch_gru."""
    backbone = tresnet.init_resnet50(torch.Generator().manual_seed(0))
    af.calibrate_batch_norm(backbone, torch.from_numpy(
        crops[0]).permute(0, 3, 1, 2))
    sd = af.spin_state_dict(
        backbone, thmr.init_hmr_head(torch.Generator().manual_seed(1)),
        tvibe.init_gru(torch.Generator().manual_seed(2)))
    jb, head = jhmr.convert_torch_hmr(sd)
    head = {k: np.asarray(v) for k, v in head.items()}
    gru = {k: np.asarray(v) for k, v in jvibe.convert_torch_gru(sd).items()}
    jsmpl = jax_synthetic_smpl(num_vertices=150, seed=0)
    ported = (tresnet.resnet50_from_jax(jb),
              thmr.hmr_head_from_jax(head), tvibe.gru_from_jax(gru))
    return ((jb, jax.tree.map(jnp.asarray, head),
             jax.tree.map(jnp.asarray, gru)),
            ported, (jsmpl, smpl_from_numpy(jsmpl)))


@pytest.fixture(scope="module")
def jax_out(nets, crops):
    """JAX's resnet50_features, vibe_forward and hmr_forward on the crops,
    compiled together once."""
    (jb, jh, jg), _, (jsmpl, _) = nets

    def run(x):
        return {"features": jresnet.resnet50_features(jb, x[0]),
                "vibe_forward": jvibe.vibe_forward(jb, jg, jh, jsmpl, x),
                "hmr_forward": jhmr.hmr_forward(jb, jh, jsmpl, x[0])}
    return jax.jit(run)(jnp.asarray(crops))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_resnet50_features(nets, crops, jax_out):
    _, (tb, _, _), _ = nets
    x = crops[0]
    want = jax_out["features"]
    with torch.no_grad():
        got = tb(_nchw(x))
    _close(got, want, what="features")
    # batch norm reads its running statistics in either module mode
    tb.train()
    try:
        with torch.no_grad():
            _close(tb(_nchw(x)), want, what="features in train mode")
    finally:
        tb.eval()


def test_hmr_head(nets):
    (_, jh, _), (_, th, _), _ = nets
    feats = np.random.RandomState(2).randn(5, 2048).astype(np.float32)
    want = jhmr.hmr_head(jh, jnp.asarray(feats))
    with torch.no_grad():
        got = th(torch.from_numpy(feats))
    for name, g, w in zip(("pose6d", "shape", "cam"), got, want):
        _close(g, w, what=name)


def test_temporal_encoder(nets):
    (_, _, jg), (_, _, tg), _ = nets
    feats = np.random.RandomState(3).randn(2, T, 2048).astype(np.float32)
    want = jvibe.temporal_encoder(jg, jnp.asarray(feats))
    with torch.no_grad():
        got = tg(torch.from_numpy(feats))
    _close(got, want, what="GRU + residual")


@pytest.mark.parametrize("fn", ["vibe_forward", "hmr_forward"])
def test_forward(nets, crops, jax_out, fn):
    _, (tb, th, tg), (_, tsmpl) = nets
    want = jax_out[fn]
    with torch.no_grad():
        if fn == "vibe_forward":
            got = tvibe.vibe_forward(tb, tg, th, tsmpl, torch.from_numpy(
                crops).permute(0, 1, 4, 2, 3))
        else:
            got = thmr.hmr_forward(tb, th, tsmpl, _nchw(crops[0]))
    for k in ("theta", "kp_2d", "kp_3d", "verts"):
        _close(got[k], want[k], what=f"{fn} {k}")


def test_weak_and_spin_projection():
    rng = np.random.RandomState(4)
    joints = rng.randn(4, 49, 3).astype(np.float32)
    joints[..., 2] += 0.5
    cam = (np.abs(rng.randn(4, 3)) + 0.5).astype(np.float32)
    for name in ("weak_perspective_projection", "spin_projection"):
        want = getattr(jhmr, name)(jnp.asarray(joints), jnp.asarray(cam))
        got = getattr(thmr, name)(torch.from_numpy(joints),
                                  torch.from_numpy(cam))
        _close(got, want, rtol=1e-6, what=name)
    img = rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    _close(thmr.imagenet_normalize(torch.from_numpy(img)),
           jhmr.imagenet_normalize(jnp.asarray(img)), rtol=1e-6,
           what="imagenet_normalize")


@pytest.mark.parametrize("with_gru", [True, False])
def test_spin_checkpoint(nets, tmp_path, with_gru, capsys):
    """A checkpoint written by write_spin_ckpt: JAX's convert_torch_hmr /
    convert_torch_gru read back the very arrays the port's modules hold,
    and the port's loader gives modules with equal state and equal
    outputs. Without encoder.gru.* the loader draws its seeded untrained
    GRU and says so."""
    (jb, jh, jg), (tb, th, tg), _ = nets
    path = af.write_spin_ckpt(str(tmp_path / "spin_model.pth.tar"), tb, th,
                              tg if with_gru else None)
    sd = torch.load(path, map_location="cpu", weights_only=False)["model"]
    assert "layer4.2.bn3.num_batches_tracked" in sd
    backbone, head = jhmr.convert_torch_hmr(sd)
    for tree, want in ((backbone, jb), (head, jh)):
        assert sorted(tree) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(tree[k]),
                                          np.asarray(want[k]), err_msg=k)
    lb, lh, lg = thmr.load_spin_checkpoint(path)
    for got, want in ((lb, tb), (lh, th)):
        for k, v in want.state_dict().items():
            torch.testing.assert_close(got.state_dict()[k], v, rtol=0,
                                       atol=0)
    if with_gru:
        gru = jvibe.convert_torch_gru(sd)
        for k in jg:
            np.testing.assert_array_equal(np.asarray(gru[k]),
                                          np.asarray(jg[k]), err_msg=k)
        for k, v in tg.state_dict().items():
            torch.testing.assert_close(lg.state_dict()[k], v, rtol=0, atol=0)
    else:
        with pytest.raises(KeyError):
            jvibe.convert_torch_gru(sd)
        assert "no encoder.gru.* weights" in capsys.readouterr().out
        seeded = tvibe.init_gru(torch.Generator().manual_seed(thmr.GRU_SEED))
        for k, v in seeded.state_dict().items():
            torch.testing.assert_close(lg.state_dict()[k], v, rtol=0, atol=0)
    feats = np.random.RandomState(5).randn(3, 2048).astype(np.float32)
    want = jhmr.hmr_head(head, jnp.asarray(feats))
    with torch.no_grad():
        got = lh(torch.from_numpy(feats))
    for name, g, w in zip(("pose6d", "shape", "cam"), got, want):
        _close(g, w, what=f"loaded head {name}")
