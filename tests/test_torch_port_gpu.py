"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so these tests skip on a machine without a
GPU. Run them on one (the repository's conftest imports jax, which the GPU
machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_port_gpu.py

Shapes are small and ragged (B and V not multiples of the kernels' tiles)
so the edge masking is exercised; chip_smoke.py checks the full-width shapes.
"""

import numpy as np
import pytest
import torch

from nemo_tpu_torch.body.constants import SMPL_PARENTS
from nemo_tpu_torch.ops import fk, lbs, launch_counts, reset_launches

pytestmark = pytest.mark.gpu
PARENTS = tuple(int(p) for p in SMPL_PARENTS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rot(gen, B, J):
    from nemo_tpu_torch.geometry.rotations import batch_rodrigues
    return batch_rodrigues(0.7 * torch.randn((B, J, 3), generator=gen))


@pytest.mark.parametrize("B", [1, 37, 300])
def test_fk_kernels_match_plain(cuda, B):
    gen = torch.Generator().manual_seed(B)
    R = _rot(gen, B, 24).to(cuda)
    t = torch.randn((B, 24, 3), generator=gen).to(cuda)
    gR = torch.randn((B, 24, 3, 3), generator=gen).to(cuda)
    gt = torch.randn((B, 24, 3), generator=gen).to(cuda)
    Rk, tk = fk.fk_fwd_cuda(R, t, PARENTS)
    Rp, tp = fk.fk_fwd_plain(R, t, PARENTS)
    torch.testing.assert_close(Rk, Rp, atol=1e-5, rtol=0)
    torch.testing.assert_close(tk, tp, atol=1e-5, rtol=0)
    gRk, gtk = fk.fk_bwd_cuda(R, t, Rk, gR, gt, PARENTS)
    gRp, gtp = fk.fk_bwd_plain(R, t, Rp, gR, gt, PARENTS)
    torch.testing.assert_close(gRk, gRp, atol=1e-4, rtol=0)
    torch.testing.assert_close(gtk, gtp, atol=1e-4, rtol=0)


@pytest.mark.parametrize("B,V", [(1, 5), (37, 300), (70, 1000)])
def test_v2v_kernel_matches_plain(cuda, B, V):
    gen = torch.Generator().manual_seed(V)
    f = lambda *s: torch.randn(s, generator=gen)
    pf_o, pf_r = 0.1 * f(B, 207), 0.1 * f(B, 207)
    A_o, A_r = f(B, 24, 12), f(B, 24, 12)
    A_r.view(B, 24, 3, 4)[..., 3] += 10.0 * torch.sign(f(B, 1, 3))
    W = torch.rand((24, V), generator=gen)
    W = W / W.sum(0, keepdim=True)
    args = [x.to(cuda).contiguous() for x in
            (pf_o, A_o, f(3, V), 0.01 * f(207, 3, V), W, pf_r, A_r)]
    tot_k, gk = lbs.v2v_l1_cuda(*args, grad=True)
    tot_p, gp = lbs.v2v_l1_plain(*args, grad=True)
    tot_f, none = lbs.v2v_l1_cuda(*args, grad=False)
    assert none is None
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-5, atol=0)
    assert torch.equal(tot_f, tot_k)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def _tiny_fitter(cuda):
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.fit import NemoConfig, NemoFitter, build_assets
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import init_vposer
    cfg = NemoConfig(model_version=2, h_dim=32, instance_code_size=4,
                     phase_rbf_dim=8, rbf_kernel="quadratic",
                     monotonic_network_n_nodes=4, batch_size=16,
                     weight_vp_loss=10.0, weight_vp_z_loss=1.0,
                     label_type="gt")
    smpl = synthetic_smpl_model(300, device=cuda)
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=12)
    assets = build_assets(bundle, smpl, cfg, gmm=synthetic_gmm_prior(4),
                          vposer=init_vposer(), device=cuda)
    return NemoFitter(cfg, assets)


def test_fit_steps_launch_every_kernel(cuda):
    fitter = _tiny_fitter(cuda)
    reset_launches()
    fitter.warmup(2)
    fitter.opt_cam(2)
    m = fitter.fit(3, chunk=3)
    fitter.eval_loss()
    counts = launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    assert np.isfinite(m["total_loss"]).all()


def test_stage_steps_never_synchronise(cuda):
    """No step of any stage waits for the device (no .item(), no host
    copies, no host-built index tensors)."""
    from nemo_tpu_torch.fit.optimizer import make_camera_stage_optimizer
    fitter = _tiny_fitter(cuda)
    cam_opt = make_camera_stage_optimizer(fitter.params, fitter.cfg)
    steps = (lambda: fitter.warmup_step(0),
             lambda: fitter.camera_step(cam_opt), fitter.main_step)
    for step in steps:      # first calls build the cached index tensors
        step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in steps:
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
