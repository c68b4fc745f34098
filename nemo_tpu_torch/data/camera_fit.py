"""Ground-truth camera fitting: recover world->camera extrinsics from mocap
(port of nemo_tpu/data/camera_fit.py).

Behavioral reference: VIBE/lib/data_utils/nemomocap_utils.py:111-211
(re_opt_camera_extrinsics) — optimise a 9-parameter camera (3 translation
+ 6D rotation) so the projected mocap GT 3D joints match the annotated 2D,
on a stable joint subset, with Adam at lr 1e-2 for ~3000 steps. JAX runs
the loop as one lax.scan over optax.adam; here it is a loop of eager steps
with the fit's own Adam (fit.optimizer.GroupAdam, optax's arithmetic) on
one device, which never waits for the device: the loss history is read
once, after the last step.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..fit.optimizer import GroupAdam
from ..geometry.camera import camera_from_params, perspective_projection

# Stable joints for camera fitting (OP indices: RAnkle, LAnkle, RShoulder,
# LShoulder, RHip, LHip — the reference's J_idxs selection).
DEFAULT_FIT_JOINTS = (11, 14, 2, 5, 9, 12)


def fit_gt_camera(joints3d, joints2d, img_d0: float, img_d1: float,
                  focal_length: float = 5000.0,
                  joint_idx: Sequence[int] = DEFAULT_FIT_JOINTS,
                  num_steps: int = 3000, lr: float = 1e-2,
                  init=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Fit one camera to (F, K, 3) world joints against (F, K, >=2) 2D
    points (arrays or tensors). joints2d[..., 2], where present, weights
    the residuals. Returns {'cam9': (9,), 'loss': (num_steps,)} on
    ``device`` ('cuda' by default; 'cpu' must be asked for)."""
    from .. import device_index, resolve_device
    dev = resolve_device(str(device))
    idx = device_index(joint_idx, dev)
    J3 = torch.as_tensor(joints3d, dtype=torch.float32, device=dev)[:, idx]
    J2 = torch.as_tensor(joints2d, dtype=torch.float32, device=dev)[:, idx]
    conf = J2[..., 2] if J2.shape[-1] > 2 else torch.ones(
        J2.shape[:-1], device=dev)
    target = J2[..., :2]
    if init is None:
        init = [0., 0., 2 * focal_length / img_d0, 1., 0., 0., 1., 0., 0.]
    cam9 = torch.tensor(init, dtype=torch.float32, device=dev) \
        if not torch.is_tensor(init) else \
        init.detach().to(dev, torch.float32).clone()
    cam9.requires_grad_(True)
    F = J3.shape[0]

    def loss_fn(c):
        cam = camera_from_params(c[None], img_d0, img_d1, focal_length)
        proj = perspective_projection(
            J3, cam.rotation.expand(F, 3, 3),
            cam.translation.expand(F, 3), cam.focal_length.expand(F),
            cam.center.expand(F, 2))
        return (conf[..., None] * (proj - target) ** 2).mean()

    opt = GroupAdam([cam9], lr)
    losses = []
    for _ in range(num_steps):
        loss = loss_fn(cam9)
        cam9.grad, = torch.autograd.grad(loss, cam9)
        opt.step()
        losses.append(loss.detach())
    return {"cam9": cam9.detach(),
            "loss": torch.stack(losses) if losses else
            torch.zeros(0, device=dev)}
