"""One main-stage step of the NeMo fit at the cell's shapes: the
operations its algorithm needs, whatever implements it.

- the v2v prior: one K2 launch's work (counts/k2.py), both meshes and the
  gradient of the predicted one;
- SPIN's 49 joints by the fused joint tables: the pose features (207)
  against the 30 extra joints' 24 x 3 tables, and the blend of the 24
  transforms into them, forward and the gradient of the pose features;
- forward kinematics: K1's forward for the joints and both v2v sides, its
  backward for the joints and the original side (counts/k1.py);
- every trained dense layer (the MotionNet's trunk and heads) at 6 B m n:
  the forward, the input's and the weight's gradients;
- VPoser, frozen: its encoder at 4 B m n (forward and the input's
  gradient), its decoder, whose reconstruction is detached, at 2 B m n;
- the GMM's 8 quadratic forms over 69 dimensions, forward and gradient.
Elementwise work (rotations, losses, Adam) is left out."""

from portbench.harness.readers import load_module


def step(shapes: dict) -> dict:
    B, H = shapes["B"], shapes["H"]
    k1, k2 = load_module("counts", "k1"), load_module("counts", "k2")
    n, z = shapes["vposer_neurons"], shapes["vposer_latent"]
    flops = k2.launch(shapes)["flops"]
    flops += 3 * k1.launch(shapes)["flops"] \
        + 2 * k1.launch(shapes, backward=True)["flops"]
    flops += 2 * 2 * B * 207 * 30 * 24 * 3 + 2 * 2 * B * 30 * 24 * 12
    d_in = shapes["K"] + shapes["C"]
    flops += 6 * B * (d_in * H + 2 * H * H + H * 144 + H * 3)
    flops += 4 * B * (63 * n + 2 * n * n + 2 * n * z)
    flops += 2 * B * (z * n + n * n + n * 126)
    flops += 3 * 2 * B * shapes["gmm_components"] * 69 * 69
    return {"flops": flops}
