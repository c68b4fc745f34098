"""One main-stage step of the NeMo fit with HuMoR's dynamics term at the
cell's shapes: the operations its algorithm needs, whatever implements it.

- the main step at B rows (counts/fit_step.py);
- the term's predict at 3B rows (the window f - 1, f, f + 1 of every row):
  the MotionNet's trunk and heads at 6 (3B) m n (forward, the input's and
  the weight's gradients) and SMPL's kinematic chain for the joints, K1's
  forward and backward (counts/k1.py) at 3B rows;
- HuMoR's posterior encoder and conditional prior, frozen, over the B
  transitions at 4 B m n (forward and the input's gradient).
Elementwise work (the states, GroupNorm, the KL) is left out."""

from portbench.harness.readers import load_module


def step(shapes: dict) -> dict:
    B, H = shapes["B"], shapes["H"]
    k1 = load_module("counts", "k1")
    flops = load_module("counts", "fit_step").step(shapes)["flops"]
    d_in = shapes["K"] + shapes["C"]
    flops += 6 * 3 * B * (d_in * H + 2 * H * H + H * 144 + H * 3)
    wide = {**shapes, "B": 3 * B}
    flops += k1.launch(wide)["flops"] + k1.launch(wide, backward=True)[
        "flops"]
    D, L = shapes["humor_state"], shapes["humor_latent"]
    for widths in ([2 * D] + shapes["humor_encoder"] + [2 * L],
                   [D] + shapes["humor_prior"] + [2 * L]):
        flops += 4 * B * sum(m * n for m, n in zip(widths[:-1], widths[1:]))
    return {"flops": flops}
