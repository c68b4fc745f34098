"""The custom-video main stage with HuMoR's dynamics prior
(``--weight_humor_loss``): fit_main's set-up, window and hand-off, with
HuMoR's weights among the program's assets and the reference's step.

Set-up draws HuMoR's posterior encoder and conditional prior at the
configuration's widths from the seed on the device (linear layers as
torch.nn.Linear draws them, GroupNorm's gamma and beta away from 1 and 0),
then runs fit_main's set-up, whose ``build_assets`` call is handed them
(``humor=``, ``humor_cfg=``): the program reaches the term through
``NemoFitter.fit`` -> ``fit_loss`` -> ``humor_dynamics_loss``, its normal
path. The reference is reference/nemo_fit_humor.py. ``readings`` adds two
planted faults to fit_main's: the term left out of the program (the
reference without it in the program's place) and a state left unchanged
(the starting parameters as the program's last).
"""

from __future__ import annotations

import math

import torch

from portbench.drivers import fit_main
from portbench.harness.compare import AsProgram, compare
from portbench.reference import nemo_fit, nemo_fit_humor

REF_STEPS = fit_main.REF_STEPS


def humor_weights(gen: torch.Generator, device, hcfg: dict) -> dict:
    """{"encoder", "prior"}: HuMoR's MLPs (w<i> (in, out), b<i>, gn<i>_g,
    gn<i>_b before linear i) at the configuration's widths: the encoder
    reads (x_{t-1}, x_t), the prior x_{t-1}, each ends in a latent's mean
    and log-variance."""
    D, L = hcfg["state_dim"], hcfg["latent_size"]

    def mlp(widths):
        p = {}
        for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            s = 1.0 / math.sqrt(n_in)
            p[f"w{i}"] = (torch.rand((n_in, n_out), generator=gen,
                                     device=device) * 2 - 1) * s
            p[f"b{i}"] = (torch.rand((n_out,), generator=gen,
                                     device=device) * 2 - 1) * s
            if i > 0:
                p[f"gn{i}_g"] = 0.5 + torch.rand((n_in,), generator=gen,
                                                 device=device)
                p[f"gn{i}_b"] = 0.2 * torch.randn((n_in,), generator=gen,
                                                  device=device)
        return p
    return {"encoder": mlp([2 * D] + hcfg["encoder_widths"] + [2 * L]),
            "prior": mlp([D] + hcfg["prior_widths"] + [2 * L])}


class Driver(fit_main.Driver):

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict):
        import nemo_tpu_torch.fit as fit
        from nemo_tpu_torch.models.humor import HumorConfig
        device = torch.device(device)
        hcfg = config["humor"]
        gen = torch.Generator(device=device).manual_seed(
            (2 * seed + 1) % 2 ** 63)
        self.humor = humor_weights(gen, device, hcfg)
        humor_cfg = HumorConfig(latent_size=hcfg["latent_size"],
                                conditional_prior=hcfg["conditional_prior"],
                                num_groups=hcfg["num_groups"])
        build = fit.build_assets

        def with_humor(*args, **kw):
            return build(*args, humor=self.humor, humor_cfg=humor_cfg, **kw)
        fit.build_assets = with_humor
        try:
            super().__init__(config, traffic, seed, device, limits)
        finally:
            fit.build_assets = build

    @property
    def shapes(self) -> dict:
        h = self.config["humor"]
        return {**super().shapes, "humor_rows": self.rows,
                "humor_state": h["state_dim"],
                "humor_latent": h["latent_size"],
                "humor_encoder": h["encoder_widths"],
                "humor_prior": h["prior_widths"],
                "humor_width": h["encoder_widths"][0],
                "humor_groups": h["num_groups"]}

    def reference(self, tf32: bool = False, half: bool = False,
                  humor: bool = True) -> dict:
        """The reference's REF_STEPS steps from the run's inputs; tf32 and
        half plant the control and the half-batch fault in it, humor=False
        leaves the dynamics term out."""
        raw = self.raw
        priors = nemo_fit.Priors(raw["vposer"], raw["gmm"]["means"],
                                 raw["gmm"]["covars"], raw["gmm"]["weights"])
        if not humor:
            return nemo_fit.run_steps(self.init, self.problem, self.body,
                                      priors, self.config["nemo"], REF_STEPS,
                                      tf32=tf32, half=half)
        return nemo_fit_humor.run_steps(
            self.init, self.problem, self.body, priors, self.humor,
            self.config["nemo"], self.config["humor"], REF_STEPS, tf32=tf32,
            half=half)

    def readings(self) -> dict:
        """The compared numbers of the program, of the control and of each
        planted fault (the half batch, the term left out, the state left
        unchanged), each against the float32 reference; and the leaves that
        set the program's worst-leaf gaps. The program's state is freed
        first."""
        self.release()
        ref = self.reference()
        info = {}
        out = {"program": compare(self, ref, self.limits, info)}
        for kind, kw in (("control_tf32", {"tf32": True}),
                         ("fault_half_batch", {"half": True}),
                         ("fault_no_humor", {"humor": False})):
            out[kind] = compare(AsProgram(self.init, self.reference(**kw)),
                                ref, self.limits)
        out["fault_unchanged"] = compare(
            AsProgram(self.init, {**ref, "params": self.init}), ref,
            self.limits)
        out["leaves"] = [(k, v, None) for k, v in info.items()]
        return out
