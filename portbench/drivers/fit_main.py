"""The custom-video recipe's main stage: set-up, the timed window and the
hand-off to the reference.

Set-up makes the body, VPoser, the GMM, the action and the starting
parameters from the seed on the device, gives them to the program through
its own loaders (body/assets.assemble, priors/gmm.load_gmm_prior on a
gmm_08.pkl written under TMPDIR, data.bundle.MultiViewBundle,
fit.build_assets) and builds one NemoFitter. The fitter's first three
main steps, through ``NemoFitter.fit`` as the window calls it, are the
ones the reference follows: their losses, the first gradient as Adam took
it (its first moment after one step over 1 - beta1) and the parameters
after the third step are kept. Those steps warm every kernel and shape
that the window runs: a chunk of the window's size differs only in how
many step metrics it stacks. The window runs chunks of ``chunk`` main
steps through ``NemoFitter.fit``, each ending with the fit's own host
copy of its metrics, until ``seconds`` have passed. ``parts`` keeps the
seconds of each part of set-up.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch

from portbench.harness.cell import sync
from portbench.harness.compare import compare, readings
from portbench.inputs.body import gmm_arrays, smpl_arrays, vposer_weights
from portbench.inputs.motion import init_params, make_action
from portbench.reference import nemo_fit
from portbench.reference.body import Body

REF_STEPS = 3


class Driver:
    rate_metric = "fit_steps_per_s"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict):
        t = time.perf_counter()
        from nemo_tpu_torch.body.assets import assemble
        from nemo_tpu_torch.data.bundle import MultiViewBundle
        from nemo_tpu_torch.fit import NemoConfig, NemoFitter, build_assets
        from nemo_tpu_torch.ops import _build
        from nemo_tpu_torch.priors.gmm import load_gmm_prior

        self.parts = {}

        def part(name):
            nonlocal t
            sync(device)
            now = time.perf_counter()
            self.parts[name] = now - t
            t = now

        part("import_program")
        self.device = device = torch.device(device)
        self.config, self.traffic, self.limits = config, traffic, limits
        self.chunk = traffic["chunk"]
        cfg = dict(config["nemo"])
        gen = torch.Generator(device=device).manual_seed(seed)
        b = config["body"]
        self.raw = {
            "smpl": smpl_arrays(gen, device, b["num_vertices"],
                                b["num_betas"]),
            "vposer": vposer_weights(gen, device,
                                     config["vposer"]["num_neurons"],
                                     config["vposer"]["latent_dim"]),
            "gmm": gmm_arrays(gen, device, config["gmm"]["num_gaussians"])}
        s = self.raw["smpl"]
        self.body = Body(s["v_template"], s["shapedirs"], s["posedirs"],
                         s["J_regressor"], s["weights"],
                         s["J_regressor_extra"])
        self.problem = make_action(gen, self.body, traffic)
        d0 = self.problem["img_hw"][0]
        self.init = init_params(gen, cfg, traffic["instances"], d0, device)
        part("inputs")

        # the program, through its loaders
        npy = {k: v.cpu().numpy() for k, v in s.items()}
        smpl = assemble(npy["v_template"], npy["shapedirs"], npy["posedirs"],
                        npy["J_regressor"], npy["weights"], npy["parents"],
                        None, npy["J_regressor_extra"], b["num_betas"],
                        device=device)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "gmm_08.pkl")
            with open(path, "wb") as f:
                pickle.dump({k: v.cpu().numpy()
                             for k, v in self.raw["gmm"].items()}, f)
            gmm = load_gmm_prior(path, device=device)
        p = {k: v.cpu().numpy() for k, v in self.problem.items()
             if k != "img_hw"}
        bundle = MultiViewBundle(labels={cfg["label_type"]: p["labels"]},
                                 hmr_theta=p["hmr_theta"],
                                 hmr_mask=p["hmr_mask"],
                                 img_hw=np.asarray(self.problem["img_hw"],
                                                   np.float32))
        self.cfg = NemoConfig(**cfg)
        assets = build_assets(bundle, smpl, self.cfg, gmm=gmm,
                              vposer=self.raw["vposer"], device=device,
                              v2v_vjp=config["v2v_vjp"],
                              motion_mlp=config["motion_mlp"],
                              net_precision=config["net_precision"])
        self.fitter = NemoFitter(self.cfg, assets, seed=seed % 2 ** 31)
        self.fitter.params.load_state_dict(self.init)
        self.rows = assets.num_views * assets.num_frames
        part("program")
        if device.type == "cuda":
            _build.library()
            part("kernel_library")

        # the steps the reference follows, through the window's call
        self.losses = list(self.fitter.fit(1, chunk=1)["total_loss"])
        self.grad1 = self._first_gradient()
        self.losses += list(self.fitter.fit(REF_STEPS - 1,
                                            chunk=REF_STEPS - 1)
                            ["total_loss"])
        self.after = {k: v.detach().clone()
                      for k, v in self.fitter.params.state_dict().items()}
        part("reference_steps")
        self.nonfinite = 0

    def _first_gradient(self):
        """Each stepped leaf's gradient as Adam took it at step 1: its first
        moment over 1 - beta1 (weight decay included)."""
        names = {id(p): n for n, p in self.fitter.params.named_parameters()}
        out = {}
        for opt in self.fitter.optimizer.groups.values():
            for p, m in zip(opt.params, opt.m):
                out[names[id(p)]] = m.detach() / (1 - opt.b1)
        return {k: v.clone() for k, v in out.items()}

    @property
    def shapes(self) -> dict:
        c = self.config
        return {"B": self.rows, "V": c["body"]["num_vertices"], "J": 24,
                "H": c["nemo"]["h_dim"], "K": c["nemo"]["phase_rbf_dim"],
                "C": c["nemo"]["instance_code_size"],
                "vposer_neurons": c["vposer"]["num_neurons"],
                "vposer_latent": c["vposer"]["latent_dim"],
                "gmm_components": c["gmm"]["num_gaussians"]}

    def window(self, seconds: float):
        """(steps, wall seconds, steps whose loss was not finite)."""
        steps = bad = 0
        self.marks = []
        sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            m = self.fitter.fit(self.chunk, chunk=self.chunk)
            steps += self.chunk
            self.marks.append((steps, time.perf_counter() - t0))
            bad += int((~np.isfinite(m["total_loss"])).sum())
        sync(self.device)
        self.nonfinite += bad
        return steps, time.perf_counter() - t0, bad

    def traced_steps(self) -> int:
        """The stretch inside the profiler's mark; returns its steps."""
        n = self.traffic["traced_steps"]
        self.fitter.fit(n, chunk=n)
        sync(self.device)
        return n

    def warm_trace(self):
        """Steps run under the profiler before its mark."""
        self.fitter.fit(2, chunk=2)
        sync(self.device)

    def check(self):
        """[(name, value, limit)]: the program's first three steps against
        the reference's from the same inputs. The program's state is freed
        first."""
        self.release()
        return compare(self, self.reference(), self.limits)

    def readings(self) -> dict:
        return readings(self)

    def release(self):
        self.__dict__.pop("fitter", None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, half: bool = False) -> dict:
        """The reference's REF_STEPS steps from the run's inputs; tf32 and
        half plant the control and the half-batch fault in it."""
        raw = self.raw
        priors = nemo_fit.Priors(raw["vposer"], raw["gmm"]["means"],
                                 raw["gmm"]["covars"], raw["gmm"]["weights"])
        return nemo_fit.run_steps(self.init, self.problem, self.body, priors,
                                  self.config["nemo"], REF_STEPS, tf32=tf32,
                                  half=half)
