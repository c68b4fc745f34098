"""One rank of tests/test_torch_port_parallel.py's two-rank gloo run.

Run as ``python tests/torch_parallel_ranks.py WORKDIR`` with torchrun's
environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). It reads the
inputs the test wrote into WORKDIR (inputs.npz, cfg.json), imports only
torch and the port, and writes what it computed to WORKDIR/rank<r>.npz:

  a_*   fit_loss and its gradient through parallel.data_parallel_step on
        a batch whose views split unevenly over the ranks (this rank's
        rows, summed over the ranks); plain_* per-rank means with the
        gradients averaged (what plain DDP computes);
  b_*   NemoFitter(mesh=...) through warmup, camera stage and main fit on
        the replayed batches: per-step metrics and final parameters;
  c_*   train_vposer(mesh=...) with the given draws: history, parameters;
  d_*   as_sharded_arrays' rows;
  jax_modules  the jax / optax / nemo_tpu modules loaded (none).
"""

import json
import os.path as osp
import sys
import types

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

from nemo_tpu_torch import fit as tfit  # noqa: E402
from nemo_tpu_torch.body.assets import smpl_from_numpy  # noqa: E402
from nemo_tpu_torch.data.bundle import MultiViewBundle  # noqa: E402
from nemo_tpu_torch.data.sharded import as_sharded_arrays  # noqa: E402
from nemo_tpu_torch.parallel import distributed, make_mesh  # noqa: E402
from nemo_tpu_torch.parallel.mesh import (data_parallel_step,  # noqa: E402
                                          reduce_gradients)
from nemo_tpu_torch.priors import vposer_train as tvt  # noqa: E402
from nemo_tpu_torch.priors.gmm import gmm_from_numpy  # noqa: E402
from nemo_tpu_torch.utils.checkpoint import (params_from_numpy,  # noqa: E402
                                             params_to_numpy,
                                             vposer_from_numpy)

torch.set_num_threads(1)


def sub(inp, prefix):
    return {k[len(prefix):]: inp[k] for k in inp.files
            if k.startswith(prefix)}


def assets_for(cfg, inp, wd):
    smpl = smpl_from_numpy(types.SimpleNamespace(**sub(inp, "smpl/")))
    gmm = sub(inp, "gmm/")
    return tfit.build_assets(
        MultiViewBundle.load(osp.join(wd, "bundle.npz")), smpl, cfg,
        gmm=gmm_from_numpy(gmm["means"], gmm["precisions"],
                           gmm["nll_weights"]),
        vposer=vposer_from_numpy(sub(inp, "vposer/")), device="cpu")


def grads_of(params):
    return {n.replace(".", "/"): (p.grad.clone() if p.grad is not None
                                  else torch.zeros_like(p)).numpy()
            for n, p in params.named_parameters()}


def part_a(inp, wd, mesh, out):
    cfg = tfit.NemoConfig(**json.load(open(osp.join(wd, "cfg_a.json"))))
    assets = assets_for(cfg, inp, wd)
    params = tfit.init_params(cfg, assets.num_views, assets.img_d0)
    params_from_numpy(params, sub(inp, "a_params/"))
    vi = torch.as_tensor(inp["a_vi"]).long()
    fi = torch.as_tensor(inp["a_fi"]).long()
    # the global function: data_parallel_step keeps this rank's rows,
    # takes the loss with the mesh and sums the gradients over the ranks
    metrics = data_parallel_step(tfit.fit_loss, mesh)(params, cfg, assets,
                                                      vi, fi)
    out["a_loss"] = metrics["total_loss"].numpy()
    for k, v in metrics.items():
        out[f"a_metric/{k}"] = v.numpy()
    out.update({f"a_grad/{k}": g for k, g in grads_of(params).items()})
    # plain DDP: this rank's mean, the gradients averaged over the ranks
    rows = mesh.rows(vi.shape[0])
    params.zero_grad(set_to_none=True)
    loss, metrics = tfit.fit_loss(params, cfg, assets, vi[rows], fi[rows])
    loss.backward()
    metrics = reduce_gradients(mesh, list(params.parameters()),
                               {k: v.detach() for k, v in metrics.items()})
    scale = 1.0 / mesh.size
    out["plain_loss"] = metrics["total_loss"].numpy() * scale
    for k, v in metrics.items():
        out[f"plain_metric/{k}"] = v.numpy() * scale
    for k, g in grads_of(params).items():
        out[f"plain_grad/{k}"] = g * scale


def part_b(inp, wd, mesh, out):
    cfg = tfit.NemoConfig(**json.load(open(osp.join(wd, "cfg_b.json"))))
    assets = assets_for(cfg, inp, wd)
    batches = {"warmup": [(inp[f"b_warmup_vi/{i}"], inp[f"b_warmup_fi/{i}"])
                          for i in range(cfg.warmup_step)],
               "main": [(inp[f"b_main_vi/{i}"], inp[f"b_main_fi/{i}"])
                        for i in range(cfg.n_steps)]}
    f = tfit.NemoFitter(cfg, assets, seed=0, mesh=mesh,
                        batch_source=lambda s, i: batches[s][i])
    params_from_numpy(f.params, sub(inp, "b_params/"))
    for stage, m in (("warmup", f.warmup()), ("camera", f.opt_cam()),
                     ("main", f.fit(chunk=cfg.n_steps // 2))):
        for k, v in m.items():
            out[f"b_{stage}/{k}"] = v
    for k, v in params_to_numpy(f.params).items():
        out[f"b_params/{k}"] = v
    out["b_scale"] = np.asarray([float(s.scale)
                                 for s in f.plateau.values()])


def part_c(inp, wd, mesh, out):
    cfg = tvt.VPoserTrainConfig(**json.load(open(osp.join(wd,
                                                          "cfg_c.json"))))
    smpl = smpl_from_numpy(types.SimpleNamespace(**sub(inp, "c_smpl/")))
    draws = iter([torch.from_numpy(inp[f"c_draw/{i}"])
                  for i in range(int(inp["c_n_draws"]))])
    start = {k: torch.from_numpy(v) for k, v in sub(inp, "c_params/").items()}
    p, hist = tvt.train_vposer(start, inp["c_data"], cfg, num_epochs=2,
                               seed=3, smpl=smpl, mesh=mesh,
                               draw=lambda shape: next(draws))
    assert next(draws, None) is None
    for k, v in p.items():
        out[f"c_params/{k}"] = v.numpy()
    for k, v in hist.items():
        out[f"c_hist/{k}"] = v


def part_d(inp, mesh, out):
    batches = [{"x": inp["d_x"][i:i + 8], "y": inp["d_y"][i:i + 8]}
               for i in range(0, inp["d_x"].shape[0], 8)]
    for i, b in enumerate(as_sharded_arrays(iter(batches), mesh)):
        for k, v in b.items():
            assert v.device == mesh.device
            out[f"d_{k}/{i}"] = v.numpy()


def main(wd):
    assert distributed.initialize(device="cpu")
    mesh = make_mesh(distributed.process_count())
    inp = np.load(osp.join(wd, "inputs.npz"))
    out = {}
    part_a(inp, wd, mesh, out)
    part_b(inp, wd, mesh, out)
    part_c(inp, wd, mesh, out)
    part_d(inp, mesh, out)
    jax_modules = sorted(k for k in sys.modules if k.split(".")[0] in
                         ("jax", "jaxlib", "optax", "nemo_tpu"))
    assert not jax_modules, jax_modules
    out["jax_modules"] = np.asarray(jax_modules, str)
    out["rank"] = np.asarray(mesh.rank)
    np.savez(osp.join(wd, f"rank{mesh.rank}.npz"), **out)
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
