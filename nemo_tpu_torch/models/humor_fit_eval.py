"""HuMoR fitting evaluation: quantitative 3D metrics and the CSV family.

Port of nemo_tpu/models/humor_fit_eval.py (behavioral reference:
humor/humor/fitting/eval_utils.py and eval_fitting_3d.py) for what
``humor_tool fit-amass`` runs: ``quant_eval_3d``, the aggregation and CSV
writers, and the results-directory layer (``save_fitting_results``,
``load_fitting_results``, ``eval_fitting_results_dirs``). All of it is the
JAX package's numpy, copied: the port imports nothing of nemo_tpu. The RGB
evaluation (``quant_eval_2d``) and ``stitch_rgb_results`` wait for the RGB
drivers (ROADMAP.md Queue 1, item 7.1).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# amass_utils.py:22-23 CONTACT_ORDERING -> SMPL joint ids (hips, l/r leg,
# l/r foot, l/r toe, l/r hand), as nemo_tpu/models/humor_loss.py's
CONTACT_INDS = (0, 4, 5, 7, 8, 10, 11, 20, 21)

# eval_utils.py:21-24
GRND_PEN_THRESH_LIST = (0.0, 0.03, 0.06, 0.09, 0.12, 0.15)
DATA_FPS = 30.0

# SMPL_JOINTS subsets (eval_utils.py:296-311): ee = feet, toebases, hands;
# legs = feet, toebases, knees
EE_INDS = (7, 8, 10, 11, 20, 21)
LEGS_INDS = (7, 8, 10, 11, 4, 5)


def get_grnd_pen_key(thresh: float) -> str:
    """eval_utils.py:68-69."""
    return "ground_pen@%0.2f" % thresh


def compute_joint_accel(joints: np.ndarray, fps: float = DATA_FPS
                        ) -> np.ndarray:
    """Magnitude of central-difference joint accelerations for (T, J, 3)
    (eval_utils.py:336-341). Returns (T-2, J)."""
    h = 1.0 / fps
    accel = (joints[:-2] - 2.0 * joints[1:-1] + joints[2:]) / (h * h)
    return np.linalg.norm(accel, axis=-1)


def compute_toe_floor_pen(joints: np.ndarray,
                          floor_plane: Optional[np.ndarray] = None,
                          thresh_list: Sequence[float] = GRND_PEN_THRESH_LIST
                          ):
    """Toe-below-floor counts per threshold + penetration distances
    (eval_utils.py:343-380). joints: (T, J, 3) SMPL joints; floor_plane:
    (4,) (a,b,c,d). The signed height s follows the reference's ray cast
    along -normal: s = n.p - d (z for the canonical floor)."""
    if floor_plane is None:
        floor_plane = np.array([0.0, 0.0, 1.0, 0.0])
    toes = joints[:, [10, 11], :].reshape(-1, 3)
    n = floor_plane[:3] / np.linalg.norm(floor_plane[:3])
    s = toes @ n - floor_plane[3]
    num_pen = [int(np.sum(s < -t)) for t in thresh_list]
    pen_dist = -s[s < 0] if np.any(s < 0) else np.zeros((0,))
    return num_pen, int(s.shape[0]), pen_dist


def quant_eval_3d(pred: Dict[str, np.ndarray], gt: Dict[str, np.ndarray],
                  obs: Optional[Dict[str, np.ndarray]] = None
                  ) -> Dict[str, np.ndarray]:
    """One sequence's quantitative 3D metrics (eval_utils.py:71-135).

    pred/gt: {'joints3d': (T, 22, 3), 'verts3d': (T, K, 3),
    'mesh3d': (T, V, 3), 'contacts': (T, >=22)}; obs optionally holds the
    observed modality with inf marking occluded points — errors are split
    into <mod>_vis / <mod>_occ exactly like the reference.
    """
    out: Dict[str, np.ndarray] = {}
    for mod in ("joints3d", "verts3d", "mesh3d"):
        err = np.linalg.norm(pred[mod] - gt[mod], axis=-1)
        out[mod + "_all"] = err
        if mod == "joints3d":
            out["joints3d_ee"] = np.linalg.norm(
                pred[mod][:, EE_INDS] - gt[mod][:, EE_INDS], axis=-1)
            out["joints3d_legs"] = np.linalg.norm(
                pred[mod][:, LEGS_INDS] - gt[mod][:, LEGS_INDS], axis=-1)
        if obs is not None and mod in obs:
            invis = np.isinf(obs[mod])[..., 0]
            vis = ~invis
            d = np.linalg.norm(pred[mod] - gt[mod], axis=-1)
            out[mod + "_vis"] = d[vis]
            out[mod + "_occ"] = d[invis]

    out["accel_mag"] = compute_joint_accel(pred["joints3d"])

    num_pen, num_tot, pen_dist = compute_toe_floor_pen(pred["joints3d"])
    out["ground_pen_dist"] = pen_dist
    for t, n in zip(GRND_PEN_THRESH_LIST, num_pen):
        out[get_grnd_pen_key(t)] = np.asarray(n)
        out[get_grnd_pen_key(t) + "_cnt"] = np.asarray(num_tot)

    pc = pred["contacts"][:, list(CONTACT_INDS)]
    gc = gt["contacts"][:, list(CONTACT_INDS)]
    out["contact_acc"] = np.asarray(int(np.sum((pc - gc) == 0)))
    out["contact_acc_cnt"] = np.asarray(pc.shape[0] * pc.shape[1])
    return out


def _is_frac_key(k: str) -> bool:
    return k.endswith("_cnt")


def aggregate_fitting_eval(per_seq: List[Dict[str, np.ndarray]]
                           ) -> Dict[str, Dict[str, float]]:
    """Aggregate per-sequence metric dicts into the reference's stat table
    (eval_fitting_3d.py:330-452): array metrics -> mean/std/median/max/min
    over ALL elements pooled across sequences; count-pair metrics
    (X + X_cnt) -> pooled ratio in 'mean' with -1 sentinels elsewhere;
    plus the two supplemental ground-penetration values.
    """
    keys = [k for k in per_seq[0] if not _is_frac_key(k)]
    agg: Dict[str, Dict[str, float]] = {}
    for k in keys:
        if (k + "_cnt") in per_seq[0]:
            val = float(sum(float(d[k]) for d in per_seq))
            cnt = float(sum(float(d[k + "_cnt"]) for d in per_seq))
            agg[k] = {"mean": val / cnt if cnt else 0.0, "std": -1.0,
                      "median": -1.0, "max": -1.0, "min": -1.0}
        else:
            arr = np.concatenate([np.ravel(d[k]) for d in per_seq])
            if arr.size == 0:
                arr = np.zeros((1,))
            agg[k] = {"mean": float(arr.mean()), "std": float(arr.std()),
                      "median": float(np.median(arr)),
                      "max": float(arr.max()), "min": float(arr.min())}
    # supplemental values (eval_fitting_3d.py:438-452)
    pen0 = agg[get_grnd_pen_key(0.0)]["mean"]
    agg["ground_pen_dist_normalized"] = {
        "mean": agg["ground_pen_dist"]["mean"] * pen0, "std": -1.0,
        "median": agg["ground_pen_dist"]["median"] * pen0, "max": -1.0,
        "min": -1.0}
    mean_frac = float(np.mean([agg[get_grnd_pen_key(t)]["mean"]
                               for t in GRND_PEN_THRESH_LIST]))
    agg["ground_pen_mean_agg_frac"] = {"mean": mean_frac, "std": -1.0,
                                       "median": -1.0, "max": -1.0,
                                       "min": -1.0}
    return agg


def per_seq_means(per_seq: List[Dict[str, np.ndarray]]
                  ) -> List[Dict[str, float]]:
    """Per-sequence mean rows (eval_fitting_3d.py:398-427): array metrics
    mean over the sequence; count pairs as per-sequence ratios."""
    rows = []
    for d in per_seq:
        row = {}
        for k, v in d.items():
            if _is_frac_key(k):
                continue
            if (k + "_cnt") in d:
                c = float(d[k + "_cnt"])
                row[k] = float(v) / c if c else 0.0
            else:
                a = np.ravel(v)
                row[k] = float(a.mean()) if a.size else 0.0
        rows.append(row)
    return rows


def write_fitting_eval_csvs(out_dir: str,
                            results: Dict[str, List[Dict[str, np.ndarray]]],
                            seq_names: List[str]) -> None:
    """Write the reference CSV family (eval_fitting_3d.py:459-492):
    <method>_per_seq_mean.csv, <method>_agg_{mean,std,median,max,min}.csv
    and compare_{mean,max,median}.csv across methods. `results` maps
    method/stage name -> list of per-sequence quant_eval_3d dicts."""
    os.makedirs(out_dir, exist_ok=True)
    compare: Dict[str, Dict[str, Dict[str, float]]] = {}
    for name, per_seq in results.items():
        rows = per_seq_means(per_seq)
        cols = list(rows[0].keys())
        with open(os.path.join(out_dir, f"{name}_per_seq_mean.csv"),
                  "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["seq_name"] + cols)
            for sn, row in zip(seq_names, rows):
                w.writerow([sn] + [row[c] for c in cols])

        agg = aggregate_fitting_eval(per_seq)
        compare[name] = agg
        out_vals = list(agg.keys())
        for stat in ("mean", "std", "median", "max", "min"):
            with open(os.path.join(out_dir, f"{name}_agg_{stat}.csv"),
                      "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(out_vals)
                w.writerow([agg[k][stat] for k in out_vals])

    out_vals = list(next(iter(compare.values())).keys())
    for stat in ("mean", "max", "median"):
        with open(os.path.join(out_dir, f"compare_{stat}.csv"),
                  "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["method"] + out_vals)
            for name, agg in compare.items():
                w.writerow([name] + [agg[k][stat] for k in out_vals])


# ---------------------------------------------------------------------------
# Results-directory layer (run_fitting.py --save-results layout,
# fitting_utils.py:270-390 save_rgb_stabilized_results/save_amass_results +
# the walk of eval_fitting_3d.py:82-200)
# ---------------------------------------------------------------------------

GT_RES_NAME = "gt_results"            # eval_fitting_3d.py:29-32
PRED_RES_NAME = "stage3_results"
OBS_NAME = "observations"

# the 43 virtual-marker "keypoint" vertex ids (body_model/utils.py:17-19)
KEYPT_VERTS = (4404, 920, 3076, 3169, 823, 4310, 1010, 1085, 4495, 4569,
               6615, 3217, 3313, 6713, 6785, 3383, 6607, 3207, 1241, 1508,
               4797, 4122, 1618, 1569, 5135, 5040, 5691, 5636, 5404, 2230,
               2173, 2108, 134, 3645, 6543, 3123, 3024, 4194, 1306, 182,
               3694, 4294, 744)


def save_fitting_results(result_dir: str, stage3: Dict[str, np.ndarray],
                         gt: Optional[Dict[str, np.ndarray]] = None,
                         observations: Optional[Dict[str, np.ndarray]]
                         = None,
                         optim_bm: str = "neutral",
                         gt_bm: str = "neutral") -> None:
    """Write one sequence's result directory in the reference layout:
    stage3_results.npz {betas, trans, root_orient, pose_body[, contacts,
    floor_plane]}, gt_results.npz, observations.npz and the two-line
    meta.txt (run_fitting.py:378-384). (The per-stage result files and their
    evaluation wait for the fit-eval subcommand.)"""
    os.makedirs(result_dir, exist_ok=True)
    np.savez(os.path.join(result_dir, PRED_RES_NAME + ".npz"), **stage3)
    if gt is not None:
        np.savez(os.path.join(result_dir, GT_RES_NAME + ".npz"), **gt)
    if observations is not None:
        np.savez(os.path.join(result_dir, OBS_NAME + ".npz"),
                 **observations)
    with open(os.path.join(result_dir, "meta.txt"), "w") as f:
        f.write("optim_bm %s\n" % optim_bm)
        f.write("gt_bm %s\n" % gt_bm)


def load_fitting_results(result_dir: str, name: str
                         ) -> Optional[Dict[str, np.ndarray]]:
    """load_res (eval_fitting_3d.py:load_res): npz -> dict or None."""
    path = os.path.join(result_dir, name + ".npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def eval_fitting_results_dirs(results_root: str, out_dir: str,
                              smpl_fn) -> List[str]:
    """Walk per-sequence result dirs, reconstruct SMPL bodies, run
    quant_eval_3d, and write the CSV family — the quantitative half of
    eval_fitting_3d.py main (:82-260, render/qual paths excluded).

    smpl_fn(trans (T,3), root_orient_aa (T,3), pose_body_aa (T,63),
    betas (T or 1, B)) -> (joints (T, >=22, 3), verts (T, V>=6890, 3)).
    Returns the evaluated sequence names.
    """
    dirs = sorted(d for d in os.listdir(results_root)
                  if not d.startswith(".")
                  and os.path.isdir(os.path.join(results_root, d)))
    per_seq: List[Dict[str, np.ndarray]] = []
    seq_names: List[str] = []

    def bodies(res, T):
        betas = np.asarray(res["betas"])
        if betas.ndim == 1:
            betas = np.broadcast_to(betas[None], (T, betas.shape[0]))
        joints, verts = smpl_fn(res["trans"], res["root_orient"],
                                res["pose_body"], betas)
        joints = np.asarray(joints)[:, :22]
        verts = np.asarray(verts)
        return {"joints3d": joints, "verts3d": verts[:, list(KEYPT_VERTS)],
                "mesh3d": verts}

    for seq in dirs:
        rd = os.path.join(results_root, seq)
        gt_res = load_fitting_results(rd, GT_RES_NAME)
        pred_res = load_fitting_results(rd, PRED_RES_NAME)
        if gt_res is None or pred_res is None:
            continue  # skip like the reference (:104-115)
        T = gt_res["trans"].shape[0]
        # NaN predictions -> zeros (:116-127)
        for k in ("trans", "root_orient", "pose_body", "betas"):
            if not np.all(np.isfinite(pred_res[k])):
                pred_res[k] = np.zeros_like(pred_res[k])
        obs = load_fitting_results(rd, OBS_NAME)
        gt_eval = bodies(gt_res, T)
        gt_eval["contacts"] = gt_res.get(
            "contacts", np.zeros((T, 22), np.float32))
        seq_names.append(seq)

        pred_eval = bodies(pred_res, T)
        pred_eval["contacts"] = pred_res.get("contacts", gt_eval["contacts"])
        per_seq.append(quant_eval_3d(pred_eval, gt_eval, obs))

    write_fitting_eval_csvs(out_dir, {PRED_RES_NAME: per_seq}, seq_names)
    return seq_names
