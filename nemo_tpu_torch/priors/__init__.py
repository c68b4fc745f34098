"""Pose priors: GMoF, GMM, VPoser, its training, the IK engine and SMPLify
(port of nemo_tpu.priors).

The names are those nemo_tpu.priors exports, each imported from its module
on first use: fit/model.py imports priors.gmm and priors.vposer while the
fit package is still initialising, and ik, smplify and vposer_train import
from the fit package in turn.
"""

import importlib

_EXPORTS = {
    "gmm": ("GMMPrior", "gmm_log_likelihood", "load_gmm_prior",
            "synthetic_gmm_prior"),
    "ik": ("IKConfig", "ik_fit"),
    "robustifiers": ("angle_prior", "gmof"),
    "smplify": ("smplify_body_fitting_loss", "smplify_camera_fitting_loss",
                "smplify_fit"),
    "temporal_smplify": ("get_fitting_loss", "run_temporal_smplify",
                         "temporal_body_fitting_loss",
                         "temporal_camera_fitting_loss",
                         "temporal_smplify_fit"),
    "vposer_train": ("VPoserTrainConfig", "load_amass_pose_data",
                     "make_vposer_train_step", "prepare_vposer_dataset",
                     "train_vposer", "vposer_train_loss"),
    "vposer": ("VPoserConfig", "convert_torch_state_dict", "init_vposer",
               "load_vposer", "vposer_decode", "vposer_encode",
               "vposer_kl_to_std_normal"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = list(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_MODULE_OF[name]}", __name__),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
