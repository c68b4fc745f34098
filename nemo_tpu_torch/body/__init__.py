"""SMPL body model (port of nemo_tpu.body)."""

from . import constants
from .assets import (load_smpl, load_smpl_npz, load_smpl_pkl, smpl_from_numpy,
                     synthetic_smpl_model)
from .smpl import (SMPLModel, batch_rigid_transform, build_fused_tables,
                   fk_rt, smpl_forward, smpl_v2v_l1_sum)
