"""HuMoR motion prior, 3D motion fitting and its evaluation (port of
nemo_tpu.models, the parts the AMASS fitting driver runs)."""

from .humor import (HumorConfig, STATE_DIM, STATE_FIELDS, humor_decode,
                    humor_from_numpy, humor_prior, humor_roll_out,
                    init_humor, pack_state, split_state)
from .humor_fit import (MotionOptConfig, humor_motion_fit,
                        load_init_motion_prior, points3d_loss)
