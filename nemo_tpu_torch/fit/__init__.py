"""The fit: model, losses, optimizers, stage loops (port of nemo_tpu.fit)."""

from .assemble import build_assets
from .loop import NemoFitter
from .model import (NemoAssets, NemoConfig, NemoParams, camera_stage_loss,
                    fit_loss, init_params, predict, project_to_views,
                    warmup_loss)
