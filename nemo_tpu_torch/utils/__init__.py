"""Experiment utilities and weight conversion (port of nemo_tpu.utils).

The config merge, the per-action YAML and the run-directory helpers are
exported here; ``checkpoint``, ``asset_files`` and ``trace`` are imported as
modules.
"""

from .exp import (MetricWriter, Timer, create_latest_child_dir,
                  dataclass_from_namespace, explicit_cli_keys,
                  find_latest_ckpt, load_action_config, merge_config)

__all__ = ["MetricWriter", "Timer", "create_latest_child_dir",
           "dataclass_from_namespace", "explicit_cli_keys",
           "find_latest_ckpt", "load_action_config", "merge_config"]
