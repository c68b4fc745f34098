"""Neural modules (port of nemo_tpu.modules)."""
