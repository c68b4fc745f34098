"""Experiment utilities and weight conversion (port of nemo_tpu.utils)."""
