"""Evaluation metrics (port of nemo_tpu.eval)."""
