"""Command-line entry points (port of nemo_tpu.cli)."""
